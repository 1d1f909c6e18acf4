"""Synthetic world renderer (numpy + scipy).

Copy of the synthetic part of swarmmap_tpu/utils/datasets.py, which the
port cannot import on a machine without JAX (every module of the JAX
package loads JAX first).  It renders a fixed 3D landmark field from a
smooth camera trajectory, and gives arrays identical to the JAX package's
for the same arguments, and `synthesize_sequence` wraps them as an
`ImageSequence` with the ground truth attached.  The moving-flock option
(`n_dynamic > 0`) and the file loaders (EuRoC, TUM, KITTI) are not ported
yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _look_rotation(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World->camera rotation for a camera looking along `forward` (z_cam)."""
    z = forward / np.linalg.norm(forward)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # rows = camera axes in world coords


@dataclasses.dataclass
class SyntheticWorld:
    points: np.ndarray          # [P,3] world landmarks
    textures: np.ndarray        # [P,ps,ps] uint8 per-landmark patch
    poses_wc: np.ndarray        # [N,4,4] camera-to-world (ground truth)
    K: np.ndarray               # [3,3]
    hw: tuple[int, int]
    # radial-tangential lens model (k1,k2,p1,p2,k3); zeros = pinhole
    dist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(5, np.float32))


def distort_points_np(pc: np.ndarray, K: np.ndarray,
                      dist: np.ndarray) -> np.ndarray:
    """Forward radial-tangential lens model: camera-frame points ->
    DISTORTED pixel coords (the inverse of extractor.undistort_points)."""
    z = np.maximum(pc[:, 2], 1e-6)
    x, y = pc[:, 0] / z, pc[:, 1] / z
    k1, k2, p1, p2, k3 = np.asarray(dist, np.float64)[:5]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def make_world(
    n_points: int = 600,
    n_frames: int = 80,
    hw: tuple[int, int] = (480, 640),
    seed: int = 0,
    agent: int = 0,
    motion: str = "arc",
    focal: float | None = None,
    dist: np.ndarray | None = None,
    n_dynamic: int = 0,
) -> SyntheticWorld:
    """Landmark field + smooth trajectory.  Different `agent` values share
    the SAME world (same seed for points) but follow offset trajectories."""
    if n_dynamic:
        raise NotImplementedError("the moving flock (n_dynamic > 0) is not ported yet")
    rng = np.random.RandomState(seed)
    h, w = hw
    if motion == "circuit":
        # ring world: landmarks on an outer annulus, camera drives a loop
        ang = rng.uniform(0, 2 * np.pi, n_points)
        rad = rng.uniform(9.0, 14.0, n_points)
        pts = np.stack(
            [rad * np.cos(ang), rng.uniform(-3.0, 3.0, n_points), rad * np.sin(ang)],
            axis=1,
        )
    else:
        # landmark slab 4..9m in front of the trajectory, wide FOV coverage
        pts = np.stack(
            [
                rng.uniform(-6, 6, n_points),
                rng.uniform(-3.5, 3.5, n_points),
                rng.uniform(4.0, 9.0, n_points),
            ],
            axis=1,
        )
    ps = 15
    # Per-landmark texture: the ONLY sharp corner is the center disk;
    # random concentric ring intensities + a smooth orientation wedge keep
    # descriptors discriminative and the intensity centroid well defined.
    yy, xx = np.mgrid[-(ps // 2): ps // 2 + 1, -(ps // 2): ps // 2 + 1]
    r = np.sqrt(xx**2 + yy**2)
    phi = np.arctan2(yy, xx)
    n_rings = 8
    ring_idx = np.clip(((r - 2.0) / 1.5).astype(int), 0, n_rings - 1)
    ring_vals = rng.uniform(0, 200, size=(n_points, n_rings)).astype(np.float32)
    tex = ring_vals[:, ring_idx.reshape(-1)].reshape(n_points, ps, ps)
    ramp = np.clip(r / 6.0, 0, 1)[None]
    for harm in (1, 2):
        phase = rng.uniform(0, 2 * np.pi, size=(n_points, 1, 1))
        amp = rng.uniform(20, 70, size=(n_points, 1, 1))
        tex = tex + amp * (1 + np.cos(harm * phi[None] - phase)) * 0.5 * ramp
    from scipy.ndimage import gaussian_filter

    tex = gaussian_filter(tex, sigma=(0, 0.8, 0.8))
    r_disk = rng.uniform(2.1, 3.0, size=(n_points, 1, 1))
    disk = r[None] <= r_disk
    amp = rng.uniform(210, 255, size=(n_points, 1, 1))
    tex = np.where(disk, amp, tex)
    tex = np.clip(tex, 0, 255).astype(np.uint8)

    base = np.array([agent * 1.2 - 1.2, 0.0, 0.0])
    poses = np.zeros((n_frames, 4, 4), dtype=np.float64)
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        if motion == "arc":
            # sideways arc (good mono-init parallax) + slight push-in
            c = base + np.array([2.2 * np.sin(0.9 * t * np.pi), 0.35 * np.sin(2 * np.pi * t), 0.8 * t])
            target = np.array([0.0, 0.0, 6.5]) + 0.2 * np.array(
                [np.sin(3 * t), np.cos(3 * t), 0.0]
            )
        elif motion == "circuit":
            # closed loop of radius 5, looking at the outer wall ahead
            th = 2 * np.pi * t * 1.05 + agent * 0.7
            c = np.array([5.0 * np.cos(th), 0.15 * np.sin(4 * th), 5.0 * np.sin(th)])
            th2 = th + 0.45
            target = np.array([11.0 * np.cos(th2), 0.0, 11.0 * np.sin(th2)])
        else:  # forward
            c = base + np.array([0.3 * np.sin(2 * np.pi * t), 0.0, 2.5 * t])
            target = np.array([0.0, 0.0, 6.5]) + 0.2 * np.array(
                [np.sin(3 * t), np.cos(3 * t), 0.0]
            )
        R_cw = _look_rotation(target - c, np.array([0.0, -1.0, 0.0]))
        T = np.eye(4)
        T[:3, :3] = R_cw.T  # camera-to-world rotation
        T[:3, 3] = c
        poses[i] = T
    if focal is None:
        focal = 0.72 * w if motion == "circuit" else 460.0
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]])
    world = SyntheticWorld(points=pts, textures=tex, poses_wc=poses, K=K, hw=hw)
    if dist is not None:
        world.dist = np.asarray(dist, np.float32)
    return world


def render_frame(
    world: SyntheticWorld, i: int, return_depth: bool = False,
    pose_wc: np.ndarray | None = None,
):
    """Render frame i: project landmarks, stamp their textures.
    With return_depth, also emit a dense depth map (landmark depth on the
    stamped patch, +inf on background)."""
    h, w = world.hw
    img = np.full((h, w), 35, dtype=np.float32)
    # gentle illumination gradient so the background isn't flat
    img += np.linspace(0, 18, w)[None, :]
    depth = np.full((h, w), np.inf, np.float32)
    T_wc = pose_wc if pose_wc is not None else world.poses_wc[i]
    R_cw = T_wc[:3, :3].T
    t_cw = -R_cw @ T_wc[:3, 3]
    pc = world.points @ R_cw.T + t_cw
    z = pc[:, 2]
    if np.any(world.dist != 0):
        uv = distort_points_np(pc, world.K, world.dist)
    else:
        uv = (pc[:, :2] / np.maximum(z[:, None], 1e-6)) @ np.diag(
            [world.K[0, 0], world.K[1, 1]]
        ) + world.K[:2, 2]
    ps = world.textures.shape[1]
    r = ps // 2
    order = np.argsort(-z)  # far first so near landmarks overwrite
    for j in order:
        if z[j] <= 0.3:
            continue
        u, v = int(round(uv[j, 0])), int(round(uv[j, 1]))
        if not (r <= u < w - r and r <= v < h - r):
            continue
        patch = world.textures[j].astype(np.float32)
        img[v - r: v + r + 1, u - r: u + r + 1] = np.maximum(
            img[v - r: v + r + 1, u - r: u + r + 1], patch
        )
        depth[v - r: v + r + 1, u - r: u + r + 1] = z[j]
    out = np.clip(img, 0, 255).astype(np.uint8)
    if return_depth:
        return out, depth
    return out


@dataclasses.dataclass
class ImageSequence:
    """A sequence of grayscale frames held in memory (the synthetic part
    of the JAX package's ImageSequence)."""
    timestamps: np.ndarray     # [N] float64 seconds
    frames: np.ndarray         # [N,H,W] uint8
    world: SyntheticWorld | None = None  # ground truth

    def __len__(self) -> int:
        return len(self.timestamps)

    def read(self, i: int) -> np.ndarray:
        """Return grayscale uint8 [H,W]."""
        return self.frames[i]


def synthesize_sequence(
    n_frames: int = 80,
    hw: tuple[int, int] = (480, 640),
    seed: int = 0,
    agent: int = 0,
    fps: float = 20.0,
    motion: str = "arc",
    n_points: int = 600,
    focal: float | None = None,
    dist: np.ndarray | None = None,
) -> ImageSequence:
    """`n_frames` rendered frames of `make_world`, at `fps`, with the
    world attached as `.world`."""
    world = make_world(n_points=n_points, n_frames=n_frames, hw=hw, seed=seed,
                       agent=agent, motion=motion, focal=focal, dist=dist)
    frames = np.stack([render_frame(world, i) for i in range(n_frames)])
    return ImageSequence(timestamps=np.arange(n_frames) / fps, frames=frames, world=world)
