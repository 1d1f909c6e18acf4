"""Dataset loaders + synthetic world renderer (numpy + scipy).

Copy of swarmmap_tpu/utils/datasets.py, which the port cannot import on a
machine without JAX (every module of the JAX package loads JAX first).
The real-format loaders mirror the reference's code/src/DataSetUtil.cc:
  - EuRoC : image dir of <ns>.png + timestamp list file
  - TUM   : dataset dir with rgb.txt ("ts path" lines)
  - KITTI : sequence dir with times.txt + image_0/%06d.png
and decode through `utils/png.py` (no cv2), to the arrays `cv2.imread`
gives.  The synthetic world renders a fixed 3D landmark field from a
smooth camera trajectory, with arrays identical to the JAX package's for
the same arguments; `synthesize_sequence` wraps them as an `ImageSequence`
with the ground truth attached.  With `n_dynamic > 0` a rigid flock of
striped patches drifts through the near field (the moving objects of
dynamic-object filtering, `core/dynamic.py`); `render_stereo_pair` renders
a rectified stereo pair.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from . import png


@dataclasses.dataclass
class ImageSequence:
    paths: list[str]           # empty for synthetic (frames held in memory)
    timestamps: np.ndarray     # [N] float64 seconds
    frames: np.ndarray | None = None  # [N,H,W] uint8 for synthetic
    depth_paths: list[str] | None = None   # RGB-D (TUM depth pngs)
    right_paths: list[str] | None = None   # stereo (KITTI image_1)
    depth_factor: float = 5000.0            # TUM: 16-bit png / 5000 = m
    world: SyntheticWorld | None = None     # ground truth of a synthetic one

    def __len__(self) -> int:
        return len(self.timestamps)

    def read(self, i: int) -> np.ndarray:
        """Return grayscale uint8 [H,W]."""
        if self.frames is not None:
            return self.frames[i]
        return png.imread_gray(self.paths[i])

    def read_depth(self, i: int) -> np.ndarray:
        """Metric depth [H,W] float32 (0 = invalid)."""
        return png.imread_unchanged(self.depth_paths[i]).astype(np.float32) / self.depth_factor

    def read_right(self, i: int) -> np.ndarray:
        return png.imread_gray(self.right_paths[i])


def load_euroc(image_dir: str, times_file: str | None = None) -> ImageSequence:
    """EuRoC cam dir of <ns>.png.  With no TIMES file, timestamps come
    from the filenames themselves (they are nanosecond stamps)."""
    if times_file and Path(times_file).exists():
        lines = [ln.strip() for ln in Path(times_file).read_text().splitlines()
                 if ln.strip()]
        stamps = [float(ln) / 1e9 for ln in lines]
        paths = [str(Path(image_dir) / f"{ln}.png") for ln in lines]
    else:
        files = sorted(Path(image_dir).glob("*.png"))
        stamps = [float(f.stem) / 1e9 for f in files]
        paths = [str(f) for f in files]
    return ImageSequence(paths=paths, timestamps=np.asarray(stamps))


def _read_tum_list(path: Path) -> list[tuple[float, str]]:
    out = []
    for ln in path.read_text().splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        ts, rel = ln.split()[:2]
        out.append((float(ts), rel))
    return out


def load_tum(dataset_dir: str, with_depth: bool = False,
             depth_factor: float = 5000.0,
             max_dt: float = 0.02) -> ImageSequence:
    """TUM RGB-D dir with rgb.txt (+ depth.txt for the rgbd mode; frames
    are associated by nearest timestamp within max_dt, the standard
    associate.py rule)."""
    base = Path(dataset_dir)
    rgb = _read_tum_list(base / "rgb.txt")
    if not with_depth:
        return ImageSequence(
            paths=[str(base / rel) for _, rel in rgb],
            timestamps=np.asarray([ts for ts, _ in rgb]),
        )
    depth = _read_tum_list(base / "depth.txt")
    d_ts = np.asarray([ts for ts, _ in depth])
    stamps, paths, dpaths = [], [], []
    for ts, rel in rgb:
        j = int(np.argmin(np.abs(d_ts - ts)))
        if abs(d_ts[j] - ts) <= max_dt:
            stamps.append(ts)
            paths.append(str(base / rel))
            dpaths.append(str(base / depth[j][1]))
    return ImageSequence(paths=paths, timestamps=np.asarray(stamps),
                         depth_paths=dpaths, depth_factor=depth_factor)


def load_kitti(sequence_dir: str, with_right: bool = False) -> ImageSequence:
    seq = Path(sequence_dir)
    stamps = [float(x) for x in (seq / "times.txt").read_text().split()]
    paths = [str(seq / "image_0" / f"{i:06d}.png") for i in range(len(stamps))]
    right = (
        [str(seq / "image_1" / f"{i:06d}.png") for i in range(len(stamps))]
        if with_right else None
    )
    return ImageSequence(paths=paths, timestamps=np.asarray(stamps),
                         right_paths=right)


def load_sequence(dtype: str, image_dir: str, times_file: str | None = None,
                  sensor: str = "mono",
                  depth_factor: float = 5000.0) -> ImageSequence:
    if dtype == "euroc":
        return load_euroc(image_dir, times_file)
    if dtype == "tum":
        return load_tum(image_dir, with_depth=(sensor == "rgbd"),
                        depth_factor=depth_factor)
    if dtype == "kitti":
        return load_kitti(image_dir, with_right=(sensor == "stereo"))
    if dtype == "synthetic":
        return synthesize_sequence()
    raise ValueError(f"unknown dataset type {dtype!r}")


# ---------------------------------------------------------------------------
# Synthetic world
# ---------------------------------------------------------------------------


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
    # moving rigid flock (the dynamic-object analogue of the reference's
    # people/vehicles, DynamicExtractor.cc): positions are
    # dyn_points + t * dyn_vel at frame-time t in [0,1]; textures are
    # the STRIPE appearance class (core.dynamic.stripe_texture) so the
    # shipped appearance segmenter can reject them
    dyn_points: np.ndarray | None = None   # [D,3] at t=0
    dyn_vel: np.ndarray | None = None      # [3] world units over the sequence
    dyn_textures: np.ndarray | None = None  # [D,ps,ps] uint8

    def dyn_at(self, i: int) -> np.ndarray | None:
        if self.dyn_points is None:
            return None
        t = i / max(len(self.poses_wc) - 1, 1)
        return self.dyn_points + t * self.dyn_vel


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
    if n_dynamic:
        # a rigid flock of corner-bearing striped patches drifting
        # through the near field: close to the camera (large apparent
        # motion and pose-opt weight) and moving coherently, so its
        # matches bias the pose estimate instead of averaging out —
        # the degenerate case dynamic filtering exists for.  Imported
        # here: core.dynamic imports core.map_store.
        from ..core.dynamic import stripe_texture

        world.dyn_points = np.stack(
            [
                rng.uniform(-3.0, 3.0, n_dynamic),
                rng.uniform(-2.0, 2.0, n_dynamic),
                rng.uniform(3.2, 5.5, n_dynamic),
            ],
            axis=1,
        )
        world.dyn_vel = np.array([0.8, 0.25, 0.0])
        dtex = np.empty((n_dynamic, ps, ps), np.uint8)
        disk = r <= 2.5
        for j in range(n_dynamic):
            t = stripe_texture(ps, rng)
            t[disk] = rng.uniform(215, 255)
            dtex[j] = np.clip(t, 0, 255).astype(np.uint8)
        world.dyn_textures = dtex
    return world


def render_frame(
    world: SyntheticWorld, i: int, return_depth: bool = False,
    pose_wc: np.ndarray | None = None, return_dyn_mask: bool = False,
):
    """Render frame i: project landmarks, stamp their textures.
    With return_depth, also emit a dense depth map (landmark depth on the
    stamped patch, +inf on background); with return_dyn_mask, the mask of
    the pixels the moving flock covers."""
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
    dyn_mask = np.zeros((h, w), bool)
    dpts = world.dyn_at(i)
    if dpts is not None:
        # the moving flock occludes the static field (it is nearer)
        pc = dpts @ R_cw.T + t_cw
        z = pc[:, 2]
        if np.any(world.dist != 0):
            uv = distort_points_np(pc, world.K, world.dist)
        else:
            uv = (pc[:, :2] / np.maximum(z[:, None], 1e-6)) @ np.diag(
                [world.K[0, 0], world.K[1, 1]]
            ) + world.K[:2, 2]
        for j in np.argsort(-z):
            if z[j] <= 0.3:
                continue
            u, v = int(round(uv[j, 0])), int(round(uv[j, 1]))
            if not (r <= u < w - r and r <= v < h - r):
                continue
            img[v - r: v + r + 1, u - r: u + r + 1] = world.dyn_textures[j]
            depth[v - r: v + r + 1, u - r: u + r + 1] = z[j]
            dyn_mask[v - r: v + r + 1, u - r: u + r + 1] = True
    out = np.clip(img, 0, 255).astype(np.uint8)
    if return_depth and return_dyn_mask:
        return out, depth, dyn_mask
    if return_depth:
        return out, depth
    if return_dyn_mask:
        return out, dyn_mask
    return out


def render_stereo_pair(world: SyntheticWorld, i: int, baseline: float = 0.12):
    """Left/right rectified pair: right camera shifted by `baseline`
    along the camera x-axis (standard rectified stereo geometry)."""
    left = render_frame(world, i)
    T = world.poses_wc[i].copy()
    T[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([baseline, 0.0, 0.0])
    right = render_frame(world, i, pose_wc=T)
    return left, right


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
    n_dynamic: int = 0,
) -> ImageSequence:
    """`n_frames` rendered frames of `make_world`, at `fps`, with the
    world attached as `.world`."""
    world = make_world(n_points=n_points, n_frames=n_frames, hw=hw, seed=seed,
                       agent=agent, motion=motion, focal=focal, dist=dist,
                       n_dynamic=n_dynamic)
    frames = np.stack([render_frame(world, i) for i in range(n_frames)])
    return ImageSequence(paths=[], timestamps=np.arange(n_frames) / fps, frames=frames,
                         world=world)
