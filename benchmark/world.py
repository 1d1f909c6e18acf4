"""The synthetic world the benchmark renders its frames from (NumPy only).

A frozen copy of the port's synthetic world and renderer
(`swarmmap_tpu_torch/utils/datasets.py`: `make_world`, `render_frame`,
`distort_points_np`), kept here so that a change to the program cannot
change the benchmark's inputs.  It differs from that copy only where a
configuration needs it: the camera matrix is the configuration's own (fx,
fy, cx, cy, not one focal length about the image centre), the landmark slab
is sized by the configuration, and the random streams come from
`numpy.random.default_rng`, which takes any seed the harness is given.

Each landmark is a 15x15 textured patch whose only sharp corner is its
centre disk, stamped at its projection (through the lens model when the
configuration has distortion), far ones first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.ndimage import gaussian_filter

PATCH = 15
N_RINGS = 8


@dataclasses.dataclass
class World:
    points: np.ndarray    # [P, 3] landmarks
    textures: np.ndarray  # [P, PATCH, PATCH] uint8
    poses_wc: np.ndarray  # [A, F, 4, 4] each agent's camera-to-world poses
    K: np.ndarray         # [3, 3]
    dist: np.ndarray      # [5] (k1, k2, p1, p2, k3)
    hw: tuple[int, int]


def camera(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's (K [3, 3], dist [5]) in float64."""
    K = np.array([[cfg["fx"], 0.0, cfg["cx"]], [0.0, cfg["fy"], cfg["cy"]], [0.0, 0.0, 1.0]])
    dist = np.array([cfg["k1"], cfg["k2"], cfg["p1"], cfg["p2"], cfg["k3"]], np.float64)
    return K, dist


def _look_rotation(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    z = forward / np.linalg.norm(forward)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def trajectory(motion: str, agent: int, n_frames: int) -> np.ndarray:
    """[n_frames, 4, 4] camera-to-world poses of one agent: the renderer's
    sideways "arc" (a hovering MAV) or its "forward" drive, agents offset
    by 1.2 m along x."""
    base = np.array([agent * 1.2 - 1.2, 0.0, 0.0])
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        if motion == "arc":
            c = base + np.array([2.2 * np.sin(0.9 * t * np.pi), 0.35 * np.sin(2 * np.pi * t), 0.8 * t])
        elif motion == "forward":
            c = base + np.array([0.3 * np.sin(2 * np.pi * t), 0.0, 2.5 * t])
        else:
            raise ValueError(f"unknown motion {motion!r}")
        target = np.array([0.0, 0.0, 6.5]) + 0.2 * np.array([np.sin(3 * t), np.cos(3 * t), 0.0])
        T = np.eye(4)
        T[:3, :3] = _look_rotation(target - c, np.array([0.0, -1.0, 0.0])).T
        T[:3, 3] = c
        poses[i] = T
    return poses


def make_world(cfg: dict, rng: np.random.Generator) -> World:
    """Landmarks, textures and every agent's trajectory for configuration
    `cfg` (its "world" block, camera and agent count), drawn from `rng`."""
    wc = cfg["world"]
    n = wc["landmarks"]
    pts = np.stack([rng.uniform(*wc["x"], n), rng.uniform(*wc["y"], n),
                    rng.uniform(*wc["z"], n)], axis=1)
    yy, xx = np.mgrid[-(PATCH // 2): PATCH // 2 + 1, -(PATCH // 2): PATCH // 2 + 1]
    r = np.sqrt(xx**2 + yy**2)
    phi = np.arctan2(yy, xx)
    ring_idx = np.clip(((r - 2.0) / 1.5).astype(int), 0, N_RINGS - 1)
    ring_vals = rng.uniform(0, 200, size=(n, N_RINGS)).astype(np.float32)
    tex = ring_vals[:, ring_idx.reshape(-1)].reshape(n, PATCH, PATCH)
    ramp = np.clip(r / 6.0, 0, 1)[None]
    for harm in (1, 2):
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1))
        amp = rng.uniform(20, 70, size=(n, 1, 1))
        tex = tex + amp * (1 + np.cos(harm * phi[None] - phase)) * 0.5 * ramp
    tex = gaussian_filter(tex, sigma=(0, 0.8, 0.8))
    r_disk = rng.uniform(2.1, 3.0, size=(n, 1, 1))
    tex = np.where(r[None] <= r_disk, rng.uniform(210, 255, size=(n, 1, 1)), tex)
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    poses = np.stack([trajectory(wc["motion"], a, wc["trajectory_frames"])
                      for a in range(cfg["n_agents"])])
    K, dist = camera(cfg)
    return World(pts, tex, poses, K, dist, (cfg["height"], cfg["width"]))


def distort_points(pc: np.ndarray, K: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Camera-frame points [P, 3] -> distorted pixel coordinates [P, 2]
    (the forward radial-tangential model)."""
    z = np.maximum(pc[:, 2], 1e-6)
    x, y = pc[:, 0] / z, pc[:, 1] / z
    k1, k2, p1, p2, k3 = dist[:5]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def camera_points(world: World, pose_wc: np.ndarray) -> np.ndarray:
    """Landmarks in the camera frame of camera-to-world pose `pose_wc`."""
    R_cw = pose_wc[:3, :3].T
    return world.points @ R_cw.T - R_cw @ pose_wc[:3, 3]


def render(world: World, pose_wc: np.ndarray) -> np.ndarray:
    """[H, W] uint8 frame seen from camera-to-world pose `pose_wc`."""
    h, w = world.hw
    img = np.full((h, w), 35, dtype=np.float32)
    img += np.linspace(0, 18, w)[None, :]
    pc = camera_points(world, pose_wc)
    uv = distort_points(pc, world.K, world.dist)
    r = PATCH // 2
    for j in np.argsort(-pc[:, 2]):
        if pc[j, 2] <= 0.3:
            continue
        u, v = int(round(uv[j, 0])), int(round(uv[j, 1]))
        if not (r <= u < w - r and r <= v < h - r):
            continue
        win = img[v - r: v + r + 1, u - r: u + r + 1]
        np.maximum(win, world.textures[j], out=win)
    return np.clip(img, 0, 255).astype(np.uint8)
