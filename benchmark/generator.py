"""The traffic generator: every input a run sends, made from the seed.

One generator serves every mix.  A mix (`traffic/<name>.json`) gives the
parameters; the configuration (`configs/<name>.json`) gives the camera,
the ORB settings, the agents and the world.  `track_ring` makes each
agent's ring of consecutive frames with the local map and the pose guess
that a steady-state tracker hands the batched step; `sequences` makes
each agent's frames in order for a whole-swarm run.

Seeds: any integer.  Every draw comes from `numpy.random.default_rng`
keyed by (seed, stream), so the same seed gives the same inputs on every
host, and another seed gives the same sizes with other content.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch
from scipy.spatial import cKDTree

from . import world as world_mod
from .reference import orb

WORLD, MAP, SAMPLE = 0, 1, 2  # random streams: the world, the maps, the checked steps


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


def in_view(w: world_mod.World, pose_wc: np.ndarray, border: int):
    """(camera-frame points [P, 3], distorted pixels [P, 2], mask [P]) of
    the landmarks that pose `pose_wc` renders at least `border` pixels
    inside its image."""
    pc = world_mod.camera_points(w, pose_wc)
    uv = world_mod.distort_points(pc, w.K, w.dist)
    h, wd = w.hw
    ok = ((pc[:, 2] > 0.3) & (uv[:, 0] >= border) & (uv[:, 0] < wd - border)
          & (uv[:, 1] >= border) & (uv[:, 1] < h - border))
    return pc, uv, ok


def landmark_descriptors(image: np.ndarray, uv: np.ndarray, device: torch.device) -> np.ndarray:
    """[P, 8] int32 steered-BRIEF descriptors of the patches at pixels uv
    [P, 2] of one frame, at level 0, by the plain extractor
    (`reference/orb.py`): what a keyframe's view of each landmark reads."""
    lvl = torch.from_numpy(image).to(device, torch.float32)[None]
    xy = torch.from_numpy(uv.astype(np.float32)).to(device)[None]
    valid = torch.ones(xy.shape[:2], dtype=torch.bool, device=device)
    with torch.no_grad():
        ang = orb.angles(lvl, xy, valid)
        return orb.descriptors(orb.blur(lvl), xy, ang, valid)[0].cpu().numpy()


def local_map(w: world_mod.World, poses: np.ndarray, fr: int, feats: dict, keyframe: Callable,
              cfg: dict, mix: dict, r: np.random.Generator) -> dict:
    """The local map a tracker holds for frame `fr`, every one of its
    `map_points` slots a landmark, as ORB-SLAM2's local map is the points
    of the covisible keyframes.  First each landmark that a keypoint of the
    previous frame (`feats`) lies within `association_px` of: its true
    position, that keypoint's descriptor and ORB-SLAM2's max distance
    (viewing distance x scale^octave).  Then, in an order drawn from `r`,
    the other landmarks in view of the keyframes fr-1, fr-1-stride, ...,
    0, each with the descriptor and viewing distance of the latest
    keyframe that sees it (`keyframe(g)`: ids, descriptors, distances)."""
    M = cfg["map_points"]
    pc, uv, _ = in_view(w, poses[fr - 1], 0)
    valid = feats["valid"]
    xy = feats["xy"][valid].astype(np.float64)
    front = np.flatnonzero(pc[:, 2] > 0.1)
    dist, k = cKDTree(uv[front]).query(xy, k=1) if len(xy) else (np.zeros(0), np.zeros(0, int))
    hit = np.flatnonzero(dist < mix["association_px"])
    ids, first = np.unique(front[k[hit]], return_index=True)   # one map point a landmark
    hit = hit[first]
    ids = list(ids)
    desc = list(feats["desc"][valid][hit])
    maxd = list(np.linalg.norm(pc[ids], axis=1) * cfg["scale_factor"] ** feats["octave"][valid][hit])
    seen = set(ids)
    more = {}
    for g in range(fr - 1, -1, -mix["keyframe_stride"]):
        for j, d, z in zip(*keyframe(g)):
            if j not in seen and j not in more:
                more[j] = (d, z)
    order = sorted(more)
    for j in (order[i] for i in r.permutation(len(order))):
        if len(ids) >= M:
            break
        ids.append(j)
        desc.append(more[j][0])
        maxd.append(more[j][1])
    if len(ids) < M:
        raise ValueError(f"{len(ids)} landmarks in view of frame {fr}'s keyframes, "
                         f"fewer than the {M} map points: the world is too sparse")
    ids = np.asarray(ids[:M])
    return {"mp_pos": w.points[ids].astype(np.float32),
            "mp_desc": np.stack(desc[:M]).astype(np.int32),
            "mp_max_dist": np.asarray(maxd[:M], np.float32),
            "mp_valid": np.ones(M, bool)}


def track_ring(cfg: dict, mix: dict, seed: int, device: torch.device) -> list[list[dict]]:
    """[agent][ring index] -> host inputs of the batched step (image,
    Tcw_guess, K, dist, mp_pos, mp_desc, mp_max_dist, mp_valid) for frames
    first_frame .. first_frame + ring_frames - 1 of each agent's trajectory.
    The guess is the constant-velocity extrapolation of the two previous
    true poses; the map (`local_map`) is built from the previous frame,
    whose features come from the plain extractor (`reference/orb.py`) on
    `device`, and from the keyframes before it."""
    w = world_mod.make_world(cfg, rng(seed, WORLD))
    r_map = rng(seed, MAP)
    f0, R = mix["first_frame"], mix["ring_frames"]
    if f0 < 2 or f0 + R > cfg["world"]["trajectory_frames"]:
        raise ValueError("the ring must lie inside the trajectory, two frames in")
    K = w.K.astype(np.float32)
    dist = w.dist.astype(np.float32)
    out = []
    for a in range(cfg["n_agents"]):
        poses = w.poses_wc[a]
        frames = np.stack([world_mod.render(w, poses[f]) for f in range(f0 + R)])
        with torch.no_grad():
            f = orb.extract(torch.from_numpy(frames[f0 - 1:-1]).to(device), cfg["n_features"],
                            cfg["n_levels"], cfg["scale_factor"],
                            float(cfg["ini_th_fast"]), float(cfg["min_th_fast"]))
        f = {k: v.cpu().numpy() for k, v in f.items()}
        views: dict[int, tuple] = {}

        def keyframe(g: int) -> tuple:
            if g not in views:
                pc, uv, ok = in_view(w, poses[g], orb.BORDER)
                j = np.flatnonzero(ok)
                views[g] = (j, landmark_descriptors(frames[g], uv[j], device),
                            np.linalg.norm(pc[j], axis=1))
            return views[g]

        ring = []
        for i in range(R):
            fr = f0 + i
            T1, T2 = np.linalg.inv(poses[fr - 1]), np.linalg.inv(poses[fr - 2])
            feats = {k: v[i] for k, v in f.items()}
            ring.append({
                "image": frames[fr],
                "Tcw_guess": (T1 @ np.linalg.inv(T2) @ T1).astype(np.float32),
                "K": K, "dist": dist,
                **local_map(w, poses, fr, feats, keyframe, cfg, mix, r_map),
            })
        out.append(ring)
    return out


def sequences(cfg: dict, mix: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(frames [A, F, H, W] uint8, timestamps [F]): each agent's whole
    trajectory in the mix's `frames` frames, at the configuration's frame
    rate."""
    F = mix["frames"]
    w = world_mod.make_world(dict(cfg, world=dict(cfg["world"], trajectory_frames=F)),
                             rng(seed, WORLD))
    frames = np.stack([np.stack([world_mod.render(w, w.poses_wc[a, f]) for f in range(F)])
                       for a in range(cfg["n_agents"])])
    return frames, np.arange(F) / cfg["fps"]
