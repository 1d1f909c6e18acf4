"""The per-frame tracking step, batched over agents.

Port of swarmmap_tpu/pipeline.py.  One tracked frame is: extraction ->
undistortion -> local-map projection -> window + octave mask -> Hamming
matching with the mutual-best check -> LM pose optimisation.  Where the
JAX package vmaps `tracking_step` over agents, every op here carries the
agent axis as a leading batch dimension, so A agents cost the launches of
one (no Python loop over agents).  On CUDA the pose stage is one launch of
the hand-written kernel (ops/pose_kernel.py).

Not ported yet: the mesh branch of `make_multi_agent_step`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops import extractor, hamming, matching, pose_opt
from .utils.device import default_device


class TrackInputs(NamedTuple):
    image: torch.Tensor        # [..., H, W] uint8
    Tcw_guess: torch.Tensor    # [..., 4, 4]
    K: torch.Tensor            # [..., 3, 3]
    dist: torch.Tensor         # [..., 5] radial-tangential (k1,k2,p1,p2,k3)
    mp_pos: torch.Tensor       # [..., M, 3] local-map points
    mp_desc: torch.Tensor      # [..., M, 8] int32 words of packed rBRIEF
    mp_max_dist: torch.Tensor  # [..., M]
    mp_valid: torch.Tensor     # [..., M] bool


class TrackOutputs(NamedTuple):
    Tcw: torch.Tensor          # [..., 4, 4] optimised pose
    n_inliers: torch.Tensor    # [...] int32
    match_mp: torch.Tensor     # [..., N_kp] int32 map-point index per keypoint (-1 none)
    features: extractor.FrameFeatures
    xy_ud: torch.Tensor        # [..., N_kp, 2] undistorted keypoint coords


class PoseProblem(NamedTuple):
    """Inputs of the pose stage of one batched step (pose_optimize's
    argument order)."""
    Tcw0: torch.Tensor
    K: torch.Tensor
    pts_w: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def match_frame(
    inp: TrackInputs,
    n_features: int = 1000,
    n_levels: int = 8,
    scale: float = 1.2,
    hw: tuple[int, int] = (480, 752),
    window_th: float = 15.0,
) -> tuple[extractor.FrameFeatures, torch.Tensor, torch.Tensor, PoseProblem]:
    """Everything before the pose stage, for [A, ...] inputs.  Returns
    (features, xy_ud, match_mp, pose problem)."""
    feats = extractor.extract_orb(
        inp.image, n_features=n_features, n_levels=n_levels, scale=scale
    )
    # undistort inside the step (reference: Frame::UndistortKeyPoints);
    # an agent with dist == 0 keeps its raw detections bit for bit
    no_dist = torch.all(inp.dist == 0, dim=-1)                     # [A]
    xy_ud = torch.where(
        no_dist[:, None, None], feats.xy,
        extractor.undistort_points(feats.xy, inp.K, inp.dist),
    )
    # visibility bounds from the undistorted image corners (reference:
    # Frame::ComputeImageBounds)
    h_, w_ = hw
    corners = torch.tensor([[0.0, 0.0], [w_, 0.0], [0.0, h_], [w_, h_]],
                           dtype=torch.float32, device=feats.xy.device)
    corners = corners.expand(no_dist.shape + corners.shape)
    cu = torch.where(no_dist[:, None, None], corners,
                     extractor.undistort_points(corners, inp.K, inp.dist))
    bounds = (cu[..., 0].amin(-1), cu[..., 0].amax(-1),
              cu[..., 1].amin(-1), cu[..., 1].amax(-1))
    uv, depth, visible = matching.project_to_frame(
        inp.Tcw_guess, inp.K, inp.mp_pos, hw, bounds=bounds
    )
    visible = visible & inp.mp_valid
    pred_oct = matching.predicted_octave(depth, inp.mp_max_dist, scale, n_levels)
    radius = window_th * torch.tensor(scale, dtype=torch.float32) ** pred_oct.float()
    mask = matching.window_mask(
        uv, xy_ud, radius, visible, feats.valid,
        t_octave=feats.octave, oct_lo=pred_oct - 1, oct_hi=pred_oct + 1,
    )
    m = matching.masked_match(
        inp.mp_desc, feats.desc, mask, max_dist=matching.TH_HIGH, ratio=0.0
    )
    # invert matches with gathers: the mutual-best pairing is an
    # involution, so keypoint t's map point is target_q[t] whenever that
    # query's match survived
    n_kp = feats.xy.shape[-2]
    t_ids = torch.arange(n_kp, dtype=torch.int32, device=feats.xy.device)
    bq = m.target_q.long()                                  # [A, N_kp]
    survived = torch.gather(m.valid, -1, bq) & (torch.gather(m.idx, -1, bq) == t_ids)
    match_mp = torch.where(survived, m.target_q, -1)
    kp_mp = torch.clamp(match_mp, 0, inp.mp_pos.shape[-2] - 1).long()
    pts = torch.gather(inp.mp_pos, -2, kp_mp[..., None].expand(kp_mp.shape + (3,)))
    valid = (match_mp >= 0) & feats.valid
    sig2 = torch.tensor(scale, dtype=torch.float32) ** (2.0 * feats.octave.float())
    problem = PoseProblem(*(x.contiguous() for x in (
        inp.Tcw_guess, inp.K, pts, xy_ud, 1.0 / sig2, valid)))
    return feats, xy_ud, match_mp, problem


def batched_tracking_step(
    inp: TrackInputs,
    n_features: int = 1000,
    n_levels: int = 8,
    scale: float = 1.2,
    hw: tuple[int, int] = (480, 752),
    window_th: float = 15.0,
) -> TrackOutputs:
    """One tracked frame for each of A agents: inputs and outputs carry a
    leading [A] axis (the production combined-mode path)."""
    feats, xy_ud, match_mp, prob = match_frame(
        inp, n_features=n_features, n_levels=n_levels, scale=scale,
        hw=hw, window_th=window_th,
    )
    # 2x8 LM schedule, as the JAX package's fused path
    res = pose_opt.pose_optimize_auto(*prob, rounds=2, iters=8)
    return TrackOutputs(
        Tcw=res.Tcw,
        n_inliers=res.inliers.sum(-1, dtype=torch.int32),
        match_mp=torch.where(res.inliers, match_mp, -1),
        features=feats,
        xy_ud=xy_ud,
    )


def tracking_step(inp: TrackInputs, **kwargs) -> TrackOutputs:
    """One tracked frame of one agent (unbatched inputs and outputs)."""
    out = batched_tracking_step(TrackInputs(*(x[None] for x in inp)), **kwargs)
    return TrackOutputs(
        *(x[0] for x in out[:3]),
        extractor.FrameFeatures(*(x[0] for x in out.features)),
        out.xy_ud[0],
    )


def pair_overlap(desc_l: torch.Tensor, valid_l: torch.Tensor,
                 desc_all: torch.Tensor, valid_all: torch.Tensor) -> torch.Tensor:
    """[L,D,8] x [N,D,8] -> [L,N] counts of descriptors with a Hamming
    match < TH_LOW on the other agent's frame."""
    x = hamming.popcount_desc(desc_l[:, None, :, None, :] ^ desc_all[None, :, None, :, :])
    x = torch.where(valid_all[None, :, None, :], x, 256)          # [L,N,D,D]
    best = x.amin(dim=3)                                           # [L,N,D]
    hit = (best < matching.TH_LOW) & valid_l[:, None, :]
    return hit.sum(-1, dtype=torch.int32)


def make_multi_agent_step(
    n_features: int = 1000,
    n_levels: int = 8,
    scale: float = 1.2,
    hw: tuple[int, int] = (480, 752),
    window_th: float = 15.0,
    mesh=None,
    n_overlap_desc: int = 128,
):
    """Multi-agent tracking step: returns a function of [A, ...] inputs
    giving (TrackOutputs, overlap [A,A] int32, total inliers).  The overlap
    hint counts each agent's strongest `n_overlap_desc` descriptors that
    find a Hamming match < TH_LOW on each other agent's frame.  Only the
    single-device form exists so far; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded multi-agent step is not ported yet")
    D = n_overlap_desc

    def step(inputs: TrackInputs):
        out = batched_tracking_step(
            inputs, n_features=n_features, n_levels=n_levels, scale=scale,
            hw=hw, window_th=window_th,
        )
        desc = out.features.desc[:, :D]
        valid = out.features.valid[:, :D]
        overlap = pair_overlap(desc, valid, desc, valid)
        return out, overlap, out.n_inliers.sum()

    return step


def realistic_track_inputs(
    hw: tuple[int, int] = (480, 752), n_map_points: int = 2048, seed: int = 0,
    n_features: int = 1000, n_levels: int = 8, scale: float = 1.2,
    dist: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0),
    device: torch.device | str | None = None,
) -> TrackInputs:
    """Steady-state inputs from a rendered synthetic world (one agent): the
    local map holds true landmark positions with descriptors extracted
    (by this package's extractor, on `device`) from the previous frame, and
    the pose guess is the constant-velocity extrapolation of the true
    poses — so matching finds real correspondences.  `device` defaults to
    the card (`utils.device.default_device`)."""
    from .utils import datasets

    device = default_device() if device is None else device

    f0, f1, f2 = 19, 20, 21
    w = datasets.make_world(
        n_points=min(n_map_points, 1500), n_frames=40, hw=hw, seed=seed,
        dist=np.asarray(dist, np.float32),
    )
    prev = datasets.render_frame(w, f1)
    feats = extractor.extract_orb(
        torch.from_numpy(prev).to(device), n_features=n_features,
        n_levels=n_levels, scale=scale,
    )
    xy, desc, valid, octv = (x.cpu().numpy() for x in
                             (feats.xy, feats.desc, feats.valid, feats.octave))
    # associate detected keypoints to the world landmarks they image
    Tcw0 = np.linalg.inv(w.poses_wc[f0]).astype(np.float32)
    Tcw_prev = np.linalg.inv(w.poses_wc[f1]).astype(np.float32)
    pc = (Tcw_prev[:3, :3] @ w.points.T).T + Tcw_prev[:3, 3]
    # associate in the DISTORTED frame: detections live there
    uvw = datasets.distort_points_np(pc, w.K, w.dist)
    infront = pc[:, 2] > 0.1
    pos_l, desc_l, maxd_l = [], [], []
    for i in np.where(valid)[0]:
        d2 = np.sum((uvw - xy[i]) ** 2, 1)
        d2[~infront] = np.inf
        j = int(np.argmin(d2))
        if d2[j] < 4.0:
            pos_l.append(w.points[j])
            desc_l.append(desc[i])
            # max_dist = viewing distance * scale^octave
            maxd_l.append(np.linalg.norm(pc[j]) * scale ** octv[i])
    n = len(pos_l)
    rng = np.random.RandomState(seed)
    pos = np.zeros((n_map_points, 3), np.float32)
    dsc = np.zeros((n_map_points, 8), np.uint32)
    maxd = np.full(n_map_points, 12.0, np.float32)
    ok = np.zeros(n_map_points, bool)
    m = min(n, n_map_points)
    pos[:m] = np.asarray(pos_l, np.float32)[:m]
    dsc[:m] = np.asarray(desc_l, np.int32).view(np.uint32)[:m]
    maxd[:m] = np.asarray(maxd_l, np.float32)[:m]
    ok[:m] = True
    # pad with far-away distractors (realistic maps carry stale points)
    pos[m:] = rng.uniform(-8, 8, (n_map_points - m, 3))
    dsc[m:] = rng.randint(0, 2**32, (n_map_points - m, 8), dtype=np.uint32)
    guess = (Tcw_prev @ np.linalg.inv(Tcw0) @ Tcw_prev).astype(np.float32)
    host = dict(
        image=datasets.render_frame(w, f2),
        Tcw_guess=guess,
        K=w.K.astype(np.float32),
        dist=w.dist.astype(np.float32),
        mp_pos=pos,
        mp_desc=dsc.view(np.int32),
        mp_max_dist=maxd,
        mp_valid=ok,
    )
    return TrackInputs(**{k: torch.from_numpy(v).to(device) for k, v in host.items()})


def stack_inputs(inputs: list[TrackInputs]) -> TrackInputs:
    """Stack per-agent inputs into one [A, ...] batch."""
    return TrackInputs(*(torch.stack(xs) for xs in zip(*inputs)))


def example_track_inputs(
    hw: tuple[int, int] = (480, 752), n_map_points: int = 2048, seed: int = 0,
    device: torch.device | str | None = None,
) -> TrackInputs:
    """Deterministic random-noise example inputs (one agent) on `device`,
    by default the card (`utils.device.default_device`)."""
    device = default_device() if device is None else device
    rng = np.random.RandomState(seed)
    h, w = hw
    img = rng.randint(0, 255, (h, w)).astype(np.uint8)
    K = np.array([[458.0, 0, w / 2], [0, 457.0, h / 2], [0, 0, 1]], np.float32)
    pts = np.stack(
        [rng.uniform(-4, 4, n_map_points), rng.uniform(-3, 3, n_map_points),
         rng.uniform(3, 10, n_map_points)], 1,
    ).astype(np.float32)
    desc = rng.randint(0, 2**32, (n_map_points, 8), dtype=np.uint32).view(np.int32)
    host = dict(
        image=img, Tcw_guess=np.eye(4, dtype=np.float32), K=K,
        dist=np.zeros(5, np.float32), mp_pos=pts, mp_desc=desc,
        mp_max_dist=np.full((n_map_points,), 12.0, np.float32),
        mp_valid=np.ones((n_map_points,), bool),
    )
    return TrackInputs(**{k: torch.from_numpy(v).to(device) for k, v in host.items()})
