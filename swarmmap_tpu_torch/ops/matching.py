"""Batched data association.

Port of the main-path part of swarmmap_tpu/ops/matching.py (reference
spec: ORBmatcher — SearchByProjection, rotation-histogram consistency).
Every search is the same dense program: an [Nq, Nt] candidate mask, one
Hamming matrix, a masked top-2 per row, optional rotation filter, and the
mutual-best cross-check.  All functions take leading batch dims.

Tie-breaks decide results, so they follow the JAX package exactly:
`argmin` returns the first minimal index (torch documents the same), the
conflict key is dist * Nq + q, and the rotation histogram's top-3 keeps
the lower bin on ties.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fast import top_k_stable
from .hamming import hamming_matrix

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
_BIG = 1 << 20


class Matches(NamedTuple):
    idx: torch.Tensor    # [..., Nq] int32 target index (undefined where !valid)
    dist: torch.Tensor   # [..., Nq] int32 Hamming distance
    valid: torch.Tensor  # [..., Nq] bool
    target_q: torch.Tensor | None = None  # [..., Nt] best query per target


def rotation_consistency(rot_deg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference: ComputeThreeMaxima, ORBmatcher.cc:1475)."""
    rot = torch.remainder(rot_deg, 360.0)
    bins = torch.clamp((rot * (HISTO_BINS / 360.0)).to(torch.int32), 0, HISTO_BINS - 1)
    onehot = (bins[..., None] == torch.arange(HISTO_BINS, device=bins.device)) & valid[..., None]
    hist = onehot.sum(-2)
    top_vals, top_idx = top_k_stable(hist, 3)
    # reference rule: drop 2nd/3rd bins if an order of magnitude below max
    keep2 = (top_vals[..., 1] > 0.1 * top_vals[..., 0])[..., None]
    keep3 = (top_vals[..., 2] > 0.1 * top_vals[..., 0])[..., None]
    ok = (
        (bins == top_idx[..., 0, None])
        | ((bins == top_idx[..., 1, None]) & keep2)
        | ((bins == top_idx[..., 2, None]) & keep3)
    )
    return valid & ok


def resolve_conflicts(best_idx: torch.Tensor, dist: torch.Tensor,
                      valid: torch.Tensor, n_targets: int) -> torch.Tensor:
    """One query per target: keep the closest, ties to the smaller query
    index (one scatter-min of the fused key dist * Nq + q)."""
    nq = best_idx.shape[-1]
    d = torch.clamp(torch.where(valid, dist, _BIG), max=1 << 12)
    qi = torch.arange(nq, dtype=torch.int32, device=dist.device)
    key = (d * nq + qi).to(torch.int32)
    per_target = torch.full(best_idx.shape[:-1] + (n_targets,), 1 << 30,
                            dtype=torch.int32, device=dist.device)
    per_target = per_target.scatter_reduce(-1, best_idx.long(), key, "amin")
    return valid & (torch.gather(per_target, -1, best_idx.long()) == key)


def masked_match(
    desc_q: torch.Tensor,
    desc_t: torch.Tensor,
    mask: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 0.0,
    angle_q: torch.Tensor | None = None,
    angle_t: torch.Tensor | None = None,
    check_rotation: bool = False,
    resolve: bool = True,
) -> Matches:
    """The shared dense matching core. mask: [..., Nq, Nt] candidate gate."""
    ham = hamming_matrix(desc_q, desc_t)
    d = torch.where(mask, ham, _BIG)
    best, best_idx = torch.min(d, dim=-1)  # first minimal index on ties
    best_idx = best_idx.to(torch.int32)
    cols = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(cols == best_idx[..., None], _BIG, d)
    second = torch.amin(d2, dim=-1)
    valid = best <= max_dist
    if ratio > 0.0:
        valid &= best.to(torch.float32) < ratio * second.to(torch.float32)
    if check_rotation:
        if angle_q is None or angle_t is None:
            raise ValueError("check_rotation needs angle_q and angle_t")
        rot = angle_q - torch.gather(angle_t, -1, best_idx.long())
        valid = rotation_consistency(rot, valid)
    target_q = None
    if resolve:
        # mutual-best cross-check: pair (q,t) survives iff q is also t's
        # best query
        target_q = torch.argmin(d, dim=-2).to(torch.int32)  # [..., Nt]
        qi = torch.arange(desc_q.shape[-2], dtype=torch.int32, device=d.device)
        valid = valid & (torch.gather(target_q, -1, best_idx.long()) == qi)
    return Matches(idx=best_idx, dist=best, valid=valid, target_q=target_q)


def window_mask(
    q_uv: torch.Tensor,
    t_uv: torch.Tensor,
    radius: torch.Tensor | float,
    q_valid: torch.Tensor,
    t_valid: torch.Tensor,
    t_octave: torch.Tensor | None = None,
    oct_lo: torch.Tensor | None = None,
    oct_hi: torch.Tensor | None = None,
) -> torch.Tensor:
    """Square search window (the reference's GetFeaturesInArea grid query)
    + optional per-query octave gate.  q_uv [..., Nq, 2], t_uv [..., Nt, 2]."""
    du = torch.abs(q_uv[..., :, None, 0] - t_uv[..., None, :, 0])
    dv = torch.abs(q_uv[..., :, None, 1] - t_uv[..., None, :, 1])
    r = radius if isinstance(radius, (int, float)) else radius[..., None]
    m = (du <= r) & (dv <= r) & q_valid[..., :, None] & t_valid[..., None, :]
    if t_octave is not None:
        m &= (t_octave[..., None, :] >= oct_lo[..., :, None]) & (
            t_octave[..., None, :] <= oct_hi[..., :, None]
        )
    return m


def predicted_octave(
    dist: torch.Tensor, max_dist: torch.Tensor, scale: float, n_levels: int
) -> torch.Tensor:
    """Scale-invariance level prediction (reference: MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    log_scale = torch.log(torch.tensor(scale, dtype=torch.float32))
    lvl = torch.ceil(torch.log(ratio) / log_scale.item()).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def project_to_frame(
    Tcw: torch.Tensor, K: torch.Tensor, pts_w: torch.Tensor,
    hw: tuple[int, int],
    bounds: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points [..., M, 3] -> pixel coords, depth and visibility.
    `bounds` = (min_x, max_x, min_y, max_y), floats or [...] tensors,
    overrides the raw image rectangle (undistorted coords legally exit
    it; reference: Frame::ComputeImageBounds + Frame::isInFrustum)."""
    pc = pts_w @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack(
        [
            K[..., 0, 0, None] * pc[..., 0] / zc + K[..., 0, 2, None],
            K[..., 1, 1, None] * pc[..., 1] / zc + K[..., 1, 2, None],
        ],
        -1,
    )
    h, w = hw
    if bounds is None:
        bounds = (0.0, float(w), 0.0, float(h))
    x0, x1, y0, y1 = (b if isinstance(b, float) else b[..., None] for b in bounds)
    visible = (
        (z > 0.05)
        & (uv[..., 0] >= x0) & (uv[..., 0] < x1)
        & (uv[..., 1] >= y0) & (uv[..., 1] < y1)
    )
    return uv, z, visible
