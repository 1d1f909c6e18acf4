"""Rectified stereo matching -> per-keypoint depth (device).

Port of swarmmap_tpu/ops/stereo.py.  Reference spec:
Frame::ComputeStereoMatches (code/src/Frame.cc, upstream ORB-SLAM2 stereo
path): row-banded descriptor matching between rectified left/right
features, disparity -> depth via the horizontal baseline.

One masked dense match with a row / disparity / octave band gate, through
`matching.masked_match` on the features' device; float32 throughout, as
the JAX program.
"""
from __future__ import annotations

import torch

from . import matching

TH_STEREO = (matching.TH_HIGH + matching.TH_LOW) // 2  # 75, as the reference


def stereo_depths(
    xyL: torch.Tensor, descL: torch.Tensor, octaveL: torch.Tensor, validL: torch.Tensor,
    xyR: torch.Tensor, descR: torch.Tensor, octaveR: torch.Tensor, validR: torch.Tensor,
    fx: float, baseline: float,
    scale: float = 1.2,
    min_disp: float = 0.5,
    max_disp: float = 200.0,
    row_band: float = 2.0,
) -> torch.Tensor:
    """Returns per-left-keypoint depth [N] (<=0 where unmatched)."""
    # scale ** octave in float32, as jnp's weak-typed scalar power
    sigma = torch.pow(torch.tensor(scale, dtype=torch.float32, device=xyL.device),
                      octaveL.to(torch.float32))
    dv = torch.abs(xyL[:, 1:2] - xyR[None, :, 1])
    disp = xyL[:, 0:1] - xyR[None, :, 0]
    mask = (
        (dv <= row_band * sigma[:, None])
        & (disp >= min_disp) & (disp <= max_disp)
        & (torch.abs(octaveL[:, None] - octaveR[None, :]) <= 1)
        & validL[:, None] & validR[None, :]
    )
    m = matching.masked_match(descL, descR, mask, max_dist=TH_STEREO, ratio=0.0)
    best_disp = xyL[:, 0] - xyR[m.idx.long(), 0]
    # a float32 numerator and a true division: `scalar / tensor` in torch
    # multiplies by the reciprocal, which rounds differently
    bf = torch.tensor(fx * baseline, dtype=torch.float32, device=xyL.device)
    depth = bf / torch.clamp(best_disp, min=1e-6)
    return torch.where(m.valid & (best_disp >= min_disp), depth, torch.full_like(depth, -1.0))
