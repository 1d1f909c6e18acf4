"""FAST corner detection as a whole-image tensor program.

Port of swarmmap_tpu/ops/fast.py (reference spec: tileCalcKeypoints_kernel,
Fast_gpu.cu:284-341).  The exact max-threshold corner score

    score(p) = max over the 16 arc starts of
               min over the 9 contiguous circle pixels of |I(c) - I(p)|
               (per brightness polarity)

so ``corner at threshold t  <=>  score > t``; NMS is a 3x3 max-pool, the
two-threshold tile retry and the per-cell winner bonus are reshapes, and
the budget is a top-k.  Images are [..., H, W]; leading dims are batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 pixels, clockwise from 12 o'clock.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LEN = 9  # contiguous segment length for the FAST-9 test


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] f32 -> [..., H, W] f32 max-threshold corner score.

    Computed in fp32: pyramid levels are integral intensities, so every
    difference is an integer |d| <= 255 and the result is bit-identical to
    the JAX package's bf16 chain.  The min over each 9-long arc is taken by
    doubling windows (1, 2, 4, 8, then 8+1) over the circle stacked twice,
    for both polarities at once: ~10 tensor ops instead of 256."""
    h, w = img.shape[-2:]
    pad = F.pad(img.reshape((-1, 1, h, w)), (3, 3, 3, 3), mode="replicate")[:, 0]
    base = img.reshape((-1, h, w))
    d = torch.stack([pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - base
                     for (dx, dy) in CIRCLE])                   # [16,B,H,W]
    d = torch.stack([d, -d])                                    # bright, dark
    m1 = torch.cat([d, d[:, :ARC_LEN - 1]], 1)                  # [2,24,B,H,W]
    m2 = torch.minimum(m1[:, :-1], m1[:, 1:])                   # windows of 2
    m4 = torch.minimum(m2[:, :-2], m2[:, 2:])                   # of 4
    m8 = torch.minimum(m4[:, :-4], m4[:, 4:])                   # of 8
    m9 = torch.minimum(m8[:, :16], m1[:, 8:24])                 # of 9, 16 starts
    score = m9.amax(dim=(0, 1))
    return score.reshape(img.shape)


def _maxpool3(score: torch.Tensor) -> torch.Tensor:
    """3x3 max with -inf outside the image (stride 1)."""
    return F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]


def _tile_any(mask: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile OR over [B, H, W], broadcast back to full resolution."""
    b, h, w = mask.shape
    t = mask.reshape(b, h // tile, tile, w // tile, tile).any(dim=4).any(dim=2)
    return t.repeat_interleave(tile, 1).repeat_interleave(tile, 2)


def _cell_max(score: torch.Tensor, cell: int) -> torch.Tensor:
    b, h, w = score.shape
    m = score.reshape(b, h // cell, cell, w // cell, cell).amax(dim=(2, 4))
    return m.repeat_interleave(cell, 1).repeat_interleave(cell, 2)


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim with ties going to the lower index — the
    order of the JAX package's top-k on the CPU (torch.topk breaks ties
    differently, and FAST scores are integers, so ties are everywhere)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Keypoints(NamedTuple):
    xy: torch.Tensor        # [..., N, 2] f32 (x=col, y=row), level coords
    score: torch.Tensor     # [..., N] f32
    valid: torch.Tensor     # [..., N] bool


def detect_fast(
    img: torch.Tensor,
    n_keypoints: int,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border: int = 16,
    tile: int = 32,
    cell: int = 32,
) -> Keypoints:
    """Full FAST pipeline on one pyramid level [..., H, W].

    Pixels pass at th_high, or at th_low if their tile produced no
    high-threshold corner; NMS survivors are ranked by score with a bonus
    for each cell's best corner, then the top `n_keypoints` are kept."""
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    ph = (tile - h % tile) % tile
    pw = (tile - w % tile) % tile
    score = fast_score_map(img).reshape((-1, h, w))
    ninf = float("-inf")
    if ph or pw:
        score = F.pad(score, (0, pw, 0, ph), value=ninf)
    b, hh, ww = score.shape

    ys = torch.arange(hh, device=img.device)[:, None]
    xs = torch.arange(ww, device=img.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(in_border, score, ninf)

    nms_ok = score >= _maxpool3(score)
    hi = nms_ok & (score > th_high)
    tile_has_hi = _tile_any(hi, tile)
    keep = hi | (nms_ok & (score > th_low) & ~tile_has_hi)
    masked = torch.where(keep, score, ninf)

    # spatial-spread bonus: each cell's best corner outranks all non-winners
    bonus = torch.where((masked == _cell_max(masked, cell)) & keep, 1e6, 0.0)
    priority = (masked + bonus).reshape(b, -1)

    vals, idx = top_k_stable(priority, n_keypoints)
    xy = torch.stack([idx % ww, idx // ww], -1).to(torch.float32)  # (x, y)
    valid = vals > ninf
    kp_score = torch.gather(masked.reshape(b, -1), 1, idx)
    kp_score = torch.where(valid, kp_score, 0.0)
    return Keypoints(
        xy=xy.reshape(batch + (n_keypoints, 2)),
        score=kp_score.reshape(batch + (n_keypoints,)),
        valid=valid.reshape(batch + (n_keypoints,)),
    )
