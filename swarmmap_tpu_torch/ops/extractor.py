"""The ORB front end: pyramid -> per-level FAST -> IC angles -> blur ->
rBRIEF, for a batch of images at once.

Port of swarmmap_tpu/ops/extractor.py (reference spec:
ORBextractor::operator(), ORBextractor.cc:746-819).  Output is a
fixed-capacity keypoint set (padded, masked) in the JAX package's level
order and padding layout: N = n_features rounded up to 128.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import brief, fast, orientation, pyramid


class FrameFeatures(NamedTuple):
    xy: torch.Tensor       # [..., N, 2] f32 level-0 (distorted) pixel coords
    response: torch.Tensor # [..., N] f32 FAST score
    octave: torch.Tensor   # [..., N] i32 pyramid level
    angle: torch.Tensor    # [..., N] f32 degrees
    desc: torch.Tensor     # [..., N, 8] int32 words of packed rBRIEF
    valid: torch.Tensor    # [..., N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[-2]


def level_budgets(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level keypoint budget, geometric in 1/scale with the remainder
    on the coarsest level (reference: ORBextractor.cc ctor)."""
    inv = 1.0 / scale
    factor = n_features * (1 - inv) / (1 - inv**n_levels)
    budgets = [int(round(factor * inv**l)) for l in range(n_levels - 1)]
    budgets.append(max(n_features - sum(budgets), 0))
    return budgets


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def extract_orb(
    img: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
    desc_mode: str = "binned",
    desc_pattern: str | None = None,
) -> FrameFeatures:
    """[..., H, W] u8/f32 -> FrameFeatures with N = n_features rounded up
    to 128.  Leading dims (the agent axis) are batch: every op runs on the
    whole batch, with no loop over images.

    desc_mode "binned" (default) steers by quantised angle bins; "exact"
    rotates the pattern per keypoint."""
    if desc_mode not in ("binned", "exact"):
        raise ValueError(f"unknown desc_mode {desc_mode!r}")
    batch = img.shape[:-2]
    levels = pyramid.build_pyramid(img, n_levels, scale)
    budgets = level_budgets(n_features, n_levels, scale)
    n_total = _round_up(sum(budgets), 128)

    binned = desc_mode == "binned"
    xs, resps, octs, angs, descs, vals, patches = [], [], [], [], [], [], []
    for l, (lvl_img, budget) in enumerate(zip(levels, budgets)):
        if budget == 0 or min(lvl_img.shape[-2:]) <= 2 * 16 + 8:
            continue
        kps = fast.detect_fast(lvl_img, budget, th_high=th_high, th_low=th_low)
        m10, m01 = orientation.moment_maps(lvl_img)
        ang = orientation.ic_angles_conv(m10, m01, kps.xy, kps.valid)
        blurred = pyramid.gaussian_blur(lvl_img)
        if binned:
            # every level's patches go through ONE descriptor pass below
            patches.append(brief.extract_patches(
                torch.round(torch.clamp(blurred, 0.0, 255.0)), kps.xy))
        else:
            descs.append(brief.compute_descriptors(
                blurred, kps.xy, ang, kps.valid, pattern=desc_pattern))
        xs.append(kps.xy * np.float32(scale**l).item())
        resps.append(kps.score)
        octs.append(torch.full(batch + (budget,), l, dtype=torch.int32, device=img.device))
        angs.append(ang)
        vals.append(kps.valid)

    xy = torch.cat(xs, -2)
    response = torch.cat(resps, -1)
    octave = torch.cat(octs, -1)
    angle = torch.cat(angs, -1)
    valid = torch.cat(vals, -1)
    if binned:
        desc = brief.descriptors_from_patches(
            torch.cat(patches, -3), angle, valid, pattern=desc_pattern)
    else:
        desc = torch.cat(descs, -2)
    pad = n_total - xy.shape[-2]
    if pad > 0:
        xy = F.pad(xy, (0, 0, 0, pad))
        response = F.pad(response, (0, pad))
        octave = F.pad(octave, (0, pad))
        angle = F.pad(angle, (0, pad))
        desc = F.pad(desc, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    return FrameFeatures(xy, response, octave, angle, desc, valid)


def extract_orb_batched(images: torch.Tensor, **kwargs) -> FrameFeatures:
    """[A, H, W] -> FrameFeatures with a leading agent axis (extract_orb
    already treats leading dims as batch)."""
    return extract_orb(images, **kwargs)


def undistort_points(
    xy: torch.Tensor, K: torch.Tensor, dist: torch.Tensor, iters: int = 5
) -> torch.Tensor:
    """Iterative radial-tangential undistortion (reference:
    Frame::UndistortKeyPoints via cv::undistortPoints).  xy [..., N, 2],
    K [..., 3, 3], dist [..., 5]."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    k1, k2, p1, p2, k3 = (dist[..., i, None] for i in range(5))
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    x, y = xn, yn
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xn - dx) * icdist
        y = (yn - dy) * icdist
    return torch.stack([x * fx + cx, y * fy + cy], -1)


def scale_sigma2(n_levels: int, scale: float) -> np.ndarray:
    """Per-octave sigma^2 (reference: ORBextractor mvLevelSigma2)."""
    return (scale ** (2.0 * np.arange(n_levels))).astype(np.float32)
