"""Intensity-centroid keypoint orientation.

Port of swarmmap_tpu/ops/orientation.py (reference spec: IC_Angle_kernel,
Fast_gpu.cu:403 — moments m01/m10 over a circular patch of radius 15,
angle = atan2(m01, m10)).  Images are [..., H, W] and keypoints
[..., N, 2]; leading dims are batch.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15


def _umax() -> np.ndarray:
    r = HALF_PATCH
    return np.round(np.sqrt(np.maximum(r * r - np.arange(r + 1) ** 2, 0))).astype(int)


@functools.lru_cache(maxsize=None)
def _patch_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dx, dy, circular mask for the 31x31 orientation patch (the
    reference's u_max rule: umax[v] = round(sqrt(15^2 - v^2)))."""
    r = HALF_PATCH
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = np.abs(dx) <= _umax()[np.abs(dy)]
    return dx.astype(np.float32), dy.astype(np.float32), mask.astype(np.float32)


def moment_maps(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-image intensity moments m10/m01 over the circular patch.

    The disk decomposes into 31 row segments of half-width umax(|dy|); each
    row's box and ramp sums are two differences of running sums along x:

      BOX_u  = CS[x+u] - CS[x-u-1]                       (CS = cumsum(img))
      RAMP_u = (CSX[x+u] - CSX[x-u-1]) - x * BOX_u       (CSX = cumsum(x*img))

    Levels are integral, so the running sums are exact in fp32 while they
    stay below 2^24 (true at widths of a few hundred pixels); at 752 the
    x*img sums reach ~7.5e7 and round in the scan's order."""
    h, w = img.shape[-2:]
    r = HALF_PATCH
    umax = _umax()
    imgp = F.pad(img, (r + 1, r, r, r))
    colx = torch.arange(-(r + 1), w + r, dtype=img.dtype, device=img.device)
    cs = torch.cumsum(imgp, dim=-1)
    csx = torch.cumsum(imgp * colx, dim=-1)
    x0 = r + 1  # column offset of image x=0 inside the padded arrays
    xs = torch.arange(w, dtype=img.dtype, device=img.device)
    boxes: dict[int, torch.Tensor] = {}
    ramps: dict[int, torch.Tensor] = {}
    for u in sorted(set(umax.tolist())):
        hi = x0 + u
        lo = x0 - u - 1
        box = cs[..., hi:hi + w] - cs[..., lo:lo + w]
        ramps[u] = (csx[..., hi:hi + w] - csx[..., lo:lo + w]) - xs * box
        boxes[u] = box
    m10 = ramps[int(umax[0])][..., r:r + h, :]
    m01 = torch.zeros_like(img)
    for k in range(1, r + 1):
        u = int(umax[k])
        up = slice(r + k, r + k + h)
        dn = slice(r - k, r - k + h)
        m10 = m10 + ramps[u][..., up, :] + ramps[u][..., dn, :]
        m01 = m01 + k * (boxes[u][..., up, :] - boxes[u][..., dn, :])
    return m10, m01


def _degrees(m01: torch.Tensor, m10: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    ang = torch.atan2(m01, m10) * (180.0 / math.pi)
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, 0.0)


def ic_angles_conv(
    m10_map: torch.Tensor, m01_map: torch.Tensor,
    xy: torch.Tensor, valid: torch.Tensor,
) -> torch.Tensor:
    """Angles in degrees [0,360) from precomputed moment maps (two
    gathers per keypoint)."""
    h, w = m10_map.shape[-2:]
    x = torch.clamp(torch.round(xy[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).long(), 0, h - 1)
    flat = y * w + x
    m10 = torch.gather(m10_map.flatten(-2), -1, flat)
    m01 = torch.gather(m01_map.flatten(-2), -1, flat)
    return _degrees(m01, m10, valid)


def ic_angles(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Angles in degrees [0,360) by a direct [N,31,31] patch gather."""
    h, w = img.shape[-2:]
    dx, dy, mask = (torch.from_numpy(t).to(img.device) for t in _patch_tables())
    x = torch.clamp(torch.round(xy[..., 0]).long(), HALF_PATCH, w - HALF_PATCH - 1)
    y = torch.clamp(torch.round(xy[..., 1]).long(), HALF_PATCH, h - HALF_PATCH - 1)
    gy = y[..., None, None] + dy.long()
    gx = x[..., None, None] + dx.long()
    flat = (gy * w + gx).flatten(-2)                        # [..., N, 961]
    src = img.flatten(-2)[..., None, :].expand(flat.shape[:-1] + (h * w,))
    patch = torch.gather(src, -1, flat).reshape(flat.shape[:-1] + (31, 31))
    m10 = torch.sum(patch * dx * mask, dim=(-2, -1))
    m01 = torch.sum(patch * dy * mask, dim=(-2, -1))
    return _degrees(m01, m10, valid)
