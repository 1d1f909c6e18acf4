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


@functools.lru_cache(maxsize=None)
def _segment_ends(w: int, us: tuple[int, ...], device: torch.device):
    """[n_u, w] indices into the padded running sums of the right end of
    each half-width-u row segment and of the column before its left end."""
    x = np.arange(w)[None, :] + HALF_PATCH + 1
    u = np.asarray(us)[:, None]
    return (torch.from_numpy(x + u).to(device), torch.from_numpy(x - u - 1).to(device))


def moment_maps(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-image intensity moments m10/m01 over the circular patch.

    The disk decomposes into 31 row segments of half-width umax(|dy|); each
    row's box and ramp sums are two differences of running sums along x:

      BOX_u  = CS[x+u] - CS[x-u-1]                       (CS = cumsum(img))
      RAMP_u = (CSX[x+u] - CSX[x-u-1]) - x * BOX_u       (CSX = cumsum(x*img))

    Levels are integral, so the running sums are exact in fp32 while they
    stay below 2^24 (true at widths of a few hundred pixels); at 752 the
    x*img sums reach ~7.5e7.  The port keeps them in float64, where they
    are exact at any width, so the moments do not depend on the scan's
    order (the batch size, the device); each row's box and ramp sum is an
    integer below 2^24 and goes back to float32 exactly.  (The JAX
    package scans in float32: at 752 its moments round.)"""
    h, w = img.shape[-2:]
    r = HALF_PATCH
    umax = _umax()
    us = sorted(set(umax.tolist()))
    imgp = F.pad(img, (r + 1, r, r, r)).to(torch.float64)
    colx = torch.arange(-(r + 1), w + r, dtype=torch.float64, device=img.device)
    cs = torch.cumsum(imgp, dim=-1)
    csx = torch.cumsum(imgp * colx, dim=-1)
    # every half-width u at once: [n_u, w] columns of each row segment's ends
    hi, lo = _segment_ends(w, tuple(us), img.device)
    box = cs[..., hi] - cs[..., lo]                          # [..., H+2r, n_u, w]
    xs = torch.arange(w, dtype=torch.float64, device=img.device)
    ramp = ((csx[..., hi] - csx[..., lo]) - xs * box).to(img.dtype)
    box = box.to(img.dtype)
    boxes = {u: box[..., i, :] for i, u in enumerate(us)}
    ramps = {u: ramp[..., i, :] for i, u in enumerate(us)}
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
