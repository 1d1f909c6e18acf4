"""Steered (rotation-aware) BRIEF-256 descriptors.

Port of swarmmap_tpu/ops/brief.py (reference spec: calcOrb_kernel,
Orb_gpu.cu:67 — 256 point-pair intensity comparisons on the blurred level,
pattern rotated by the keypoint's IC angle, packed to 32 bytes).

Descriptors are carried as [..., N, 8] int32 words holding the same bits as
the JAX package's uint32 words (numpy `.view(np.int32)`): PyTorch's uint32
has no shifts on the CPU.  Every `>>` is masked, since int32 shifts are
arithmetic.

The binned path keeps the JAX package's semantics — steering quantised to
N_BINS angle bins, one {-1,0,+1} comparison column per bit — but evaluates
it as a gather: each column of `_binned_weights` holds +1 at one patch
offset and -1 at another (0 where they collide), so the dot product with a
patch is `patch[b] - patch[a]`.  Per keypoint only its own bin's 512
offsets are read, instead of an [N,1369]x[1369,8192] product; with integral
patches both forms are exact, so the bits are identical.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

N_BITS = 256
PATTERN_CLIP = 13  # keeps rotated samples within a 19px border
PATTERN_SEED = 0x5EED

N_BINS = 32            # 11.25° steering quantisation (original ORB: 12°)
PATCH_R = 18           # max |round(rotated offset)| over all bins (asserted)
PATCH = 2 * PATCH_R + 1
PATCH_K = PATCH * PATCH

# "synthetic": deterministic Gaussian pairs (self-consistent default).
# "opencv":   OpenCV's learned bit_pattern_31_ (BSD public constant), read
#             from the JAX package's data file.
DEFAULT_PATTERN = os.environ.get("SWARMMAP_ORB_PATTERN", "synthetic")
_OPENCV_PATTERN = (Path(__file__).resolve().parents[2] / "swarmmap_tpu" / "data"
                   / "orb_pattern_opencv.npz")


@functools.lru_cache(maxsize=None)
def brief_pattern(name: str | None = None) -> np.ndarray:
    """[512, 2] int8 sampling offsets (pairs are (2i, 2i+1))."""
    name = name or DEFAULT_PATTERN
    if name == "opencv":
        pts = np.load(_OPENCV_PATTERN)["pattern"].astype(np.int8)
        if pts.shape != (2 * N_BITS, 2):
            raise ValueError(f"{_OPENCV_PATTERN}: pattern shape {pts.shape}")
        return pts
    rng = np.random.RandomState(PATTERN_SEED)
    pts = np.clip(
        np.round(rng.normal(0.0, 31 / 5.0, size=(2 * N_BITS, 2))),
        -PATTERN_CLIP,
        PATTERN_CLIP,
    ).astype(np.int8)
    # avoid degenerate identical pairs
    for i in range(N_BITS):
        if np.all(pts[2 * i] == pts[2 * i + 1]):
            pts[2 * i + 1, 0] = min(pts[2 * i + 1, 0] + 1, PATTERN_CLIP)
    return pts


@functools.lru_cache(maxsize=None)
def _bin_offsets(pattern: str | None = None) -> np.ndarray:
    """[N_BINS, 512] flattened patch offsets of the pattern's samples
    rotated by each bin angle."""
    pat = brief_pattern(pattern).astype(np.float64)
    out = np.zeros((N_BINS, 2 * N_BITS), np.int64)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[:, 0] * ca - pat[:, 1] * sa).astype(np.int64)
        ry = np.round(pat[:, 0] * sa + pat[:, 1] * ca).astype(np.int64)
        assert np.abs(rx).max() <= PATCH_R and np.abs(ry).max() <= PATCH_R
        out[b] = (ry + PATCH_R) * PATCH + (rx + PATCH_R)
    return out


@functools.lru_cache(maxsize=None)
def _binned_weights(pattern: str | None = None) -> np.ndarray:
    """[PATCH_K, N_BINS*256] int8 comparison weights: column (b*256 + s)
    holds +1 at the patch offset of sample 2s+1 rotated by bin b and -1 at
    sample 2s; a rounding collision cancels to 0 (bit = False)."""
    idx = _bin_offsets(pattern)
    W = np.zeros((N_BINS, PATCH_K, N_BITS), np.int8)
    for b in range(N_BINS):
        for s in range(N_BITS):
            W[b, idx[b, 2 * s + 1], s] += 1
            W[b, idx[b, 2 * s], s] -= 1
    return np.ascontiguousarray(W.transpose(1, 0, 2).reshape(PATCH_K, N_BINS * N_BITS))


@functools.lru_cache(maxsize=None)
def _bin_offsets_on(pattern: str | None, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bin_offsets(pattern)).to(device)


def angle_bins(angles_deg: torch.Tensor) -> torch.Tensor:
    """Quantise IC angles to the N_BINS steering bins (round half to even)."""
    b = torch.round(angles_deg * (N_BINS / 360.0)).long()
    return torch.remainder(b, N_BINS)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} -> [..., 8] int32 words (bit j of word i = bit 32i+j)."""
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(bits.long().unflatten(-1, (8, 32)) << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] {0,1} int8."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.flatten(-2).to(torch.int8)


def extract_patches(img_blur: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[..., H, W] integral-intensity image + [..., N, 2] keypoints ->
    [..., N, PATCH, PATCH] patches, by gather.  The image is edge-padded,
    so a patch is always in bounds; edge replication matches the direct
    path's coordinate clamping."""
    h, w = img_blur.shape[-2:]
    batch = img_blur.shape[:-2]
    imgp = F.pad(img_blur.reshape((-1, 1, h, w)), (PATCH_R,) * 4, mode="replicate")
    imgp = imgp.reshape(batch + (h + 2 * PATCH_R, w + 2 * PATCH_R))
    wp = w + 2 * PATCH_R
    cx = torch.clamp(torch.round(xy[..., 0]).long(), 0, w - 1)
    cy = torch.clamp(torch.round(xy[..., 1]).long(), 0, h - 1)
    offs = torch.arange(PATCH, device=xy.device)
    rows = cy[..., None, None] + offs[:, None]                  # [..., N, P, 1]
    cols = cx[..., None, None] + offs[None, :]                  # [..., N, 1, P]
    flat = (rows * wp + cols).flatten(-3)                       # [..., N*P*P]
    vals = torch.gather(imgp.flatten(-2), -1, flat)
    return vals.reshape(xy.shape[:-1] + (PATCH, PATCH))


def descriptors_from_patches(
    patches: torch.Tensor,
    angles_deg: torch.Tensor,
    valid: torch.Tensor,
    pattern: str | None = None,
) -> torch.Tensor:
    """[..., N, PATCH, PATCH] integral-intensity patches -> [..., N, 8]
    int32 descriptor words (binned steering)."""
    offs = _bin_offsets_on(pattern, patches.device)[angle_bins(angles_deg)]  # [...,N,512]
    vals = torch.gather(patches.flatten(-2), -1, offs)
    bits = vals[..., 1::2] - vals[..., 0::2] > 0
    return torch.where(valid[..., None], _pack_bits(bits), 0)


def compute_descriptors(
    img_blur: torch.Tensor,
    xy: torch.Tensor,
    angles_deg: torch.Tensor,
    valid: torch.Tensor,
    pattern: str | None = None,
) -> torch.Tensor:
    """Exact steering: [..., H, W] blurred level + keypoints -> [..., N, 8]
    int32 words, the pattern rotated per keypoint."""
    h, w = img_blur.shape[-2:]
    pat = torch.from_numpy(brief_pattern(pattern)).to(img_blur.device, torch.float32)
    a = torch.deg2rad(angles_deg)
    ca, sa = torch.cos(a)[..., None], torch.sin(a)[..., None]
    px, py = pat[:, 0], pat[:, 1]
    rx = torch.round(px * ca - py * sa)
    ry = torch.round(px * sa + py * ca)
    gx = torch.clamp(torch.round(xy[..., 0:1]) + rx, 0, w - 1).long()
    gy = torch.clamp(torch.round(xy[..., 1:2]) + ry, 0, h - 1).long()
    vals = torch.gather(img_blur.flatten(-2), -1, (gy * w + gx).flatten(-2))
    vals = vals.reshape(gx.shape)
    bits = vals[..., 0::2] < vals[..., 1::2]
    return torch.where(valid[..., None], _pack_bits(bits), 0)
