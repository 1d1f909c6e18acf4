"""Plain ORB front end: pyramid, FAST-9 with the two-threshold tile retry,
intensity-centroid angles and steered rBRIEF-256, for a batch of images.

The semantics are the port's (`swarmmap_tpu_torch/ops/{pyramid,fast,
orientation,brief,extractor}.py` as the benchmark was defined), written as
plainly as they go: the corner score is the max over the 16 arc starts of
the min over 9 circle pixels, the angle sums a 31x31 disk per keypoint and
each descriptor bit compares two samples of its own rotated pattern.  Where
the port's result depends on an arithmetic order (the bilinear pyramid,
rounded to integers at every level), this file uses the same one, so both
give the same bits in float32.

Images are [B, H, W]; every function keeps the batch axis.  Descriptors are
[B, N, 8] int32 words holding the bits of the port's packed layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock (x, y)
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
ARC = 9
BORDER = 16
TILE = 32
HALF_PATCH = 15
N_BITS = 256
N_BINS = 32
PATTERN_SEED = 0x5EED
PATTERN_CLIP = 13
BLUR_TAPS = 7
BLUR_SIGMA = 2.0


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [(int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)]


def level_budgets(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Keypoints per level, geometric in 1/scale, the rest on the last."""
    inv = 1.0 / scale
    factor = n_features * (1 - inv) / (1 - inv**n_levels)
    budgets = [int(round(factor * inv**l)) for l in range(n_levels - 1)]
    return budgets + [max(n_features - sum(budgets), 0)]


def slots(n_features: int) -> int:
    """Keypoint slots of a frame: n_features rounded up to 128."""
    return (n_features + 127) // 128 * 128


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] half-pixel-centre 2-tap weights, edges clamped."""
    s = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        x = (i + 0.5) * s - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        W[i, min(max(x0, 0), n_in - 1)] += 1.0 - f
        W[i, min(max(x0 + 1, 0), n_in - 1)] += f
    return W


def pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """[B, H, W] -> float32 levels, each the bilinear resize of the one
    before (rows, then columns, one image at a time) rounded to integers."""
    levels = [img.to(torch.float32)]
    for h2, w2 in level_shapes(*img.shape[-2:], n_levels, scale)[1:]:
        prev = levels[-1]
        Wr = torch.from_numpy(_bilinear_weights(prev.shape[-2], h2)).to(img.device)
        Wc = torch.from_numpy(_bilinear_weights(prev.shape[-1], w2)).to(img.device)
        levels.append(torch.round(torch.stack([Wr @ x @ Wc.T for x in prev])))
    return levels


def blur(img: torch.Tensor) -> torch.Tensor:
    """7-tap sigma-2 Gaussian, rows then columns, reflect padding."""
    x = np.arange(BLUR_TAPS, dtype=np.float64) - BLUR_TAPS // 2
    k = np.exp(-(x**2) / (2 * BLUR_SIGMA**2))
    k = (k / k.sum()).astype(np.float32).tolist()
    r = BLUR_TAPS // 2
    h, w = img.shape[-2:]
    p = F.pad(img[:, None], (0, 0, r, r), mode="reflect")[:, 0]
    out = torch.zeros_like(img)
    for i in range(BLUR_TAPS):
        out = out + k[i] * p[:, i:i + h, :]
    p = F.pad(out[:, None], (r, r, 0, 0), mode="reflect")[:, 0]
    res = torch.zeros_like(img)
    for i in range(BLUR_TAPS):
        res = res + k[i] * p[:, :, i:i + w]
    return res


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> the largest t such that 9 contiguous circle pixels are
    all brighter than centre + t, or all darker than centre - t."""
    h, w = img.shape[-2:]
    p = F.pad(img[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    d = [p[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dx, dy in CIRCLE]
    best = torch.full_like(img, float("-inf"))
    for sign in (1.0, -1.0):
        for start in range(16):
            arc = sign * d[start]
            for k in range(1, ARC):
                arc = torch.minimum(arc, sign * d[(start + k) % 16])
            best = torch.maximum(best, arc)
    return best


def detect(img: torch.Tensor, budget: int, th_high: float, th_low: float):
    """FAST corners of one level: (xy [B, n, 2] level coordinates, score,
    valid).  A pixel is a corner above th_high, or above th_low where its
    32x32 tile has no corner above th_high; only 3x3 maxima inside the
    16-pixel border count; each 32x32 cell's best corner ranks before all
    others; the top `budget` are kept, ties to the lower raster index."""
    b, h, w = img.shape
    ph, pw = (-h) % TILE, (-w) % TILE
    ninf = float("-inf")
    score = F.pad(fast_score(img), (0, pw, 0, ph), value=ninf)
    hh, ww = score.shape[-2:]
    ys = torch.arange(hh, device=img.device)[:, None]
    xs = torch.arange(ww, device=img.device)[None, :]
    inside = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    score = torch.where(inside, score, ninf)
    peak = score >= F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]

    def per_tile(x, reduce):
        t = reduce(x.reshape(b, hh // TILE, TILE, ww // TILE, TILE))
        return t.repeat_interleave(TILE, 1).repeat_interleave(TILE, 2)

    hi = peak & (score > th_high)
    tile_hi = per_tile(hi, lambda t: t.any(4).any(2))
    keep = hi | (peak & (score > th_low) & ~tile_hi)
    kept = torch.where(keep, score, ninf)
    cell_best = per_tile(kept, lambda t: t.amax(dim=(2, 4)))
    rank = kept + torch.where(keep & (kept == cell_best), 1e6, 0.0)
    vals, idx = torch.sort(rank.reshape(b, -1), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :budget], idx[:, :budget]
    valid = vals > ninf
    xy = torch.stack([idx % ww, idx // ww], -1).to(torch.float32)
    sc = torch.where(valid, torch.gather(kept.reshape(b, -1), 1, idx), 0.0)
    return xy, sc, valid


def _umax() -> np.ndarray:
    r = HALF_PATCH
    return np.round(np.sqrt(np.maximum(r * r - np.arange(r + 1) ** 2, 0))).astype(int)


def angles(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle in degrees [0, 360) of each keypoint: the
    moments of its radius-15 disk (row half-widths round(sqrt(225 - v^2))).
    Sums of integers below 2^24, so exact in float32."""
    r = HALF_PATCH
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    mask = np.abs(dx) <= _umax()[np.abs(dy)]
    dev = img.device
    dxt = torch.from_numpy((dx * mask).astype(np.float32)).to(dev).flatten()
    dyt = torch.from_numpy((dy * mask).astype(np.float32)).to(dev).flatten()
    b, h, w = img.shape
    p = F.pad(img, (r, r, r, r))
    cx = torch.round(xy[..., 0]).long()
    cy = torch.round(xy[..., 1]).long()
    offs = torch.arange(2 * r + 1, device=dev)
    rows = cy[..., None, None] + offs[:, None]
    cols = cx[..., None, None] + offs[None, :]
    flat = (rows * (w + 2 * r) + cols).flatten(-2)
    patch = torch.gather(p.flatten(-2), -1, flat.flatten(-2)).reshape(flat.shape)
    m10 = (patch * dxt).sum(-1)
    m01 = (patch * dyt).sum(-1)
    ang = torch.atan2(m01, m10) * (180.0 / math.pi)
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, 0.0)


def pattern() -> np.ndarray:
    """[512, 2] BRIEF sample offsets (x, y): pairs (2i, 2i+1)."""
    rng = np.random.RandomState(PATTERN_SEED)
    pts = np.clip(np.round(rng.normal(0.0, 31 / 5.0, size=(2 * N_BITS, 2))),
                  -PATTERN_CLIP, PATTERN_CLIP).astype(np.int64)
    for i in range(N_BITS):
        if np.all(pts[2 * i] == pts[2 * i + 1]):
            pts[2 * i + 1, 0] = min(pts[2 * i + 1, 0] + 1, PATTERN_CLIP)
    return pts


def rotated_patterns() -> np.ndarray:
    """[N_BINS, 512, 2] offsets of the pattern rotated by each bin's angle,
    rounded to pixels."""
    pat = pattern().astype(np.float64)
    out = np.zeros((N_BINS, 2 * N_BITS, 2), np.int64)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        out[b, :, 0] = np.round(pat[:, 0] * np.cos(th) - pat[:, 1] * np.sin(th))
        out[b, :, 1] = np.round(pat[:, 0] * np.sin(th) + pat[:, 1] * np.cos(th))
    return out


def descriptors(blurred: torch.Tensor, xy: torch.Tensor, ang: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: bit i is set where sample 2i+1 of the pattern,
    rotated by the keypoint's angle bin (round half to even of angle/11.25),
    is brighter than sample 2i on the blurred level rounded to integers.
    Samples outside the level take the nearest edge pixel."""
    b, h, w = blurred.shape
    img = torch.round(torch.clamp(blurred, 0.0, 255.0))
    rot = torch.from_numpy(rotated_patterns()).to(blurred.device)
    bins = torch.remainder(torch.round(ang * (N_BINS / 360.0)).long(), N_BINS)
    off = rot[bins]                                              # [B, N, 512, 2]
    cx = torch.clamp(torch.round(xy[..., 0]).long(), 0, w - 1)[..., None]
    cy = torch.clamp(torch.round(xy[..., 1]).long(), 0, h - 1)[..., None]
    sx = torch.clamp(cx + off[..., 0], 0, w - 1)
    sy = torch.clamp(cy + off[..., 1], 0, h - 1)
    vals = torch.gather(img.flatten(-2), -1, (sy * w + sx).flatten(-2)).reshape(sx.shape)
    bits = (vals[..., 1::2] > vals[..., 0::2]).long()             # [B, N, 256]
    words = (bits.reshape(b, -1, 8, 32) << torch.arange(32, device=img.device)).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.where(valid[..., None], words, 0)


def extract(img: torch.Tensor, n_features: int, n_levels: int, scale: float,
            th_high: float, th_low: float) -> dict:
    """[B, H, W] uint8 -> {xy [B, N, 2] level-0 coordinates, octave, angle,
    desc, valid} with N = slots(n_features), levels in order, each level's
    keypoints padded to its budget."""
    b = img.shape[0]
    out = {k: [] for k in ("xy", "octave", "angle", "desc", "valid")}
    for l, (lvl, budget) in enumerate(zip(pyramid(img, n_levels, scale),
                                          level_budgets(n_features, n_levels, scale))):
        if budget == 0 or min(lvl.shape[-2:]) <= 2 * BORDER + 8:
            continue
        xy, _, valid = detect(lvl, budget, th_high, th_low)
        ang = angles(lvl, xy, valid)
        out["xy"].append(xy * np.float32(scale**l).item())
        out["octave"].append(torch.full((b, budget), l, dtype=torch.int32, device=img.device))
        out["angle"].append(ang)
        out["desc"].append(descriptors(blur(lvl), xy, ang, valid))
        out["valid"].append(valid)
    res = {k: torch.cat(v, 1) for k, v in out.items()}
    pad = slots(n_features) - res["xy"].shape[1]
    for k, v in res.items():
        res[k] = F.pad(v, (0, 0, 0, pad) if v.dim() == 3 else (0, pad))
    return res
