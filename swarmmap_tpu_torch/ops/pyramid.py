"""Image pyramid + Gaussian blur.

Port of swarmmap_tpu/ops/pyramid.py (reference spec:
ORBextractor::ComputePyramid — 8 levels, scale 1.2, bilinear resize, 7x7
sigma=2 Gaussian before descriptor extraction).  Images are [..., H, W];
leading dims (the agent axis) are batch.

Levels are rounded to integral intensities at every step.  That rounding
is not bit-reproducible across frameworks: where `Wr @ img @ Wc.T` lands
within an ulp of .5, PyTorch and XLA may round to neighbouring integers,
so about 1e-4 of the pixels of a level differ by 1 from the JAX package.
For the same reason each image of a batch is resized by its own matmuls:
the GEMM kernel that a batch of A images would get sums in another order
than one image's, and a cohort row would part from the per-agent step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [
        (int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)
    ]


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _as4d(img: torch.Tensor) -> torch.Tensor:
    return img.reshape((-1, 1) + tuple(img.shape[-2:]))


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian on [..., H, W] f32 with reflect padding, summed
    tap by tap in the JAX package's order."""
    k = gaussian_kernel_1d(ksize, sigma).tolist()
    r = ksize // 2
    h, w = img.shape[-2:]
    x = F.pad(_as4d(img), (0, 0, r, r), mode="reflect")
    out = torch.zeros_like(_as4d(img))
    for i in range(ksize):
        out = out + k[i] * x[..., i:i + h, :]
    x = F.pad(out, (r, r, 0, 0), mode="reflect")
    out = torch.zeros_like(out)
    for i in range(ksize):
        out = out + k[i] * x[..., :, i:i + w]
    return out.reshape(img.shape)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] 2-tap bilinear resize weights (half-pixel centers,
    edge clamp) — the same sampling as cv::resize INTER_LINEAR."""
    s = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        x = (i + 0.5) * s - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        lo = min(max(x0, 0), n_in - 1)
        hi = min(max(x0 + 1, 0), n_in - 1)
        W[i, lo] += 1.0 - f
        W[i, hi] += f
    return W


@functools.lru_cache(maxsize=None)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize of [..., h1, w1] as two fp32 matmuls per
    image, whatever the leading dims, so an image's level has the same
    bits alone and in a batch."""
    h2, w2 = shape
    h1, w1 = img.shape[-2:]
    Wr = _resize_weights_on(h1, h2, img.device)
    Wc = _resize_weights_on(w1, w2, img.device)
    flat = img.reshape((-1, h1, w1))
    out = torch.stack([torch.matmul(torch.matmul(Wr, x), Wc.T) for x in flat.unbind(0)])
    return out.reshape(img.shape[:-2] + (h2, w2))


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """[..., H, W] u8/f32 -> list of [..., h_l, w_l] f32 levels (chained
    2-tap bilinear, each level rounded to integral intensities as the
    reference's u8 -> u8 chain)."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(torch.round(resize_bilinear(levels[-1], shapes[l])))
    return levels
