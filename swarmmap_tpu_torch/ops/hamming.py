"""Hamming distances of packed 256-bit descriptors.

Port of swarmmap_tpu/ops/hamming.py (reference spec:
ORBmatcher::DescriptorDistance, ORBmatcher.cc:1511-1526).  Descriptors are
[..., N, 8] int32 words (see brief.py).  PyTorch has no popcount and CUDA
no int8 matmul, so

    ham(a, b) = popcount(a) + popcount(b) - 2 a.b

takes a.b as an fp32 product of the unpacked {0,1} bits — exact, since
every partial sum is an integer <= 256 and TF32 is off (package pin).
"""
from __future__ import annotations

import torch

from .brief import unpack_bits


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of 32-bit words (SWAR on int64-widened values,
    so no sign bit gets in the way)."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_desc(desc: torch.Tensor) -> torch.Tensor:
    """[..., N, 8] -> [..., N] total bit count."""
    return popcount_u32(desc).sum(-1, dtype=torch.int32)


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """[..., Nq, 8] x [..., Nt, 8] -> [..., Nq, Nt] int32 Hamming distances."""
    bq = unpack_bits(desc_q).to(torch.float32)
    bt = unpack_bits(desc_t).to(torch.float32)
    dots = torch.matmul(bq, bt.transpose(-1, -2)).to(torch.int32)
    pq = popcount_desc(desc_q)[..., :, None]
    pt = popcount_desc(desc_t)[..., None, :]
    return pq + pt - 2 * dots


def hamming_pairs(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-wise distance between aligned [..., N, 8] descriptor arrays."""
    return popcount_desc(torch.bitwise_xor(desc_a, desc_b))
