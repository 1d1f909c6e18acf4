"""Batched linear triangulation.

Port of swarmmap_tpu/ops/triangulate.py (reference spec: the SVD
triangulation inside LocalMapping::CreateNewMapPoints and
Initializer::Triangulate — per-point 4x4 DLT).  All points are
triangulated at once with one batched SVD; every function takes leading
batch dims on its arguments (a neighbour or hypothesis axis).
"""
from __future__ import annotations

import torch


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """3x4 projection P = K [R|t]."""
    return K @ Tcw[..., :3, :4]


def triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor) -> torch.Tensor:
    """DLT: [..., N, 2] pixel pairs under [..., 3, 4] projections ->
    [..., N, 3] world points.

    A x = 0 with rows (u * P[2] - P[0]), (v * P[2] - P[1]) per view.  The
    null vector's sign is the SVD's choice and cancels in the division by w.
    """
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    rows = [
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # [..., N, 4, 4]
    _, _, vt = torch.linalg.svd(A)
    x = vt[..., 3, :]
    w = x[..., 3]
    safe = torch.where(torch.abs(w) > 1e-10, w, torch.full_like(w, 1e-10))
    return x[..., :3] / safe[..., None]


def reprojection_error2(P: torch.Tensor, pts: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Squared pixel reprojection error of [..., N, 3] points under [..., 3, 4] P."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    proj = ph @ P.transpose(-1, -2)
    z = proj[..., 2]
    z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    d = proj[..., :2] / z[..., None] - uv
    return torch.sum(d * d, -1)


def depths(Tcw: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Camera-frame z of [..., N, 3] world points under [..., 4, 4] Tcw."""
    return (pts @ Tcw[..., :3, :3].transpose(-1, -2))[..., 2] + Tcw[..., None, 2, 3]


def parallax_cos(c1: torch.Tensor, c2: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray angle between camera centers c1, c2 [..., 3] and
    points [..., N, 3]."""
    r1 = pts - c1[..., None, :]
    r2 = pts - c2[..., None, :]
    num = torch.sum(r1 * r2, -1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    return num / torch.clamp(den, min=1e-12)
