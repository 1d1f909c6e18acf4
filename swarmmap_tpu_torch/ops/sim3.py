"""Sim(3) estimation.

Port of swarmmap_tpu/ops/sim3.py (reference spec: Sim3Solver — 3-point
RANSAC with Horn's closed form, used by loop closing; the cross-map merge
also uses Eigen::umeyama, AgentMediator.cc:476-502).

Umeyama (Horn's closed form for minimal sets, least squares for full sets)
is one batched closed form over leading dims; RANSAC is one bank of
N_HYPOTHESES minimal sets solved by one batched 3x3 SVD and scored at once
by the symmetric reprojection error in both cameras.  The random minimal
sets are drawn apart from the solve, as in `ops/pnp.py`:
`ransac_sim3_draws` draws from an explicit `torch.Generator`, and
`ransac_sim3` takes any [N_HYPOTHESES, 3] draws, the JAX package's
`jax.random.randint(key, (128, 3), 0, count)` included.

R = U diag(1, 1, sign det(U Vt)) Vt does not depend on the SVD's column
signs (a flipped pair of columns of U and V cancels), so the backend's
SVD (LAPACK, cuSOLVER) gives the JAX package's rotation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

N_HYPOTHESES = 128
MIN_SET = 3


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] in closed form."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def umeyama(
    src: torch.Tensor, dst: torch.Tensor,
    weights: torch.Tensor | None = None,
    with_scale: bool = True,
):
    """Weighted similarity (s, R, t) with dst ~ s R src + t, for
    [..., N, 3] point sets (leading dims are independent problems)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(-1), min=1e-9)
    wn = (weights / wsum[..., None])[..., None]          # [..., N, 1]
    mu_s = torch.sum(src * wn, -2)
    mu_d = torch.sum(dst * wn, -2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd * wn).transpose(-1, -2) @ xs               # [..., 3, 3]
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(_det3(U) * _det3(Vt))
    one = torch.ones_like(sgn)
    diag_s = torch.stack([one, one, sgn], -1)            # [..., 3]
    R = (U * diag_s[..., None, :]) @ Vt
    var_s = torch.sum(torch.sum(xs * xs, -1) * wn[..., 0], -1)
    if with_scale:
        s = torch.sum(D * diag_s, -1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(var_s)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor      # [3,3]: maps frame-2 coords into frame-1
    t: torch.Tensor
    inliers: torch.Tensor


def ransac_sim3_draws(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N_HYPOTHESES, MIN_SET] int64 draws, uniform in [0, count) with
    count = max(valid.sum(), MIN_SET), from `generator` (on the points'
    device); stays on the device, count is never read on the host."""
    count = torch.clamp(valid.sum(), min=MIN_SET)
    u = torch.rand((N_HYPOTHESES, MIN_SET), generator=generator, device=valid.device)
    return torch.minimum((u * count).long(), count - 1)


def _project(Km: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(pc[..., 2], min=1e-9)
    return torch.stack(
        [Km[0, 0] * pc[..., 0] / z + Km[0, 2], Km[1, 1] * pc[..., 1] / z + Km[1, 2]], -1)


def ransac_sim3(
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    valid: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    draws: torch.Tensor,
    chi2_1: torch.Tensor | float = 9.21,
    chi2_2: torch.Tensor | float = 9.21,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """Matched camera-frame point sets [N,3] (pc1 in cam-1 frame, pc2 in
    cam-2 frame) and [N_HYPOTHESES, 3] draws (indices into the valid
    rows) -> S12 with its inlier mask.

    The inlier test mirrors Sim3Solver::CheckInliers: project the
    transformed partner point into each camera and gate the squared pixel
    error.  No host sync: `success` stays a device bool."""
    # jnp.argsort is stable; torch.argsort only with stable=True
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    sets = order[draws]                                   # [H, 3]
    s_b, R_b, t_b = umeyama(pc2[sets], pc1[sets], with_scale=not fix_scale)

    uv1_obs = _project(K1, pc1)
    uv2_obs = _project(K2, pc2)
    # every hypothesis scored at once: [H, N, 3]
    p2in1 = s_b[:, None, None] * (pc2 @ R_b.transpose(-1, -2)) + t_b[:, None, :]
    sinv = 1.0 / torch.clamp(s_b, min=1e-12)
    p1in2 = sinv[:, None, None] * ((pc1 - t_b[:, None, :]) @ R_b)
    e1 = torch.sum((_project(K1, p2in1) - uv1_obs) ** 2, -1)
    e2 = torch.sum((_project(K2, p1in2) - uv2_obs) ** 2, -1)
    inls = valid & (e1 < chi2_1) & (e2 < chi2_2) & (p2in1[..., 2] > 0) & (p1in2[..., 2] > 0)
    n_in = inls.sum(-1)
    best = torch.argmax(n_in)          # the first of the largest, as jnp.argmax
    ok = n_in[best] >= min_inliers
    # least-squares refit on the winning inliers (umeyama over all)
    w = inls[best].to(pc1.dtype)
    s_f, R_f, t_f = umeyama(pc2, pc1, weights=w, with_scale=not fix_scale)
    return Sim3Result(success=ok, s=s_f, R=R_f, t=t_f, inliers=inls[best])
