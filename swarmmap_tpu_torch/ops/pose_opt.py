"""Motion-only LM pose optimisation — the plain PyTorch version and the
dispatcher.

Port of swarmmap_tpu/ops/pose_opt.py (reference spec:
Optimizer::PoseOptimization, Optimizer.cc:239 — Huber delta sqrt(5.991),
rounds x iterations with chi-square outlier re-classification between
rounds).  Every function takes an optional leading agent axis: `Tcw0`
[...,4,4], `K` [...,3,3], `pts_w` [...,N,3], `uv` [...,N,2], `inv_sigma2`
and `valid` [...,N].

`pose_optimize_auto` sends CUDA tensors to the hand-written kernel
(`pose_kernel.pose_optimize_cuda`, csrc/pose_lm.cu) and CPU tensors to
`pose_optimize` below.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import lie

CHI2_MONO = 5.991
HUBER_DELTA = math.sqrt(CHI2_MONO)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor       # [...,4,4]
    inliers: torch.Tensor   # [...,N] bool
    chi2: torch.Tensor      # [...,N] f32 (weighted squared error)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate) over leading dims."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([D, E, F], -1),
        torch.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a 6x6 SPD system via 3x3 block elimination with closed-form
    inverses (the same arithmetic as the kernel's one-thread solve)."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ainv = _inv3(A)
    BtAinv = B.transpose(-1, -2) @ Ainv
    S = C - BtAinv @ B
    Sinv = _inv3(S)
    rhs2 = b2 - (BtAinv @ b1[..., None])[..., 0]
    x2 = (Sinv @ rhs2[..., None])[..., 0]
    x1 = (Ainv @ (b1 - (B @ x2[..., None])[..., 0])[..., None])[..., 0]
    return torch.cat([x1, x2], -1)


def _residuals_jac(Tcw, K, pts_w, uv):
    """Residuals [...,N,2], Jacobians [...,N,2,6] wrt a left-multiplied
    se3 update (omega, upsilon), and camera depth [...,N]."""
    pc = (pts_w @ Tcw[..., :3, :3].transpose(-1, -2)) + Tcw[..., None, :3, 3]
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    u = fx * x / z + K[..., 0, 2, None]
    v = fy * y / z + K[..., 1, 2, None]
    r = torch.stack([u, v], -1) - uv
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    # d(uv)/d(pc)
    j00 = fx * zinv
    j02 = -fx * x * zinv2
    j11 = fy * zinv
    j12 = -fy * y * zinv2
    zero = torch.zeros_like(z)
    Juv = torch.stack(
        [torch.stack([j00, zero, j02], -1), torch.stack([zero, j11, j12], -1)], -2
    )  # [...,N,2,3]
    # d(pc)/d(xi): [-hat(pc) | I]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    Jp = torch.cat([-lie.hat(pc), eye], -1)  # [...,N,3,6]
    return r, Juv @ Jp, pc[..., 2]


def _robust_cost(r, inv_sigma2, active):
    e = torch.sqrt(torch.sum(r * r, -1) * inv_sigma2 + 1e-12)
    rho = torch.where(e <= HUBER_DELTA, e * e, 2 * HUBER_DELTA * e - HUBER_DELTA**2)
    return torch.sum(rho * active, -1)


def pose_optimize(
    Tcw0: torch.Tensor,
    K: torch.Tensor,
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 4,
    iters: int = 10,
    chi2_th: float = CHI2_MONO,
    step_tol: float = 1e-6,
) -> PoseOptResult:
    """Optimise camera poses against fixed 3D points (plain version).

    Each round runs at most `iters` LM steps and stops once an accepted
    step's norm drops below `step_tol`, or once a step is rejected at the
    largest damping.  Over an agent axis each agent stops on its own: the
    loop runs while any agent is still going and the carry of an agent that
    has stopped stays frozen — what `jax.vmap` of the JAX package's
    while_loop does.  `step_tol=0` gives the kernel's fixed schedule."""
    active_f = valid.to(pts_w.dtype)
    Tcw = Tcw0
    batch = Tcw0.shape[:-2]
    eye6 = torch.eye(6, dtype=Tcw.dtype, device=Tcw.device)
    for _ in range(rounds):
        lam = torch.full(batch, 1e-3, dtype=Tcw.dtype, device=Tcw.device)
        conv = torch.zeros(batch, dtype=torch.bool, device=Tcw.device)
        for _ in range(iters):
            if bool(conv.all()):
                break
            r, J, _z = _residuals_jac(Tcw, K, pts_w, uv)
            w = inv_sigma2 * active_f
            # Huber IRLS weights on the sigma-normalised error norm
            en = torch.sqrt(torch.sum(r * r, -1) * inv_sigma2 + 1e-12)
            hub = torch.where(en <= HUBER_DELTA, torch.ones_like(en), HUBER_DELTA / en)
            wh = w * hub
            H = torch.einsum("...nik,...n,...nil->...kl", J, wh, J)
            b = -torch.einsum("...nik,...n,...ni->...k", J, wh, r)
            Hd = H + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye6
            dx = solve6(Hd, b)
            T_new = lie.se3_exp(dx) @ Tcw
            r_new, _, _ = _residuals_jac(T_new, K, pts_w, uv)
            c_old = _robust_cost(r, inv_sigma2, active_f)
            c_new = _robust_cost(r_new, inv_sigma2, active_f)
            improved = c_new < c_old
            step = torch.sqrt(torch.sum(dx * dx, -1))
            lam_new = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            conv_new = (improved & (step < step_tol)) | (~improved & (lam_new >= 1e6))
            run = ~conv
            Tcw = torch.where((run & improved)[..., None, None], T_new, Tcw)
            lam = torch.where(run, lam_new, lam)
            conv = torch.where(run, conv_new, conv)
        r, _, z = _residuals_jac(Tcw, K, pts_w, uv)
        chi2 = torch.sum(r * r, -1) * inv_sigma2
        active_f = (valid & (chi2 <= chi2_th) & (z > 0)).to(pts_w.dtype)
    r, _, z = _residuals_jac(Tcw, K, pts_w, uv)
    chi2 = torch.sum(r * r, -1) * inv_sigma2
    inl = valid & (chi2 <= chi2_th) & (z > 0)
    return PoseOptResult(Tcw=Tcw, inliers=inl, chi2=chi2)


def pose_optimize_auto(
    Tcw0, K, pts_w, uv, inv_sigma2, valid,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
) -> PoseOptResult:
    """Backend dispatcher shared by every caller: CUDA tensors run the
    whole optimisation as ONE launch of the hand-written kernel (fixed
    `rounds` x `iters` schedule), CPU tensors run `pose_optimize`.  There
    is no opt-out: a CUDA tensor that the kernel refuses raises."""
    if Tcw0.is_cuda:
        from . import pose_kernel

        batched = Tcw0.dim() == 3
        args = [x if batched else x[None] for x in
                (Tcw0, K, pts_w, uv, inv_sigma2, valid)]
        res = pose_kernel.pose_optimize_cuda(
            *args, rounds=rounds, iters=iters, chi2_th=chi2_th)
        return res if batched else PoseOptResult(*(x[0] for x in res))
    return pose_optimize(
        Tcw0, K, pts_w, uv, inv_sigma2, valid,
        rounds=rounds, iters=iters, chi2_th=chi2_th,
    )
