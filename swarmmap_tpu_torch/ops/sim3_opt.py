"""Sim(3) relative-pose refinement.

Port of swarmmap_tpu/ops/sim3_opt.py (reference spec:
Optimizer::OptimizeSim3, Optimizer.cc:998+ — g2o LM over one Sim3 vertex
with forward/backward reprojection edge pairs, Huber delta sqrt(10),
outlier removal between two rounds; and the EdgeSim3RelativeXYZ
refinement of OptimizeSim3ByMapPoint).

Residual Jacobians over the 7-dim tangent are closed forms in the left
perturbation S <- exp(delta) S, where the JAX package takes `jax.jacfwd`
of the same residuals (torch's forward-mode AD runs Python decompositions
for scalar arithmetic and `where`, and costs seconds on its first call;
tests/test_torch_sim3.py holds the two Jacobians together).  The fixed LM
schedule is a Python loop with no host sync: a step is kept or dropped by
a `torch.where` on the robust cost, and the damped 7x7 system is solved
with `solve_ex` (no error check, so no sync).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie

CHI2_SIM3 = 9.210  # 2-dof chi2 at 99% (g2o th2 = 10 is close; reference uses 10)
HUBER = float(np.sqrt(np.float32(10.0)))


def _project(Km, pc):
    z = torch.clamp(pc[..., 2], min=1e-9)
    return torch.stack(
        [Km[0, 0] * pc[..., 0] / z + Km[0, 2], Km[1, 1] * pc[..., 1] / z + Km[1, 2]], -1)


def _project_jac(Km, pc):
    """[..., 2, 3] d _project / d pc (the depth clamp's derivative 0 below it)."""
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-9)
    live = (z > 1e-9).to(pc.dtype)
    zero = torch.zeros_like(z)
    fx, fy = Km[0, 0], Km[1, 1]
    return torch.stack([
        torch.stack([fx / zc, zero, -fx * pc[..., 0] / (zc * zc) * live], -1),
        torch.stack([zero, fy / zc, -fy * pc[..., 1] / (zc * zc) * live], -1)], -2)


def _left_jac(q):
    """[..., 3, 7] d (exp(delta) q) / d delta at delta = 0, for
    delta = (omega, upsilon, sigma): [-hat(q) | I | q]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
    return torch.cat([-lie.hat(q), eye, q[..., None]], -1)


class Sim3OptResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _lm(xi, res_and_jac, weights, cost, n_it, fix_scale, fix_scale_step):
    """n_it LM steps from xi: residuals r [M,k] and their Jacobians [M,k,7]
    in the left perturbation S <- exp(delta) S at the current estimate
    (`res_and_jac(R, t, s)`), H + lam diag(H), accept where the robust
    cost drops (lam x0.5), else keep (lam x4), lam clipped to [1e-8, 1e8]."""
    lam = torch.tensor(1e-3, dtype=xi.dtype, device=xi.device)
    eye7 = torch.eye(7, dtype=xi.dtype, device=xi.device)
    for _ in range(n_it):
        r, Jf = res_and_jac(*lie.sim3_exp(xi))
        w = weights(r)                                    # [M]
        H = torch.einsum("nik,n,nil->kl", Jf, w, Jf)
        b = -torch.einsum("nik,n,ni->k", Jf, w, r)
        if fix_scale:
            H = H + 1e6 * torch.outer(eye7[6], eye7[6])
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
        dx = torch.linalg.solve_ex(Hd, b)[0]
        if fix_scale_step:
            dx = dx * (1.0 - eye7[6])
        xi_new = lie.sim3_log(*lie.sim3_mul(*lie.sim3_exp(dx), *lie.sim3_exp(xi)))
        ok = cost(xi_new) < cost(xi)
        xi = torch.where(ok, xi_new, xi)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return xi


def _rho(c, huber):
    e = torch.sqrt(c + 1e-12)
    return torch.where(e <= huber, c, 2 * huber * e - huber**2)


def optimize_sim3(
    s0: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
    pc1: torch.Tensor, pc2: torch.Tensor,
    uv1: torch.Tensor, uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    K1: torch.Tensor, K2: torch.Tensor,
    fix_scale: bool = False,
    iters: int = 10,
    chi2_th: float = 10.0,
) -> Sim3OptResult:
    """Refine S12 so that project(K1, S12 pc2) = uv1 and
    project(K2, S12^-1 pc1) = uv2: iters // 2 LM steps over the valid
    pairs, a chi2 gate, iters more over the inliers, a final gate."""
    xi0 = lie.sim3_log(R0, t0, s0)

    def points(R, t, s):
        p2in1 = s * (pc2 @ R.T) + t
        sinv = 1.0 / torch.clamp(s, min=1e-12)
        return p2in1, sinv * ((pc1 - t) @ R), sinv

    def residuals_rts(R, t, s):
        p2in1, p1in2, _ = points(R, t, s)
        return torch.cat([_project(K1, p2in1) - uv1, _project(K2, p1in2) - uv2], 0)

    def res_and_jac(R, t, s):
        # S' = exp(delta) S: S' pc2 moves as exp(delta) applied to p2in1,
        # S'^-1 pc1 = S^-1 exp(-delta) pc1 as S^-1's linear part applied
        # to -[-hat(pc1) | I | pc1]
        p2in1, p1in2, sinv = points(R, t, s)
        r = torch.cat([_project(K1, p2in1) - uv1, _project(K2, p1in2) - uv2], 0)
        J1 = _project_jac(K1, p2in1) @ _left_jac(p2in1)
        J2 = _project_jac(K2, p1in2) @ (-(sinv * R.T) @ _left_jac(pc1))
        return r, torch.cat([J1, J2], 0)

    n = pc1.shape[0]
    inv_sigma2 = torch.cat([inv_sigma2_1, inv_sigma2_2], 0)

    def chi2(r):
        return torch.sum(r * r, 1) * inv_sigma2

    def classify(xi):
        c = chi2(residuals_rts(*lie.sim3_exp(xi)))
        return valid & (c[:n] < chi2_th) & (c[n:] < chi2_th)

    def lm(xi, active, n_it):
        act2 = torch.cat([active, active], 0)

        def weights(r):
            e = torch.sqrt(chi2(r) + 1e-12)
            return inv_sigma2 * torch.where(e <= HUBER, 1.0, HUBER / e) * act2

        def cost(xi):
            return torch.sum(_rho(chi2(residuals_rts(*lie.sim3_exp(xi))), HUBER) * act2)

        return _lm(xi, res_and_jac, weights, cost, n_it, fix_scale, fix_scale)

    xi = lm(xi0, valid.to(xi0.dtype), iters // 2)
    inl = classify(xi)
    xi = lm(xi, inl.to(xi0.dtype), iters)
    inl = classify(xi)
    R, t, s = lie.sim3_exp(xi)
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, n_inliers=inl.sum())


def optimize_sim3_points(
    s0: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
    p1: torch.Tensor, p2: torch.Tensor,
    valid: torch.Tensor,
    fix_scale: bool = False,
    iters: int = 10,
    chi2_th: float = 10.0,
) -> Sim3OptResult:
    """The EdgeSim3RelativeXYZ analogue (reference:
    include/g2o/EdgeSim3RelativeXYZ.h + Optimizer::OptimizeSim3ByMapPoint,
    Optimizer.cc:1450-1811): refine a Sim3 Twl so that p1 ~ Twl.map(p2)
    over matched 3D point pairs — residual obs - v_sim3.map(p),
    Huber(sqrt(th2)), LM, one chi2 pruning pass between two rounds.
    MapManager.fuse polishes the group transform with it."""
    xi0 = lie.sim3_log(R0, t0, s0)

    def residuals_rts(R, t, s):
        return p1 - (s * (p2 @ R.T) + t)

    def res_and_jac(R, t, s):
        q = s * (p2 @ R.T) + t
        return p1 - q, -_left_jac(q)

    huber = torch.sqrt(torch.tensor(chi2_th, dtype=p1.dtype, device=p1.device))

    def lm(xi, active, n_it):
        def weights(e):
            r = torch.sqrt(torch.sum(e * e, 1) + 1e-12)
            return torch.where(r <= huber, 1.0, huber / r) * active

        def cost(xi):
            e = residuals_rts(*lie.sim3_exp(xi))
            return torch.sum(_rho(torch.sum(e * e, 1), huber) * active)

        # this variant damps the scale but does not zero its step (as JAX)
        return _lm(xi, res_and_jac, weights, cost, n_it, fix_scale, False)

    def classify(xi):
        e = residuals_rts(*lie.sim3_exp(xi))
        return valid & (torch.sum(e * e, 1) < chi2_th)

    # reference schedule: optimize(5) -> chi2 prune -> optimize(5 or 10)
    xi = lm(xi0, valid.to(xi0.dtype), iters // 2)
    inl = classify(xi)
    xi = lm(xi, inl.to(xi0.dtype), iters)
    inl = classify(xi)
    R, t, s = lie.sim3_exp(xi)
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, n_inliers=inl.sum())
