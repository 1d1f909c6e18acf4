"""Batched RANSAC PnP for relocalization.

Port of swarmmap_tpu/ops/pnp.py (reference spec: PnPsolver — EPnP
(Lepetit et al.) minimal solves inside an adaptive RANSAC loop).  A
fixed-size hypothesis bank: batched EPnP (4 PCA control points,
barycentric coordinates, the 12x12 M^T M nullspace, the N=1 and N=2 beta
cases), Kabsch alignment world->camera, best case by reprojection error;
a 6-point DLT resection as the alternative solver.  The winner is
LM-refined through `pose_opt.pose_optimize_auto`: on the card that is
the hand-written kernel (csrc/pose_lm.cu, fixed 3x8 schedule), on the
CPU the plain version with its early exit, as in the JAX package.

Where `jax.vmap` maps the solvers over hypotheses, every function here
takes the hypothesis axis as a leading batch dimension.  The random
minimal sets are drawn apart from the rest (`draw_indices`, from an
explicit `torch.Generator`), so `ransac_pnp_draws` can be fed any
[N_HYPOTHESES, MIN_SET] draws, the JAX package's included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import pose_opt

N_HYPOTHESES = 256
MIN_SET = 6


def _rigid_align(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Kabsch: find Tcw with Q ~ R P + t (P world, Q camera), no scale
    (reference: PnPsolver::estimate_R_and_t).  [..., S, 3] -> [..., 4, 4]."""
    cp, cq = P.mean(-2), Q.mean(-2)
    H = (P - cp[..., None, :]).transpose(-1, -2) @ (Q - cq[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(-1, -2)
    t = cq - (R @ cp[..., None])[..., 0]
    T = torch.eye(4, dtype=P.dtype, device=P.device).expand(R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solution through the SVD with the default cutoff
    eps * max(M, N), what jnp.linalg.lstsq computes (and on the card,
    where torch.linalg.lstsq takes only full-rank systems)."""
    return (torch.linalg.pinv(A) @ b[..., None])[..., 0]


def _solve_epnp(pts: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[..., S, 3] world points + [..., S, 2] *normalized* image coords
    -> Tcw [..., 4, 4] via EPnP with the N=1 and N=2 beta cases."""
    S = pts.shape[-2]
    f32, dev = pts.dtype, pts.device
    batch = pts.shape[:-2]
    # control points: centroid + PCA axes (choose_control_points)
    c0 = pts.mean(-2)
    Pc = pts - c0[..., None, :]
    cov = Pc.transpose(-1, -2) @ Pc / S
    w_eig, V = torch.linalg.eigh(cov)
    sd = torch.sqrt(torch.clamp(w_eig, min=1e-10))
    C = torch.cat([c0[..., None, :],
                   c0[..., None, :] + sd[..., :, None] * V.transpose(-1, -2)], -2)  # [...,4,3]
    # barycentric coordinates (compute_barycentric_coordinates)
    M44 = torch.cat([C.transpose(-1, -2), torch.ones(batch + (1, 4), dtype=f32, device=dev)], -2)
    rhs = torch.cat([pts.transpose(-1, -2), torch.ones(batch + (1, S), dtype=f32, device=dev)], -2)
    A = torch.linalg.solve(M44, rhs).transpose(-1, -2)  # [...,S,4]
    # M matrix [2S,12] in normalized coords (fill_M with fx=fy=1, cx=cy=0)
    u, v = uv[..., 0], uv[..., 1]
    Z = torch.zeros_like(A)
    M1 = torch.stack([A, Z, -A * u[..., None]], -1).reshape(batch + (S, 12))
    M2 = torch.stack([Z, A, -A * v[..., None]], -1).reshape(batch + (S, 12))
    M = torch.cat([M1, M2], -2)
    _, Vn = torch.linalg.eigh(M.transpose(-1, -2) @ M)  # ascending eigenvalues
    v1 = Vn[..., :, 0].reshape(batch + (4, 3))  # nullspace basis
    v2 = Vn[..., :, 1].reshape(batch + (4, 3))

    # world control-point pairwise distances
    pi, pj = torch.triu_indices(4, 4, offset=1, device=dev)
    dC = torch.linalg.norm(C[..., pi, :] - C[..., pj, :], dim=-1)  # [...,6]

    def finish(Cc):
        # flip so points sit in front of the camera, then align
        Xc = A @ Cc
        sgn = torch.sign(Xc[..., 2].sum(-1))
        Xc = Xc * torch.where(sgn == 0, 1.0, sgn)[..., None, None]
        T = _rigid_align(pts, Xc)
        pc = pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
        pu = pc[..., 0] / torch.clamp(pc[..., 2], min=1e-9)
        pv = pc[..., 1] / torch.clamp(pc[..., 2], min=1e-9)
        err = torch.sum((pu - u) ** 2 + (pv - v) ** 2, -1)
        err = err + torch.where(pc[..., 2].amin(-1) <= 0, 1e9, 0.0)
        return T, err

    # case N=1: single beta from distance consistency
    dv1 = torch.linalg.norm(v1[..., pi, :] - v1[..., pj, :], dim=-1)
    beta1 = torch.sum(dv1 * dC, -1) / torch.clamp(torch.sum(dv1 * dv1, -1), min=1e-12)
    T_a, err_a = finish(beta1[..., None, None] * v1)

    # case N=2: Cc = b1*v2 + b2*v1; solve [b11,b12,b22] by least squares
    # over the 6 distance constraints (find_betas_approx_2)
    d2 = v2[..., pi, :] - v2[..., pj, :]
    d1 = v1[..., pi, :] - v1[..., pj, :]
    L = torch.stack(
        [torch.sum(d2 * d2, -1), 2.0 * torch.sum(d2 * d1, -1), torch.sum(d1 * d1, -1)], -1
    )  # [...,6,3]
    b = _lstsq(L, dC**2)
    b11, b12, b22 = b[..., 0], b[..., 1], b[..., 2]
    bb1 = torch.sqrt(torch.abs(b11))
    bb2 = torch.sqrt(torch.abs(b22)) * torch.sign(b12) * torch.sign(b11)
    T_b, err_b = finish(bb1[..., None, None] * v2 + bb2[..., None, None] * v1)

    return torch.where((err_a <= err_b)[..., None, None], T_a, T_b)


def _solve_dlt(pts: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[..., 6, 3] world points + [..., 6, 2] *normalized* image coords
    -> Tcw [..., 4, 4]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    o = torch.ones_like(x)
    zr = torch.zeros_like(x)
    r1 = torch.stack([x, y, z, o, zr, zr, zr, zr, -u * x, -u * y, -u * z, -u], -1)
    r2 = torch.stack([zr, zr, zr, zr, x, y, z, o, -v * x, -v * y, -v * z, -v], -1)
    A = torch.cat([r1, r2], -2)  # [...,12,12]
    _, _, vt = torch.linalg.svd(A)
    P = vt[..., 11, :].reshape(pts.shape[:-2] + (3, 4))
    # sign: points must be in front (positive depth for the centroid)
    c = pts.mean(-2)
    sgn = torch.sign((P[..., 2, :3] * c).sum(-1) + P[..., 2, 3])
    P = P * torch.where(sgn == 0, 1.0, sgn)[..., None, None]
    M = P[..., :3]
    # orthonormalize M -> R, recover scale for t
    U, s, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    scale = s.mean(-1)
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    T = torch.eye(4, dtype=pts.dtype, device=pts.device).expand(R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


class PnPResult(NamedTuple):
    success: torch.Tensor
    Tcw: torch.Tensor       # [4,4]
    inliers: torch.Tensor   # [N] bool


class Hypotheses(NamedTuple):
    Tcw: torch.Tensor       # [N_HYPOTHESES, 4, 4] minimal-set poses
    n_loose: torch.Tensor   # [N_HYPOTHESES] loose-gate inlier counts
    loose: torch.Tensor     # [N_HYPOTHESES, N] loose-gate inliers


def draw_indices(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N_HYPOTHESES, MIN_SET] int64 draws, uniform in [0, count) with
    count = max(valid.sum(), MIN_SET) — the JAX package's
    `jax.random.randint(key, ..., 0, count)` with another generator.
    Stays on the device: count is never read on the host."""
    count = torch.clamp(valid.sum(), min=MIN_SET)
    u = torch.rand((N_HYPOTHESES, MIN_SET), generator=generator, device=valid.device)
    return torch.minimum((u * count).long(), count - 1)


def _project_e2(T, pts_w, uv, K, sigma2):
    """Reprojection error^2 / sigma2 and depth of every point under each
    pose T [..., 4, 4]."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pc = pts_w @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    z = pc[..., 2]
    pu = fx * pc[..., 0] / torch.clamp(z, min=1e-9) + cx
    pv = fy * pc[..., 1] / torch.clamp(z, min=1e-9) + cy
    return ((pu - uv[:, 0]) ** 2 + (pv - uv[:, 1]) ** 2) / sigma2, z


def hypotheses(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
    draws: torch.Tensor, sigma2: torch.Tensor | float = 1.0,
    chi2_th: float = 5.991, solver: str = "epnp",
) -> Hypotheses:
    """Stage 1 for given draws: one minimal solve per hypothesis and its
    loose-gate score (minimal poses are noisy, so strict chi2 would
    starve every hypothesis)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    norm_uv = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], 1)
    # jnp.argsort is stable; torch.argsort only with stable=True
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    sets = order[draws]
    minimal = _solve_epnp if solver == "epnp" else _solve_dlt
    T_batch = minimal(pts_w[sets], norm_uv[sets])
    e2, z = _project_e2(T_batch, pts_w, uv, K, sigma2)
    loose = valid & (z > 0) & (e2 < 100.0 * chi2_th)
    return Hypotheses(T_batch, loose.sum(-1), loose)


def ransac_pnp_draws(
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    draws: torch.Tensor,
    sigma2: torch.Tensor | float = 1.0,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    solver: str = "epnp",
) -> PnPResult:
    """RANSAC PnP on given [N_HYPOTHESES, MIN_SET] draws (indices into
    the valid points, in order)."""
    hyp = hypotheses(pts_w, uv, valid, K, draws, sigma2, chi2_th, solver)
    best = torch.argmax(hyp.n_loose)  # first maximal index, as jnp.argmax
    # stage 2: LM refinement on the loose inliers (the reference refines
    # every RANSAC winner with PoseOptimization too, Tracking.cc:1138+)
    inv_s2 = torch.ones(pts_w.shape[0], dtype=pts_w.dtype, device=pts_w.device) / sigma2
    res = pose_opt.pose_optimize_auto(
        hyp.Tcw[best].contiguous(), K, pts_w, uv, inv_s2, hyp.loose[best].contiguous(),
        rounds=3, iters=8, chi2_th=chi2_th,
    )
    e2, z = _project_e2(res.Tcw, pts_w, uv, K, sigma2)
    inls = valid & (z > 0) & (e2 < chi2_th)
    return PnPResult(success=inls.sum() >= min_inliers, Tcw=res.Tcw, inliers=inls)


def ransac_pnp(
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    generator: torch.Generator,
    sigma2: torch.Tensor | float = 1.0,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    solver: str = "epnp",
) -> PnPResult:
    """[N,3] world points vs [N,2] pixels -> camera pose.

    All hypotheses solved and scored in one batch; the winner is the
    hypothesis with most loose inliers, refined by LM.  The draws come
    from `generator`, which must live on the points' device."""
    return ransac_pnp_draws(pts_w, uv, valid, K, draw_indices(valid, generator),
                            sigma2, chi2_th, min_inliers, solver)
