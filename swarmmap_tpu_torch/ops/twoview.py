"""Monocular two-view bootstrapping.

Port of swarmmap_tpu/ops/twoview.py (reference spec: Initializer —
parallel RANSAC of a homography H and a fundamental F over minimal sets,
model selection by score ratio, motion recovery + triangulation with
cheirality/parallax checks).

RANSAC is batched hypothesis scoring: all 256 minimal sets are solved
(batched SVDs) and scored at once, with no early exit; the hypothesis axis
is a leading batch dimension where the JAX package has `jax.vmap`.  The
random minimal sets are drawn apart from the rest, as in `ops/pnp.py`:
`draw_indices` draws from an explicit `torch.Generator`, and
`reconstruct_draws` takes any [N_HYPOTHESES, 8] draws, the JAX package's
`jax.random.randint(key, (256, 8), 0, count)` included.

SVD signs are the backend's choice (LAPACK, cuSOLVER).  They cancel: F
and H are scored through squares and ratios, the 4 motions of E and the
8 of H form the same set under any column signs (only their order moves),
and the winner is picked by its count of good points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import triangulate as tri

N_HYPOTHESES = 256
MIN_SET = 8
CHI2_F = 3.841
CHI2_H = 5.991
TH_SCORE = 5.991  # both models score with this cap (Initializer.cc)


class Reconstruction(NamedTuple):
    success: torch.Tensor   # bool scalar
    R21: torch.Tensor       # [3,3]
    t21: torch.Tensor       # [3] (unit norm)
    pts3d: torch.Tensor     # [N,3] in view-1 frame
    inliers: torch.Tensor   # [N] bool triangulated-good mask
    used_h: torch.Tensor    # bool scalar (model choice)


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Isotropic normalization (mean 0, mean abs dev 1) as the reference."""
    n = torch.clamp(valid.sum(), min=1)
    mean = torch.sum(torch.where(valid[:, None], uv, 0.0), 0) / n
    d = torch.where(valid[:, None], torch.abs(uv - mean), 0.0)
    md = torch.sum(d, 0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    T = torch.zeros(3, 3, dtype=uv.dtype, device=uv.device)
    T[0, 0], T[0, 2] = s[0], -mean[0] * s[0]
    T[1, 1], T[1, 2] = s[1], -mean[1] * s[1]
    T[2, 2] = 1.0
    return (uv - mean) * s, T


def _f_rows(uv1, uv2):
    """Rows of the 8-point system x2^T F x1 = 0: [..., M, 9]."""
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], -1)


def _h_rows(uv1, uv2):
    """Rows of the DLT system x2 ~ H x1: [..., 2M, 9]."""
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return r1, r2


def _null_vector(A: torch.Tensor, full: bool = True) -> torch.Tensor:
    """Right singular vector of the smallest singular value, as [..., 3, 3]."""
    _, _, vt = torch.linalg.svd(A, full_matrices=full)
    return vt[..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, v = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ v


def _solve_f(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """8-point algorithm on minimal sets: [..., 8, 2] x2 -> F [..., 3, 3]."""
    return _rank2(_null_vector(_f_rows(uv1, uv2)))


def _solve_h(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """4-point DLT fed 8 points for stability: H [..., 3, 3], x2 ~ H x1."""
    return _null_vector(torch.cat(_h_rows(uv1, uv2), -2))


def _refit_f(uv1n, uv2n, w):
    """Weighted least-squares 8-point refit over all inliers."""
    return _rank2(_null_vector(_f_rows(uv1n, uv2n) * w[:, None], full=False))


def _refit_h(uv1n, uv2n, w):
    r1, r2 = _h_rows(uv1n, uv2n)
    return _null_vector(torch.cat([r1 * w[:, None], r2 * w[:, None]], 0), full=False)


def _score_f(F, uv1, uv2, valid, sigma2=1.0):
    """Symmetric epipolar-distance score (Initializer::CheckFundamental)
    of [..., 3, 3] models: ([...] scores, [..., N] inliers)."""
    ones = torch.ones_like(uv1[:, :1])
    p1 = torch.cat([uv1, ones], 1)
    p2 = torch.cat([uv2, ones], 1)
    l2 = p1 @ F.transpose(-1, -2)  # lines in image 2
    l1 = p2 @ F                    # lines in image 1
    d2 = torch.sum(l2 * p2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * p1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return _score(d1 / sigma2, d2 / sigma2, CHI2_F, valid)


def _score(c1, c2, chi2, valid):
    in1 = c1 < chi2
    in2 = c2 < chi2
    score = (torch.where(in1 & valid, TH_SCORE - c1, 0.0)
             + torch.where(in2 & valid, TH_SCORE - c2, 0.0))
    return score.sum(-1), in1 & in2 & valid


def _score_h(H, uv1, uv2, valid, sigma2=1.0):
    """Symmetric transfer-error score of [..., 3, 3] homographies.  A
    singular H scores 0 with no inliers (its inverse is not finite)."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def transfer(M, src, dst):
        p = torch.cat([src, torch.ones_like(src[:, :1])], 1) @ M.transpose(-1, -2)
        z = p[..., 2]
        z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        d = p[..., :2] / z[..., None] - dst
        return torch.sum(d * d, -1)

    return _score(transfer(Hinv, uv2, uv1) / sigma2, transfer(H, uv1, uv2) / sigma2,
                  CHI2_H, valid)


def _det_sign(M: torch.Tensor) -> torch.Tensor:
    return torch.sign(torch.linalg.det(M))


def _decompose_e(E: torch.Tensor):
    """E -> 4 candidate (R, t) (Initializer::DecomposeE)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * _det_sign(u)
    vt = vt * _det_sign(vt)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H: torch.Tensor, K: torch.Tensor):
    """H -> 8 candidate (R, t) via Faugeras' SVD decomposition
    (Initializer::ReconstructH)."""
    dt, dev = H.dtype, H.device
    A = torch.linalg.inv(K) @ H @ K
    U, s, Vt = torch.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = torch.linalg.det(U) * torch.linalg.det(Vt)
    eps = 1e-9
    den = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev) * aux3
    sign4 = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros(4, dtype=dt, device=dev), torch.ones(4, dtype=dt, device=dev)

    def rot(c, s, mid, flip):
        # rows (c, 0, -flip*s), (0, mid, 0), (s, 0, flip*c), per candidate
        c4 = c.expand(4)
        return torch.stack([
            torch.stack([c4, zero, -flip * s], -1),
            torch.stack([zero, mid * one, zero], -1),
            torch.stack([s, zero, flip * c4], -1)], -2)

    # case d' > 0
    sin_t = root / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    Rp_a = rot(cos_t, sign4 * sin_t, 1.0, 1.0)
    tp_a = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)
    # case d' < 0
    sin_p = root / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    Rp_b = rot(cos_p, sign4 * sin_p, -1.0, -1.0)
    tp_b = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)
    Rp = torch.cat([Rp_a, Rp_b], 0)          # [8,3,3]
    tp = torch.cat([tp_a, tp_b], 0)          # [8,3]
    R = sdet * U @ Rp @ Vt
    t = tp @ U.T
    t = t / torch.clamp(torch.linalg.norm(t, dim=1, keepdim=True), min=1e-12)
    return R, t


def _check_rt(R, t, uv1, uv2, valid, K, sigma2=1.0):
    """Triangulate under each candidate (R [B,3,3], t [B,3]) and mark the
    good points (Initializer::CheckRT): positive depth in both views,
    reprojection < 4 sigma^2, parallax above ~0.36 degrees."""
    B = R.shape[0]
    T1 = torch.eye(4, dtype=R.dtype, device=R.device)
    T2 = T1.expand(B, 4, 4).clone()
    T2[:, :3, :3] = R
    T2[:, :3, 3] = t
    P1 = K @ T1[:3]
    P2 = K @ T2[:, :3]
    pts = tri.triangulate(P1.expand(B, 3, 4), P2, uv1, uv2)
    finite = torch.isfinite(pts).all(-1)
    z1 = tri.depths(T1, pts)
    z2 = tri.depths(T2, pts)
    e1 = tri.reprojection_error2(P1, pts, uv1)
    e2 = tri.reprojection_error2(P2, pts, uv2)
    c1 = torch.zeros(3, dtype=R.dtype, device=R.device)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    cosp = tri.parallax_cos(c1, c2, pts)
    good = (
        valid & finite & (z1 > 0) & (z2 > 0)
        & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
        & (cosp < 0.99998)
    )
    return good, pts


def draw_indices(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N_HYPOTHESES, MIN_SET] int64 draws, uniform in [0, count) with
    count = max(valid.sum(), MIN_SET) — the JAX package's
    `jax.random.randint(key, ..., 0, count)` with another generator.
    Stays on the device: count is never read on the host."""
    count = torch.clamp(valid.sum(), min=MIN_SET)
    u = torch.rand((N_HYPOTHESES, MIN_SET), generator=generator, device=valid.device)
    return torch.minimum((u * count).long(), count - 1)


def reconstruct_draws(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    draws: torch.Tensor,
    sigma2: float = 1.0,
    min_triangulated: int = 50,
) -> Reconstruction:
    """Full two-view bootstrap on [N,2] matched pixel coordinates, with
    the minimal sets given as [N_HYPOTHESES, 8] indices into the valid
    entries (in order)."""
    # map the draws onto indices of valid entries (compacted, stable order)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    sets = order[draws]  # [H,8]

    n1, T1n = _normalize(uv1, valid)
    n2, T2n = _normalize(uv2, valid)
    T2n_inv = torch.linalg.inv(T2n)
    # denormalize: F = T2' Fn T1 ; H = T2^-1 Hn T1
    F_batch = T2n.T @ _solve_f(n1[sets], n2[sets]) @ T1n
    H_batch = T2n_inv @ _solve_h(n1[sets], n2[sets]) @ T1n

    f_scores, f_in = _score_f(F_batch, uv1, uv2, valid, sigma2)
    h_scores, h_in = _score_h(H_batch, uv1, uv2, valid, sigma2)
    fi = torch.argmax(f_scores)  # first maximal index, as jnp.argmax
    hi = torch.argmax(h_scores)

    # least-squares refit on the winning inlier sets, then rescore
    F_fit = T2n.T @ _refit_f(n1, n2, f_in[fi].to(n1.dtype)) @ T1n
    H_fit = T2n_inv @ _refit_h(n1, n2, h_in[hi].to(n1.dtype)) @ T1n
    SF, f_inl = _score_f(F_fit, uv1, uv2, valid, sigma2)
    SH, h_inl = _score_h(H_fit, uv1, uv2, valid, sigma2)
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40  # Initializer.cc RH ratio

    # candidate motions from both models; evaluate all 12, pick by vote
    Re, te = _decompose_e(K.T @ F_fit @ K)
    Rh, th = _decompose_h(H_fit, K)
    R_all = torch.cat([Re, Rh], 0)   # [12,3,3]
    t_all = torch.cat([te, th], 0)
    model_in = torch.where(use_h, h_inl, f_inl)
    is_h_cand = torch.arange(12, device=uv1.device) >= 4
    allowed = torch.where(use_h, is_h_cand, ~is_h_cand)

    goods, ptss = _check_rt(R_all, t_all, uv1, uv2, model_in, K, sigma2)
    counts = torch.where(allowed, goods.sum(1), -1)
    best = torch.argmax(counts)
    n_best = counts[best]
    # winner must dominate: no runner-up with >70% of its support
    second = torch.sort(counts).values[-2]
    nin = torch.clamp(model_in.sum(), min=1)
    success = (
        (n_best >= min_triangulated)
        & (n_best.float() > 0.75 * nin.float())
        & (second.float() < 0.8 * n_best.float())
    )
    return Reconstruction(success=success, R21=R_all[best], t21=t_all[best],
                          pts3d=ptss[best], inliers=goods[best], used_h=use_h)


def reconstruct(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    generator: torch.Generator,
    sigma2: float = 1.0,
    min_triangulated: int = 50,
) -> Reconstruction:
    """`reconstruct_draws` on draws from `generator`, which must live on
    the points' device."""
    return reconstruct_draws(uv1, uv2, valid, K, draw_indices(valid, generator),
                             sigma2, min_triangulated)
