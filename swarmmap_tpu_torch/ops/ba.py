"""Bundle adjustment — the g2o replacement of local mapping, two-view
initialisation and the server's global BA.

Port of the dense and CG paths of swarmmap_tpu/ops/ba.py (reference spec:
Optimizer::LocalBundleAdjustment and Optimizer::GlobalBundleAdjustment —
Levenberg-Marquardt over camera SE(3) and point vertices with monocular
reprojection edges, Huber delta sqrt(5.991), a 5+10 iteration schedule
with chi-square outlier pruning in between, fixed frontier cameras).

The observation graph is a padded COO table; every LM iteration builds the
Schur-reduced [C*6, C*6] camera system by segment sums over observations
(`_segment_sum` where the JAX package has `segment_sum` and `.at[].add`)
and solves it exactly with `torch.linalg.solve_ex`.  The observations are
sorted by segment once per problem (`segment_plan`); every segment sum is
then a copy into a zeroed [segments, width] buffer and a sum over width,
with no atomics, so a BA gives the same bits on every run on either
device.  The LM loop runs on
the device: accept or reject is a `torch.where` on the robust cost, never
a host read.

The conjugate-gradient backend of global BA (`mode="cg"`) never builds
W: each Schur matvec is two segment sums through the same plan, and its
32 iterations run with no host sync.

`bundle_adjust_sharded` splits the observation axis over a device mesh
(`parallel.mesh.obs_mesh`): each shard holds a contiguous slice of the
observations with its own segment plan and a replica of the camera and
point state.  Every reduction over observations (the blocks, each CG
matvec, the robust cost) is a per-shard partial summed in shard order on
the mesh's lead device (`parallel.mesh.psum`, JAX's psum over the
observation axis), where the damping, the CG scalars and the LM accept
test run once; the new state is then copied to each shard.  The
one-device path is the same code over one shard, where the sum is the
identity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie
from ..parallel.mesh import all_gather, psum
from ..utils.device import default_device

CHI2_MONO = 5.991
HUBER_DELTA = float(np.sqrt(np.float32(5.991)))


class BAProblem(NamedTuple):
    Tcw: torch.Tensor            # [C,4,4]
    K: torch.Tensor              # [C,3,3] per-camera intrinsics
    cam_fixed: torch.Tensor      # [C] bool — frontier / gauge anchors
    cam_valid: torch.Tensor      # [C] bool
    pts: torch.Tensor            # [P,3]
    pt_valid: torch.Tensor       # [P] bool
    obs_cam: torch.Tensor        # [O] int64
    obs_pt: torch.Tensor         # [O] int64
    obs_uv: torch.Tensor         # [O,2]
    obs_inv_sigma2: torch.Tensor # [O]
    obs_valid: torch.Tensor      # [O] bool


class BAResult(NamedTuple):
    Tcw: torch.Tensor
    pts: torch.Tensor
    obs_chi2: torch.Tensor    # [O] final (unrobust) chi2 per observation
    obs_inlier: torch.Tensor  # [O] bool (chi2 gate + positive depth)


def build_padded_problem(
    Tcw, K, cam_fixed, pts, obs_cam, obs_pt, obs_uv, obs_inv_sigma2,
    min_cams: int = 4, min_pts: int = 256, min_obs: int = 1024,
    device: torch.device | str | None = None,
) -> BAProblem:
    """Host arrays -> a BAProblem on `device` (by default the card) with
    every axis padded to a power-of-two bucket, as the JAX package pads
    (there one compile per bucket; here the same padding, so both
    packages solve the same system)."""
    device = default_device() if device is None else device

    def bucket(n, lo):
        b = lo
        while b < n:
            b *= 2
        return b

    C, P, O = len(Tcw), len(pts), len(obs_cam)
    Cb, Pb, Ob = bucket(C, min_cams), bucket(P, min_pts), bucket(O, min_obs)

    def padr(a, n, fill=0):
        a = np.asarray(a)
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    Tcw_p = padr(Tcw, Cb)
    Tcw_p[C:] = np.eye(4)
    K_p = padr(K, Cb)
    K_p[C:] = np.eye(3)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    f32, i64 = torch.float32, torch.int64
    return BAProblem(
        Tcw=t(Tcw_p, f32), K=t(K_p, f32),
        cam_fixed=t(padr(cam_fixed, Cb, False), torch.bool),
        cam_valid=t(np.arange(Cb) < C, torch.bool),
        pts=t(padr(pts, Pb), f32),
        pt_valid=t(np.arange(Pb) < P, torch.bool),
        obs_cam=t(padr(np.asarray(obs_cam, np.int64), Ob), i64),
        obs_pt=t(padr(np.asarray(obs_pt, np.int64), Ob), i64),
        obs_uv=t(padr(np.asarray(obs_uv, np.float32).reshape(-1, 2), Ob), f32),
        obs_inv_sigma2=t(padr(obs_inv_sigma2, Ob, 1), f32),
        obs_valid=t(np.arange(Ob) < O, torch.bool),
    )


def _camera_points(Tcw, pts, p: BAProblem):
    """Per observation: its camera's pose and intrinsics, and the point in
    that camera's frame."""
    Tc = Tcw[p.obs_cam]                       # [O,4,4]
    Kc = p.K[p.obs_cam]                       # [O,3,3]
    X = pts[p.obs_pt]                         # [O,3]
    pc = torch.einsum("oij,oj->oi", Tc[:, :3, :3], X) + Tc[:, :3, 3]
    return Tc, Kc, pc


def _linearize(Tcw, pts, p: BAProblem, active):
    """Residuals r [O,2], Jc [O,2,6], Jp [O,2,3], IRLS weights w [O]."""
    Tc, Kc, pc = _camera_points(Tcw, pts, p)
    x, y = pc[:, 0], pc[:, 1]
    z = torch.clamp(pc[:, 2], min=1e-6)
    fx, fy = Kc[:, 0, 0], Kc[:, 1, 1]
    u = fx * x / z + Kc[:, 0, 2]
    v = fy * y / z + Kc[:, 1, 2]
    r = torch.stack([u, v], 1) - p.obs_uv
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    zero = torch.zeros_like(z)
    Juv = torch.stack(
        [
            torch.stack([fx * zinv, zero, -fx * x * zinv2], 1),
            torch.stack([zero, fy * zinv, -fy * y * zinv2], 1),
        ],
        1,
    )  # [O,2,3] d(uv)/d(pc)
    eye3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jpose = torch.cat([-lie.hat(pc), eye3], dim=2)  # [O,3,6]
    Jc = Juv @ Jpose                                # [O,2,6]
    Jp = Juv @ Tc[:, :3, :3]                        # [O,2,3]
    # gate fixed cameras out of the camera Jacobian (their dofs stay 0)
    free = ~p.cam_fixed[p.obs_cam]
    Jc = Jc * free[:, None, None]
    en = torch.sqrt(torch.sum(r * r, 1) * p.obs_inv_sigma2 + 1e-12)
    hub = torch.where(en <= HUBER_DELTA, 1.0, HUBER_DELTA / en)
    w = p.obs_inv_sigma2 * hub * active
    return r, Jc, Jp, w


def _robust_cost(r, inv_sigma2, active):
    en = torch.sqrt(torch.sum(r * r, 1) * inv_sigma2 + 1e-12)
    rho = torch.where(en <= HUBER_DELTA, en * en, 2 * HUBER_DELTA * en - HUBER_DELTA**2)
    return torch.sum(rho * active)


def _residual_only(Tcw, pts, p: BAProblem):
    _, Kc, pc = _camera_points(Tcw, pts, p)
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = Kc[:, 0, 0] * pc[:, 0] / z + Kc[:, 0, 2]
    v = Kc[:, 1, 1] * pc[:, 1] / z + Kc[:, 1, 2]
    return torch.stack([u, v], 1) - p.obs_uv, pc[:, 2]


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate), with the JAX package's
    clamp of a tiny determinant to 1e-12 (not to its sign)."""
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
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        -2,
    )
    return adj / det[..., None, None]


class Segments(NamedTuple):
    """One key's segment-sum plan over a problem's valid observations:
    row src[i] of a per-observation tensor goes to slot dst[i] (its
    segment * width + its rank within the segment) of a zeroed [n * width]
    buffer, and the segment sum is the sum over width."""
    src: torch.Tensor   # [V] int64
    dst: torch.Tensor   # [V] int64
    n: int
    width: int


class SegmentPlan(NamedTuple):
    cam: Segments       # by obs_cam, n = C
    pt: Segments        # by obs_pt, n = P
    pt_cam: Segments | None  # by (obs_pt, obs_cam), n = P*C; the dense backend's


def segments(key: np.ndarray, rows: np.ndarray, n: int,
             device: torch.device | str) -> Segments:
    """The plan of a segment sum of the rows `rows` of a per-row tensor
    into segments key[row] in [0, n), built on the host: the rows sorted
    stably by key, each given the next free slot of its segment."""
    order = np.argsort(key[rows], kind="stable")
    src, k = rows[order], key[rows][order]
    counts = np.bincount(k, minlength=n)
    width = max(int(counts.max(initial=0)), 1)
    rank = np.arange(len(k)) - (np.cumsum(counts) - counts)[k]
    return Segments(torch.from_numpy(src).to(device),
                    torch.from_numpy(k * width + rank).to(device), n, width)


def segment_plan(p: BAProblem, pt_cam: bool = True) -> SegmentPlan:
    """The segment sums' plans of one problem, built on the host from its
    fixed observation graph (one read of three [O] tensors per BA).
    Padded observations are left out: their IRLS weight is 0, so they add
    exactly 0 to every sum.  pt_cam=False leaves out the dense backend's
    [P*C] plan, which the CG backend never needs."""
    n_cams, n_pts = p.Tcw.shape[0], p.pts.shape[0]
    cam, pt = p.obs_cam.cpu().numpy(), p.obs_pt.cpu().numpy()
    rows = np.flatnonzero(p.obs_valid.cpu().numpy())
    dev = p.obs_cam.device
    return SegmentPlan(segments(cam, rows, n_cams, dev), segments(pt, rows, n_pts, dev),
                       segments(pt * n_cams + cam, rows, n_pts * n_cams, dev)
                       if pt_cam else None)


def _segment_sum(x, seg: Segments):
    """sum of x's rows by segment (jax.ops.segment_sum): a copy to unique
    slots and a sum over each segment's slots, the same bits on every run."""
    buf = torch.zeros((seg.n * seg.width,) + x.shape[1:], dtype=x.dtype, device=x.device)
    buf.index_copy_(0, seg.dst, x[seg.src])
    return buf.view((seg.n, seg.width) + x.shape[1:]).sum(1)


class Shard(NamedTuple):
    """One shard of a problem: the observations on one device (with the
    replicated camera and point state) and their segment plan."""
    p: BAProblem
    plan: SegmentPlan


def _replicate(x: torch.Tensor, shards: list[Shard]) -> list[torch.Tensor]:
    return [x.to(s.p.Tcw.device) for s in shards]


def _block_sums(r, Jc, Jp, w, plan: SegmentPlan):
    """One shard's gradient and Hessian diagonal blocks (its segment sums)."""
    bc = -_segment_sum(torch.einsum("oik,o,oi->ok", Jc, w, r), plan.cam)      # [C,6]
    bp = -_segment_sum(torch.einsum("oik,o,oi->ok", Jp, w, r), plan.pt)       # [P,3]
    Hcc = _segment_sum(torch.einsum("oik,o,oil->okl", Jc, w, Jc), plan.cam)   # [C,6,6]
    Hpp = _segment_sum(torch.einsum("oik,o,oil->okl", Jp, w, Jp), plan.pt)    # [P,3,3]
    return bc, bp, Hcc, Hpp


def _common_blocks(lin: list, shards: list[Shard], lam):
    """Gradient and damped diagonal Hessian blocks of one LM iteration:
    each shard's segment sums (lin[i] = shard i's (r, Jc, Jp, w)), summed
    across shards, then damped on the lead device."""
    p = shards[0].p
    bc, bp, Hcc, Hpp = psum([_block_sums(*l, s.plan) for l, s in zip(lin, shards)],
                             p.Tcw.device)
    # LM damping: H + lam*diag(H), multiplicative for scale invariance
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    dHcc = Hcc + (lam * torch.diagonal(Hcc, dim1=1, dim2=2))[..., None] * eye6
    dHpp = Hpp + (lam * torch.diagonal(Hpp, dim1=1, dim2=2))[..., None] * eye3
    # anchor fixed/invalid cameras and dead points with identity blocks
    anchored = p.cam_fixed | ~p.cam_valid
    dHcc = torch.where(anchored[:, None, None], eye6, dHcc) + 1e-8 * eye6
    dHpp = torch.where(~p.pt_valid[:, None, None], eye3, dHpp) + 1e-9 * eye3
    return bc, bp, dHcc, _inv3x3(dHpp)


def _dense_schur_solve(r, Jc, Jp, w, p: BAProblem, lam, plan: SegmentPlan):
    """The reduced camera system built and solved exactly (one device)."""
    n_cams, n_pts = plan.cam.n, plan.pt.n
    bc, bp, dHcc, Hpp_inv = _common_blocks([(r, Jc, Jp, w)], [Shard(p, plan)], lam)
    # W[p,c] = sum_obs Jc^T W Jp : [P,C,6,3]
    blocks = torch.einsum("oik,o,oil->okl", Jc, w, Jp)  # [O,6,3]
    Wpc = _segment_sum(blocks, plan.pt_cam).view(n_pts, n_cams, 6, 3)
    Y = torch.einsum("pcij,pjk->pcik", Wpc, Hpp_inv)    # [P,C,6,3]
    S = torch.zeros((n_cams, 6, n_cams, 6), dtype=r.dtype, device=r.device)
    ar = torch.arange(n_cams, device=r.device)
    S[ar, :, ar, :] = dHcc
    S = S - torch.einsum("pcij,pdkj->cidk", Y, Wpc)
    b_s = bc - torch.einsum("pcij,pj->ci", Y, bp)
    # solve_ex: no error check, so no host sync per LM iteration on the card
    dxc = torch.linalg.solve_ex(
        S.reshape(n_cams * 6, n_cams * 6), b_s.reshape(-1)
    )[0].reshape(n_cams, 6)
    dxp = torch.einsum("pjk,pk->pj", Hpp_inv, bp - torch.einsum("pcij,ci->pj", Wpc, dxc))
    return dxc, dxp


def _cg_schur_solve(lin: list, shards: list[Shard], lam, cg_iters: int):
    """The reduced camera system solved by Jacobi-preconditioned conjugate
    gradients, never materialising W: each Schur matvec is two segment
    sums over the observations, per shard, summed across shards.  The CG
    scalars are computed once, on the lead device.  cg_iters fixed
    iterations, no host sync."""
    bc, bp, dHcc, Hpp_inv = _common_blocks(lin, shards, lam)
    lead = bc.device

    def Wt_v(v):  # [C,6] -> [P,3] :  W^T v
        parts = []
        for (_, Jc, Jp, w), s, vs in zip(lin, shards, _replicate(v, shards)):
            t = torch.einsum("oik,ok->oi", Jc, vs[s.p.obs_cam])
            parts.append(_segment_sum(torch.einsum("oik,o,oi->ok", Jp, w, t), s.plan.pt))
        return psum(parts, lead)

    def W_y(y):  # [P,3] -> [C,6] :  W y
        parts = []
        for (_, Jc, Jp, w), s, ys in zip(lin, shards, _replicate(y, shards)):
            t = torch.einsum("oik,ok->oi", Jp, ys[s.p.obs_pt])
            parts.append(_segment_sum(torch.einsum("oik,o,oi->ok", Jc, w, t), s.plan.cam))
        return psum(parts, lead)

    def S_mv(v):
        hv = torch.einsum("cij,cj->ci", dHcc, v)
        return hv - W_y(torch.einsum("pjk,pk->pj", Hpp_inv, Wt_v(v)))

    Minv = _6x6_inv(dHcc)
    b_s = bc - W_y(torch.einsum("pjk,pk->pj", Hpp_inv, bp))
    x = torch.zeros_like(b_s)
    rr = b_s - S_mv(x)
    zz = torch.einsum("cij,cj->ci", Minv, rr)
    pp = zz
    rz = torch.sum(rr * zz)
    for _ in range(cg_iters):
        Ap = S_mv(pp)
        alpha = rz / torch.clamp(torch.sum(pp * Ap), min=1e-12)
        x = x + alpha * pp
        rr = rr - alpha * Ap
        zz = torch.einsum("cij,cj->ci", Minv, rr)
        rz_new = torch.sum(rr * zz)
        pp = zz + rz_new / torch.clamp(rz, min=1e-12) * pp
        rz = rz_new
    dxp = torch.einsum("pjk,pk->pj", Hpp_inv, bp - Wt_v(x))
    return x, dxp


def _6x6_inv(H):
    """Batched inverse of the damped camera blocks; inv_ex, so no error
    check and no host sync."""
    return torch.linalg.inv_ex(H)[0]


def _lm_phase(shards: list[Shard], Tcw, pts, active: list, iters, solve):
    """`iters` LM steps on the active observations (active[i]: shard i's
    weights); a step is kept where it lowers the robust cost (lambda
    x0.5), else dropped (lambda x4).  The state lives on the lead device
    and is copied to each shard for its per-observation work; the cost is
    summed across shards, so every shard takes the same step.
    solve(lin, shards, lam) -> (dxc, dxp) is the backend."""
    p = shards[0].p
    lead = p.Tcw.device
    moving = ~(p.cam_fixed | ~p.cam_valid)
    lam = torch.tensor(1e-4, dtype=Tcw.dtype, device=lead)
    for _ in range(iters):
        lin = [_linearize(T, X, s.p, a) for s, T, X, a in
               zip(shards, _replicate(Tcw, shards), _replicate(pts, shards), active)]
        dxc, dxp = solve(lin, shards, lam)
        # guard fixed cams / dead points
        dxc = dxc * moving[:, None]
        dxp = dxp * p.pt_valid[:, None]
        Tcw_new = lie.se3_exp(dxc) @ Tcw
        pts_new = pts + dxp
        c_new = psum([_robust_cost(_residual_only(T, X, s.p)[0], s.p.obs_inv_sigma2, a)
                       for s, T, X, a in zip(shards, _replicate(Tcw_new, shards),
                                             _replicate(pts_new, shards), active)], lead)
        c_old = psum([_robust_cost(l[0], s.p.obs_inv_sigma2, a)
                       for l, s, a in zip(lin, shards, active)], lead)
        ok = c_new < c_old
        Tcw = torch.where(ok, Tcw_new, Tcw)
        pts = torch.where(ok, pts_new, pts)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return Tcw, pts


def _chi2(shards: list[Shard], Tcw, pts) -> list[tuple]:
    """Per shard: (chi2 [O_i], positive depth [O_i]) of its observations."""
    out = []
    for s, T, X in zip(shards, _replicate(Tcw, shards), _replicate(pts, shards)):
        r, z = _residual_only(T, X, s.p)
        out.append((torch.sum(r * r, 1) * s.p.obs_inv_sigma2, z > 0))
    return out


def _bundle_adjust_shards(shards: list[Shard], iters_a: int, iters_b: int, chi2_th: float,
                          solve) -> BAResult:
    """The two-phase schedule over the shards; results on the lead device
    (the per-observation outputs in shard order)."""
    p = shards[0].p
    lead, dtype = p.Tcw.device, p.Tcw.dtype
    Tcw, pts = _lm_phase(shards, p.Tcw, p.pts, [s.p.obs_valid.to(dtype) for s in shards],
                         iters_a, solve)
    keep = [(s.p.obs_valid & (chi2 <= chi2_th) & front).to(dtype)
            for s, (chi2, front) in zip(shards, _chi2(shards, Tcw, pts))]
    Tcw, pts = _lm_phase(shards, Tcw, pts, keep, iters_b, solve)
    final = _chi2(shards, Tcw, pts)
    inlier = [s.p.obs_valid & (chi2 <= chi2_th) & front
              for s, (chi2, front) in zip(shards, final)]
    return BAResult(Tcw=Tcw, pts=pts, obs_chi2=all_gather([c for c, _ in final], lead),
                    obs_inlier=all_gather(inlier, lead))


def bundle_adjust(
    p: BAProblem,
    iters_a: int = 5,
    iters_b: int = 10,
    chi2_th: float = CHI2_MONO,
    mode: str = "dense",
    cg_iters: int = 32,
) -> BAResult:
    """Two-phase BA mirroring the reference schedule: iters_a LM steps,
    chi-square outlier pruning, iters_b more steps, final classification.
    mode="dense" solves the reduced camera system exactly (local BA);
    mode="cg" by cg_iters conjugate-gradient steps (global BA).  Runs on
    the problem's device."""
    if mode == "dense":
        def solve(lin, shards, lam):
            return _dense_schur_solve(*lin[0], shards[0].p, lam, shards[0].plan)
    elif mode == "cg":
        def solve(lin, shards, lam):
            return _cg_schur_solve(lin, shards, lam, cg_iters=cg_iters)
    else:
        raise ValueError(f"bundle_adjust: unknown mode {mode!r}")
    shards = [Shard(p, segment_plan(p, pt_cam=mode == "dense"))]
    return _bundle_adjust_shards(shards, iters_a, iters_b, chi2_th, solve)


def _shard_problem(p: BAProblem, mesh) -> list[Shard]:
    """The problem split over `mesh`: shard i holds the i-th contiguous
    slice of the observations and a copy of the camera and point state on
    mesh.devices[i], with its own segment plan (built on the host from its
    slice).  Observation indices stay global."""
    n = mesh.size()
    O = p.obs_cam.shape[0]
    if O % n:
        raise ValueError(f"obs axis {O} must divide mesh size {n}")
    k = O // n
    obs = {"obs_cam", "obs_pt", "obs_uv", "obs_inv_sigma2", "obs_valid"}
    shards = []
    for i, dev in enumerate(mesh.devices):
        sp = BAProblem(**{f: (x[i * k:(i + 1) * k] if f in obs else x).to(dev)
                          for f, x in p._asdict().items()})
        shards.append(Shard(sp, segment_plan(sp, pt_cam=False)))
    return shards


def bundle_adjust_sharded(
    p: BAProblem,
    mesh,
    iters_a: int = 5,
    iters_b: int = 10,
    chi2_th: float = CHI2_MONO,
    cg_iters: int = 32,
) -> BAResult:
    """Observation-sharded global BA over a device mesh
    (`parallel.mesh.obs_mesh`; SURVEY.md §5: the server's joint
    optimisation sharded across devices).  The same math as
    bundle_adjust(mode="cg"): the observations split into contiguous
    shards (`_shard_problem`), the camera and point state replicates, and
    every reduction over observations is summed across shards in shard
    order, so two runs give the same bits.  The observation axis must
    divide the mesh size; build_padded_problem's power-of-two buckets
    guarantee that for obs_mesh's power-of-two meshes.  Results land on
    the mesh's lead device."""
    def solve(lin, shards, lam):
        return _cg_schur_solve(lin, shards, lam, cg_iters=cg_iters)

    return _bundle_adjust_shards(_shard_problem(p, mesh), iters_a, iters_b, chi2_th, solve)
