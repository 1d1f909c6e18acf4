"""Plain tracking step of a batch of agents: the front end (`orb.py`),
undistortion, local-map projection, the window and octave gate, Hamming
matching with the mutual-best check, and Levenberg-Marquardt pose
optimisation over a fixed schedule of rounds and iterations, in float64.

The semantics are the port's `pipeline.batched_tracking_step` as the
benchmark was defined (ORB-SLAM2's SearchByProjection and
PoseOptimization, `Optimizer.cc:239`): Huber delta sqrt(5.991), outliers
re-classified by chi-square between rounds, the damping halved on an
accepted step and quadrupled on a rejected one.  The pose stage here is
the plain loop that the port's CUDA kernel replaces.  Inputs and outputs
are dicts of [A, ...] tensors on one device.
"""
from __future__ import annotations

import math

import torch

from . import orb

TH_HIGH = 100
CHI2_MONO = 5.991
HUBER = math.sqrt(CHI2_MONO)
_BIG = 1 << 20
POPCOUNT_ROWS = 256  # map points per block of the Hamming matrix


def undistort(xy: torch.Tensor, K: torch.Tensor, dist: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Fixed-point inverse of the radial-tangential model (cv::undistortPoints)."""
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    k1, k2, p1, p2, k3 = (dist[:, i, None] for i in range(5))
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    x, y = xn, yn
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xn - dx) * icdist
        y = (yn - dy) * icdist
    return torch.stack([x * fx + cx, y * fy + cy], -1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, summed over the last axis."""
    x = x.long() & 0xFFFFFFFF
    n = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for b in range(32):
        n += ((x >> b) & 1).sum(-1, dtype=torch.int32)
    return n


def hamming(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """[A, Q, 8] x [A, T, 8] -> [A, Q, T] Hamming distances, by XOR."""
    out = [popcount(desc_q[:, i:i + POPCOUNT_ROWS, None, :] ^ desc_t[:, None, :, :])
           for i in range(0, desc_q.shape[1], POPCOUNT_ROWS)]
    return torch.cat(out, 1)


def hat(w: torch.Tensor) -> torch.Tensor:
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (omega, upsilon) -> [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + 1e-8)
    W = hat(w)
    W2 = W @ W
    big = theta2 > 1e-8
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    T = torch.zeros(w.shape[:-1] + (4, 4), dtype=w.dtype, device=w.device)
    T[..., :3, :3] = eye + a * W + b * W2
    T[..., :3, 3] = ((eye + b * W + c * W2) @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def project(Tcw: torch.Tensor, K: torch.Tensor, pts: torch.Tensor):
    """World points [A, M, 3] -> (pixels [A, M, 2], depth [A, M])."""
    pc = pts @ Tcw[:, :3, :3].transpose(-1, -2) + Tcw[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    uv = torch.stack([K[:, 0, 0, None] * pc[..., 0] / z + K[:, 0, 2, None],
                      K[:, 1, 1, None] * pc[..., 1] / z + K[:, 1, 2, None]], -1)
    return uv, pc[..., 2]


def residuals(Tcw, K, pts, uv):
    """Residuals [A, N, 2], their Jacobians [A, N, 2, 6] in a left se3
    update, and depths [A, N]."""
    pc = pts @ Tcw[:, :3, :3].transpose(-1, -2) + Tcw[:, None, :3, 3]
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    r = torch.stack([fx * x / z + K[:, 0, 2, None], fy * y / z + K[:, 1, 2, None]], -1) - uv
    zi = 1.0 / z
    o = torch.zeros_like(z)
    Juv = torch.stack([torch.stack([fx * zi, o, -fx * x * zi * zi], -1),
                       torch.stack([o, fy * zi, -fy * y * zi * zi], -1)], -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    return r, Juv @ torch.cat([-hat(pc), eye], -1), pc[..., 2]


def robust_cost(r, inv_sigma2, active):
    e = torch.sqrt(torch.sum(r * r, -1) * inv_sigma2 + 1e-12)
    rho = torch.where(e <= HUBER, e * e, 2 * HUBER * e - HUBER**2)
    return torch.sum(rho * active, -1)


def pose_lm(Tcw, K, pts, uv, inv_sigma2, valid, rounds: int, iters: int):
    """(Tcw [A, 4, 4], inliers [A, N]) after `rounds` x `iters` LM steps;
    an agent stops early only when a step is rejected at the largest
    damping."""
    active = valid.to(pts.dtype)
    A = Tcw.shape[0]
    eye6 = torch.eye(6, dtype=Tcw.dtype, device=Tcw.device)
    for _ in range(rounds):
        lam = torch.full((A,), 1e-3, dtype=Tcw.dtype, device=Tcw.device)
        done = torch.zeros(A, dtype=torch.bool, device=Tcw.device)
        for _ in range(iters):
            if bool(done.all()):
                break
            r, J, _ = residuals(Tcw, K, pts, uv)
            en = torch.sqrt(torch.sum(r * r, -1) * inv_sigma2 + 1e-12)
            wh = inv_sigma2 * active * torch.where(en <= HUBER, torch.ones_like(en), HUBER / en)
            H = torch.einsum("anik,an,anil->akl", J, wh, J)
            b = -torch.einsum("anik,an,ani->ak", J, wh, r)
            Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye6
            dx = torch.linalg.solve(Hd.double(), b.double()).to(Tcw.dtype)
            T_new = se3_exp(dx) @ Tcw
            r_new, _, _ = residuals(T_new, K, pts, uv)
            better = robust_cost(r_new, inv_sigma2, active) < robust_cost(r, inv_sigma2, active)
            lam_new = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            run = ~done
            Tcw = torch.where((run & better)[:, None, None], T_new, Tcw)
            lam = torch.where(run, lam_new, lam)
            done = done | (run & ~better & (lam_new >= 1e6))
        r, _, z = residuals(Tcw, K, pts, uv)
        active = (valid & (torch.sum(r * r, -1) * inv_sigma2 <= CHI2_MONO) & (z > 0)).to(pts.dtype)
    r, _, z = residuals(Tcw, K, pts, uv)
    return Tcw, valid & (torch.sum(r * r, -1) * inv_sigma2 <= CHI2_MONO) & (z > 0)


def track(inp: dict, cfg: dict) -> dict:
    """One tracked frame of each agent.  `inp`: image [A, H, W] uint8,
    Tcw_guess [A, 4, 4], K [A, 3, 3], dist [A, 5], mp_pos [A, M, 3],
    mp_desc [A, M, 8] int32, mp_max_dist [A, M], mp_valid [A, M].  Returns
    the features (xy, octave, desc, valid), match_mp [A, N] (the map point
    of each keypoint that is a pose inlier, else -1), Tcw (float64),
    n_inliers and the pose stage's problem (Tcw0, K, points, pixels,
    1/sigma^2 in float64, valid)."""
    scale, n_levels = cfg["scale_factor"], cfg["n_levels"]
    f = orb.extract(inp["image"], cfg["n_features"], n_levels, scale,
                    float(cfg["ini_th_fast"]), float(cfg["min_th_fast"]))
    K, dist = inp["K"], inp["dist"]
    plain = torch.all(dist == 0, dim=-1)
    xy_ud = torch.where(plain[:, None, None], f["xy"], undistort(f["xy"], K, dist))
    h, w = inp["image"].shape[-2:]
    corners = torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]],
                           dtype=torch.float32, device=K.device).expand(K.shape[0], 4, 2)
    cu = torch.where(plain[:, None, None], corners, undistort(corners, K, dist))
    uv, depth = project(inp["Tcw_guess"], K, inp["mp_pos"])
    visible = ((depth > 0.05) & inp["mp_valid"]
               & (uv[..., 0] >= cu[..., 0].amin(-1, keepdim=True))
               & (uv[..., 0] < cu[..., 0].amax(-1, keepdim=True))
               & (uv[..., 1] >= cu[..., 1].amin(-1, keepdim=True))
               & (uv[..., 1] < cu[..., 1].amax(-1, keepdim=True)))
    # ORB-SLAM2's MapPoint::PredictScale from the depth, and a window of
    # window_th * scale^octave around the projection
    ratio = torch.clamp(inp["mp_max_dist"] / torch.clamp(depth, min=1e-9), min=1e-9)
    log_s = torch.log(torch.tensor(scale, dtype=torch.float32)).item()
    pred = torch.clamp(torch.ceil(torch.log(ratio) / log_s).to(torch.int32), 0, n_levels - 1)
    radius = cfg["window_th"] * torch.tensor(scale, dtype=torch.float32) ** pred.float()
    oct_t = f["octave"][:, None, :]
    cand = ((torch.abs(uv[..., :, None, 0] - xy_ud[..., None, :, 0]) <= radius[..., None])
            & (torch.abs(uv[..., :, None, 1] - xy_ud[..., None, :, 1]) <= radius[..., None])
            & visible[..., :, None] & f["valid"][:, None, :]
            & (oct_t >= (pred - 1)[..., None]) & (oct_t <= (pred + 1)[..., None]))
    d = torch.where(cand, hamming(inp["mp_desc"], f["desc"]), _BIG)     # [A, M, N]
    best, best_kp = torch.min(d, dim=-1)           # each map point's nearest keypoint
    best_mp = torch.argmin(d, dim=-2)              # each keypoint's nearest map point
    mp_ids = torch.arange(d.shape[1], device=d.device)
    mutual = (best <= TH_HIGH) & (torch.gather(best_mp, -1, best_kp) == mp_ids)
    # keypoint t holds map point q when q's nearest keypoint is t and t's is q
    q = best_mp
    match = (torch.gather(mutual, -1, q)
             & (torch.gather(best_kp, -1, q) == torch.arange(d.shape[2], device=d.device)))
    match_mp = torch.where(match, q, -1).to(torch.int32)
    pts = torch.gather(inp["mp_pos"], 1, torch.clamp(match_mp, 0).long()[..., None].expand(-1, -1, 3))
    valid = (match_mp >= 0) & f["valid"]
    inv_sigma2 = 1.0 / torch.tensor(scale, dtype=torch.float32) ** (2.0 * f["octave"].float())
    # the pose in float64: the fixed schedule can leave a frame unconverged
    # along a flat direction, and there float32 rounding alone picks the path
    problem = (inp["Tcw_guess"].double(), K.double(), pts.double(), xy_ud.double(),
               inv_sigma2.double(), valid)
    Tcw, inl = pose_lm(*problem, cfg["pose_rounds"], cfg["pose_iters"])
    return {**{k: f[k] for k in ("xy", "octave", "desc", "valid")},
            "match_mp": torch.where(inl, match_mp, -1), "Tcw": Tcw,
            "n_inliers": inl.sum(-1, dtype=torch.int32),
            "problem": problem}


def active_per_round(problem: tuple, rounds: int, iters: int) -> list[int]:
    """Points of all agents active in each LM round: the valid ones in
    round 0, the inliers after r rounds in round r."""
    valid = problem[-1]
    return [int(valid.sum()) if r == 0 else int(pose_lm(*problem, r, iters)[1].sum())
            for r in range(rounds)]
