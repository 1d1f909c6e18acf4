"""SO(3) / SE(3) / Sim(3) closed forms on tensors.

Port of swarmmap_tpu/ops/lie.py with the same conventions:

  - Rotations stored as 3x3 matrices (f32), poses as 4x4 (row [0,0,0,1]).
  - se3 tangent ordered (omega[3], upsilon[3]) — rotation first.
  - sim3 tangent ordered (omega[3], upsilon[3], sigma) — log-scale last.
  - All functions broadcast over leading batch dims.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] skew-symmetric."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [...,3] -> [...,3,3]."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    big = theta2 > 1e-8
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3(w) + a * W + b * W2


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,4] quaternion (x,y,z,w), Shepperd's branch-free
    selection (all four candidates computed, then selected)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([(r21 - r12) / s0, (r02 - r20) / s0, (r10 - r01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2
    q1 = torch.stack([0.25 * s1, (r01 + r10) / s1, (r02 + r20) / s1, (r21 - r12) / s1], -1)
    s2 = safe_sqrt(1.0 + r11 - r00 - r22) * 2
    q2 = torch.stack([(r01 + r10) / s2, 0.25 * s2, (r12 + r21) / s2, (r02 - r20) / s2], -1)
    s3 = safe_sqrt(1.0 + r22 - r00 - r11) * 2
    q3 = torch.stack([(r02 + r20) / s3, (r12 + r21) / s3, 0.25 * s3, (r10 - r01) / s3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((r00 > r11) & (r00 > r22))[..., None]
    use2 = (r11 > r22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3], robust at all angles (via quaternion)."""
    q = mat_to_quat(R)
    q = torch.where(q[..., 3:4] < 0, -q, q)  # w >= 0: principal branch
    v = q[..., :3]
    w = q[..., 3]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn > 1e-7, theta / torch.clamp(vn, min=_EPS),
                        2.0 / torch.clamp(w, min=_EPS))
    return scale[..., None] * v


def _so3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): exp-map translation coupling."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    big = theta2 > 1e-8
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye3(w) + b * W + c * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[...,6] (omega, upsilon) -> [...,4,4]."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_V(w) @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    Vinv = torch.linalg.inv(_so3_V(w))
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] to points [...,3] (broadcasting)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


# ---------------------------------------------------------------------------
# Sim(3): represented as (R [...,3,3], t [...,3], s [...])
# Acts on points as  x -> s * R x + t   (g2o sim3 convention)
# ---------------------------------------------------------------------------

def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_mul(R1, t1, s1, R2, t2, s2):
    """Composition: S1 * S2 (apply S2 first)."""
    R = R1 @ R2
    t = s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1
    return R, t, s1 * s2


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ t[..., None])[..., 0]
    return Rt, t_inv, s_inv


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The Sim(3) exp-map translation coupling  Wmat = C I + A W + B W².

    All four (sigma ~ 0) x (theta ~ 0) regimes use exact limits with
    division guards keyed on the raw squared angle, so values stay finite
    at the identity."""
    theta2 = torch.sum(w * w, -1)
    eps_th = theta2 < 1e-10
    eps_sig = torch.abs(sigma) < 1e-6
    one = torch.ones_like(theta2)
    th2s = torch.where(eps_th, one, theta2)       # safe denominators
    theta = torch.sqrt(th2s)
    sig_s = torch.where(eps_sig, one, sigma)
    W = hat(w)
    W2 = W @ W

    C = torch.where(eps_sig, 1.0 + sigma / 2.0, (s - 1.0) / sig_s)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    den = sigma * sigma + theta2
    den_s = torch.where(eps_th & eps_sig, one, den)

    # general (sigma != 0, theta != 0)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / torch.where(eps_th, one, theta * den_s)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / den_s) / th2s
    # sigma -> 0 limits (any theta)
    A_sig0 = torch.where(eps_th, 0.5 * one, (1.0 - torch.cos(theta)) / th2s)
    B_sig0 = torch.where(eps_th, one / 6.0, (theta - torch.sin(theta)) / (th2s * theta))
    # theta -> 0 limits (sigma != 0)
    sig2_s = torch.where(eps_sig, one, sigma * sigma)
    A_th0 = (s * sigma - s + 1.0) / sig2_s
    B_th0 = (C - s + s * sigma / 2.0) / sig2_s

    A = torch.where(eps_sig, A_sig0, torch.where(eps_th, A_th0, A_gen))
    B = torch.where(eps_sig, B_sig0, torch.where(eps_th, B_th0, B_gen))
    return (C[..., None, None] * _eye3(w) + A[..., None, None] * W
            + B[..., None, None] * W2)


def sim3_exp(xi: torch.Tensor):
    """[...,7] (omega, upsilon, sigma) -> (R, t, s).

    Closed-form Sim(3) exponential (Strasdat's W-matrix derivation)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(w)
    s = torch.exp(sigma)
    Wmat = _sim3_W(w, sigma, s)
    t = (Wmat @ v[..., None])[..., 0]
    return R, t, s


def sim3_log(R, t, s):
    """(R, t, s) -> [...,7]; inverse of sim3_exp."""
    w = so3_log(R)
    sigma = torch.log(s)
    Wmat = _sim3_W(w, sigma, s)
    # solve_ex: no error check, so no host sync inside the LM loops
    v = torch.linalg.solve_ex(Wmat, t[..., None])[0][..., 0]
    return torch.cat([w, v, sigma[..., None]], -1)


def project(K: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points [...,3] -> pixels [...,2]."""
    z = torch.clamp(pc[..., 2:3], min=1e-6)
    xy = pc[..., :2] / z
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], -1)



def sim3_adjoint(R, t, s):
    """[..., 7, 7] Ad(S) of S = (R, t, s) on (omega, upsilon, sigma):
    S exp(xi) S^-1 = exp(Ad(S) xi)."""
    batch = R.shape[:-2]
    z3, z31 = R.new_zeros(batch + (3, 3)), R.new_zeros(batch + (3, 1))
    top = torch.cat([R, z3, z31], -1)
    mid = torch.cat([hat(t) @ R, s[..., None, None] * R, -t[..., None]], -1)
    bot = torch.cat([R.new_zeros(batch + (1, 6)), R.new_ones(batch + (1, 1))], -1)
    return torch.cat([top, mid, bot], -2)


def sim3_ad(xi: torch.Tensor) -> torch.Tensor:
    """[..., 7, 7] ad(xi), the Lie bracket [xi, .] of sim(3)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    batch = xi.shape[:-1]
    W = hat(w)
    z3, z31 = xi.new_zeros(batch + (3, 3)), xi.new_zeros(batch + (3, 1))
    top = torch.cat([W, z3, z31], -1)
    mid = torch.cat([hat(v), W + sigma[..., None, None] * _eye3(xi), -v[..., None]], -1)
    return torch.cat([top, mid, xi.new_zeros(batch + (1, 7))], -2)


def sim3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """[..., 7, 7] inverse left Jacobian of sim(3) at xi, the series
    sum_n B_n / n! ad(xi)^n to n = 8: log(exp(a) exp(xi)) = xi +
    J^-1(xi) a + O(|a|^2).  The first omitted term is |ad(xi)|^10 / 4.8e7
    of the whole, below float32's resolution for |xi| < 3."""
    A = sim3_ad(xi)
    A2 = A @ A
    A4 = A2 @ A2
    eye7 = torch.eye(7, dtype=xi.dtype, device=xi.device)
    return (eye7 - 0.5 * A + A2 / 12.0 - A4 / 720.0 + (A4 @ A2) / 30240.0
            - (A4 @ A4) / 1209600.0)
