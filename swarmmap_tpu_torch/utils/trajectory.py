"""Trajectory output and ATE evaluation, and rotation <-> quaternion.

Copy of swarmmap_tpu/utils/trajectory.py's `rot_to_quat`, `quat_to_rot`
(`MapStore.set_transform` needs them), `save_tum` (the reference's TUM
writer, System::SaveKeyFrameTrajectoryTUM) and the evo-equivalent
`umeyama_align` + `ate_rmse`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM convention."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            x, w = 0.25 * s, (R[2, 1] - R[1, 2]) / s
            y, z = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            y, w = 0.25 * s, (R[0, 2] - R[2, 0]) / s
            x, z = (R[0, 1] + R[1, 0]) / s, (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            z, w = 0.25 * s, (R[1, 0] - R[0, 1]) / s
            x, y = (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )



def save_tum(path: str | Path, timestamps: np.ndarray, poses_wc: np.ndarray) -> None:
    """poses_wc: [N,4,4] camera-to-world (Twc), matching the reference output."""
    lines = []
    for ts, T in zip(timestamps, poses_wc):
        q = rot_to_quat(T[:3, :3])
        t = T[:3, 3]
        lines.append(
            f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def umeyama_align(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Similarity (s, R, t) minimizing ||dst - (s R src + t)||^2  [Umeyama 1991]."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_t: np.ndarray, gt_t: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after Sim(3) alignment (evo-style)."""
    s, R, t = umeyama_align(est_t, gt_t, with_scale)
    aligned = est_t @ (s * R).T + t
    return float(np.sqrt(((aligned - gt_t) ** 2).sum(axis=1).mean()))
