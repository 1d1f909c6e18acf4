"""Wrapper of the hand-written LM pose kernel (csrc/pose_lm.cu).

Replaces the TPU kernel swarmmap_tpu/ops/pallas_pose.py:pose_optimize_pallas.
The plain PyTorch version of the same function is
`pose_opt.pose_optimize(..., step_tol=0.0)`; `pose_opt.pose_optimize_auto`
routes CUDA tensors here and CPU tensors there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .pose_opt import CHI2_MONO, PoseOptResult

# launches of pose_lm_kernel in this process (bumped only where it launches)
pose_lm_launches = 0

_P = ctypes.c_void_p

THREADS = 256        # threads per CTA; one CTA per agent
PPT_BUILDS = (4, 8)  # the register builds' points per thread
STREAMING = 0        # LaunchConfig.ppt of the streaming build


class LaunchConfig(NamedTuple):
    ppt: int      # points each thread holds in registers; STREAMING: none
    threads: int  # threads per CTA


def launch_config(n: int) -> LaunchConfig:
    """The build of the kernel that takes N points per agent (the same
    choice as pose_lm_launch in csrc/pose_lm.cu): pose_lm_kernel with 4
    points per thread in registers up to N = 1024 and 8 up to N = 2048,
    pose_lm_stream_kernel (points read from global memory on each pass)
    above."""
    for ppt in PPT_BUILDS:
        if n <= ppt * THREADS:
            return LaunchConfig(ppt, THREADS)
    return LaunchConfig(STREAMING, THREADS)


def bind(lib: ctypes.CDLL):
    """The typed C entry point pose_lm_launch of a build of csrc/pose_lm.cu."""
    fn = lib.pose_lm_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_fn():
    """The C entry point, built and typed at first use."""
    return bind(_build.load("pose_lm"))


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pose_optimize_cuda(
    Tcw0: torch.Tensor,
    K: torch.Tensor,
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 2,
    iters: int = 8,
    chi2_th: float = CHI2_MONO,
) -> PoseOptResult:
    """A agents' LM pose optimisations in one kernel launch.

    Tcw0 [A,4,4], K [A,3,3], pts_w [A,N,3], uv [A,N,2], inv_sigma2 [A,N]
    fp32 and valid [A,N] bool, all contiguous on one CUDA device, any N
    (`launch_config` names the build).  Returns Tcw [A,4,4], inliers [A,N]
    bool, chi2 [A,N].  Launches on the current stream and does not
    synchronise."""
    global pose_lm_launches
    A, N = pts_w.shape[0], pts_w.shape[1]
    dev = Tcw0.device
    f32 = torch.float32
    for name, t, shape, dt in (
        ("Tcw0", Tcw0, (A, 4, 4), f32), ("K", K, (A, 3, 3), f32),
        ("pts_w", pts_w, (A, N, 3), f32), ("uv", uv, (A, N, 2), f32),
        ("inv_sigma2", inv_sigma2, (A, N), f32), ("valid", valid, (A, N), torch.bool),
    ):
        _check(name, t, shape, dt, dev)
    if rounds < 0 or iters < 0:
        raise ValueError("rounds and iters must be >= 0")
    launch = _launch_fn()
    Tout = torch.empty((A, 4, 4), dtype=f32, device=dev)
    inl = torch.empty((A, N), dtype=torch.bool, device=dev)
    chi2 = torch.empty((A, N), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            Tcw0.data_ptr(), K.data_ptr(), pts_w.data_ptr(), uv.data_ptr(),
            inv_sigma2.data_ptr(), valid.data_ptr(), A, N, rounds, iters,
            float(chi2_th), Tout.data_ptr(), inl.data_ptr(), chi2.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"pose_lm_kernel launch failed: cudaError_t {err}")
    pose_lm_launches += 1
    return PoseOptResult(Tcw=Tout, inliers=inl, chi2=chi2)
