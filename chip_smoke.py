"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the main path
(the batched per-frame tracking step in the two cells of
`swarmmap_tpu_torch/cells.py`: 3 agents at EuRoC geometry, 480x752, 1000
features, 8 levels, 2048 map points; pinhole and EuRoC-distorted) and
times it.  Any failed phase is fatal.  Needs a CUDA device: without one it
exits non-zero before doing anything.

Kernel times are CUDA events around 50 back-to-back launches divided by
the count, with the stream held by a sleep kernel while the host enqueues
them (`swarmmap_tpu_torch.bench_pose.per_launch_ms`), so the wrapper's host
work is not timed; whole-step and plain-version times are the median of
CUDA events around single calls.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is {"kernels": [...]} with each kernel's launches on the
main path (and per step), its disagreement with the plain version, its
time, the plain version's, the roofline bound and the library call's.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_STEPS = 5
# kernel vs plain bars (fp32 reduction order differs between the two)
TCW_TOL = 1e-3
AGREE_MIN = {(2, 8): 0.99, (4, 10): 0.98}
MIN_INLIERS = 30


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events
    around single calls)."""
    from swarmmap_tpu_torch.cells import timed_call

    for _ in range(warmup):
        fn()
    return statistics.median(timed_call(fn)[0] for _ in range(n))


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    return kind


def phase_build() -> None:
    from swarmmap_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load("pose_lm")
    rec = _build.build_record("pose_lm")
    log(f"build pose_lm: {'cache' if rec['cached'] else 'nvcc'} "
        f"{rec['seconds']:.2f}s (load {time.perf_counter() - t0:.2f}s) -> {rec['so']}")
    if rec["ptxas"]:
        log(rec["ptxas"])


def phase_pose_kernel(dev: torch.device) -> tuple[float, dict]:
    """Kernel vs plain pose_optimize(step_tol=0) on the card at A=3, N=1024
    (EuRoC) and 2048 (KITTI), for both schedules; returns the largest
    |dTcw| and the kernel's ms per schedule and N."""
    from swarmmap_tpu_torch.bench_pose import N_AGENTS, per_launch_ms, pose_problems
    from swarmmap_tpu_torch.ops import pose_kernel, pose_opt

    worst, times = 0.0, {}
    for n, sched in ((1024, (2, 8)), (1024, (4, 10)), (2048, (2, 8)), (2048, (4, 10))):
        rounds, iters = sched
        rng = np.random.RandomState(7 + rounds + n)
        args = [x.to(dev) for x in pose_problems(rng, N_AGENTS, n, cold=(rounds == 4))]

        def kernel():
            return pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)

        def plain():
            return pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)

        rk, rp = kernel(), plain()
        torch.cuda.synchronize()
        err = float((rk.Tcw - rp.Tcw).abs().max())
        agree = float((rk.inliers == rp.inliers).float().mean())
        ms_k, ms_p = per_launch_ms(kernel), cuda_ms(plain, n=5)
        log(f"pose {rounds}x{iters} A={N_AGENTS} N={n}: max|dTcw| {err:.3g}, "
            f"inlier agreement {agree:.4f}, kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if not err < TCW_TOL or not agree > AGREE_MIN[sched]:
            fail(f"pose kernel disagrees with plain at {rounds}x{iters}, N={n}")
        worst = max(worst, err)
        times[f"{rounds}x{iters}_n{n}"] = ms_k
    return worst, times


def build_inputs(dev: torch.device):
    """Per-cell [A, ...] inputs: pinhole and EuRoC-distorted, agents 0..2."""
    from swarmmap_tpu_torch import cells as c

    t0 = time.perf_counter()
    cells = c.build_cells(dev)
    torch.cuda.synchronize()
    log(f"inputs: {c.N_AGENTS} agents x {list(cells)} at {c.HW}, "
        f"{c.N_MAP_POINTS} map points ({time.perf_counter() - t0:.1f}s)")
    return cells


def phase_main_path(cells: dict) -> dict:
    """N_STEPS batched tracking steps per cell through the public entry
    point, with the kernel's launch count reset just before and read just
    after."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.cells import N_AGENTS, STEP_KW
    from swarmmap_tpu_torch.ops import pose_kernel

    outs = {}
    pose_kernel.pose_lm_launches = 0
    for name, inp in cells.items():
        for _ in range(N_STEPS):
            outs[name] = pipeline.batched_tracking_step(inp, **STEP_KW)
    torch.cuda.synchronize()
    launches = pose_kernel.pose_lm_launches
    n_steps = N_STEPS * len(cells)
    log(f"main path: {n_steps} batched steps, pose_lm launches {launches}")
    if launches != n_steps:
        fail(f"pose_lm launched {launches} times in {n_steps} steps")
    for name, out in outs.items():
        inl = out.n_inliers.tolist()
        log(f"  {name}: n_inliers per agent {inl}")
        if tuple(out.Tcw.shape) != (N_AGENTS, 4, 4) or not bool(torch.isfinite(out.Tcw).all()):
            fail(f"{name}: pose is not a finite [{N_AGENTS},4,4] tensor")
        if min(inl) < MIN_INLIERS:
            fail(f"{name}: an agent tracked with fewer than {MIN_INLIERS} inliers")
    return {"launches": launches, "steps": n_steps, "outs": outs}


def phase_reference(cells: dict, outs: dict) -> float:
    """The card's step against references: (a) the pose stage of the same
    step through the plain pose_optimize(step_tol=0) on the card, (b) the
    whole step on the CPU, where every stage runs its plain version.
    (b) is held to |dTcw| < 5e-3 and n_inliers within max(3, 5%), not to
    equality: at width 752 the moment maps' running sums pass 2^24 and
    round in each device's scan order, so an IC angle near a steering-bin
    edge may flip its descriptor bin."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.cells import STEP_KW
    from swarmmap_tpu_torch.ops import pose_opt

    worst = 0.0
    for name, inp in cells.items():
        out = outs[name]
        prob = pipeline.match_frame(inp, **STEP_KW)[3]
        rk = pose_opt.pose_optimize_auto(*prob, rounds=2, iters=8)
        rp = pose_opt.pose_optimize(*prob, rounds=2, iters=8, step_tol=0.0)
        err = float((rk.Tcw - rp.Tcw).abs().max())
        agree = float((rk.inliers == rp.inliers).float().mean())
        log(f"  {name}: kernel vs plain pose on the step's own problem: "
            f"max|dTcw| {err:.3g}, inlier agreement {agree:.4f}")
        if not err < TCW_TOL or not agree > AGREE_MIN[(2, 8)]:
            fail(f"{name}: pose kernel disagrees with plain on the main path")
        worst = max(worst, err)

        cpu = pipeline.batched_tracking_step(
            pipeline.TrackInputs(*(x.cpu() for x in inp)), **STEP_KW)
        d_cpu = float((out.Tcw.cpu() - cpu.Tcw).abs().max())
        n_gpu, n_cpu = out.n_inliers.cpu(), cpu.n_inliers
        log(f"  {name}: card vs CPU step: max|dTcw| {d_cpu:.3g}, "
            f"n_inliers {n_gpu.tolist()} vs {n_cpu.tolist()}")
        tol = torch.clamp(torch.ceil(0.05 * n_cpu.float()), min=3)
        if not d_cpu < 5e-3 or bool(((n_gpu - n_cpu).abs() > tol).any()):
            fail(f"{name}: the card's step disagrees with the CPU step")
        overlap, total = pipeline.make_multi_agent_step(**STEP_KW)(inp)[1:]
        log(f"  {name}: overlap matrix {overlap.tolist()}, total inliers {int(total)}")
    return worst


def phase_times(cells: dict) -> dict:
    """Median CUDA-event times (ms) of the batched step per cell, of the
    pinhole step with its pose stage on the plain version, and of the plain
    pose stage alone on the step's own problem; the kernel's per-launch
    time on that problem (back-to-back launches) and its roofline bound;
    plus host wall time per step."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.bench_pose import bound, per_launch_ms
    from swarmmap_tpu_torch.cells import N_AGENTS, STEP_KW as kw
    from swarmmap_tpu_torch.ops import pose_opt

    inp = cells["pinhole"]
    prob = pipeline.match_frame(inp, **kw)[3]
    t = {f"step_{name}_ms": cuda_ms(lambda x=x: pipeline.batched_tracking_step(x, **kw), n=10)
         for name, x in cells.items()}
    t["step_pinhole_plain_pose_ms"] = cuda_ms(lambda: pose_opt.pose_optimize(
        *pipeline.match_frame(inp, **kw)[3], rounds=2, iters=8, step_tol=0.0), n=10)
    t["pose_ms"] = per_launch_ms(lambda: pose_opt.pose_optimize_auto(*prob, rounds=2, iters=8))
    t["pose_bound_ms"], t["pose_bound_by"] = bound(prob, 2, 8)
    t["pose_plain_ms"] = cuda_ms(lambda: pose_opt.pose_optimize(
        *prob, rounds=2, iters=8, step_tol=0.0), n=10)
    t0 = time.perf_counter()
    for _ in range(10):
        pipeline.batched_tracking_step(inp, **kw)
    torch.cuda.synchronize()
    t["step_pinhole_wall_ms"] = (time.perf_counter() - t0) * 100.0
    log(f"times (median ms, CUDA events; A={N_AGENTS}): " + json.dumps(t))
    for name in cells:
        log(f"  {name}: tracking fps per agent {1e3 / t[f'step_{name}_ms']:.2f}")
    return t


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is "
              "False", file=sys.stderr)
        sys.exit(2)
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    dev = torch.device("cuda", 0)
    kind = phase_device()
    phase_build()
    worst, synthetic_ms = phase_pose_kernel(dev)
    cells = build_inputs(dev)
    main_path = phase_main_path(cells)
    worst = max(worst, phase_reference(cells, main_path["outs"]))
    times = phase_times(cells)
    kernels = [{
        "name": "pose_lm", "route": "cuda",
        "source": "swarmmap_tpu_torch/csrc/pose_lm.cu",
        "replaces": "swarmmap_tpu/ops/pallas_pose.py:251",
        "launches": main_path["launches"],
        "launches_per_step": main_path["launches"] / main_path["steps"],
        "max_abs_err": worst,
        "ms": times["pose_ms"], "plain_ms": times["pose_plain_ms"],
        "bound_ms": times["pose_bound_ms"], "bound_by": times["pose_bound_by"],
        # no single PyTorch call computes an LM pose optimisation
        "library_ms": None,
        "synthetic_ms": synthetic_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
