"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the main path
(the batched per-frame tracking step of 3 agents at EuRoC geometry, 480x752,
1000 features, 8 levels, 2048 map points; pinhole and EuRoC-distorted) and
times it.  Any failed phase is fatal.  Needs a CUDA device: without one it
exits non-zero before doing anything.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is {"kernels": [...]} with each kernel's launches on the
main path, its disagreement with the plain version and both times.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_AGENTS = 3
HW = (480, 752)
N_FEATURES = 1000
N_LEVELS = 8
N_MAP_POINTS = 2048
N_STEPS = 5
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
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
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def pose_problem(rng: np.random.RandomState, n: int, schedule: tuple[int, int]):
    """One numpy-seeded pose problem (noisy projections, 20% outliers),
    shaped like the JAX package's pose tests; 4x10 starts from a colder
    guess, as the staged path does."""
    from swarmmap_tpu_torch.ops import lie

    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], 1)
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
    R = lie.so3_exp(torch.from_numpy((rng.randn(3) * 0.3).astype(np.float32))).numpy()
    t = np.array([0.2, -0.1, 0.3])
    pc = pts @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3]) @ np.diag([450.0, 450.0]) + K[:2, 2]
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.rand(n) < 0.2
    uv[out] += rng.uniform(15, 60, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    cold = schedule == (4, 10)
    xi = np.concatenate([rng.randn(3) * (0.05 if cold else 0.02),
                         rng.randn(3) * (0.15 if cold else 0.05)]).astype(np.float32)
    T0 = lie.se3_exp(torch.from_numpy(xi)).numpy() @ T
    return (T0.astype(np.float32), K, pts.astype(np.float32), uv.astype(np.float32),
            np.ones(n, np.float32), np.ones(n, bool))


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


def phase_pose_kernel(dev: torch.device) -> float:
    """Kernel vs plain pose_optimize(step_tol=0) on the card at A=3, N=1024,
    for both schedules; returns the largest |dTcw|."""
    from swarmmap_tpu_torch.ops import pose_kernel, pose_opt

    worst = 0.0
    for sched in ((2, 8), (4, 10)):
        rounds, iters = sched
        rng = np.random.RandomState(7 + rounds)
        probs = [pose_problem(rng, 1024, sched) for _ in range(N_AGENTS)]
        args = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*probs)]

        def kernel():
            return pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)

        def plain():
            return pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)

        rk, rp = kernel(), plain()
        torch.cuda.synchronize()
        err = float((rk.Tcw - rp.Tcw).abs().max())
        agree = float((rk.inliers == rp.inliers).float().mean())
        ms_k, ms_p = cuda_ms(kernel), cuda_ms(plain)
        log(f"pose {rounds}x{iters} A={N_AGENTS} N=1024: max|dTcw| {err:.3g}, "
            f"inlier agreement {agree:.4f}, kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if not err < TCW_TOL or not agree > AGREE_MIN[sched]:
            fail(f"pose kernel disagrees with plain at {rounds}x{iters}")
        worst = max(worst, err)
    return worst


def build_inputs(dev: torch.device):
    """Per-cell [A, ...] inputs: pinhole and EuRoC-distorted, agents 0..2."""
    from swarmmap_tpu_torch import pipeline

    t0 = time.perf_counter()
    cells = {}
    for name, dist in (("pinhole", (0.0,) * 5), ("distorted", EUROC_DIST)):
        cells[name] = pipeline.stack_inputs([
            pipeline.realistic_track_inputs(
                hw=HW, n_map_points=N_MAP_POINTS, seed=a, n_features=N_FEATURES,
                n_levels=N_LEVELS, dist=dist, device=dev)
            for a in range(N_AGENTS)
        ])
    torch.cuda.synchronize()
    log(f"inputs: {N_AGENTS} agents x {list(cells)} at {HW}, "
        f"{N_MAP_POINTS} map points ({time.perf_counter() - t0:.1f}s)")
    return cells


def step_kwargs() -> dict:
    return dict(n_features=N_FEATURES, n_levels=N_LEVELS, hw=HW)


def phase_main_path(cells: dict) -> dict:
    """N_STEPS batched tracking steps per cell through the public entry
    point, with the kernel's launch count reset just before and read just
    after."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.ops import pose_kernel

    outs = {}
    pose_kernel.pose_lm_launches = 0
    for name, inp in cells.items():
        for _ in range(N_STEPS):
            outs[name] = pipeline.batched_tracking_step(inp, **step_kwargs())
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
    return {"launches": launches, "outs": outs}


def phase_reference(cells: dict, outs: dict) -> float:
    """The card's step against references: (a) the pose stage of the same
    step through the plain pose_optimize(step_tol=0) on the card, (b) the
    whole step on the CPU, where every stage runs its plain version.
    (b) is held to |dTcw| < 5e-3 and n_inliers within max(3, 5%), not to
    equality: at width 752 the moment maps' running sums pass 2^24 and
    round in each device's scan order, so an IC angle near a steering-bin
    edge may flip its descriptor bin."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.ops import pose_opt

    worst = 0.0
    for name, inp in cells.items():
        out = outs[name]
        prob = pipeline.match_frame(inp, **step_kwargs())[3]
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
            pipeline.TrackInputs(*(x.cpu() for x in inp)), **step_kwargs())
        d_cpu = float((out.Tcw.cpu() - cpu.Tcw).abs().max())
        n_gpu, n_cpu = out.n_inliers.cpu(), cpu.n_inliers
        log(f"  {name}: card vs CPU step: max|dTcw| {d_cpu:.3g}, "
            f"n_inliers {n_gpu.tolist()} vs {n_cpu.tolist()}")
        tol = torch.clamp(torch.ceil(0.05 * n_cpu.float()), min=3)
        if not d_cpu < 5e-3 or bool(((n_gpu - n_cpu).abs() > tol).any()):
            fail(f"{name}: the card's step disagrees with the CPU step")
        overlap, total = pipeline.make_multi_agent_step(**step_kwargs())(inp)[1:]
        log(f"  {name}: overlap matrix {overlap.tolist()}, total inliers {int(total)}")
    return worst


def phase_times(cells: dict) -> dict:
    """Median CUDA-event times (ms) of the batched step per cell, of the
    pinhole step with its pose stage on the plain version, and of the pose
    stage alone on the step's own problem; plus host wall time per step."""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.ops import pose_opt

    kw = step_kwargs()
    inp = cells["pinhole"]
    prob = pipeline.match_frame(inp, **kw)[3]
    t = {f"step_{name}_ms": cuda_ms(lambda x=x: pipeline.batched_tracking_step(x, **kw), n=10)
         for name, x in cells.items()}
    t["step_pinhole_plain_pose_ms"] = cuda_ms(lambda: pose_opt.pose_optimize(
        *pipeline.match_frame(inp, **kw)[3], rounds=2, iters=8, step_tol=0.0), n=10)
    t["pose_ms"] = cuda_ms(lambda: pose_opt.pose_optimize_auto(*prob, rounds=2, iters=8))
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
    worst = phase_pose_kernel(dev)
    cells = build_inputs(dev)
    main_path = phase_main_path(cells)
    worst = max(worst, phase_reference(cells, main_path["outs"]))
    times = phase_times(cells)
    kernels = [{
        "name": "pose_lm", "route": "cuda",
        "source": "swarmmap_tpu_torch/csrc/pose_lm.cu",
        "replaces": "swarmmap_tpu/ops/pallas_pose.py:251",
        "launches": main_path["launches"], "max_abs_err": worst,
        "ms": times["pose_ms"], "plain_ms": times["pose_plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
