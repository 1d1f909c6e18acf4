"""Time the LM pose kernel (csrc/pose_lm.cu) on the card.

    python -m swarmmap_tpu_torch.bench_pose [--parent DIR] [--out DIR]

Times this checkout's kernel, and with --parent the kernel of another
checkout (DIR/swarmmap_tpu_torch/csrc/pose_lm.cu, for example a `git
archive` of the parent commit unpacked under the gitignored `_scratch/`),
on synthetic problems of 3 agents: N = 1024 points at the schedules 1x1,
1x8, 2x8 and 4x10, and N = 2048 at 2x8 and 4x10.  Each kernel is called
through its C entry point with preallocated outputs, in turns (parent,
this, this, parent), timed as CUDA events around 50 back-to-back launches,
and cross-checked with torch.profiler's device time.  Reports each
design's per-LM-step slope and fixed cost (a least-squares line over the
N = 1024 sweep), its agreement with the plain version, the roofline bound
and ptxas's register and spill report.  Prints one JSON line and writes it
to DIR/bench_pose.json.  Needs a CUDA device.

The helpers (`pose_problems`, `per_launch_ms`, `bound`,
`record_pose_calls`, `against_plain`) are shared with chip_smoke.py and
the GPU tests.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# Work the function needs, counted from lm_pass, solve6 and se3_exp_compose
# in csrc/pose_lm.cu (FLOP = one add, multiply, compare, reciprocal or
# square root).  The chi2 of a point at one pose: R X + t 18, clamp and 1/z 2,
# the u and v residuals 8, chi2 4, the z > 0 test 1.
FLOP_CHI2 = 33
# An active point in one pass: its chi2 33; Huber norm, weight and cost 7 and
# the weight 2; d(uv)/d(pc) 7 and the two Jacobian rows 10; the weighted
# rows 10 (Ju[4] = Jv[3] = 0); the 21 H terms 60 (10 with both rows at 2
# multiplies and 2 adds, 10 with one row at 2, H[3][4] = 0); the 6 b terms
# 20; the cost 2.
FLOP_PER_POINT_PASS = 151
# One LM step of one agent: the damped 6x6 block solve 227, the SE(3) exp
# and its left composition 157, the accept test and lambda 4.
FLOP_PER_STEP = 388
# bytes per point: pts 12, uv 8, 1/sigma^2 4, valid 1 in; chi2 4, inlier 1 out
BYTES_PER_POINT = 30
BYTES_PER_AGENT = 164  # T0 64, K 36 in; Tout 64 out
# H100 SXM, NVIDIA's data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 100_000_000  # ~50 ms of a held stream while the host enqueues

SWEEP = ((1024, 1, 1), (1024, 1, 8), (1024, 2, 8), (1024, 4, 10), (2048, 2, 8), (2048, 4, 10))
N_AGENTS = 3


def pose_problems(rng: np.random.RandomState, n_agents: int, n: int, cold: bool):
    """[A, ...] CPU tensors (Tcw0, K, pts_w, uv, inv_sigma2, valid): noisy
    projections of random points with 20% outliers, three octave sigmas,
    5% invalid slots, and a perturbed start (motion-model grade, or cold as
    the 4x10 staged path)."""
    from .ops import lie

    out = []
    for _ in range(n_agents):
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(4, 8, n)], 1)
        K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
        R = lie.so3_exp(torch.from_numpy((rng.randn(3) * 0.3).astype(np.float32))).numpy()
        t = np.array([0.2, -0.1, 0.3])
        pc = pts @ R.T + t
        uv = (pc[:, :2] / pc[:, 2:3]) * 450.0 + K[:2, 2]
        uv += rng.normal(0, 0.5, uv.shape)
        bad = rng.rand(n) < 0.2
        uv[bad] += rng.uniform(15, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        s_w, s_t = (0.05, 0.15) if cold else (0.02, 0.05)
        xi = np.concatenate([rng.randn(3) * s_w, rng.randn(3) * s_t]).astype(np.float32)
        T0 = lie.se3_exp(torch.from_numpy(xi)).numpy() @ T
        is2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n).astype(np.float32)
        out.append((T0.astype(np.float32), K, pts.astype(np.float32),
                    uv.astype(np.float32), is2, rng.rand(n) < 0.95))
    return [torch.from_numpy(np.stack(x)) for x in zip(*out)]


def active_per_round(prob, rounds: int, iters: int) -> list[int]:
    """Active points of all agents in each round of the fixed schedule, as
    this problem's data makes them: round 0 takes every valid point, round
    r the inliers after r rounds (the plain version run for r rounds)."""
    from .ops import pose_opt

    return [int(prob[5].sum()) if r == 0 else int(pose_opt.pose_optimize(
        *prob, rounds=r, iters=iters, step_tol=0.0).inliers.sum()) for r in range(rounds)]


def bound(prob, rounds: int, iters: int) -> tuple[float, str]:
    """(least milliseconds the card could take, "operations" or "bytes")
    for one optimisation of prob (Tcw0, K, pts_w, uv, inv_sigma2, valid).
    Operations: in each round a pass over its active points at its start
    and at every LM step's candidate; one chi2 of each point outside a
    round's active set where the next re-gate or the output reads it; one
    solve and exp per agent and step.  Bytes: each input read and each
    output written once.  With iters <= 10 no round ends early: that takes
    15 rejects in a row."""
    A, N = prob[5].shape
    valid = int(prob[5].sum())
    active = active_per_round(prob, rounds, iters)
    flops = (sum(active) * (iters + 1) * FLOP_PER_POINT_PASS
             + sum(valid - a for a in active[:-1]) * FLOP_CHI2
             + (A * N - (active[-1] if active else 0)) * FLOP_CHI2
             + A * rounds * iters * FLOP_PER_STEP)
    nbytes = A * N * BYTES_PER_POINT + A * BYTES_PER_AGENT
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def per_launch_ms(fn, count: int = 50, warmup: int = 3) -> float:
    """Device milliseconds per call of fn (which launches kernels and does
    not synchronise): CUDA events around `count` back-to-back calls.  A
    sleep kernel holds the stream while the host enqueues them, so the
    host work of each call does not fall inside the timed window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(count):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / count


@contextlib.contextmanager
def record_pose_calls():
    """Within the block, every call of `pose_opt.pose_optimize_auto` (the
    dispatcher that every caller goes through) is kept as (its arguments
    bound to its signature with the defaults applied, its result) in the
    list that the block receives.  The arguments are kept by reference:
    every caller hands the dispatcher tensors it does not write again."""
    from .ops import pose_opt

    inner, calls = pose_opt.pose_optimize_auto, []
    sig = inspect.signature(inner)

    def recorded(*args, **kw):
        res = inner(*args, **kw)
        bound_args = sig.bind(*args, **kw)
        bound_args.apply_defaults()
        calls.append((dict(bound_args.arguments), res))
        return res

    pose_opt.pose_optimize_auto = recorded
    try:
        yield calls
    finally:
        pose_opt.pose_optimize_auto = inner


def against_plain(calls) -> list[dict]:
    """Each recorded call's result against the plain `pose_optimize` at
    step_tol = 0 (the kernel's fixed schedule) on the same tensors: its
    schedule, point slots, max |dTcw| and inlier agreement."""
    from .ops import pose_opt

    out = []
    for args, res in calls:
        plain = pose_opt.pose_optimize(**args, step_tol=0.0)
        out.append({"schedule": (args["rounds"], args["iters"]),
                    "n": int(args["valid"].shape[-1]),
                    "err": float((res.Tcw - plain.Tcw).abs().max()),
                    "agree": float((res.inliers == plain.inliers).float().mean())})
    return out


def profiled_ms(fn, count: int = 20) -> float | None:
    """Mean device time (ms) of the pose_lm_kernel launches of `count`
    calls under torch.profiler; None if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "pose_lm_kernel" in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def raw_launcher(launch, args: list[torch.Tensor], rounds: int, iters: int):
    """(fn, outputs): fn launches `launch` (a typed pose_lm_launch) once on
    the current stream into preallocated outputs."""
    from .ops.pose_opt import CHI2_MONO, PoseOptResult

    A, N = args[2].shape[:2]
    dev = args[0].device
    out = PoseOptResult(torch.empty((A, 4, 4), device=dev),
                        torch.empty((A, N), dtype=torch.bool, device=dev),
                        torch.empty((A, N), device=dev))
    ptrs = [x.data_ptr() for x in args]
    optrs = [x.data_ptr() for x in out]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fn():
        err = launch(*ptrs, A, N, rounds, iters, CHI2_MONO, *optrs, stream)
        if err != 0:
            raise RuntimeError(f"pose_lm_launch failed: cudaError_t {err}")

    return fn, out


def line_fit(steps: list[int], ms: list[float]) -> dict:
    """Least-squares ms = fixed + slope * steps."""
    slope, fixed = np.polyfit(np.asarray(steps, float), np.asarray(ms, float), 1)
    return {"slope_us_per_step": slope * 1e3, "fixed_us": fixed * 1e3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout whose csrc/pose_lm.cu is timed beside this one")
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_pose needs a CUDA device")

    from . import _build
    from .ops import pose_kernel, pose_opt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    designs = {"this": pose_kernel.bind(_build.load("pose_lm"))}
    ptxas = {"this": _build.build_record("pose_lm")["ptxas"]}
    if args.parent:
        src = Path(args.parent) / "swarmmap_tpu_torch" / "csrc" / "pose_lm.cu"
        designs["parent"] = pose_kernel.bind(_build.load("pose_lm_parent", src))
        ptxas["parent"] = _build.build_record("pose_lm_parent")["ptxas"]
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]

    rows = []
    for n, rounds, iters in SWEEP:
        rng = np.random.RandomState(1000 + n + 10 * rounds + iters)
        prob = [x.to(dev) for x in pose_problems(rng, N_AGENTS, n, cold=(rounds == 4))]
        plain = pose_opt.pose_optimize(*prob, rounds=rounds, iters=iters, step_tol=0.0)
        fns = {k: raw_launcher(f, prob, rounds, iters) for k, f in designs.items()}
        times = {k: [] for k in designs}
        for k in order:
            times[k].append(per_launch_ms(fns[k][0]))
        row = {"n": n, "agents": N_AGENTS, "rounds": rounds, "iters": iters}
        row["bound_ms"], row["bound_by"] = bound(prob, rounds, iters)
        for k, (fn, out) in fns.items():
            fn()
            torch.cuda.synchronize()
            ms = float(np.mean(times[k]))
            row[k] = {
                "ms": ms, "ms_runs": times[k], "profiler_ms": profiled_ms(fn),
                "roofline_share": row["bound_ms"] / ms,
                "max_abs_dTcw_vs_plain": float((out.Tcw - plain.Tcw).abs().max()),
                "inlier_agreement": float((out.inliers == plain.inliers).float().mean()),
            }
        rows.append(row)
        print(json.dumps(row), flush=True)

    sweep = [r for r in rows if r["n"] == 1024]
    steps = [r["rounds"] * r["iters"] for r in sweep]
    fits = {k: line_fit(steps, [r[k]["ms"] for r in sweep]) for k in designs}
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "rows": rows, "fit_n1024": fits, "ptxas": ptxas}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench_pose.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"fit_n1024": fits}))
    for k, rep in ptxas.items():
        print(f"ptxas ({k}): " + "; ".join(
            ln.strip() for ln in rep.splitlines() if "stack frame" in ln or "Used" in ln))


if __name__ == "__main__":
    main()
