"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the main paths
and times them.  Any failed phase is fatal.  Needs a CUDA device: without
one it exits non-zero before doing anything.  The paths:

- the batched per-frame tracking step in the two cells of
  `swarmmap_tpu_torch/cells.py` (3 agents at EuRoC geometry, 480x752, 1000
  features, 8 levels, 2048 map points; pinhole and EuRoC-distorted);
- the per-agent tracker (`core/tracking.py`, `Tracking.grab`) on
  make_world(seed=4) at the same geometry with 1500 landmarks: 40 RGB-D
  frames (the staged path, two 4x10 pose_lm launches per frame), a depth
  frame then 20 monocular frames (the fused path, one 2x8 launch per
  frame), and a relocalisation (RANSAC PnP with its 3x8 refinement, then
  4x10), each against ground truth and its first frames against the same
  tracker on the CPU; every pose_lm launch of these paths is held against
  the plain version on the tensors it was given.

Kernel times are CUDA events around 50 back-to-back launches divided by
the count, with the stream held by a sleep kernel while the host enqueues
them (`swarmmap_tpu_torch.bench_pose.per_launch_ms`), so the wrapper's host
work is not timed; whole-step and plain-version times are the median of
CUDA events around single calls.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is {"kernels": [...]} with each kernel's launches on the
main paths (per path, per step and per frame), its disagreement with the
plain version, its time, the plain version's, the roofline bound and the
library call's.
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
AGREE_MIN = {(2, 8): 0.99, (3, 8): 0.98, (4, 10): 0.98}
MIN_INLIERS = 30
# the tracker phases
RGBD_FRAMES = 40
MONO_FRAMES = 20
CPU_FRAMES = 5
MAX_MEDIAN_TRANS_ERR = 0.05  # m, the bar of tests/test_rgbd_stereo.py


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


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q))


def _reset_counts() -> None:
    from swarmmap_tpu_torch.ops import pose_kernel
    from swarmmap_tpu_torch.utils.stats import STATS

    STATS.reset()
    pose_kernel.pose_lm_launches = 0


def _read_counts() -> tuple[int, dict]:
    from swarmmap_tpu_torch.ops import pose_kernel
    from swarmmap_tpu_torch.utils.stats import STATS

    torch.cuda.synchronize()
    return pose_kernel.pose_lm_launches, dict(STATS.counts)


def _path_summary(name: str, records, launches: int) -> dict:
    """Per-frame ms (median, p90), fetches and launches per frame of the
    frames `records` of one tracker path, and `launches`, the phase's
    whole count; printed and returned."""
    ms = [r.ms for r in records]
    fetches = [r.counts.get("rpc_fetch", 0) for r in records]
    out = {"frames": len(records), "launches": launches,
           "launches_per_frame": float(np.mean([r.counts["pose_lm"] for r in records])),
           "ms_median": _pct(ms, 50), "ms_p90": _pct(ms, 90),
           "fetches_per_frame_median": _pct(fetches, 50),
           "fetches_per_frame_mean": float(np.mean(fetches))}
    log(f"  tracker {name}: " + json.dumps(out))
    log(f"  tracker {name}: fetches per frame {fetches}")
    return out


def _hold_to_plain(name: str, calls) -> float:
    """The pose_lm launches that `record_pose_calls` kept on one tracker
    path against the plain pose_optimize(step_tol=0) on the same card
    tensors, per schedule; returns the largest |dTcw|."""
    from swarmmap_tpu_torch.bench_pose import against_plain

    rows = against_plain(calls)
    for sched in sorted({r["schedule"] for r in rows}):
        rs = [r for r in rows if r["schedule"] == sched]
        err, agree = max(r["err"] for r in rs), min(r["agree"] for r in rs)
        log(f"  tracker {name}: kernel vs plain on its {len(rs)} calls at "
            f"{sched[0]}x{sched[1]}, N {sorted({r['n'] for r in rs})}: max|dTcw| "
            f"{err:.3g}, least inlier agreement {agree:.4f}")
        if not err < TCW_TOL or not agree > AGREE_MIN[sched]:
            fail(f"tracker {name}: pose kernel disagrees with plain at {sched}")
    return max(r["err"] for r in rows)


def _pnp_ms(dev: torch.device, K: np.ndarray) -> float:
    """Host ms of one ransac_pnp, to its fetch, on 256 exact projections of
    random points."""
    from swarmmap_tpu_torch.ops import pnp

    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-2, 2, 256), rng.uniform(-2, 2, 256),
                    rng.uniform(3, 8, 256)], 1).astype(np.float32)
    uv = (pts[:, :2] / pts[:, 2:] * np.diag(K)[:2] + K[:2, 2]).astype(np.float32)
    args = [torch.from_numpy(x).to(dev)
            for x in (pts, uv, np.ones(256, bool), K.astype(np.float32))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = bool(pnp.ransac_pnp(*args, torch.Generator(device=dev).manual_seed(0)).success)
    ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        fail("ransac_pnp found no pose for exact projections")
    return ms


def phase_tracker(dev: torch.device) -> dict:
    """The per-agent tracker's three phases on the card, each driven with
    the counts set to 0 just before it and read just after and with its
    pose_lm launches recorded and held to the plain version, then the first
    CPU_FRAMES frames of the RGB-D and fused phases again on the CPU."""
    from swarmmap_tpu_torch.bench_pose import record_pose_calls
    from swarmmap_tpu_torch.cells import (compare_records, new_tracker, render_frames,
                                          track_frame, track_sequence, tracker_world)

    t0 = time.perf_counter()
    world = tracker_world()
    frames = render_frames(world, RGBD_FRAMES)
    log(f"tracker world: {world.points.shape[0]} landmarks, {world.hw}, "
        f"{len(frames)} frames rendered ({time.perf_counter() - t0:.1f}s)")
    paths = {}

    # RGB-D: every frame takes the staged path
    _reset_counts()
    with record_pose_calls() as calls:
        rgbd = track_sequence(new_tracker(world, dev), frames, range(RGBD_FRAMES))
    launches, counts = _read_counts()
    states = [r.state for r in rgbd]
    if states != ["OK"] * RGBD_FRAMES:
        fail(f"tracker rgbd: states {states}")
    errs = []
    T0, G0 = np.linalg.inv(rgbd[0].pose_cw), world.poses_wc[0]
    for i, r in enumerate(rgbd):
        e = np.linalg.inv(T0) @ np.linalg.inv(r.pose_cw)
        g = np.linalg.inv(G0) @ world.poses_wc[i]
        errs.append(float(np.linalg.norm(e[:3, 3] - g[:3, 3])))
    log(f"tracker rgbd: {states.count('OK')}/{RGBD_FRAMES} frames OK, inliers "
        f"{min(r.inliers for r in rgbd[1:])}-{max(r.inliers for r in rgbd[1:])}, "
        f"map {rgbd[-1].n_kf} keyframes / {rgbd[-1].n_mp} points, median translation "
        f"error {np.median(errs):.4f} m (max {max(errs):.4f}), pose_lm launches {launches}, "
        f"_pose_opt_frame calls {counts.get('pose_opt_frame', 0)}")
    if not np.median(errs) < MAX_MEDIAN_TRANS_ERR:
        fail(f"tracker rgbd: median translation error {np.median(errs):.4f} m")
    if launches != counts.get("pose_opt_frame", 0) or launches < 2 * (RGBD_FRAMES - 1):
        fail(f"tracker rgbd: {launches} pose_lm launches for "
             f"{counts.get('pose_opt_frame', 0)} _pose_opt_frame calls")
    paths["tracker_rgbd"] = _path_summary("rgbd (staged)", rgbd[1:], launches)
    paths["tracker_rgbd"]["max_abs_err"] = _hold_to_plain("rgbd", calls)

    # a depth bootstrap, then monocular frames: the fused path
    _reset_counts()
    with record_pose_calls() as calls:
        fused = track_sequence(new_tracker(world, dev), frames[:MONO_FRAMES + 1], {0})
    launches, counts = _read_counts()
    log(f"tracker fused: states {sorted(set(r.state for r in fused))}, fused_frames "
        f"{fused[-1].fused_frames}, pose_lm launches {launches} = fused steps "
        f"{counts.get('fused_step', 0)} + _pose_opt_frame calls {counts.get('pose_opt_frame', 0)}")
    fused_recs = [r for r in fused if r.counts.get("fused_step") and "pose_opt_frame" not in r.counts]
    if [r.state for r in fused] != ["OK"] * (MONO_FRAMES + 1):
        fail("tracker fused: a frame was not tracked")
    if fused[-1].fused_frames != MONO_FRAMES - 1 or len(fused_recs) != MONO_FRAMES - 1:
        fail(f"tracker fused: {fused[-1].fused_frames} fused frames, not {MONO_FRAMES - 1}")
    if any(r.counts["pose_lm"] != 1 for r in fused_recs) or launches != (
            counts.get("fused_step", 0) + counts.get("pose_opt_frame", 0)):
        fail("tracker fused: pose_lm launches do not match the fused and staged calls")
    paths["tracker_fused"] = _path_summary("fused", fused_recs, launches)
    paths["tracker_fused"]["max_abs_err"] = _hold_to_plain("fused", calls)

    # relocalisation: depth init on frame 0, LOST, frame 0's image again.
    # The process's first RANSAC PnP pays a one-time set-up, timed apart on
    # a small problem (first and second call); a first relocalisation on a
    # throwaway tracker then warms the rest, and the asserted one is timed
    # warm.
    img0, d0 = frames[0]

    def lost_tracker():
        tracker = new_tracker(world, dev)
        tracker.grab(img0, 0.0, depth_image=d0)
        tracker.state = type(tracker.state).LOST
        return tracker

    pnp_first, pnp_second = _pnp_ms(dev, world.K), _pnp_ms(dev, world.K)
    first = track_frame(lost_tracker(), img0, None, 0.05)
    tracker = lost_tracker()
    _reset_counts()
    with record_pose_calls() as calls:
        rec = track_frame(tracker, img0, None, 0.05)
    launches, counts = _read_counts()
    log(f"tracker reloc (frame 0's image): state {rec.state}, relocalized "
        f"{counts.get('relocalized', 0)}, ransac_pnp {counts.get('ransac_pnp', 0)}, "
        f"pose_lm launches {launches} (3x8 in ransac_pnp + 4x10 in "
        f"{counts.get('pose_opt_frame', 0)} _pose_opt_frame), inliers {rec.inliers}, "
        f"{rec.ms:.1f} ms warm; the process's first relocalisation {first.ms:.1f} ms, "
        f"its first ransac_pnp (256 points) {pnp_first:.1f} ms, the second {pnp_second:.1f} ms")
    if rec.state != "OK" or counts.get("relocalized", 0) != 1:
        fail("tracker reloc: no relocalisation against keyframe 0 on frame 0's image")
    if launches != counts.get("ransac_pnp", 0) + counts.get("pose_opt_frame", 0):
        fail("tracker reloc: pose_lm launches do not match the ransac_pnp and "
             "_pose_opt_frame calls")
    paths["tracker_reloc"] = {"frames": 1, "launches": launches, "launches_per_frame": launches,
                              "ransac_pnp": counts.get("ransac_pnp", 0), "ms": rec.ms,
                              "ms_first_reloc": first.ms, "pnp_first_ms": pnp_first,
                              "pnp_second_ms": pnp_second,
                              "max_abs_err": _hold_to_plain("reloc", calls)}
    rec1 = track_frame(lost_tracker(), frames[1][0], None, 0.05)
    log(f"tracker reloc (frame 1, not asserted): state {rec1.state}, relocalized "
        f"{rec1.counts.get('relocalized', 0)}, {rec1.ms:.1f} ms")

    # the same tracker on the CPU: the first frames of the two sequences
    for name, recs, depth_frames in (("rgbd", rgbd, range(CPU_FRAMES)), ("fused", fused, {0})):
        cpu = track_sequence(new_tracker(world, "cpu"), frames[:CPU_FRAMES], depth_frames)
        diffs = compare_records(recs[:CPU_FRAMES], cpu)
        worst = max(np.abs(a.pose_cw - b.pose_cw).max() for a, b in zip(recs, cpu))
        log(f"tracker {name} card vs CPU, {CPU_FRAMES} frames: max|dTcw| {worst:.3g}, "
            f"inliers {[r.inliers for r in recs[:CPU_FRAMES]]} vs {[r.inliers for r in cpu]}")
        if diffs:
            fail(f"tracker {name}: the card disagrees with the CPU: {diffs}")
    return paths


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
    tracker_paths = phase_tracker(dev)
    worst = max(worst, *(p["max_abs_err"] for p in tracker_paths.values()))
    times = phase_times(cells)
    per_path = {"batched_step": {"steps": main_path["steps"],
                                 "launches": main_path["launches"]}, **tracker_paths}
    kernels = [{
        "name": "pose_lm", "route": "cuda",
        "source": "swarmmap_tpu_torch/csrc/pose_lm.cu",
        "replaces": "swarmmap_tpu/ops/pallas_pose.py:251",
        "launches": sum(p["launches"] for p in per_path.values()),
        "launches_per_path": per_path,
        "launches_per_step": main_path["launches"] / main_path["steps"],
        "launches_per_frame": {
            "batched_step": main_path["launches"] / main_path["steps"],
            "staged": tracker_paths["tracker_rgbd"]["launches_per_frame"],
            "fused": tracker_paths["tracker_fused"]["launches_per_frame"],
            "relocalisation": tracker_paths["tracker_reloc"]["launches_per_frame"]},
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
