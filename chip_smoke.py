"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

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
  the plain version on the tensors it was given;
- the monocular client (`core/system.py`, `System.track_monocular`) on
  synthesize_sequence(seed=0, motion="arc") at the same geometry with
  1500 landmarks, 40 frames: two-view initialisation, the dense initial BA,
  tracking (fused frames one 2x8 launch, staged frames two 4x10) and local
  mapping (triangulate + fuse, local BA, culling) of every keyframe; held
  to initialisation by frame 2, 36 of 40 frames tracked, 3 keyframes
  mapped, 100 map points, every pose_lm launch to the plain version, and
  its first 8 frames to the CPU on the card's two-view draws; then 48 runs
  seeded 0-47, each held to initialisation by frame 2 and 36 frames
  tracked, and their count with an ATE at or above 5% of the span to the
  JAX package's rate at this size; with per-frame, per-mapping-stage,
  per-BA and two-view times.  With --out DIR, the 48 runs' two-view draws
  go to DIR/mono_draws.npz (`tests/ate_spread_mono.py port --draws` replays
  them on the CPU);
- the agent's side of the swarm (`swarm.SwarmAgent`, the `sync/` layer,
  `System.save_map` / `load_map`) on the same sequence: a state report and
  a push every 10 frames, each push decoded and applied to a replica store
  that must end equal to the agent's map bit for bit, the replica's pull
  distributed back after frame 29 with the agent tracking on as the
  uninterrupted run did, and the map saved in both formats, loaded into a
  fresh client and relocalised against (2 of frames 10, 20, 30); wire
  bytes and encode / decode / apply / save / load times;
- `python -m swarmmap_tpu_torch.bench` (bench.py's tracking metrics), its
  distorted inliers held to the CPU step's.

The pose kernel is held to the plain version on synthetic problems at
N = 1024 and 2048 (its register builds) and 2049 and 4096 (its streaming
build), at 2x8 and 4x10.

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

import contextlib
import json
import math
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
    """The CUDA kernel, and the host library (g++) that the tracker's
    quadtree and local mapping's culling call, so no phase's times hold a
    build."""
    from swarmmap_tpu_torch import _build, native

    t0 = time.perf_counter()
    _build.load("pose_lm")
    rec = _build.build_record("pose_lm")
    log(f"build pose_lm: {'cache' if rec['cached'] else 'nvcc'} "
        f"{rec['seconds']:.2f}s (load {time.perf_counter() - t0:.2f}s) -> {rec['so']}")
    if rec["ptxas"]:
        log(rec["ptxas"])
    native.get_lib()
    rec = _build.build_record("native")
    log(f"build native (host): {'cache' if rec['cached'] else 'g++'} {rec['seconds']:.2f}s "
        f"-> {rec['so']}")


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


def phase_pose_large(dev: torch.device) -> tuple[float, dict]:
    """The streaming build (N > 2048) against plain pose_optimize(step_tol=0)
    on the card at A=3, N = 2049 and 4096, for both schedules, with the
    bars of phase_pose_kernel; returns the largest |dTcw| and the kernel's
    ms, the plain version's and the bound per schedule and N."""
    from swarmmap_tpu_torch.bench_pose import N_AGENTS, bound, per_launch_ms, pose_problems
    from swarmmap_tpu_torch.ops import pose_kernel, pose_opt

    worst, times = 0.0, {}
    for n in (2049, 4096):
        if pose_kernel.launch_config(n).ppt != pose_kernel.STREAMING:
            fail(f"launch_config({n}) does not pick the streaming build")
        for rounds, iters in ((2, 8), (4, 10)):
            rng = np.random.RandomState(11 + rounds + n)
            args = [x.to(dev) for x in pose_problems(rng, N_AGENTS, n, cold=(rounds == 4))]

            def kernel():
                return pose_opt.pose_optimize_auto(*args, rounds=rounds, iters=iters)

            def plain():
                return pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)

            rk, rp = kernel(), plain()
            torch.cuda.synchronize()
            err = float((rk.Tcw - rp.Tcw).abs().max())
            agree = float((rk.inliers == rp.inliers).float().mean())
            ms_k, ms_p = per_launch_ms(kernel), cuda_ms(plain, n=5)
            b_ms, b_by = bound(args, rounds, iters)
            log(f"pose streaming {rounds}x{iters} A={N_AGENTS} N={n}: max|dTcw| {err:.3g}, "
                f"inlier agreement {agree:.4f}, kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
                f"bound {b_ms * 1e3:.3f} us ({b_by})")
            if not err < TCW_TOL or not agree > AGREE_MIN[(rounds, iters)]:
                fail(f"pose streaming build disagrees with plain at {rounds}x{iters}, N={n}")
            worst = max(worst, err)
            times[f"{rounds}x{iters}_n{n}"] = {"ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                                               "bound_by": b_by}
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


def inliers_disagree(card: list[int], cpu: list[int]) -> bool:
    """Whether per-agent inliers differ by more than max(3, 5%) of the CPU's."""
    return any(abs(a - b) > max(3, math.ceil(0.05 * b)) for a, b in zip(card, cpu))


def phase_reference(cells: dict, outs: dict) -> tuple[float, dict]:
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

    worst, cpu_inliers = 0.0, {}
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
        cpu_inliers[name] = n_cpu.tolist()
        log(f"  {name}: card vs CPU step: max|dTcw| {d_cpu:.3g}, "
            f"n_inliers {n_gpu.tolist()} vs {n_cpu.tolist()}")
        if not d_cpu < 5e-3 or inliers_disagree(n_gpu.tolist(), cpu_inliers[name]):
            fail(f"{name}: the card's step disagrees with the CPU step")
        overlap, total = pipeline.make_multi_agent_step(**STEP_KW)(inp)[1:]
        log(f"  {name}: overlap matrix {overlap.tolist()}, total inliers {int(total)}")
    return worst, cpu_inliers


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


MONO_CPU_FRAMES = 8
MONO_BARS = {"init_by": 2, "tracked": 36, "keyframes": 3, "points": 100, "ate_share": 0.05}
# One run's ATE is heavy-tailed in the two-view RANSAC draws (the seed
# changes nothing else).  The JAX package's System on the CPU at this
# cell's size (tests/ate_spread_mono.py jax, rng_seed 0-47) has MONO_REF_TAIL
# = (runs at or above 5% of the span, runs).  So every run seeded
# 0..MONO_ATE_SEEDS-1 is held to initialisation by frame 2 and 36 frames
# tracked, and the count of runs at or above 5% to the 99th percentile of
# that rate.
MONO_ATE_SEEDS = 48
MONO_REF_TAIL = (22, 48)
MAPPING_STAGES = ("lm_process_new", "lm_cull_mps", "lm_tri_fuse", "lm_triangulate",
                  "lm_fuse", "lm_local_ba", "lm_cull_kfs")


@contextlib.contextmanager
def _recorded_ba_calls():
    """Within the block, every `ops.ba.bundle_adjust` call (the initial BA
    and each local BA) is timed from an idle card to the end of its work
    and kept with its problem, its real and bucketed (C, P, O) and its
    iterations."""
    from swarmmap_tpu_torch.ops import ba

    inner, calls = ba.bundle_adjust, []

    def recorded(p, iters_a=5, iters_b=10, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(p, iters_a=iters_a, iters_b=iters_b, **kw)
        torch.cuda.synchronize()
        calls.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "real": [int(p.cam_valid.sum()), int(p.pt_valid.sum()), int(p.obs_valid.sum())],
            "bucket": [p.Tcw.shape[0], p.pts.shape[0], p.obs_cam.shape[0]],
            "iters": [iters_a, iters_b], "problem": p})
        return res

    ba.bundle_adjust = recorded
    try:
        yield calls
    finally:
        ba.bundle_adjust = inner


def _twoview_ms_pair() -> None:
    """Host ms of the process's first and second `twoview.reconstruct`, to
    its fetch, on 300 noisy correspondences of a general scene: the first
    holds the one-time set-up of the card's batched SVD.  Prints one JSON
    line; run in a fresh process by phase_mono."""
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)
    from swarmmap_tpu_torch.ops import twoview

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                    rng.uniform(4, 8, 300)], 1)
    K = np.array([[450.0, 0, 376], [0, 450.0, 240], [0, 0, 1]])
    t = np.array([0.6, 0.0, 0.05])
    uv1 = pts[:, :2] / pts[:, 2:] * 450.0 + K[:2, 2]
    pc = pts + t
    uv2 = pc[:, :2] / pc[:, 2:] * 450.0 + K[:2, 2] + rng.normal(0, 0.4, (300, 2))
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (uv1, uv2)]
    args += [torch.ones(300, dtype=torch.bool, device=dev),
             torch.tensor(K, dtype=torch.float32, device=dev)]
    out = []
    for seed in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bool(twoview.reconstruct(*args, torch.Generator(device=dev).manual_seed(seed)).success)
        out.append({"ms": (time.perf_counter() - t0) * 1e3, "success": ok})
    print(json.dumps(out))


def _mono_frames(recs, init: int) -> dict:
    """ms per frame (median, p90, count) of the init frame, the fused
    frames that inserted no keyframe, every staged frame (few: the frame
    after init, fallbacks; a staged frame that inserts a keyframe holds its
    mapping), and the frames that inserted a keyframe (local mapping runs
    inside their grab); pose_lm launches per frame over each path's
    frames."""
    after = recs[init + 1:]
    fused = [r for r in after if r.counts.get("fused_step") and "pose_opt_frame" not in r.counts]
    staged = [r for r in after if "pose_opt_frame" in r.counts]

    def keyframe(r):
        return r.since_kf == 0 and r.state == "OK"

    def summary(frames, timed):
        ms = [r.ms for r in timed]
        return {"frames": len(timed), "ms_median": _pct(ms, 50) if ms else None,
                "ms_p90": _pct(ms, 90) if ms else None,
                "pose_lm_per_frame": float(np.mean([r.counts["pose_lm"] for r in frames]))
                if frames else None}

    return {"init": summary([recs[init]], [recs[init]]),
            "fused": summary(fused, [r for r in fused if not keyframe(r)]),
            "staged": summary(staged, staged),
            "keyframe": summary([r for r in after if keyframe(r)],
                                [r for r in after if keyframe(r)])}


def _seed_run(seed: int, recs: list, system, seq, draws: list) -> dict:
    """One seeded run of the monocular client: the frame it initialised
    at, frames tracked, keyframes, map points, its ATE as a share of its
    own span (inf if it never tracked), and its two-view draws."""
    from swarmmap_tpu_torch.cells import ate_share

    poses = {i: r.pose_cw for i, r in enumerate(recs) if r.pose_cw is not None}
    rmse, span = ate_share(poses, seq.world) if poses else (float("inf"), 1.0)
    init = next((i for i, r in enumerate(recs) if r.state == "OK"), len(recs))
    return {"seed": seed, "init_frame": init, "tracked": len(poses),
            "keyframes": system.n_keyframes(), "map_points": system.n_map_points(),
            "ate_share": rmse / span, "draws": list(draws)}


def _tail_bound(n: int, k_ref: int, n_ref: int, q: float = 0.99) -> int:
    """The least m with P(Binomial(n, k_ref / n_ref) <= m) >= q."""
    p, cdf = k_ref / n_ref, 0.0
    for m in range(n + 1):
        cdf += math.comb(n, m) * p ** m * (1 - p) ** (n - m)
        if cdf >= q:
            return m
    return n


def phase_mono(dev: torch.device, out_dir: str | None = None) -> dict:
    """The monocular client (`System.track_monocular`: two-view
    initialisation, dense initial BA, tracking, local mapping with its
    triangulate + fuse and local BA) on `cells.mono_sequence()` on the
    card, with the counts set to 0 just before and read just after, every
    pose_lm launch held to the plain version, then its first
    MONO_CPU_FRAMES frames again on the CPU with the card's RANSAC draws;
    then MONO_ATE_SEEDS runs seeded 0.. for the ATE (their draws saved to
    out_dir/mono_draws.npz when out_dir is given)."""
    from swarmmap_tpu_torch.bench_pose import record_pose_calls
    from swarmmap_tpu_torch.cells import (ate_share, mono_sequence, new_system,
                                          recorded_draws, replayed_draws,
                                          state_disagreements, track_mono)
    from swarmmap_tpu_torch.utils.stats import STATS

    out = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke._twoview_ms_pair()"],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"mono: the fresh-process twoview timing failed: {out.stderr[-2000:]}")
    twoview_fresh = json.loads(out.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    seq = mono_sequence()
    log(f"mono sequence: {seq.world.points.shape[0]} landmarks, {seq.world.hw}, "
        f"{len(seq)} frames rendered ({time.perf_counter() - t0:.1f}s)")
    system = new_system(seq, dev)
    mapper = system.local_mapping
    pk_ms = []
    inner_pk = mapper.process_keyframe

    def process_keyframe(k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inner_pk(k)
        torch.cuda.synchronize()
        pk_ms.append((time.perf_counter() - t1) * 1e3)

    mapper.process_keyframe = process_keyframe
    _reset_counts()
    with record_pose_calls() as calls, _recorded_ba_calls() as ba_calls, \
            recorded_draws() as draws:
        recs = track_mono(system, seq)
    launches, counts = _read_counts()
    stage_ms = {k: [1e3 * x for x in STATS.times.get(k, [])] for k in MAPPING_STAGES}
    twoview_ms = [1e3 * x for x in STATS.times.get("twoview", [])]
    poses = {i: r.pose_cw for i, r in enumerate(recs) if r.pose_cw is not None}
    ok = [i for i, r in enumerate(recs) if r.state == "OK"]
    init = ok[0] if ok else len(recs)
    rmse, span = ate_share(poses, seq.world) if poses else (float("inf"), 1.0)
    res = {"init_frame": init, "init_points": recs[init].n_mp if ok else 0,
           "tracked": len(poses), "frames": len(recs),
           "keyframes": system.n_keyframes(), "keyframes_inserted": recs[-1].n_kf,
           "map_points": system.n_map_points(), "process_keyframe_calls": len(pk_ms),
           "ate_m": rmse, "span_m": span, "ate_share": rmse / span,
           "launches": launches, "fused_steps": counts.get("fused_step", 0),
           "pose_opt_frame": counts.get("pose_opt_frame", 0),
           "merged_fuse_fallback": counts.get("lm_merged_fuse_fallback", 0),
           "twoview_calls": len(draws), "states": [r.state for r in recs]}
    log("mono: " + json.dumps(res))
    frames = _mono_frames(recs, min(init, len(recs) - 1))
    log("mono ms per frame (host clock around track_monocular, ends in a fetch): "
        + json.dumps(frames))
    log(f"mono process_keyframe ms per keyframe (median {_pct(pk_ms, 50):.2f}, p90 "
        f"{_pct(pk_ms, 90):.2f}): {[round(x, 2) for x in pk_ms]}")
    for k, v in stage_ms.items():
        if v:
            log(f"  mapping stage {k}: {len(v)} calls, median {_pct(v, 50):.2f} ms, "
                f"p90 {_pct(v, 90):.2f} ms, total {sum(v):.1f} ms")
    for c in ba_calls:
        log(f"  BA real (C, P, O) {tuple(c['real'])}, bucket {tuple(c['bucket'])}, "
            f"{c['iters'][0]}+{c['iters'][1]} iterations: {c['ms']:.2f} ms")
    log(f"mono twoview ms: in the phase {[round(x, 2) for x in twoview_ms]}; a fresh "
        f"process's first (cold) and second (warm) call on 300 correspondences "
        f"{[round(x['ms'], 2) for x in twoview_fresh]}")
    log(f"mono lm_merged_fuse_fallback: {res['merged_fuse_fallback']}")

    # two card runs of the largest local BA problem, bit for bit
    big = max(ba_calls[1:] or ba_calls, key=lambda c: c["real"][2])
    from swarmmap_tpu_torch.ops import ba

    r1, r2 = (ba.bundle_adjust(big["problem"], *big["iters"]) for _ in range(2))
    same = all(torch.equal(getattr(r1, f), getattr(r2, f)) for f in ba.BAResult._fields)
    diff = float((r1.Tcw - r2.Tcw).abs().max())
    log(f"mono BA determinism: two card runs of the BA at {tuple(big['real'])} agree bit for "
        f"bit: {same} (max |dTcw| {diff:.3g})")
    res.update(frames=frames, process_keyframe_ms=pk_ms, stage_ms=stage_ms,
               ba_calls=[{k: c[k] for k in ("ms", "real", "bucket", "iters")} for c in ba_calls],
               twoview_ms=twoview_ms, twoview_fresh=twoview_fresh, ba_bitwise_equal=same)

    # the first frames again on the CPU, on the card run's two-view draws
    t0 = time.perf_counter()
    with replayed_draws(list(draws)):
        cpu = track_mono(new_system(seq, "cpu"), seq, MONO_CPU_FRAMES)
    diffs = state_disagreements(recs[:MONO_CPU_FRAMES], cpu)
    worst = max((float(np.abs(a.pose_cw - b.pose_cw).max()) for a, b in
                 zip(recs, cpu) if a.pose_cw is not None and b.pose_cw is not None), default=0.0)
    log(f"mono card vs CPU, {MONO_CPU_FRAMES} frames ({time.perf_counter() - t0:.1f}s): "
        f"max|dTcw| {worst:.3g}, states {[r.state for r in cpu]}, keyframes / points "
        f"{[(r.n_kf, r.n_mp) for r in recs[:MONO_CPU_FRAMES]]} vs {[(r.n_kf, r.n_mp) for r in cpu]}")

    # every seeded run (the run above is rng_seed 0), its ATE over its own span
    t0 = time.perf_counter()
    runs = [_seed_run(0, recs, system, seq, draws)]
    for seed in range(1, MONO_ATE_SEEDS):
        s = new_system(seq, dev, rng_seed=seed)
        with recorded_draws() as d:
            run = track_mono(s, seq)
        runs.append(_seed_run(seed, run, s, seq, d))
    shares = [r["ate_share"] for r in runs]
    above = [r["seed"] for r in runs if not r["ate_share"] < MONO_BARS["ate_share"]]
    tail_max = _tail_bound(MONO_ATE_SEEDS, *MONO_REF_TAIL)
    res.update(ate_share_per_seed=shares, ate_share_median=float(np.median(shares)),
               ate_seeds_above=len(above), ate_seeds_above_max=tail_max)
    for r in runs:
        log("  mono " + json.dumps({k: v for k, v in r.items() if k != "draws"}))
    log(f"mono ATE share of its span, rng_seed 0-{MONO_ATE_SEEDS - 1} "
        f"({time.perf_counter() - t0:.1f}s): median {np.median(shares):.4f}; at or above "
        f"{MONO_BARS['ate_share']}: {len(above)} of {MONO_ATE_SEEDS} {above} (the JAX "
        f"package: {MONO_REF_TAIL[0]} of {MONO_REF_TAIL[1]}; bar: at most {tail_max})")
    if out_dir:
        np.savez(f"{out_dir}/mono_draws.npz", **{f"{r['seed']}_{j}": d.numpy()
                                                 for r in runs for j, d in enumerate(r["draws"])})

    bars, failed = MONO_BARS, []
    if not init <= bars["init_by"]:
        failed.append(f"initialised at frame {init}, not by frame {bars['init_by']}")
    if len(poses) < bars["tracked"]:
        failed.append(f"{len(poses)} of {len(recs)} frames tracked")
    if system.n_keyframes() < bars["keyframes"] or len(pk_ms) < bars["keyframes"]:
        failed.append(f"{system.n_keyframes()} keyframes, process_keyframe ran {len(pk_ms)} times")
    if not system.n_map_points() > bars["points"]:
        failed.append(f"{system.n_map_points()} map points")
    short = [r["seed"] for r in runs
             if not (r["init_frame"] <= bars["init_by"] and r["tracked"] >= bars["tracked"])]
    if short:
        failed.append(f"rng_seed {short} did not initialise by frame {bars['init_by']} or "
                      f"tracked fewer than {bars['tracked']} frames")
    if len(above) > tail_max:
        failed.append(f"{len(above)} of {MONO_ATE_SEEDS} runs at or above ATE share "
                      f"{bars['ate_share']}, more than {tail_max}")
    if launches != res["fused_steps"] + res["pose_opt_frame"] or launches < len(poses) - init:
        failed.append(f"{launches} pose_lm launches for {res['fused_steps']} fused steps and "
                      f"{res['pose_opt_frame']} _pose_opt_frame calls")
    if diffs:
        failed.append(f"the card disagrees with the CPU: {diffs}")
    if failed:
        fail("mono: " + "; ".join(failed))
    res["max_abs_err"] = _hold_to_plain("mono", calls)
    res["launches_per_frame"] = launches / len(recs)
    return res


SYNC_EVERY = 10                 # frames between state reports and between pushes
SYNC_DISTRIBUTE_AFTER = 29      # the replica's pull goes back to the agent after this frame
SYNC_RELOC_FRAMES = (10, 20, 30)


def _ms(fn):
    """(fn's result, host ms to its end); fn does not leave work on the card."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _replica_disagreements(agent_store, replica) -> list[str]:
    """Where a replica differs from the agent's map: the alive keyframes and
    map points by gid, each keyframe's pose and point's position bit for
    bit."""
    out = []
    for kind, alive, by_gid, gid, vals in (
            ("keyframe", "kf_alive", "kf_by_gid", "kf_gid", "kf_pose_cw"),
            ("map point", "mp_alive", "mp_by_gid", "mp_gid", "mp_pos")):
        a_slots = np.flatnonzero(getattr(agent_store, alive))
        r_slots = np.flatnonzero(getattr(replica, alive))
        a_gids = set(getattr(agent_store, gid)[a_slots].tolist())
        r_gids = set(getattr(replica, gid)[r_slots].tolist())
        if a_gids != r_gids:
            out.append(f"alive {kind}s: {len(a_gids)} on the agent, {len(r_gids)} on the "
                       f"replica, {len(a_gids ^ r_gids)} not on both")
            continue
        rmap = getattr(replica, by_gid)
        differ = [g for g, k in zip(getattr(agent_store, gid)[a_slots].tolist(), a_slots)
                  if not np.array_equal(getattr(agent_store, vals)[k],
                                        getattr(replica, vals)[rmap[g]])]
        if differ:
            out.append(f"{len(differ)} of {len(a_gids)} {kind}s differ, gids {differ[:5]}")
    return out


def phase_sync(dev: torch.device, mono_states: list[str]) -> dict:
    """The agent's side of the swarm on the `mono` cell, on the card: a
    SwarmAgent tracks cells.mono_sequence() with a state report and a push
    every SYNC_EVERY frames; a replica store decodes and applies every push
    and must end equal to the agent's map bit for bit; after frame
    SYNC_DISTRIBUTE_AFTER the replica's pull is distributed back and the
    agent must go on tracking without relocalising, as many of the
    remaining frames as the uninterrupted run (`phase_mono`) within 1; the
    map is saved in both formats and each loads into a fresh client with
    the same counts, which relocalises at least 2 of SYNC_RELOC_FRAMES.
    The counts are set to 0 just before and read just after; every pose_lm
    launch is held to the plain version."""
    import tempfile
    from pathlib import Path

    from swarmmap_tpu_torch.bench_pose import record_pose_calls
    from swarmmap_tpu_torch.cells import (mono_sequence, new_system, relocalised, settings_for,
                                          timed_record)
    from swarmmap_tpu_torch.core.map_store import MapStore
    from swarmmap_tpu_torch.ops.vocab import default_vocabulary
    from swarmmap_tpu_torch.swarm import SwarmAgent
    from swarmmap_tpu_torch.sync import codec
    from swarmmap_tpu_torch.sync.oplog import Mapit

    seq = mono_sequence()
    vocab = default_vocabulary()
    _reset_counts()
    failed, pushes, states, saves = [], [], [], {}
    with record_pose_calls() as calls, tempfile.TemporaryDirectory() as tmp:
        agent = SwarmAgent(0, settings_for(seq.world), vocab, device=dev)
        replica = MapStore(map_id=0, n_kp=agent.system.store.n_kp)
        replica_mapit = Mapit(replica)
        recs = []
        for i in range(len(seq)):
            recs.append(timed_record(lambda i=i: agent.track(seq.read(i), seq.timestamps[i]),
                                     agent.system.tracking))
            if (i + 1) % SYNC_EVERY:
                continue
            states.append(len(agent.state_payload()))
            data, push_ms = _ms(agent.push_payload)
            if data is None:
                failed.append(f"frame {i}: nothing to push")
                continue
            sl, dec_ms = _ms(lambda: codec.decode_slice(data))
            _, app_ms = _ms(lambda: replica_mapit.apply_slice(sl, vocab=vocab))
            pushes.append({"frame": i, "bytes": len(data), "kfs": len(sl.kfs), "mps": len(sl.mps),
                           "updates": len(sl.updates), "archive_encode_ms": push_ms,
                           "decode_ms": dec_ms, "apply_ms": app_ms})
            log("sync push: " + json.dumps(pushes[-1]))
            if i == SYNC_DISTRIBUTE_AFTER:
                pull, enc_ms = _ms(lambda: codec.encode_slice(replica_mapit.reply_pull()))
                _, recv_ms = _ms(lambda: agent.receive_distribute(pull))
                log(f"sync distribute after frame {i}: {len(pull)} bytes, pull + encode "
                    f"{enc_ms:.2f} ms, receive_distribute {recv_ms:.2f} ms")
        st = agent.system.store
        diffs = _replica_disagreements(st, replica)
        counts = (agent.system.n_keyframes(), agent.system.n_map_points())
        log(f"sync replica after {len(pushes)} pushes: agent {counts[0]} keyframes / {counts[1]} "
            f"points, replica {int(replica.kf_alive.sum())} / {int(replica.mp_alive.sum())}; "
            f"disagreements {diffs}")
        failed += [f"replica: {d}" for d in diffs]
        after = recs[SYNC_DISTRIBUTE_AFTER + 1:]
        tracked = sum(r.state == "OK" for r in after)
        ref = sum(x == "OK" for x in mono_states[SYNC_DISTRIBUTE_AFTER + 1:])
        relocs = sum(r.state == "LOST" or "ransac_pnp" in r.counts or "relocalized" in r.counts
                     for r in after)
        log(f"sync frames {SYNC_DISTRIBUTE_AFTER + 1}-{len(seq) - 1} after the distribute: "
            f"{tracked} tracked (uninterrupted run: {ref}), frames lost or relocalising {relocs}, "
            f"states {[r.state for r in after]}")
        if abs(tracked - ref) > 1 or relocs:
            failed.append(f"after the distribute {tracked} frames tracked (uninterrupted {ref}), "
                          f"{relocs} frames lost or relocalising")

        for fmt in ("msgpack", "boost-bin"):
            path = Path(tmp) / f"map-client-0.{fmt}"
            _, save_ms = _ms(lambda: agent.system.save_map(path, fmt=fmt))
            fresh = new_system(seq, dev)
            ok, load_ms = _ms(lambda: fresh.load_map(path))
            loaded = (fresh.n_keyframes(), fresh.n_map_points())
            reloc = relocalised(fresh, seq, SYNC_RELOC_FRAMES)
            torch.cuda.synchronize()
            saves[fmt] = {"bytes": path.stat().st_size, "save_ms": save_ms, "load_ms": load_ms,
                          "keyframes": loaded[0], "map_points": loaded[1], "relocalised": reloc}
            log(f"sync {fmt} checkpoint: " + json.dumps(saves[fmt]))
            if not ok or loaded != counts:
                failed.append(f"{fmt}: loaded {loaded}, saved {counts}")
            if sum(reloc) < 2:
                failed.append(f"{fmt}: relocalised {reloc} of frames {SYNC_RELOC_FRAMES}")
    launches, stats = _read_counts()
    calls_made = stats.get("fused_step", 0) + stats.get("pose_opt_frame", 0) + stats.get(
        "ransac_pnp", 0)
    log(f"sync pose_lm launches {launches} (fused steps {stats.get('fused_step', 0)}, "
        f"_pose_opt_frame {stats.get('pose_opt_frame', 0)}, ransac_pnp "
        f"{stats.get('ransac_pnp', 0)}); state reports {states} bytes")
    if launches != calls_made or launches == 0:
        failed.append(f"{launches} pose_lm launches for {calls_made} pose calls")
    if len(pushes) != len(seq) // SYNC_EVERY:
        failed.append(f"{len(pushes)} pushes in {len(seq)} frames")
    if failed:
        fail("sync: " + "; ".join(failed))
    return {"frames": len(seq), "launches": launches, "launches_per_frame": launches / len(seq),
            "pushes": pushes, "state_bytes": states, "checkpoints": saves,
            "max_abs_err": _hold_to_plain("sync", calls)}


def phase_bench(cpu_inliers: dict) -> dict:
    """`python -m swarmmap_tpu_torch.bench` in this process, with the counts
    set to 0 just before and read just after: its JSON line, and its
    distorted inliers held to the CPU step's within max(3, 5%)."""
    from swarmmap_tpu_torch import bench

    _reset_counts()
    rec = bench.run()
    launches, _ = _read_counts()
    log("bench: " + json.dumps(rec))
    steps = 1 + 3 * bench.N_ITER + 1 + 2 * bench.N_ITER
    if launches != steps:
        fail(f"bench: {launches} pose_lm launches in {steps} steps")
    if inliers_disagree(rec["distorted_inliers"], cpu_inliers["distorted"]):
        fail(f"bench: distorted inliers {rec['distorted_inliers']} vs the CPU's "
             f"{cpu_inliers['distorted']}")
    return {"steps": steps, "launches": launches, "record": rec}


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
    worst_large, streaming = phase_pose_large(dev)
    worst = max(worst, worst_large)
    cells = build_inputs(dev)
    main_path = phase_main_path(cells)
    worst_ref, cpu_inliers = phase_reference(cells, main_path["outs"])
    worst = max(worst, worst_ref)
    tracker_paths = phase_tracker(dev)
    mono = phase_mono(dev, sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None)
    tracker_paths["mono"] = {k: mono[k] for k in (
        "frames", "launches", "launches_per_frame", "max_abs_err")}
    sync = phase_sync(dev, mono["states"])
    tracker_paths["sync"] = {k: sync[k] for k in (
        "frames", "launches", "launches_per_frame", "max_abs_err")}
    worst = max(worst, *(p["max_abs_err"] for p in tracker_paths.values()))
    bench_run = phase_bench(cpu_inliers)
    times = phase_times(cells)
    per_path = {"batched_step": {"steps": main_path["steps"],
                                 "launches": main_path["launches"]}, **tracker_paths,
                "bench": {k: bench_run[k] for k in ("steps", "launches")}}
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
            "relocalisation": tracker_paths["tracker_reloc"]["launches_per_frame"],
            "mono_fused": mono["frames"]["fused"]["pose_lm_per_frame"],
            "mono_staged": mono["frames"]["staged"]["pose_lm_per_frame"]},
        "max_abs_err": worst,
        "ms": times["pose_ms"], "plain_ms": times["pose_plain_ms"],
        "bound_ms": times["pose_bound_ms"], "bound_by": times["pose_bound_by"],
        # no single PyTorch call computes an LM pose optimisation
        "library_ms": None,
        "synthetic_ms": synthetic_ms,
        "streaming_build": streaming,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
