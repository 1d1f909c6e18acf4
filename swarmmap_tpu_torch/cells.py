"""The cells the port is measured in, shared by chip_smoke.py,
bench_step.py, profile_step.py and profile_tracker.py.

The batched step's two cells are the JAX package's bench configuration
(`bench.py:24-28`, `:367`), uncut: 3 agents at EuRoC geometry (480x752),
1000 features, 8 levels, 2048 map points, `realistic_track_inputs` seeds
0-2.  `pinhole` has no distortion; `distorted` has EuRoC cam0's
radial-tangential coefficients.

The per-agent tracker runs on the synthetic world `make_world(seed=4)` at
the same geometry and ORB settings with 1500 landmarks (`tracker_world`,
`new_tracker`): RGB-D frames take the staged path, monocular frames after
a depth bootstrap the fused one.  `track_sequence` drives a tracker over
rendered frames and keeps one `FrameRecord` per frame; `compare_records`
holds two runs to the tracker's parity bars.

The monocular client (`core/system.py`, tracking with local mapping) runs
on `mono_sequence()`: synthesize_sequence(seed=0, motion="arc") with 1500
landmarks, 40 frames, at the same geometry and ORB settings
(`new_system`, `track_mono`).  Its two-view initialisation draws RANSAC
hypotheses from the tracker's generator; `recorded_draws` and
`replayed_draws` let a second run on another device (or the JAX package's
draws) take the same ones.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from .utils.stats import STATS

N_AGENTS = 3
HW = (480, 752)
N_FEATURES = 1000
N_LEVELS = 8
N_MAP_POINTS = 2048
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
CELLS = {"pinhole": (0.0,) * 5, "distorted": EUROC_DIST}
# keyword arguments of pipeline.batched_tracking_step / match_frame in both cells
STEP_KW = dict(n_features=N_FEATURES, n_levels=N_LEVELS, hw=HW)


# the per-agent tracker's world: landmarks and frames of make_world
TRACKER_LANDMARKS = 1500
TRACKER_SEED = 4


def tracker_world(hw: tuple[int, int] = HW, n_points: int = TRACKER_LANDMARKS):
    """The synthetic world the tracker cells render (80 frames, the default
    trajectory)."""
    from .utils import datasets

    return datasets.make_world(n_points=n_points, hw=hw, seed=TRACKER_SEED)


def settings_for(world, n_features: int = N_FEATURES, n_levels: int = N_LEVELS):
    """Settings of the world's pinhole camera at 20 fps with these ORB
    settings."""
    from .utils import config

    K = world.K
    return config.Settings(
        camera=config.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]),
                                   cx=float(K[0, 2]), cy=float(K[1, 2]), fps=20.0,
                                   width=world.hw[1], height=world.hw[0]),
        orb=config.OrbConfig(n_features=n_features, n_levels=n_levels),
    )


def new_tracker(world, device, n_features: int = N_FEATURES, n_levels: int = N_LEVELS):
    """A tracker on an empty map with the world's pinhole camera at 20 fps,
    on `device`."""
    from .core import keyframe_db, map_store, tracking
    from .ops import vocab

    voc = vocab.default_vocabulary()
    return tracking.Tracking(settings_for(world, n_features, n_levels), map_store.MapStore(),
                             keyframe_db.KeyFrameDatabase(voc), voc, device=device)


# the monocular client's cell: a System mapping a synthetic arc sequence
MONO_FRAMES = 40
MONO_LANDMARKS = 1500
MONO_SEED = 0


def mono_sequence(hw: tuple[int, int] = HW, n_points: int = MONO_LANDMARKS,
                  n_frames: int = MONO_FRAMES):
    """synthesize_sequence(seed=0, motion="arc"): the monocular cell's
    frames with the ground truth attached (`.world`)."""
    from .utils import datasets

    return datasets.synthesize_sequence(n_frames=n_frames, hw=hw, seed=MONO_SEED,
                                        n_points=n_points, motion="arc")


def new_system(seq, device, n_features: int = N_FEATURES, n_levels: int = N_LEVELS,
               rng_seed: int = 0):
    """A monocular System (tracking + local mapping) on an empty map with
    the sequence's camera, on `device`, its RANSAC draws seeded by
    rng_seed."""
    from .core.system import System

    return System(settings_for(seq.world, n_features, n_levels), rng_seed=rng_seed,
                  device=device)


def ate_share(poses: dict, world) -> tuple[float, float]:
    """(ATE RMSE after Sim(3) alignment, span of the ground-truth
    positions) of {frame index: Tcw}."""
    from .utils.trajectory import ate_rmse

    idx = sorted(poses)
    est = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in idx])
    gt = world.poses_wc[idx][:, :3, 3]
    return ate_rmse(est, gt), float(np.linalg.norm(gt.max(0) - gt.min(0)))


def relocalised(system, seq, frames=(10, 20, 30)) -> list[bool]:
    """For each index of `seq` in `frames`, whether a fresh frame of it,
    built on the system's device, relocalises against the system's map
    (`Tracking._relocalize`: BoW candidates, RANSAC PnP, pose refinement):
    the map-reuse check of tests/test_slam_e2e.py."""
    from .core.frame import build_frame

    s, tr = system.settings, system.tracking
    return [bool(tr._relocalize(build_frame(seq.read(i), float(seq.timestamps[i]), s.camera,
                                            s.orb, device=tr.device)))
            for i in frames]


class FrameRecord(NamedTuple):
    state: str
    pose_cw: np.ndarray | None
    inliers: int
    pairs: frozenset          # {(keypoint index, map point)}
    n_kf: int
    n_mp: int
    fused_frames: int
    since_kf: int             # frame id minus the last keyframe's frame id
    ms: float                 # host clock around grab (ends in a fetch)
    counts: dict              # STATS counters bumped by this frame


def frame_record(tracker, ms: float = 0.0, counts: dict | None = None) -> FrameRecord:
    """The state a tracker left after its last grab.  Reads only what the
    JAX package's tracker has too, so its tests hold the two alike."""
    f = tracker.last_frame
    return FrameRecord(
        state=tracker.state.name,
        pose_cw=None if f.pose_cw is None else np.array(f.pose_cw),
        inliers=int(tracker.matches_inliers),
        pairs=frozenset((i, int(m)) for i, m in enumerate(f.mp) if m >= 0),
        n_kf=int(tracker.store.n_kf), n_mp=int(tracker.store.n_mp),
        fused_frames=int(tracker.fused_frames),
        since_kf=int(f.frame_id - tracker.last_kf_frame_id),
        ms=ms, counts=counts or {},
    )


def render_frames(world, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(image, depth) of frames 0..n-1."""
    from .utils import datasets

    return [datasets.render_frame(world, i, return_depth=True) for i in range(n)]


def _launches() -> int:
    from .ops import pose_kernel

    return pose_kernel.pose_lm_launches


def timed_record(grab, tracker) -> FrameRecord:
    """Run grab(), then the record of `tracker` with grab's host time, its
    STATS counts and the pose_lm launches it made (`counts["pose_lm"]`)."""
    before, launches = dict(STATS.counts), _launches()
    t0 = time.perf_counter()
    grab()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v - before.get(k, 0) for k, v in STATS.counts.items()
              if v != before.get(k, 0)}
    counts["pose_lm"] = _launches() - launches
    return frame_record(tracker, ms, counts)


def track_frame(tracker, image, depth, timestamp: float) -> FrameRecord:
    """One grab, timed and counted (`timed_record`)."""
    return timed_record(lambda: tracker.grab(image, timestamp, depth_image=depth), tracker)


def track_mono(system, seq, n: int | None = None) -> list[FrameRecord]:
    """`System.track_monocular` on the first n frames of `seq` at their
    timestamps, one timed and counted record per frame."""
    return [timed_record(lambda i=i: system.track_monocular(seq.read(i), seq.timestamps[i]),
                   system.tracking)
            for i in range(len(seq) if n is None else n)]


def track_sequence(tracker, frames, depth_frames) -> list[FrameRecord]:
    """Grab frames[i] at i / 20 s, with its depth where i is in
    `depth_frames` (a container of indices)."""
    return [track_frame(tracker, img, d if i in depth_frames else None, i / 20.0)
            for i, (img, d) in enumerate(frames)]


def frame_disagreements(x: FrameRecord, y: FrameRecord, tcw_tol: float = 1e-3) -> list[str]:
    """Where two trackers' states after one frame break the tracker's
    parity bars: the same state, keyframe and point counts, fused frames
    and frames since the last keyframe, |dTcw| < tcw_tol, inliers within
    max(2, 2%), association sets agreeing >= 0.99.  Empty when they agree."""
    out = []
    key = ("state", "n_kf", "n_mp", "fused_frames", "since_kf")
    if [getattr(x, k) for k in key] != [getattr(y, k) for k in key]:
        out.append(f"{'/'.join(key)} {[getattr(x, k) for k in key]} vs "
                   f"{[getattr(y, k) for k in key]}")
    if (x.pose_cw is None) != (y.pose_cw is None):
        out.append("pose present in one run only")
    elif x.pose_cw is not None and not np.abs(x.pose_cw - y.pose_cw).max() < tcw_tol:
        out.append(f"|dTcw| {np.abs(x.pose_cw - y.pose_cw).max():.3g}")
    if abs(x.inliers - y.inliers) > max(2, 0.02 * x.inliers):
        out.append(f"inliers {x.inliers} vs {y.inliers}")
    common = len(x.pairs & y.pairs)
    if common < 0.99 * max(len(x.pairs), len(y.pairs)):
        out.append(f"associations {common} shared of {len(x.pairs)} / {len(y.pairs)}")
    return out


def compare_records(a: list[FrameRecord], b: list[FrameRecord],
                    tcw_tol: float = 1e-3) -> list[str]:
    """`frame_disagreements` of two runs of one sequence, frame by frame."""
    return [f"frame {i}: {d}" for i, (x, y) in enumerate(zip(a, b))
            for d in frame_disagreements(x, y, tcw_tol)]


@contextlib.contextmanager
def recorded_draws():
    """Record, as CPU tensors in call order, every set of two-view RANSAC
    draws (`twoview.draw_indices`) made inside the block."""
    from .ops import twoview

    draws, orig = [], twoview.draw_indices

    def record(valid, generator):
        d = orig(valid, generator)
        draws.append(d.cpu())
        return d

    twoview.draw_indices = record
    try:
        yield draws
    finally:
        twoview.draw_indices = orig


@contextlib.contextmanager
def replayed_draws(draws: list):
    """Inside the block, two-view initialisation takes its RANSAC draws
    from `draws` (popped from the front, moved to the points' device)
    instead of the tracker's generator: the card's and the CPU's
    generators give different streams for one seed, and the JAX package
    draws from its own keys."""
    from .ops import twoview

    orig = twoview.draw_indices

    def replay(valid, generator):
        return torch.as_tensor(np.array(draws.pop(0))).long().to(valid.device)

    twoview.draw_indices = replay
    try:
        yield
    finally:
        twoview.draw_indices = orig


def state_disagreements(a: list[FrameRecord], b: list[FrameRecord],
                        tcw_tol: float = 1e-3) -> list[str]:
    """Where two runs of one sequence part on the monocular client's
    per-frame bars: the same state, keyframe and map-point counts, and
    |dTcw| < tcw_tol.  Empty when they agree."""
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        key = ("state", "n_kf", "n_mp")
        if [getattr(x, k) for k in key] != [getattr(y, k) for k in key]:
            out.append(f"frame {i}: state/n_kf/n_mp {[getattr(x, k) for k in key]} vs "
                       f"{[getattr(y, k) for k in key]}")
        elif (x.pose_cw is None) != (y.pose_cw is None):
            out.append(f"frame {i}: pose present in one run only")
        elif x.pose_cw is not None and not np.abs(x.pose_cw - y.pose_cw).max() < tcw_tol:
            out.append(f"frame {i}: |dTcw| {np.abs(x.pose_cw - y.pose_cw).max():.3g}")
    return out


def build_cells(dev: torch.device) -> dict:
    """{cell name: [A, ...] TrackInputs on dev}, agents 0..N_AGENTS-1."""
    from . import pipeline

    return {name: pipeline.stack_inputs([
        pipeline.realistic_track_inputs(
            hw=HW, n_map_points=N_MAP_POINTS, seed=a, n_features=N_FEATURES,
            n_levels=N_LEVELS, dist=dist, device=dev)
        for a in range(N_AGENTS)]) for name, dist in CELLS.items()}


def timed_call(fn) -> tuple[float, float]:
    """(CUDA-event ms, host-clock ms) of one call of fn, from an idle
    device to the end of its work."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), (time.perf_counter() - h0) * 1e3
