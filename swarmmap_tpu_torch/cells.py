"""The two cells the port's step is measured in, shared by chip_smoke.py,
bench_step.py and profile_step.py.

Both are the JAX package's bench configuration (`bench.py:24-28`, `:367`),
uncut: 3 agents at EuRoC geometry (480x752), 1000 features, 8 levels,
2048 map points, `realistic_track_inputs` seeds 0-2.  `pinhole` has no
distortion; `distorted` has EuRoC cam0's radial-tangential coefficients.
"""
from __future__ import annotations

import time

import torch

N_AGENTS = 3
HW = (480, 752)
N_FEATURES = 1000
N_LEVELS = 8
N_MAP_POINTS = 2048
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
CELLS = {"pinhole": (0.0,) * 5, "distorted": EUROC_DIST}
# keyword arguments of pipeline.batched_tracking_step / match_frame in both cells
STEP_KW = dict(n_features=N_FEATURES, n_levels=N_LEVELS, hw=HW)


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
