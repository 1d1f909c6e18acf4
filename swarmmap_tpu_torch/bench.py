"""Tracking throughput of the port's batched step on the card, under the
metric names of the JAX package's benchmark (`bench.py`).

    python -m swarmmap_tpu_torch.bench

Does on CUDA what `bench.py:322-391` does on the TPU: the batched tracking
step (`pipeline.batched_tracking_step`) of 3 agents at EuRoC geometry,
480x752, 1000 features, 8 levels, 2048 map points, on
`realistic_track_inputs` seeds 0-2 (the `pinhole` and `distorted` cells of
`cells.py`), each step's pose chained into the next step's `Tcw_guess`.
Host wall time over 30 steps behind one `torch.cuda.synchronize` per block;
the best of 3 blocks (pinhole) and of 2 (EuRoC cam0's distortion).  Frames
per second per agent is steps per second: every agent advances one frame
a step.

Prints one JSON line: `metric` (tracking_fps_per_agent_3agent_euroc_geom),
`value`, `unit`, `vs_baseline` (against the EuRoC camera rate, 20 fps),
`tracking_fps_per_agent_distorted`, `distorted_inliers` (per agent, of
the first distorted step) and the card's name and power limit.  The
`swarm_*` fields of `bench.py` wait for the port's `Swarm` (ROADMAP queue
1, item 12).  Needs a CUDA device: without one it raises.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

BASELINE_FPS = 20.0  # EuRoC camera rate -> real-time bar (BASELINE.md)
N_ITER = 30


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].split(", ")
    return {"name": name, "power_limit": limit}


def best_fps(step, inp, blocks: int) -> float:
    """Steps per second of the best of `blocks` blocks of N_ITER chained
    steps, host wall time to a synchronize."""
    best = 0.0
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur = inp
        for _ in range(N_ITER):
            out = step(cur)
            # chain the pose into the next input, as bench.py does
            cur = cur._replace(Tcw_guess=out.Tcw)
        torch.cuda.synchronize()
        best = max(best, N_ITER / (time.perf_counter() - t0))
    return best


def run() -> dict:
    """The benchmark's record (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    from . import cells, pipeline

    dev = torch.device("cuda", 0)
    inputs = cells.build_cells(dev)

    def step(x):
        return pipeline.batched_tracking_step(x, **cells.STEP_KW)

    step(inputs["pinhole"])  # warm-up
    fps = best_fps(step, inputs["pinhole"], 3)
    inliers_d = step(inputs["distorted"]).n_inliers.tolist()
    fps_d = best_fps(step, inputs["distorted"], 2)
    return {
        "metric": "tracking_fps_per_agent_3agent_euroc_geom",
        "value": fps,
        "unit": "frames/s/agent",
        "vs_baseline": fps / BASELINE_FPS,
        "tracking_fps_per_agent_distorted": fps_d,
        "distorted_inliers": inliers_d,
        "device": torch.cuda.get_device_name(0),
        "card": card(),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
