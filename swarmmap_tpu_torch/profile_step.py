"""Profile one batched tracking step on the GPU.

    python -m swarmmap_tpu_torch.profile_step [--out DIR]

Runs the main path in the pinhole cell of `cells.py` (3 agents, EuRoC
geometry: 480x752, 1000 features, 8 levels, 2048 map points) for a few
warm-up steps, then one step under torch.profiler.  Prints one JSON line:
device kernels launched in the step, their summed device time, the step's
wall time and the device's idle share of it; writes the profiler's table
sorted by device time to DIR/profile_step.txt.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_step needs a CUDA device")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.cells import N_AGENTS, STEP_KW, build_cells

    inp = build_cells(torch.device("cuda", 0))["pinhole"]
    for _ in range(3):
        pipeline.batched_tracking_step(inp, **STEP_KW)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.batched_tracking_step(inp, **STEP_KW)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev_events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_step.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=60))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "agents": N_AGENTS,
        "kernel_launches": len(kernels), "device_events": len(dev_events),
        "device_ms": device_ms, "wall_ms_profiled": wall_ms,
        "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
    }))


if __name__ == "__main__":
    main()
