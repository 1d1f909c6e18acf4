"""Profiling hooks (reference counterpart: NVTX PUSH_RANGE/POP_RANGE,
include/Utils.hpp:17-40).

Port of swarmmap_tpu/utils/profiling.py in PyTorch's idiom: a range is a
`torch.profiler.record_function`, which shows in the profiler's trace as
an NVTX range does in Nsight, and device kernels launched inside it sit
under it on the timeline.  Set SWARMMAP_TRACE_DIR=<dir> to capture a trace
of the CPU and (where there is a card) CUDA activity, written on exit as a
Chrome trace, <dir>/trace-<pid>.json (chrome://tracing, Perfetto).

The tracking step's stages are named ranges: `extract` with its
`extract.*` parts (ops/extractor.py), `match` with its `match.*` parts
and `pose` (pipeline.py).  The benchmark attributes each kernel to the
innermost range open when it was launched (benchmark/spans.py).
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

_NULL = contextlib.nullcontext()


def named_range(label: str):
    """Annotate a host-side region; device ops launched inside it are
    attributed to it in the trace (NVTX range equivalent).  A range is
    built only while a torch profiler records: otherwise this returns one
    shared null context, so an untraced call pays one flag read."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(label)
    return _NULL


@contextlib.contextmanager
def maybe_trace():
    """Capture a full runtime trace when SWARMMAP_TRACE_DIR is set; yields
    the trace file's path, or None when tracing is off."""
    trace_dir = os.environ.get("SWARMMAP_TRACE_DIR", "")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(trace_dir) / f"trace-{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))
