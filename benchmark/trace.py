"""Reading a torch.profiler trace of the traced steps.

The harness marks its own host spans with `record_function` (`harness`:
stacking the inputs and the loop, `upload`, `step`: the call into the
program, `fetch`); the profiler records them beside every device
operation on one clock.  From the raw events this module takes the
traced window (first span start to last span end), the device intervals,
the busy time (their union inside the window), the idle gaps labelled by
the host span that was open at each gap's midpoint, and the device time
by operation name.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

SPANS = ("harness", "upload", "step", "fetch")
TOP = 10
NAME_CHARS = 120


class Trace(NamedTuple):
    ops: list          # [(name, start_ns, dur_ns)] device operations in the window
    spans: list        # [(name, start_ns, end_ns)] host spans
    window_s: float
    busy_s: float
    idle_by_span: dict  # {span name or "other": idle seconds}
    steps: int         # steps traced
    agents: int

    @staticmethod
    def is_copy(name: str) -> bool:
        n = name.lower()
        return n.startswith("memcpy") or n.startswith("memset")

    def kernels(self) -> list:
        return [o for o in self.ops if not self.is_copy(o[0])]

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, _, dur in self.ops:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + dur / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [list(x) for x in top], "idle_gaps": [list(x) for x in gaps]}


def profiler():
    """A torch.profiler over the host and the card, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str, on: bool):
    """A profiler range named `name` while tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def parse(prof, steps: int, agents: int) -> Trace:
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in SPANS and not e.is_user_annotation():
                ops.append((name, e.start_ns(), e.duration_ns()))
        elif name in SPANS and e.is_user_annotation():
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return build(ops, spans, steps, agents)


def build(ops: list, spans: list, steps: int, agents: int) -> Trace:
    """The Trace of device operations and host spans (times in ns)."""
    if not spans:
        return Trace([], [], 0.0, 0.0, {}, steps, agents)
    spans = sorted(spans, key=lambda s: s[1])
    w0, w1 = spans[0][1], max(s[2] for s in spans)
    ops = sorted((o for o in ops if o[1] < w1 and o[1] + o[2] > w0), key=lambda o: o[1])
    merged: list[list[int]] = []
    for _, s, d in ops:
        s, e = max(s, w0), min(s + d, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        # share the gap among the host spans open during it
        covered = 0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            o = min(b, spans[k][2]) - max(a, spans[k][1])
            if o > 0:
                idle[spans[k][0]] = idle.get(spans[k][0], 0.0) + o / 1e9
                covered += o
            k += 1
        if b - a > covered:
            idle["other"] = idle.get("other", 0.0) + (b - a - covered) / 1e9
    return Trace(ops, spans, (w1 - w0) / 1e9, busy / 1e9, idle, steps, agents)
