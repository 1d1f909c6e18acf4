"""The program's spans in a torch.profiler trace: the card's time, launches
and idle by stage of the tracking step.

    python -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

The program opens a profiler range at each stage of the step
(`swarmmap_tpu_torch.utils.profiling.named_range`): `extract` with its
`extract.*` parts, `match` with its `match.*` parts, and `pose`.  Every
host-side user annotation that is not a harness span (`trace.SPANS`) is a
program span.  `parse` takes `trace.parse`'s Trace of the traced steps and
attributes each of its device operations by its launch, not by its time:
the runtime call that launched it carries its correlation id, and the
operation goes to the innermost program span open on that call's thread
when it was made, or to the harness span open then where no program span
is.  Each idle gap of the card is shared among the host's innermost open
spans during it, labelled `<harness span>/<program span>`
(`step/extract.orientation`), or the harness span alone outside every
program span.  Without program spans, `breakdown` is `trace.Trace`'s.

The command is `python -m benchmark.run ... --trace 1` with the traced
tail also read here: it prints the benchmark's result line, then one JSON
line with the six stage metrics (`front_end_*`, `matching_*`), the time,
launches and idle of each span a step, the totals they add up to, and the
host time of the traced `step` span.  Needs a CUDA device.
"""
from __future__ import annotations

import bisect
import re
from typing import NamedTuple

from . import trace

# host-side runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): the one that launched a kernel or copy carries
# the correlation id that the kernel or copy carries on the device
LAUNCH_PREFIX = "cu"
NOISE = re.compile(r"^void |\(anonymous namespace\)::|at::native::|at::cuda::|at_cuda_detail::")
STAGES = {"front_end": "extract", "matching": "match"}
# `trace.parse` itself: `main` swaps the module's name for one that calls `parse`
TRACE_PARSE = trace.parse


class Stages(NamedTuple):
    trace: trace.Trace
    labels: list       # per op of trace.ops: its span, program or harness ("other" if none)
    idle_ns: dict      # {"<harness>/<program span>" or "<harness>" or "other": idle ns}
    program: set       # program span names present
    unlaunched: int    # ops whose launch event was not found
    mirrors: int       # ops of trace.ops named as a program span: 0 where the
    #                    spans' device-side mirrors are kept out, as they must be

    def per_span(self) -> dict:
        """{span: {kernel_ns, launches, copy_ns, copies}} over the traced steps."""
        out: dict[str, dict] = {}
        for (name, _, dur), label in zip(self.trace.ops, self.labels):
            d = out.setdefault(label, dict.fromkeys(("kernel_ns", "launches", "copy_ns",
                                                     "copies"), 0))
            kind = ("copy_ns", "copies") if trace.Trace.is_copy(name) else ("kernel_ns",
                                                                            "launches")
            d[kind[0]] += dur
            d[kind[1]] += 1
        return out

    def stage(self, span: str) -> dict:
        """Kernel ns, launches and card idle ns of `span` and the spans
        nested in it: idle while one of them was the host's innermost span."""
        ps = [d for k, d in self.per_span().items() if in_stage(k, span)]
        return {"kernel_ns": sum(d["kernel_ns"] for d in ps),
                "launches": sum(d["launches"] for d in ps),
                "idle_ns": sum(ns for k, ns in self.idle_ns.items()
                               if "/" in k and in_stage(k.split("/", 1)[1], span))}

    def metrics(self) -> dict:
        """The six stage metrics: device ms, launches an agent frame and
        card idle ms of the front end and of matching, a traced step."""
        t = self.trace
        if not self.program or not t.steps:
            return {}
        out = {}
        for name, span in STAGES.items():
            s = self.stage(span)
            out[f"{name}_device_ms"] = s["kernel_ns"] / 1e6 / t.steps
            out[f"{name}_launches_per_agent_frame"] = s["launches"] / (t.steps * t.agents)
            out[f"{name}_idle_ms"] = s["idle_ns"] / 1e6 / t.steps
        return out

    def breakdown(self) -> dict:
        """`trace.Trace.breakdown`'s two keys, by span where the program
        has spans: device ops keyed `<span>: <kernel>`, idle gaps by
        `<harness span>/<program span>`."""
        if not self.program:
            return self.trace.breakdown()
        by_name: dict[str, float] = {}
        for (name, _, dur), label in zip(self.trace.ops, self.labels):
            key = f"{label}: {short(name)}"[:trace.NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + dur / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:trace.TOP]
        gaps = sorted(((k, ns / 1e9) for k, ns in self.idle_ns.items()),
                      key=lambda kv: -kv[1])[:trace.TOP]
        return {"device_ops": [list(x) for x in top], "idle_gaps": [list(x) for x in gaps]}


def in_stage(span: str, stage: str) -> bool:
    return span == stage or span.startswith(stage + ".")


def short(kernel: str) -> str:
    """A kernel's name without its namespaces' noise."""
    return NOISE.sub("", kernel)


def parse(prof, steps: int, agents: int) -> Stages:
    """The Stages of a stopped `trace.profiler()`: `trace.parse`'s Trace,
    and from the same events what it leaves out: the program spans, the
    launch calls and each device op's correlation id."""
    from torch.autograd import DeviceType

    t = TRACE_PARSE(prof, steps, agents)
    pspans, threads, launches, corr = [], set(), {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            corr[(name, e.start_ns(), e.duration_ns())] = e.correlation_id()
        elif e.is_user_annotation():
            if name in trace.SPANS:
                threads.add(e.start_thread_id())
            else:
                pspans.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.start_thread_id()))
        elif name.startswith(LAUNCH_PREFIX) and e.correlation_id():
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    return attribute(t, [corr.get(o) for o in t.ops], launches, pspans, threads)


def innermost(spans: list) -> list:
    """[(start, end, name)] pieces of one thread's nested spans
    [(name, start, end, ...)], in order, each labelled by the innermost
    span open over it."""
    out: list = []
    stack: list = []   # (end, name) of the open spans

    def emit(a, b):
        if stack and b > a:
            name = stack[-1][1]
            if out and out[-1][1] == a and out[-1][2] == name:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))

    now = None
    for name, s, e, *_ in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            emit(now, stack[-1][0])
            now = stack.pop()[0]
        if stack:
            emit(now, s)
        now = s
        stack.append((e, name))
    while stack:
        emit(now, stack[-1][0])
        now = stack.pop()[0]
    return out


def _at(pieces: list, starts: list, t: int):
    """The label of the piece (of sorted, disjoint (start, end, label)
    pieces) holding time t."""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else None


def _timeline(harness: list, host: list) -> list:
    """Each harness span's time cut by the host's program-span pieces:
    [("<harness>/<span>" or "<harness>", start, end)], in order."""
    starts = [p[0] for p in host]
    out = []
    for hs, he, hname in harness:
        now = hs
        i = max(bisect.bisect_right(starts, hs) - 1, 0)
        while i < len(host) and host[i][0] < he:
            ps, pe, pname = host[i]
            a, b = max(ps, hs), min(pe, he)
            if b > a:
                if a > now:
                    out.append((hname, now, a))
                out.append((f"{hname}/{pname}", a, b))
                now = b
            i += 1
        if he > now:
            out.append((hname, now, he))
    return out


def attribute(t: trace.Trace, corrs: list, launches: dict, pspans: list,
              threads: set) -> Stages:
    """The Stages of Trace t, given each of its ops' correlation id, the
    launches {correlation id: (thread, ns)}, the program spans
    [(name, start_ns, end_ns, thread)] and the harness spans' threads."""
    if not t.spans:
        return Stages(t, [], {}, set(), 0, 0)
    by_thread: dict = {}
    for s in pspans:
        by_thread.setdefault(s[3], []).append(s)
    pieces = {tid: innermost(ss) for tid, ss in by_thread.items()}
    starts = {tid: [p[0] for p in ps] for tid, ps in pieces.items()}
    harness = [(s, e, name) for name, s, e in t.spans]
    h_starts = [h[0] for h in harness]

    labels, unlaunched = [], 0
    for (_, start, _), c in zip(t.ops, corrs):
        got = launches.get(c)
        if got is None:
            unlaunched += 1
            labels.append(_at(harness, h_starts, start) or "other")
            continue
        tid, at = got
        labels.append(_at(pieces.get(tid, []), starts.get(tid, []), at)
                      or _at(harness, h_starts, at) or "other")

    # the idle gaps shared by `trace.build` among the harness spans' pieces,
    # each labelled by the program span innermost on the harness's thread
    host = sorted(p for tid in threads for p in pieces.get(tid, []))
    idle = trace.build(t.ops, _timeline(harness, host), t.steps, t.agents).idle_by_span
    names = {s[0] for s in pspans}
    return Stages(t, labels, {k: round(s * 1e9) for k, s in idle.items()}, names,
                  unlaunched, sum(o[0] in names for o in t.ops))


def summary(st: Stages) -> dict:
    """The stage metrics; each span's kernel ms, launches, copies and card
    idle ms a step; the sums they must equal (the trace's kernel ns and
    launches, `trace.build`'s `step` idle); the kernels launched in `step`
    outside every program span; the host ms of a traced `step`."""
    t = st.trace
    n = max(t.steps, 1)
    ps = st.per_span()
    stages = {k: st.stage(k) for k in ("extract", "match", "pose")}
    in_step = [d for k, d in ps.items() if k == "step" or k in st.program]
    outside = ps.get("step", {"kernel_ns": 0, "launches": 0})
    step_spans = [e - s for name, s, e in t.spans if name == "step"]
    return {
        "metrics": st.metrics(),
        "per_span_a_step": {
            k: {"kernel_ms": d["kernel_ns"] / 1e6 / n, "launches": d["launches"] / n,
                "copy_ms": d["copy_ns"] / 1e6 / n, "copies": d["copies"] / n}
            for k, d in sorted(ps.items(), key=lambda kv: -kv[1]["kernel_ns"])},
        "idle_ms_a_step": {k: ns / 1e6 / n
                           for k, ns in sorted(st.idle_ns.items(), key=lambda kv: -kv[1])},
        "sums": {
            "kernel_ns": sum(d for _, _, d in t.kernels()),
            "kernel_ns_by_stage": {k: v["kernel_ns"] for k, v in stages.items()},
            "kernel_ns_outside_stages": sum(d["kernel_ns"] for k, d in ps.items()
                                            if not any(in_stage(k, s) for s in stages)),
            "launches": len(t.kernels()),
            "launches_by_stage": {k: v["launches"] for k, v in stages.items()},
            "launches_outside_stages": sum(d["launches"] for k, d in ps.items()
                                           if not any(in_stage(k, s) for s in stages)),
            "step_idle_ns": round(t.idle_by_span.get("step", 0.0) * 1e9),
            "step_idle_ns_by_span": sum(v for k, v in st.idle_ns.items()
                                        if k == "step" or k.startswith("step/")),
            "unlaunched_ops": st.unlaunched,
            "span_mirrors_in_ops": st.mirrors,
        },
        "outside_spans_in_step": {
            "kernel_share": outside["kernel_ns"] / max(sum(d["kernel_ns"] for d in in_step), 1),
            "launch_share": outside["launches"] / max(sum(d["launches"] for d in in_step), 1),
            "kernels": sorted({short(name)[:trace.NAME_CHARS]
                               for (name, _, _), label in zip(t.ops, st.labels)
                               if label == "step" and not trace.Trace.is_copy(name)}),
        },
        "step_span_host_ms": sum(step_spans) / 1e6 / max(len(step_spans), 1),
        "card_ms_per_agent_frame": 1e3 * t.busy_s / (n * t.agents),
        "breakdown": st.breakdown(),
    }


def main(argv: list[str] | None = None) -> int:
    """`benchmark.run`'s `main` with `--trace 1`, its traced tail parsed by
    `parse` (which returns `trace.parse`'s Trace to the run unchanged);
    prints the run's result line, then the stage split's."""
    import json
    import sys

    from . import run  # sets the benchmark's thread environment before torch loads

    got: list[Stages] = []

    def parse_and_keep(prof, steps, agents):
        got.append(parse(prof, steps, agents))
        return got[-1].trace

    trace.parse = parse_and_keep
    try:
        rc = run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    finally:
        trace.parse = TRACE_PARSE
    if rc == 0 and got:
        print(json.dumps(summary(got[-1])))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
