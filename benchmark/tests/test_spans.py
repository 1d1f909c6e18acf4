"""CPU tests of `benchmark.spans`: the program's spans read by launch
(run with `python -m pytest benchmark/tests`)."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import spans, trace

U = 100_000  # 0.1 ms in ns
HARNESS = [("harness", 0, 20 * U, 1), ("upload", 20 * U, 30 * U, 1),
           ("step", 30 * U, 130 * U, 1), ("fetch", 130 * U, 140 * U, 1)]
PROGRAM = [("extract", 30 * U, 80 * U, 1), ("extract.fast", 40 * U, 60 * U, 1),
           ("match", 80 * U, 110 * U, 1), ("match.hamming", 90 * U, 100 * U, 1),
           ("pose", 110 * U, 125 * U, 1)]
# (name, device start, duration, correlation id) and each id's launch time
OPS = [("Memcpy HtoD (Pageable -> Device)", 26 * U, 2 * U, 1), ("k_a", 36 * U, 4 * U, 2),
       ("k_fast1", 46 * U, 4 * U, 3), ("k_fast2", 50 * U, 5 * U, 4), ("k_m", 86 * U, 2 * U, 5),
       ("k_h", 96 * U, 10 * U, 6), ("pose_lm_kernel<4, 8>", 116 * U, 1 * U, 7),
       ("k_out", 128 * U, 1 * U, 8), ("Memcpy DtoH (Device -> Pinned)", 133 * U, 2 * U, 9)]
LAUNCHED = {1: 25, 2: 35, 3: 45, 4: 50, 5: 85, 6: 95, 7: 115, 8: 127, 9: 132}
LAUNCHES = {c: (1, t * U) for c, t in LAUNCHED.items()}


class _Event:
    """A KinetoEvent's accessors; `kind` says whether it is a user annotation."""

    def __init__(self, name, start, dur, device, kind, corr=0, tid=1):
        self._v = (name, start, dur, device, kind, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4] in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def _events(program, mirror_flagged: bool):
    """A traced step's events: host spans, launch calls, device ops and the
    device-side mirrors of three ranges, spanning their kernels."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [_Event(n, s, e - s, cpu, "user_annotation") for n, s, e, _ in HARNESS + program]
    ev += [_Event("cudaLaunchKernel", t, 10, cpu, "cuda_runtime", c) for c, (_, t) in
           LAUNCHES.items()]
    ev += [_Event(n, s, d, cuda, "kernel", c) for n, s, d, c in OPS]
    kind = "gpu_user_annotation" if mirror_flagged else "kernel"
    ev += [_Event("extract.fast", 46 * U, 9 * U, cuda, kind),
           _Event("match", 86 * U, 20 * U, cuda, kind), _Event("step", 36 * U, 93 * U, cuda,
                                                                "gpu_user_annotation")]
    return ev


def stages(program=PROGRAM, mirrors_flagged=True):
    return spans.parse(_Prof(_events(program, mirrors_flagged)), 1, 2)


def test_device_ms_launches_and_idle_by_span():
    st = stages()
    ps = st.per_span()
    assert {k: (d["kernel_ns"], d["launches"]) for k, d in ps.items() if d["launches"]} == {
        "extract": (4 * U, 1), "extract.fast": (9 * U, 2), "match": (2 * U, 1),
        "match.hamming": (10 * U, 1), "pose": (1 * U, 1), "step": (1 * U, 1)}
    # k_h runs past its span's end: it stays with the span that launched it
    assert st.labels[[o[0] for o in st.trace.ops].index("k_h")] == "match.hamming"
    assert ps["upload"]["copies"] == ps["fetch"]["copies"] == 1
    assert st.idle_ns == {"harness": 20 * U, "upload": 8 * U, "step/extract": 26 * U,
                          "step/extract.fast": 11 * U, "step/match": 12 * U,
                          "step/match.hamming": 6 * U, "step/pose": 14 * U, "step": 4 * U,
                          "fetch": 8 * U}
    got = st.metrics()
    want = {"front_end_device_ms": 1.3, "front_end_launches_per_agent_frame": 1.5,
            "front_end_idle_ms": 3.7, "matching_device_ms": 1.2,
            "matching_launches_per_agent_frame": 1.0, "matching_idle_ms": 1.8}
    assert got == pytest.approx(want)
    assert st.unlaunched == 0


def test_stages_add_up_to_the_trace():
    s = spans.summary(stages())
    sums = s["sums"]
    assert sum(sums["kernel_ns_by_stage"].values()) + sums["kernel_ns_outside_stages"] == (
        sums["kernel_ns"]) == 27 * U
    assert sum(sums["launches_by_stage"].values()) + sums["launches_outside_stages"] == (
        sums["launches"]) == 7
    assert sums["step_idle_ns_by_span"] == sums["step_idle_ns"] == 73 * U
    out = s["outside_spans_in_step"]
    assert out["kernels"] == ["k_out"] and out["launch_share"] == pytest.approx(1 / 7)
    assert out["kernel_share"] == pytest.approx(1 / 27)
    assert s["per_span_a_step"]["extract.fast"] == {"kernel_ms": 0.9, "launches": 2.0,
                                                    "copy_ms": 0.0, "copies": 0.0}


def test_step_idle_labels_sum_to_the_step_figure():
    st = stages()
    parts = sum(v for k, v in st.idle_ns.items() if k == "step" or k.startswith("step/"))
    assert parts == round(st.trace.idle_by_span["step"] * 1e9)
    assert sum(st.idle_ns.values()) == round((st.trace.window_s - st.trace.busy_s) * 1e9)
    labels = dict(st.breakdown()["idle_gaps"])
    assert labels["step/extract"] == pytest.approx(26 * U / 1e9)


def test_breakdown_names_the_stage_and_kernel():
    ops = stages().breakdown()["device_ops"]
    assert ops[0] == ["match.hamming: k_h", pytest.approx(1e-3)]
    assert all(": " in k for k, _ in ops)
    name = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
            "<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 3, 128, 1>")
    assert spans.short(name).startswith("CatArrayBatchedCopy_vectorized<OpaqueType<4u>")


def test_without_program_spans_everything_is_the_trace():
    st = stages(program=[])
    want = trace.build([o[:3] for o in OPS], [h[:3] for h in HARNESS], 1, 2)
    assert st.trace == want == trace.parse(_Prof(_events([], True)), 1, 2)
    assert st.breakdown() == want.breakdown()
    assert st.metrics() == {}
    assert {k: v / 1e9 for k, v in st.idle_ns.items()} == pytest.approx(want.idle_by_span)


def test_main_reads_the_run_s_traced_tail(monkeypatch, capsys):
    """`main` is `benchmark.run.main` with --trace 1, whose traced tail
    `trace.parse` reads; the run gets the Trace, and the split follows."""
    from benchmark import run

    seen = []

    def fake_main(argv):
        seen.append(argv)
        got = trace.parse(_Prof(_events(PROGRAM, True)), 1, 2)
        assert got == stages().trace
        print('{"result": 1}')
        return 0

    monkeypatch.setattr(run, "main", fake_main)
    assert spans.main(["--workload", "mh12345.track", "--seed", "2147483001",
                       "--seconds", "1"]) == 0
    assert seen[0][-2:] == ["--trace", "1"]
    assert trace.parse is spans.TRACE_PARSE
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == '{"result": 1}'
    assert json.loads(lines[1]) == json.loads(json.dumps(spans.summary(stages())))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run's refusal without a card")
def test_main_without_a_card_is_the_run_s_refusal():
    assert spans.main(["--workload", "mh12345.track", "--seed", "2147483001",
                       "--seconds", "1"]) == 2
    assert trace.parse is spans.TRACE_PARSE


def test_innermost_pieces():
    got = spans.innermost([("a", 0, 10), ("a.b", 2, 4), ("a.c", 4, 6), ("a.c.d", 5, 6)])
    assert got == [(0, 2, "a"), (2, 4, "a.b"), (4, 5, "a.c"), (5, 6, "a.c.d"), (6, 10, "a")]


def test_a_flagged_span_mirror_is_never_a_device_op():
    st = stages()
    assert [o[0] for o in st.trace.ops] == [o[0] for o in OPS]
    assert st.mirrors == 0 and spans.summary(st)["sums"]["span_mirrors_in_ops"] == 0


def test_an_unflagged_span_mirror_is_reported():
    """`trace.parse` keeps out of `Trace.ops` only the annotations torch
    flags; a program span's mirror that it let through is counted."""
    st = stages(mirrors_flagged=False)
    assert sorted(o[0] for o in st.trace.ops if o[0] in st.program) == ["extract.fast", "match"]
    assert spans.summary(st)["sums"]["span_mirrors_in_ops"] == st.mirrors == 2


def test_program_spans_of_a_cpu_profile():
    """The real profiler's events: the tiny step's spans are program spans."""
    from swarmmap_tpu_torch import pipeline

    inp = pipeline.stack_inputs([pipeline.realistic_track_inputs(
        hw=(240, 320), n_map_points=256, n_features=256, n_levels=3, device="cpu")])
    prof = trace.profiler()
    with prof:
        with trace.span("step", True):
            pipeline.batched_tracking_step(inp, n_features=256, n_levels=3, hw=(240, 320))
    st = spans.parse(prof, 1, 1)
    assert st.program == {"extract", "extract.pyramid", "extract.fast", "extract.orientation",
                          "extract.blur", "extract.patches", "extract.brief", "match",
                          "match.undistort", "match.project", "match.window",
                          "match.hamming", "match.pair", "pose"}
    assert [s[0] for s in st.trace.spans] == ["step"]
    if not torch.cuda.is_available():
        assert st.trace.ops == [] and set(st.idle_ns) <= {"step"} | {
            f"step/{n}" for n in st.program}
