"""The tracking step's profiler ranges (`utils.profiling.named_range`).

Under a CPU torch.profiler, `pipeline.batched_tracking_step` opens one
range per stage: `extract` with its `extract.*` parts, `match` with its
`match.*` parts, and `pose`; every aten op of the call lies inside one, and
the outputs are the bits of an untraced call.  Outside a profiler no range
is built.  Small shapes: 2 agents (one pinhole, one distorted) at 240x320,
256 features, 3 levels, 512 map points.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swarmmap_tpu_torch import pipeline
from swarmmap_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KW = dict(n_features=256, n_levels=3, hw=(240, 320))
EXTRACT = ("extract.pyramid", "extract.fast", "extract.orientation", "extract.blur",
           "extract.patches", "extract.brief")
MATCH = ("match.undistort", "match.project", "match.window", "match.hamming", "match.pair")
SPANS = ("extract",) + EXTRACT + ("match",) + MATCH + ("pose",)


@pytest.fixture(scope="module")
def inputs():
    agents = [pipeline.realistic_track_inputs(
        hw=KW["hw"], n_map_points=512, n_features=256, n_levels=3, seed=s, dist=d,
        device="cpu") for s, d in ((0, (0.0,) * 5), (1, (-0.28, 0.07, 2e-4, 2e-5, 0.0)))]
    return pipeline.stack_inputs(agents)


@pytest.fixture(scope="module")
def traced(inputs):
    """(outputs, user annotations [(name, start, end, thread)], aten ops)"""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipeline.batched_tracking_step(inputs, **KW)
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
        if e.is_user_annotation():
            spans.append(iv)
        elif e.name().startswith("aten::"):
            ops.append(iv)
    return out, spans, ops


def _inside(iv, outer):
    return iv[3] == outer[3] and outer[1] <= iv[1] and iv[2] <= outer[2]


def test_every_stage_opens_its_span(traced):
    _, spans, _ = traced
    names = {s[0] for s in spans}
    assert names == set(SPANS), names ^ set(SPANS)
    by = {n: [s for s in spans if s[0] == n] for n in SPANS}
    assert len(by["extract"]) == len(by["match"]) == len(by["pose"]) == 1
    # one FAST, orientation, blur and patch range per pyramid level
    for n in ("extract.fast", "extract.orientation", "extract.blur", "extract.patches"):
        assert len(by[n]) == KW["n_levels"], n
    for parent, parts in (("extract", EXTRACT), ("match", MATCH)):
        for n in parts:
            assert by[n] and all(_inside(s, by[parent][0]) for s in by[n]), n
    # the stages follow one another: extract, then match, then pose
    assert by["extract"][0][2] <= by["match"][0][1]
    assert by["match"][0][2] <= by["pose"][0][1]


def test_every_aten_op_lies_in_a_span(traced):
    _, spans, ops = traced
    assert ops
    outside = [op[0] for op in ops if not any(_inside(op, s) for s in spans)]
    assert not outside, outside


def test_outputs_bit_identical_with_and_without_profiler(inputs, traced):
    plain = pipeline.batched_tracking_step(inputs, **KW)
    out, _, _ = traced
    flat = lambda o: list(o[:3]) + list(o.features) + [o.xy_ud]  # noqa: E731
    for a, b in zip(flat(plain), flat(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_range_built_outside_a_profiler(inputs, monkeypatch):
    def refuse(label):
        raise AssertionError(f"record_function({label!r}) built outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.named_range("extract") is profiling.named_range("pose")
    with profiling.named_range("extract") as x:
        assert x is None
    pipeline.batched_tracking_step(inputs, **KW)


def test_range_built_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = profiling.named_range("match.pair")
        assert isinstance(r, torch.profiler.record_function)
        with r:
            torch.ones(2).add_(1)
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()] == ["match.pair"]
