"""CPU tests of the benchmark harness (run with `python -m pytest benchmark/tests`).

The cells run here at a tiny size on the CPU, where the program takes its
plain path; the card's tests are marked `gpu` and skip without one.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, trace

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell: harness.Cell) -> harness.Cell:
    """The cell at 240x320, 600 features, 4 levels, 512 map points."""
    cfg = dict(cell.cfg, height=240, width=320, n_features=600, n_levels=4, map_points=512,
               fx=230.0, fy=229.0, cx=160.0, cy=120.0)
    cfg["world"] = dict(cfg["world"], landmarks=900)
    mix = dict(cell.mix, ring_frames=4, sample_steps=3, trace_steps=2, warmup_steps=1)
    return cell._replace(cfg=cfg, mix=mix)


def run_tiny(name: str = "mh12345.track", traced: bool = False, seed: int = 2**31 + 7) -> dict:
    # 4 s: at least three steps, so that the sample holds 15 agent frames or
    # more and one frame that rounding leaves unconverged cannot move the
    # 90th percentile of the pose gaps
    return harness.run(tiny(harness.cell(name)), seed, 4.0, traced, "cpu",
                       time.perf_counter(), log=lambda s: None)


def test_spec_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    c = harness.cell(name)
    assert c.cfg["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert (REPO / "benchmark" / "drivers" / f"{c.mix['driver']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert set(check.limits(name)) == set(check.NUMBERS)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and c.per_layer


def test_unused_mix_resolves():
    mix = json.loads((REPO / "benchmark" / "traffic" / "swarm.json").read_text())
    assert (REPO / "benchmark" / "drivers" / f"{mix['driver']}.py").is_file()
    assert "swarm" not in {w["traffic"] for w in SPEC["workloads"]}


def test_tiny_run_on_the_cpu_gives_the_result_line():
    res = run_tiny()
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["attempted"] % 5 == 0
    # every end-to-end metric but the card's time, which has no card to read here
    assert set(res["metrics"]) == {m["name"] for m in SPEC["end_to_end"]} - {
        "card_ms_per_agent_frame"}
    assert res["metrics"]["tracked_pct"]["value"] == 100.0
    assert set(res["checks"]) == set(check.NUMBERS)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_traced_tiny_run_gives_breakdown():
    res = run_tiny("kitti00-02.track", traced=True)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert {"step_enqueue_ms", "fetch_wait_ms"} <= set(res["metrics"])


def _half_batch(step):
    def broken(inp, **kw):
        half = max(inp.image.shape[0] // 2, 1)
        out = step(type(inp)(*(x[:half] for x in inp)), **kw)
        rows = torch.arange(inp.image.shape[0]) % half

        def fill(x):
            return x[rows]
        return type(out)(*(fill(x) for x in out[:3]),
                         type(out.features)(*(fill(x) for x in out.features)), fill(out.xy_ud))
    return broken


def _altered_pose(step):
    def broken(inp, **kw):
        out = step(inp, **kw)
        Tcw = out.Tcw.clone()
        Tcw[0, 0, 3] += 0.01
        return out._replace(Tcw=Tcw)
    return broken


def _altered_descriptor(step):
    def broken(inp, **kw):
        out = step(inp, **kw)
        desc = out.features.desc.clone()
        desc[0, 0, 0] ^= 1
        return out._replace(features=out.features._replace(desc=desc))
    return broken


def _pose_unchanged(optimize):
    def broken(Tcw0, K, pts_w, uv, inv_sigma2, valid, **kw):
        res = optimize(Tcw0, K, pts_w, uv, inv_sigma2, valid, **kw)
        return res._replace(Tcw=Tcw0.clone(), inliers=valid.clone())
    return broken


@pytest.mark.parametrize("fault", ["pose_unchanged", "half_batch", "altered_pose",
                                   "altered_descriptor"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    """The timed path broken underneath: the run still ends, `correct` is
    false.  (One chip: no exchange between chips to leave out.)"""
    from swarmmap_tpu_torch import pipeline
    from swarmmap_tpu_torch.ops import pose_opt

    if fault == "pose_unchanged":
        monkeypatch.setattr(pose_opt, "pose_optimize_auto",
                            _pose_unchanged(pose_opt.pose_optimize_auto))
    else:
        wrap = {"half_batch": _half_batch, "altered_pose": _altered_pose,
                "altered_descriptor": _altered_descriptor}[fault]
        monkeypatch.setattr(pipeline, "batched_tracking_step",
                            wrap(pipeline.batched_tracking_step))
    res = run_tiny()
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed, res["checks"]


def test_reservoir_is_fixed_by_the_seed():
    picks = []
    for _ in range(2):
        r = check.Reservoir(4, np.random.default_rng([5, 2]))
        for i in range(100):
            r.offer(i)
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] and len(set(picks[0])) == 4


def test_nan_pose_fails_the_comparison():
    host = {"xy": np.zeros((1, 2, 2)), "octave": np.zeros((1, 2)), "desc": np.zeros((1, 2, 8)),
            "valid": np.ones((1, 2), bool), "match_mp": np.zeros((1, 2)),
            "Tcw": np.eye(4)[None], "n_inliers": np.array([5])}
    bad = dict(host, Tcw=np.full((1, 4, 4), np.nan))
    ok, _ = check.judge(check.compare([bad], [host]), {k: 1.0 for k in check.NUMBERS})
    assert not ok


def test_one_far_frame_moves_the_widest_pose_gap_and_not_the_percentile():
    eye = np.broadcast_to(np.eye(4), (20, 4, 4)).copy()
    ref = {"xy": np.zeros((20, 2, 2)), "octave": np.zeros((20, 2)),
           "desc": np.zeros((20, 2, 8)), "valid": np.ones((20, 2), bool),
           "match_mp": np.zeros((20, 2)), "Tcw": eye, "n_inliers": np.full(20, 5)}
    prog = dict(ref, Tcw=eye.copy())
    prog["Tcw"][3, 0, 3] += 5e-3
    got = check.compare([prog], [ref])
    assert got["pose_err_max"] == pytest.approx(5e-3) and got["pose_err_p90"] == 0.0


def test_trace_busy_and_idle_gaps():
    ms = 1_000_000
    spans = [("harness", 0, 2 * ms), ("upload", 2 * ms, 3 * ms), ("step", 3 * ms, 9 * ms),
             ("fetch", 9 * ms, 10 * ms)]
    ops = [("k1", 4 * ms, 1 * ms), ("k2", 6 * ms, 2 * ms), ("Memcpy DtoH", 9 * ms, ms // 2)]
    t = trace.build(ops, spans, steps=1, agents=2)
    assert t.window_s == pytest.approx(0.010) and t.busy_s == pytest.approx(0.0035)
    assert t.idle_by_span["step"] == pytest.approx(0.003)
    assert t.idle_by_span["harness"] == pytest.approx(0.002)
    assert [k[0] for k in t.kernels()] == ["k1", "k2"]
    assert t.breakdown()["device_ops"][0] == ["k2", pytest.approx(0.002)]


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """The whole tiny run in a fresh process; top-level names compared whole
    (swarmmap_tpu_torch begins with swarmmap_tpu and must pass)."""
    top = _modules_after(
        "import time, torch\ntorch.set_num_threads(2)\n"
        "from benchmark import harness\nfrom benchmark.tests import test_bench_harness as t\n"
        "t.run_tiny()\nassert not harness.forbidden_modules(), harness.forbidden_modules()")
    assert "swarmmap_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "swarmmap_tpu"}


def test_reference_imports_nothing_of_the_program():
    top = _modules_after("import benchmark.reference.track, benchmark.generator, "
                         "benchmark.check, benchmark.roofline")
    assert not top & {"jax", "jaxlib", "flax", "swarmmap_tpu", "swarmmap_tpu_torch"}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.gpu
def test_control_fails_and_program_passes_on_the_card():
    """The control (the reference in TF32) at a small size on the card:
    the program's readings stay within the cell's limits, the control's
    front-end reading does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import control

    c = tiny(harness.cell(CELLS[0]))
    lim = check.limits(CELLS[0])
    got = control.readings(c, 11, 2.0, torch.device("cuda", 0), True)
    assert check.judge(got["program"], lim)[0], got
    assert not check.judge(got["control"], lim)[0], got


def test_pose_lm_roofline_counts_the_problems_active_points():
    """The reader's bound: every valid point of a problem solved exactly
    stays active in both rounds; 1 us of kernel in the trace."""
    from benchmark import roofline

    K = torch.tensor([[[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]]])
    pts = torch.stack([torch.linspace(-1, 1, 8), torch.linspace(-0.5, 0.5, 8),
                       torch.full((8,), 5.0)], -1)[None]
    uv = pts[..., :2] / pts[..., 2:] * 450.0 + torch.tensor([320.0, 240.0])
    prob = (torch.eye(4)[None], K, pts, uv, torch.ones(1, 8), torch.ones(1, 8, dtype=torch.bool))
    cell = harness.cell(CELLS[0])
    tr = trace.build([("pose_lm_kernel<4, 8>", 0, 1000)], [("step", 0, 2000)], 1, 1)
    ctx = harness.Context(cell, 0.0, None, tr, [0], lambda key: {"problem": prob},
                          lambda line: None)
    rounds, iters = cell.cfg["pose_rounds"], cell.cfg["pose_iters"]
    want = roofline.pose_bound(1, 8, 8, [8] * rounds, rounds, iters)[0] / 1e-3 * 100.0
    assert harness.reader("pose_lm_roofline")(ctx) == pytest.approx(want)
