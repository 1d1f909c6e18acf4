"""Runs one cell of `BENCHMARK.json` and builds its result line.

Everything is found by name: the cell's configuration at the `file` its
entry names, its traffic mix at `traffic/<mix>.json`, the mix's driver at
`drivers/<driver>.py`, each metric's reader at `metrics/<metric>.py` and
the cell's limits at `limits/<cell>.json`.  A new cell, mix or metric is
new files and entries; nothing here names one.

A run: the driver's set-up (inputs from the seed, the program's first
calls at the cell's shapes; `setup_s` leaves out the making of the
inputs), the measured window, a traced tail of the mix's `trace_steps`
after it (the device time of every run; with `--trace 1` the per-layer
metrics and the breakdown too), the device's peak memory, then the
comparison with the plain reference on a sample of the window's steps.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "swarmmap_tpu")


class Cell(NamedTuple):
    name: str
    cfg: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list


class Context(NamedTuple):
    """What a metric reader may read."""
    cell: Cell
    setup_s: float
    window: object       # the driver's Window
    trace: object        # trace.Trace of the traced tail
    traced_keys: list    # the traced steps' keys for `reference`
    reference: object    # key -> the plain reference's outputs (cached)
    log: object          # prints a line to standard error


def spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell(name: str, s: dict | None = None) -> Cell:
    s = spec() if s is None else s
    w = next((w for w in s["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in s["configs"] if c["name"] == w["config"])
    cfg = json.loads((REPO / c["file"]).read_text())
    mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, cfg, mix, w["chips"], s["end_to_end"], s["per_layer"])


def reader(metric: str):
    path = ROOT / "metrics" / f"{metric}.py"
    spec_ = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def read_metrics(metrics: list, ctx: Context) -> dict:
    """Each metric's reader; one that finds nothing to read in this cell
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(c: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log=print) -> dict:
    """One run of cell `c`; returns the result object (see run.py)."""
    import torch

    from . import check

    device = torch.device(device)
    driver = importlib.import_module(f"benchmark.drivers.{c.mix['driver']}").Driver(
        c.cfg, c.mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the program's set-up: imports, kernel builds or loads, warm-up; not
    # the benchmark's own making of the inputs
    setup_s = time.perf_counter() - t_start - driver.inputs_s
    win = driver.window(seconds)
    tr = driver.traced(c.mix["trace_steps"])
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    samples = driver.outputs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs: dict = {}

    def reference(key):
        if key not in refs:
            refs[key] = driver.reference(key)
        return refs[key]

    prog = [p for _, p in samples]
    ref = [{k: v.cpu().numpy() for k, v in reference(r).items() if k != "problem"}
           for r, _ in samples]
    correct, checks = check.judge(check.compare(prog, ref), check.limits(c.name))
    ctx = Context(c, setup_s, win, tr, driver.traced_keys, reference, log)
    result = {
        "correct": correct,
        "attempted": win.frames,
        "failed": win.frames - win.tracked_frames,
        "metrics": read_metrics(c.per_layer if traced else c.end_to_end, ctx),
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": c.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
