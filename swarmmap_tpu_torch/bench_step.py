"""Time the batched tracking step of this checkout against another one.

    python -m swarmmap_tpu_torch.bench_step [--other DIR] [--out DIR]

Drives the main path in the cells of `cells.py` (3 agents, 480x752, 1000
features, 8 levels, 2048 map points; pinhole and EuRoC-distorted).  With
--other (for example a `git archive` of the parent commit unpacked under
the gitignored `_scratch/`), that checkout's package is loaded into the
same process under another name and the two take turns step by step
(other, this, this, other, ...) on the same inputs, so that drift on the
host falls on both alike.  Each step is timed by CUDA events around one
call and by the host clock to its end (`cells.timed_call`).  Prints the
median, lowest and highest of each, and with --other the paired
differences (this minus other, step i against step i) with their
quartiles; writes every sample to DIR/bench_step.json.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

STEPS = 30  # timed steps per cell and checkout


def load_pipeline(tree: Path, alias: str):
    """The pipeline module of the swarmmap_tpu_torch package in `tree`,
    imported as the package `alias`."""
    init = tree / "swarmmap_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.pipeline")


def spread(v: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles(v, n=4)
    return {"median": med, "q1": q1, "q3": q3, "min": min(v), "max": max(v)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="checkout timed in turns with this one")
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_step needs a CUDA device")

    from . import pipeline
    from .cells import STEP_KW, build_cells, timed_call

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    versions = {"this": pipeline}
    if args.other:
        versions["other"] = load_pipeline(Path(args.other).resolve(), "swarmmap_tpu_torch_other")
    cells = build_cells(torch.device("cuda", 0))
    for pipe in versions.values():  # warm-up, kernel builds included
        for inp in cells.values():
            for _ in range(3):
                pipe.batched_tracking_step(inp, **STEP_KW)
    samples = {who: {c: {"event_ms": [], "wall_ms": []} for c in cells} for who in versions}
    order = list(versions)[::-1]
    for i in range(STEPS):
        for who in (order if i % 2 == 0 else order[::-1]):
            for c, inp in cells.items():
                ev, wall = timed_call(
                    lambda: versions[who].batched_tracking_step(inp, **STEP_KW))
                samples[who][c]["event_ms"].append(ev)
                samples[who][c]["wall_ms"].append(wall)
    summary = {who: {f"step_{c}_{k}": spread(v) for c, d in per.items() for k, v in d.items()}
               for who, per in samples.items()}
    if args.other:
        summary["this_minus_other"] = {
            f"step_{c}_{k}": spread([t - o for t, o in zip(v, samples["other"][c][k])])
            for c, d in samples["this"].items() for k, v in d.items()}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench_step.json").write_text(json.dumps(
        {"device": smi, "steps": STEPS, "summary": summary, "samples": samples}, indent=1))
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
