"""Readings behind each cell's limits: the program and the control.

    python -m benchmark.control --workload <cell> --seeds A-B --control-seeds C-D [--seconds S] [--dump DIR]

For each seed, in one process: the cell's set-up, a short window of the
timed path at the cell's own size, and the comparison of its sampled steps
with the plain reference (the program's readings).  For each control seed
also the control: the reference in the program's place, computed in TF32
(the precision below the configurations' float32 with TF32 off), compared
with the reference; and each fault a cell can have, planted in the
reference's outputs (`planted`).  Prints one JSON line per seed, then the
largest program reading and the smallest control and fault readings of
each number.  The benchmark's own runs never run it.
Needs a CUDA device unless --device names another.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np


def span(text: str) -> list[int]:
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


FAULTS = ("pose_unchanged", "half_batch", "altered_pose", "altered_descriptor")


def planted(fault: str, out: dict, guess: np.ndarray) -> dict:
    """The reference's host outputs of one step with a fault planted where
    they are produced: the pose left at its guess, half of the batch left
    out (its first half's outputs in every row), one agent's pose moved
    1 cm, one descriptor bit flipped."""
    o = {k: v.copy() for k, v in out.items()}
    if fault == "pose_unchanged":
        o["Tcw"] = guess.astype(np.float64)
    elif fault == "half_batch":
        rows = np.arange(len(o["Tcw"])) % max(len(o["Tcw"]) // 2, 1)
        o = {k: v[rows] for k, v in o.items()}
    elif fault == "altered_pose":
        o["Tcw"][0, 0, 3] += 0.01
    elif fault == "altered_descriptor":
        o["desc"][0, 0, 0] ^= 1
    return o


def readings(cell, seed: int, seconds: float, device, control: bool, dump=None) -> dict:
    """{"program": numbers, ["control": numbers, "faults": {fault: numbers}]}
    of one seed; with `dump`, each sampled agent frame's pose gaps go to
    <dump>/<cell>.<seed>.npz (the program's, the control's, and the
    reference's own LM in float32 against its float64 one)."""
    from . import check
    from .reference import track as ref_track

    driver = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}").Driver(
        cell.cfg, cell.mix, seed, device)
    driver.window(seconds)
    samples = driver.outputs()
    rings = sorted({r for r, _ in samples})
    full = {r: driver.reference(r) for r in rings}
    host = {r: {k: v.cpu().numpy() for k, v in full[r].items() if k != "problem"} for r in rings}
    prog = [p for _, p in samples]
    ref = [host[r] for r, _ in samples]
    out = {"program": check.compare(prog, ref)}
    gaps = {"program": np.concatenate([check.frame_gaps(p, r) for p, r in zip(prog, ref)]),
            "inliers": np.concatenate([r["n_inliers"] for r in ref])}
    if control:
        ctl = {r: {k: v.cpu().numpy() for k, v in driver.reference(r, tf32=True).items()
                   if k != "problem"} for r in rings}
        out["control"] = check.compare([ctl[r] for r, _ in samples], ref)
        gaps["control"] = np.concatenate([check.frame_gaps(ctl[r], host[r]) for r, _ in samples])
        guess = {r: full[r]["problem"][0].cpu().numpy() for r in rings}
        out["faults"] = {f: check.compare([planted(f, host[r], guess[r]) for r, _ in samples], ref)
                         for f in FAULTS}
    if dump:
        rounds, iters = cell.cfg["pose_rounds"], cell.cfg["pose_iters"]
        f32 = {}
        for r in rings:
            prob = tuple(x.float() if x.is_floating_point() else x for x in full[r]["problem"])
            f32[r] = {"Tcw": ref_track.pose_lm(*prob, rounds, iters)[0].cpu().numpy()}
        gaps["ref_f32"] = np.concatenate([check.frame_gaps(f32[r], host[r]) for r, _ in samples])
        Path(dump).mkdir(parents=True, exist_ok=True)
        np.savez(Path(dump) / f"{cell.name}.{seed}.npz", **gaps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=span)
    ap.add_argument("--control-seeds", default="", type=lambda s: span(s) if s else [])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default=None, help="directory for each seed's per-frame pose gaps")
    args = ap.parse_args(argv)
    import torch

    from . import check, harness

    cell = harness.cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lo = {k: 0.0 for k in check.NUMBERS}
    hi = {k: float("inf") for k in check.NUMBERS}
    faults = {f: dict(hi) for f in FAULTS}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        got = readings(cell, seed, args.seconds, device, seed in args.control_seeds, args.dump)
        print(json.dumps({"workload": cell.name, "seed": seed, **got}), flush=True)
        if seed in args.seeds:
            lo = {k: max(lo[k], got["program"][k]) for k in lo}
        if "control" in got:
            hi = {k: min(hi[k], got["control"][k]) for k in hi}
            faults = {f: {k: min(v[k], got["faults"][f][k]) for k in v} for f, v in faults.items()}
    print(json.dumps({"workload": cell.name, "program_max": lo, "control_min": hi,
                      "fault_min": faults}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
