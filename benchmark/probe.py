"""Runs a configuration under a traffic mix that is no cell yet.

    python -m benchmark.probe --config <config> --traffic <mix> --limits <cell> \
        --seed <n> --seconds <s> [--trace 0|1]

The same run as `benchmark.run` (set-up, window, optional traced tail,
the comparison with the plain reference under cell `--limits`'s limits),
for a pair of configuration and mix that `BENCHMARK.json` does not list,
with the end-to-end metrics of the spec's list.  Prints the result line
last.  Probes decide whether a mix is steady enough to become a cell.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag in ("--config", "--traffic", "--limits"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from . import harness

    s = harness.spec()
    c = next(c for c in s["configs"] if c["name"] == args.config)
    cell = harness.Cell(
        args.limits, json.loads((harness.REPO / c["file"]).read_text()),
        json.loads((harness.ROOT / "traffic" / f"{args.traffic}.json").read_text()),
        1, s["end_to_end"], s["per_layer"])
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
