"""Per-stage wall-time and host<->device transfer accounting.

Port of swarmmap_tpu/utils/stats.py with the same counter names
(`rpc_fetch`, `rpc_h2d`, `fetch_wall`, `fetch_wall_main`), so a bench that
reads `STATS.summary()` (or `save_csv`'s file) means the same thing on
either package, and of `measure_rpc_floor`, the round-trip probe behind
the bench's `swarm_rpc_floor_ms`.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StageStats:
    """Process-global named stage timers + event counters."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def bump(self, name: str, n: int = 1):
        self.counts[name] += n

    def reset(self):
        self.times.clear()
        self.counts.clear()

    def summary(self) -> dict:
        out: dict[str, dict] = {}
        for name, samples in sorted(self.times.items()):
            s = sorted(samples)
            out[name] = {
                "count": len(s),
                "total_s": round(sum(s), 4),
                "mean_ms": round(1e3 * sum(s) / len(s), 2),
                "p50_ms": round(1e3 * s[len(s) // 2], 2),
                "max_ms": round(1e3 * s[-1], 2),
            }
        for name, n in sorted(self.counts.items()):
            out.setdefault(name, {})["count"] = n
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'count':>7}{'total_s':>9}{'mean_ms':>9}"
                 f"{'p50_ms':>9}{'max_ms':>9}"]
        for name, d in self.summary().items():
            lines.append(
                f"{name:<28}{d.get('count', 0):>7}{d.get('total_s', 0):>9}"
                f"{d.get('mean_ms', 0):>9}{d.get('p50_ms', 0):>9}"
                f"{d.get('max_ms', 0):>9}"
            )
        return "\n".join(lines)

    def save_csv(self, path):
        import csv

        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["stage", "count", "total_s", "mean_ms", "p50_ms", "max_ms"])
            for name, d in self.summary().items():
                w.writerow([name, d.get("count", 0), d.get("total_s", 0),
                            d.get("mean_ms", 0), d.get("p50_ms", 0),
                            d.get("max_ms", 0)])


STATS = StageStats()


def measure_rpc_floor(n: int = 12, device=None) -> dict:
    """Measured per-round-trip device cost on this host: a tiny upload +
    fetch pair, and a trivial one-op dispatch + fetch (after one warm-up),
    each averaged over n (unrounded, as the port's bench
    reports).  `device` defaults to the card
    (`utils.device.default_device`).  Used by the bench to publish the
    round-trip floor."""
    import numpy as np
    import torch

    from .device import default_device

    dev = default_device() if device is None else torch.device(device)
    tiny = np.zeros(8, np.float32)

    def f(x):
        return x + 1.0

    _ = f(torch.from_numpy(tiny).to(dev)).cpu().numpy()  # warm-up
    t0 = time.perf_counter()
    for _ in range(n):
        torch.from_numpy(tiny).to(dev).cpu().numpy()
    put_get = (time.perf_counter() - t0) / n
    x = torch.from_numpy(tiny).to(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        f(x).cpu().numpy()
    dispatch_fetch = (time.perf_counter() - t0) / n
    return {
        "rpc_put_get_ms": 1e3 * put_get,
        "rpc_dispatch_fetch_ms": 1e3 * dispatch_fetch,
    }
