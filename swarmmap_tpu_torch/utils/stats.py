"""Per-stage wall-time and host<->device transfer accounting.

Port of swarmmap_tpu/utils/stats.py with the same counter names
(`rpc_fetch`, `rpc_h2d`, `fetch_wall`, `fetch_wall_main`), so a bench that
reads `STATS.summary()` means the same thing on either package.  The
JAX-only RPC-floor probe is not carried over.
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


STATS = StageStats()
