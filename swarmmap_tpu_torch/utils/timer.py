"""Timing utilities (reference counterpart: code/src/Timer.cc).

Copy of swarmmap_tpu/utils/timer.py.  ``global_clock()`` is the
process-epoch clock used for all STS/MBP timestamps (reference:
Timer::globalInstance(), used at KeyFrame.cc:64 and LandmarkScoring.cc:55).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

from .logging import get_logger

_log = get_logger("timer")
_EPOCH = time.monotonic()


def global_clock() -> float:
    """Seconds since process start — the shared STS/MBP timestamp base."""
    return time.monotonic() - _EPOCH


class Timer:
    """Accumulating named timer with simple stats."""

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.samples: list[float] = []

    @contextmanager
    def scope(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.count += 1
            self.total += dt
            self.samples.append(dt)

    def mean_ms(self) -> float:
        return 1e3 * self.total / max(self.count, 1)

    def percentile_ms(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(int(q / 100.0 * len(s)), len(s) - 1)
        return 1e3 * s[idx]


@contextmanager
def ScopeTimer(label: str, emit: Callable[[str], None] | None = None):
    """RAII-style scope timer (reference: FuncTimer() macro, Timer.h:10)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        (emit or _log.debug)(f"{label}: {dt:.2f} ms")
