"""The process-epoch clock.

Copy of `global_clock` from swarmmap_tpu/utils/timer.py (reference
counterpart: Timer::globalInstance(), used at KeyFrame.cc:64 and
LandmarkScoring.cc:55): the shared STS/MBP timestamp base.
"""
from __future__ import annotations

import time

_EPOCH = time.monotonic()


def global_clock() -> float:
    """Seconds since process start — the shared STS/MBP timestamp base."""
    return time.monotonic() - _EPOCH
