"""Shape bucketing: pad dynamic work sizes to power-of-two buckets so
jitted device programs compile once per bucket instead of once per call
(SURVEY.md §7.4 hard part #3 — dynamic map growth vs static shapes).

Copy of swarmmap_tpu/utils/padding.py.  The port keeps the buckets: the
matching tie-breaks (first index wins) see the padded order, so the same
padding gives the same matches."""
from __future__ import annotations

import numpy as np


def bucket_size(n: int, min_size: int = 64) -> int:
    b = min_size
    while b < n:
        b *= 2
    return b


def pad_slots(slots: np.ndarray, min_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Pad an int index array to its bucket; returns (padded, valid_mask).
    Padding indexes slot 0 (always in-range) with valid=False."""
    n = len(slots)
    b = bucket_size(max(n, 1), min_size)
    out = np.zeros(b, slots.dtype if slots.dtype != np.int64 else np.int32)
    out[:n] = slots
    valid = np.zeros(b, bool)
    valid[:n] = True
    return out, valid


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 of `arr` with zeros up to `bucket` rows."""
    if len(arr) >= bucket:
        return arr[:bucket]
    out = np.zeros((bucket,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out
