"""Batched device<->host transfer with accounting.

Port of swarmmap_tpu/utils/device.py: every host-side consumer of device
results fetches through `fetch()`, one call per logical step, so the
`rpc_fetch` / `rpc_h2d` counters count logical round trips.  A fetch
queues every device->host copy first and waits once.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .stats import STATS


def _map(fn, tree, leaf=torch.Tensor):
    """Apply fn to every `leaf` of a tree of NamedTuples, tuples, lists
    and dicts; other leaves (None, ints) pass through."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map(fn, x, leaf) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, leaf) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, leaf) for k, v in tree.items()}
    return tree


def fetch(*trees):
    """Copy any number of tensors (or NamedTuples / lists / dicts of them)
    to host numpy in one batched round trip.  Returns a tuple matching the
    inputs (or the single object for one argument)."""
    STATS.bump("rpc_fetch")
    t0 = time.perf_counter()
    obj = trees if len(trees) > 1 else trees[0]
    host = _map(lambda t: t.detach().to("cpu", non_blocking=True), obj)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = _map(lambda t: t.numpy(), host)
    dt = time.perf_counter() - t0
    STATS.times["fetch_wall"].append(dt)
    if threading.current_thread() is threading.main_thread():
        STATS.times["fetch_wall_main"].append(dt)
    return out


def upload(*trees, device: torch.device | str):
    """Host->device transfer of numpy arrays (or trees of them) as one
    logical upload event.  Returns a tuple matching the inputs (or the
    single object for one argument)."""
    STATS.bump("rpc_h2d")
    obj = trees if len(trees) > 1 else trees[0]
    return _map(lambda x: torch.as_tensor(x).to(device, non_blocking=True),
                obj, leaf=np.ndarray)
