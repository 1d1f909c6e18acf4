"""The default device, and batched device<->host transfer with accounting.

Port of swarmmap_tpu/utils/device.py: every host-side consumer of device
results fetches through `fetch()`, one call per logical step, so the
`rpc_fetch` / `rpc_h2d` counters count logical round trips.  A fetch
queues every device->host copy first and waits once.

Entry points that take a `device` run on `default_device()`, the card,
unless the caller names another; there is no silent fallback to the CPU.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .stats import STATS


def default_device() -> torch.device:
    """cuda:0, the device an entry point uses when the caller names none.
    Raises where there is no CUDA device: pass device="cpu" to run on the
    CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return torch.device("cuda", 0)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`, with the types that the JAX
    package's device arrays get: float64 -> float32, int64 -> int32,
    uint32 descriptor words -> int32 of the same bits."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


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


def require_one_device(mesh) -> None:
    """Raise where `mesh` (None, a torch DeviceMesh, or anything with a
    `.devices` array) spans more than one device: the observation-sharded
    global BA over a mesh is not ported yet (ROADMAP queue 1, item 17)."""
    if mesh is None:
        return
    n = mesh.size() if callable(getattr(mesh, "size", None)) else np.size(mesh.devices)
    if n > 1:
        raise NotImplementedError(
            f"global BA sharded over a {n}-device mesh is not ported yet "
            "(ROADMAP queue 1, item 17)")
