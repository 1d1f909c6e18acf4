"""The default device, and batched device<->host transfer with accounting.

Port of swarmmap_tpu/utils/device.py: every host-side consumer of device
results fetches through `fetch()`, one call per logical step, so the
`rpc_fetch` / `rpc_h2d` counters count logical round trips.  A fetch
queues every device->host copy first and waits once, on an event of its
own copies (as `jax.device_get` waits on the arrays it is given);
`fetch_async` enqueues the copies and leaves the wait to its handle.

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


class HostCopy:
    """Device->host copies already enqueued: `result()` waits for them and
    gives numpy, in the shape of the tree they were taken of.

    A leaf on a CUDA device is copied `non_blocking` into a pinned host
    buffer on the current stream, and one event recorded after the copies
    is all `result()` waits on: work queued after them, on this stream,
    another stream or from another thread, does not hold it up.  A leaf
    on the CPU is copied at once.  `result()` may be called from any
    thread; each call is accounted as one fetch (`rpc_fetch`,
    `fetch_wall`, `fetch_wall_main`), and the first one waits (later
    calls return the same arrays)."""

    def __init__(self, obj):
        self._event, cuda = None, []

        def copy(t: torch.Tensor) -> torch.Tensor:
            if t.device.type != "cuda":
                return t.detach().clone()
            cuda.append(t.device)
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t.detach(), non_blocking=True)
            return buf

        self._host = _map(copy, obj)
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0]))
        self._lock = threading.Lock()
        self._out = None

    def result(self):
        """The numpy tree, once the copies have landed."""
        STATS.bump("rpc_fetch")
        t0 = time.perf_counter()
        with self._lock:
            if self._out is None:
                if self._event is not None:
                    self._event.synchronize()
                self._out = _map(lambda t: t.numpy(), self._host)
        dt = time.perf_counter() - t0
        STATS.times["fetch_wall"].append(dt)
        if threading.current_thread() is threading.main_thread():
            STATS.times["fetch_wall_main"].append(dt)
        return self._out


def fetch(*trees):
    """Copy any number of tensors (or NamedTuples / lists / dicts of them)
    to host numpy in one batched round trip.  Returns a tuple matching the
    inputs (or the single object for one argument).  Waits for these
    copies only (`HostCopy`), not for all the work queued on the device."""
    return fetch_async(*trees).result()


def fetch_np(*trees):
    """Like fetch(), but guarantees np.ndarray leaves (one fetch)."""
    got = fetch(*trees)

    def as_np(t):
        return _map(np.asarray, t, leaf=(np.ndarray, np.generic, int, float))

    if len(trees) == 1:
        return as_np(got)
    return tuple(as_np(g) for g in got)


def fetch_async(*trees) -> HostCopy:
    """Enqueue the device->host copies of `fetch` now and return at once;
    the handle's `result()` waits for them and is accounted as the fetch
    (JAX's `copy_to_host_async`, then `fetch`)."""
    return HostCopy(trees if len(trees) > 1 else trees[0])


def upload(*trees, device: torch.device | str):
    """Host->device transfer of numpy arrays (or trees of them) as one
    logical upload event.  Returns a tuple matching the inputs (or the
    single object for one argument)."""
    STATS.bump("rpc_h2d")
    obj = trees if len(trees) > 1 else trees[0]
    return _map(lambda x: torch.as_tensor(x).to(device, non_blocking=True),
                obj, leaf=np.ndarray)

