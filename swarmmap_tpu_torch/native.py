"""Host C++ of the port (g++ + ctypes): exact quadtree keypoint budgets,
covisibility, keyframe redundancy counts and the op-log compaction mask.

Port of the parts of swarmmap_tpu/native/__init__.py that the tracker,
the map store and the change log (sync/oplog.py) use.  The sources are
copies (`csrc/octree.cc`, `csrc/mapops.cc`), built at first use by
`_build.load_host`.  There is no Python fallback: a failed build raises.  (The JAX package's fallback for
`distribute_octree` is a global top-k, another keypoint policy.)
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import _build

SOURCES = ("octree.cc", "mapops.cc")


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built library with its entry points typed."""
    lib = _build.load_host("native", SOURCES)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.distribute_octree.restype = ctypes.c_int
    lib.distribute_octree.argtypes = [
        f32p, f32p, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, u8p,
    ]
    lib.covisibility_from_observations.restype = ctypes.c_int
    lib.covisibility_from_observations.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        i32p, i32p, i32p, ctypes.c_int,
    ]
    lib.redundancy_counts.restype = None
    lib.redundancy_counts.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int, u8p,
        i32p, ctypes.c_int, i32p, i32p,
    ]
    lib.aggregate_oplog.restype = ctypes.c_int
    lib.aggregate_oplog.argtypes = [
        i32p, i32p, np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int,
        u8p, u8p, u8p,
    ]
    return lib


def distribute_octree(xs, ys, responses, bounds, budget) -> np.ndarray:
    """Quadtree keypoint budgeting; returns bool keep-mask."""
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    rs = np.ascontiguousarray(responses, np.float32)
    keep = np.zeros(len(xs), np.uint8)
    get_lib().distribute_octree(
        xs, ys, rs, len(xs),
        float(bounds[0]), float(bounds[1]), float(bounds[2]), float(bounds[3]),
        int(budget), keep,
    )
    return keep.astype(bool)


def covisibility(kf_mp: np.ndarray, kf_alive: np.ndarray,
                 min_shared: int = 1, max_pairs: int = 1 << 20):
    """Batch covisibility rebuild; returns (i, j, count) arrays."""
    kf_mp = np.ascontiguousarray(kf_mp, np.int32)
    alive = np.ascontiguousarray(kf_alive, np.uint8)
    oi = np.zeros(max_pairs, np.int32)
    oj = np.zeros(max_pairs, np.int32)
    oc = np.zeros(max_pairs, np.int32)
    n = get_lib().covisibility_from_observations(
        kf_mp, kf_mp.shape[0], kf_mp.shape[1], alive,
        int(min_shared), oi, oj, oc, max_pairs,
    )
    return oi[:n], oj[:n], oc[:n]


def redundancy(kf_mp: np.ndarray, kf_oct: np.ndarray, kf_alive: np.ndarray,
               cands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-candidate (total, redundant) counts for keyframe culling."""
    kf_mp = np.ascontiguousarray(kf_mp, np.int32)
    kf_oct = np.ascontiguousarray(kf_oct, np.int32)
    alive = np.ascontiguousarray(kf_alive, np.uint8)
    cands = np.ascontiguousarray(cands, np.int32)
    total = np.zeros(len(cands), np.int32)
    red = np.zeros(len(cands), np.int32)
    get_lib().redundancy_counts(
        kf_mp, kf_oct, kf_mp.shape[0], kf_mp.shape[1], alive,
        cands, len(cands), total, red,
    )
    return total, red


def aggregate_keep(kind: np.ndarray, func: np.ndarray, target: np.ndarray,
                   last_writer: np.ndarray, is_badflag: np.ndarray) -> np.ndarray:
    """Op-log compaction keep-mask (reference: Mapit::Aggregate).

    kind/func are small int ids; last_writer/is_badflag are per-func-id
    flag tables. Returns a bool keep mask; for last-writer funcs the
    LAST record survives."""
    kind = np.ascontiguousarray(kind, np.int32)
    func = np.ascontiguousarray(func, np.int32)
    target = np.ascontiguousarray(target, np.int64)
    lw = np.ascontiguousarray(last_writer, np.uint8)
    bf = np.ascontiguousarray(is_badflag, np.uint8)
    keep = np.zeros(len(kind), np.uint8)
    get_lib().aggregate_oplog(kind, func, target, len(kind), lw, bf, keep)
    return keep.astype(bool)
