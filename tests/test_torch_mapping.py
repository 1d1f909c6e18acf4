"""Parity of the port's local-mapping device programs
(swarmmap_tpu_torch.core.local_mapping) with the JAX package's on the CPU,
and of its merged and two-phase paths with each other.

The JAX package's System runs test_slam_e2e.py's sequence (240x320, 400
features, 4 levels) until its third merged triangulate+fuse call; that
call's inputs (one keyframe against its covisible neighbours and fuse
targets) go through both packages' programs: the merged
`_batched_triangulate_then_fuse`, and the two-phase bodies
`_triangulate_body` and `_fuse_body`.  Bars: match indices where a match
holds and the good / valid masks exact; triangulated points within 1e-4
relative.  The candidate set stays below the merged path's bucket, where
it departs from two-phase (ROADMAP.md, queue 3).
"""
import numpy as np
import pytest
import torch

from swarmmap_tpu.core import local_mapping as jlm
from swarmmap_tpu.core.system import System as JSystem
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch.core import local_mapping as lm
from swarmmap_tpu_torch.core.system import System
from swarmmap_tpu_torch.utils import config, datasets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)


def _settings(mod, world):
    K = world.K
    return mod.Settings(
        camera=mod.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=mod.OrbConfig(n_features=400, n_levels=4),
    )


def _port(x):
    """A JAX program argument -> the port's (uint32 words -> int32 views)."""
    if isinstance(x, (float, int)):
        return x
    a = np.array(x)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def merged_call():
    """(args, outputs) of the JAX package's third merged program call."""
    seq = jdata.synthesize_sequence(n_frames=40, hw=HW, seed=0, n_points=350, motion="arc")
    calls = []
    orig = jlm._batched_triangulate_then_fuse

    def record(*args):
        out = orig(*args)
        calls.append((args, tuple(np.asarray(x) for x in out)))
        return out

    jlm._batched_triangulate_then_fuse = record
    try:
        s = JSystem(_settings(jconfig, seq.world))
        for i in range(len(seq)):
            s.track_monocular(seq.read(i), seq.timestamps[i])
            if len(calls) >= 3:
                break
    finally:
        jlm._batched_triangulate_then_fuse = orig
    assert len(calls) >= 3
    return calls[2]


def _assert_matches(idx_a, ok_a, idx_b, ok_b):
    np.testing.assert_array_equal(ok_b, ok_a)
    np.testing.assert_array_equal(np.where(ok_b, idx_b, -1), np.where(ok_a, idx_a, -1))


def _assert_points(pts_a, pts_b, good):
    rel = np.abs(pts_b - pts_a).max(-1) / np.maximum(np.abs(pts_a).max(-1), 1e-6)
    assert rel[good].max() < 1e-4, rel[good].max()


def test_merged_program_matches_jax(merged_call):
    args, (idx_a, good_a, pts_a, fidx_a, fvalid_a) = merged_call
    idx_b, good_b, pts_b, fidx_b, fvalid_b = (
        x.numpy() for x in lm._batched_triangulate_then_fuse(*map(_port, args)))
    _assert_matches(idx_a, good_a, idx_b, good_b)
    _assert_points(pts_a, pts_b, good_a)
    _assert_matches(fidx_a, fvalid_a, fidx_b, fvalid_b)
    # a real keyframe: neighbours, fresh points and fused matches
    assert good_a.sum() > 20 and fvalid_a.sum() > 100 and np.asarray(args[19]).sum() >= 2


def test_two_phase_bodies_match_jax(merged_call):
    """The same keyframe through the standalone bodies: triangulation on
    the merged call's first 20 arguments, fuse on its neighbour-only
    candidate bucket against its targets."""
    args, _ = merged_call
    tri_a = [np.asarray(x) for x in jlm._batched_triangulate(*args[:20])]
    tri_b = [x.numpy() for x in lm._triangulate_body(*map(_port, args[:20]))]
    _assert_matches(tri_a[0], tri_a[1], tri_b[0], tri_b[1])
    _assert_points(tri_a[2], tri_b[2], tri_a[1])
    fuse_args = args[25:29] + args[29:36] + args[36:]
    fa = [np.asarray(x) for x in jlm._batched_fuse_match(*fuse_args)]
    fb = [x.numpy() for x in lm._fuse_body(*map(_port, fuse_args))]
    _assert_matches(fa[0], fa[1], fb[0], fb[1])
    assert fa[1].sum() > 50


def test_merged_equals_two_phase_per_keyframe():
    """tests/test_mapping_fused.py's A/B on the port: the System runs the
    merged path; per keyframe, the two-phase path (triangulate, then fuse)
    replays on a clone of the pre-state, and the two stores must agree —
    the same created-point keypoint set, (near-)identical fuse outcomes."""
    seq = datasets.synthesize_sequence(n_frames=30, hw=HW, seed=5, n_points=350, motion="arc")
    s = System(_settings(config, seq.world), device="cpu")
    mapper = s.local_mapping
    assert mapper._merged_mapping
    orig = lm.LocalMapping._create_and_fuse
    stats = {"kfs": 0, "sym": 0, "cells": 0}

    def merged(self, k, *a, **kw):
        cl = self.store.clone()
        cl.log_fn = None
        pre = self.store.n_mp
        orig(self, k, *a, **kw)
        lm2 = lm.LocalMapping(cl, self.settings, device="cpu")
        lm2._create_new_map_points(k)
        lm2._fuse_neighbors(k)
        st = self.store
        made_a = {i for i in range(st.n_kp) if st.kf_kp_mp[k, i] >= pre}
        made_b = {i for i in range(cl.n_kp) if cl.kf_kp_mp[k, i] >= pre}
        ra = st.kf_kp_mp[: st.n_kf].copy()
        rb = cl.kf_kp_mp[: st.n_kf].copy()
        ra[ra >= pre] = -2
        rb[rb >= pre] = -3
        stats["kfs"] += 1
        stats["sym"] += len(made_a ^ made_b)
        stats["cells"] += int(((ra != rb) & ~((ra == -2) & (rb == -3))).sum())

    lm.LocalMapping._create_and_fuse = merged
    try:
        for i in range(len(seq)):
            s.track_monocular(seq.read(i), seq.timestamps[i])
    finally:
        lm.LocalMapping._create_and_fuse = orig
    assert stats["kfs"] >= 5
    assert stats["sym"] == 0, stats
    assert stats["cells"] <= max(2, stats["kfs"] // 4), stats
