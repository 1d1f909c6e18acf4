"""Parity of the port's host state with the JAX package, held exactly: the
map store under the same operation sequences (arrays, indices and op-log
records), the keyframe database, the vocabulary's host and device
transforms, `node_mask`, `pad_slots`, and the native quadtree and
covisibility passes.  The JAX package's copies are the reference; the
port keeps its own because it cannot import them on a machine without
JAX.
"""
import numpy as np
import pytest
import torch

from swarmmap_tpu import native as jnative
from swarmmap_tpu.core import keyframe_db as jkdb, map_store as jms
from swarmmap_tpu.ops import matching as jmatching, vocab as jvocab
from swarmmap_tpu.utils import padding as jpadding
from swarmmap_tpu_torch import native
from swarmmap_tpu_torch.core import keyframe_db, map_store
from swarmmap_tpu_torch.ops import matching, vocab
from swarmmap_tpu_torch.utils import padding
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# written from the process clock (global_clock), so they differ between any
# two runs; every other attribute must be equal
CLOCK_FIELDS = {"kf_created", "mp_created", "mp_last_tracked"}
N_KP = 48


def _assert_same(a, b, path="store"):
    """Recursive exact equality of numpy arrays, containers and scalars."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _store_state(st) -> dict:
    skip = CLOCK_FIELDS | {"lock", "log_fn", "transform_guard"}
    return {k: v for k, v in vars(st).items() if k not in skip}


def _random_kf(rng, n):
    pose = np.eye(4, dtype=np.float32)
    pose[:3] += rng.normal(0, 0.05, (3, 4)).astype(np.float32)
    return dict(
        pose_cw=pose,
        K=np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32),
        kp_uv=rng.uniform(0, 320, (n, 2)).astype(np.float32),
        kp_octave=rng.randint(0, 4, n).astype(np.int32),
        kp_angle=rng.uniform(0, 360, n).astype(np.float32),
        kp_response=rng.uniform(0, 50, n).astype(np.float32),
        kp_valid=rng.rand(n) > 0.1,
        desc=rng.randint(0, 2**32, (n, 8), dtype=np.uint32),
    )


def _sequence(st, rng):
    """One scripted life of a map: keyframes and points past both initial
    capacities, observations one by one and per new keyframe, connection,
    normal and descriptor refreshes, culling, fusion, poses and the local->
    world transform."""
    for i in range(5):
        st.add_keyframe(**_random_kf(rng, N_KP), ts=0.1 * i, frame_id=10 * i,
                        velocity=0.01 * i, hw=(240, 320))
    for m in range(70):
        st.add_map_point(rng.uniform(-2, 2, 3).astype(np.float32) + [0, 0, 5],
                         rng.randint(0, 2**32, 8, dtype=np.uint32), ref_kf=m % 5)
    for m in range(70):
        for k in rng.choice(5, size=1 + m % 3, replace=False):
            kp = int(rng.randint(N_KP))
            if st.kf_kp_mp[k, kp] == map_store.NO_MP:
                st.add_observation(m, int(k), kp)
    k5 = st.add_keyframe(**_random_kf(rng, N_KP), ts=0.6, frame_id=60, hw=(240, 320))
    kps = np.arange(0, 40, 2)
    st.add_observations_new_kf(k5, kps, rng.choice(70, size=len(kps), replace=False).astype(np.int32))
    for k in range(6):
        st.update_connections(k, min_weight=2)
    for m in range(0, 70, 3):
        st.update_normal_and_depth(m, 1.2, 4)
        st.compute_distinctive_descriptor(m)
    st.refresh_points(range(1, 70, 3), 1.2, 4)
    st.refresh_points(range(2, 70, 3), 1.2, 4, descriptors=False)
    st.increase_visible(np.arange(0, 70, 2))
    st.increase_found(np.arange(0, 70, 4))
    st.erase_observation(5, int(next(iter(st.obs[5]))) if st.obs[5] else 0)
    st.set_mp_bad(7)
    st.replace_mp(9, 11)
    st.set_kf_bad(3)
    st.add_loop_edge(1, 4)
    st.set_kf_pose(2, np.eye(4, dtype=np.float32) * 1.01)
    st.set_mp_pos(12, np.array([0.5, 0.5, 4.0], np.float32))
    st.rebuild_covisibility()
    R = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    st.set_transform(R, np.ones(3, np.float32), 1.1)
    st.set_transform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.05)
    return {
        "redundancy": st.redundancy_counts([0, 1, 2, 4, 5]),
        "covisible": [st.covisible_kfs(k, 3) for k in range(6)],
        "tracked": [st.kf_tracked_points(k, min_obs=2) for k in range(6)],
        "obs_arrays": st.obs_arrays(),
        "alive": (st.alive_kf_slots(), st.alive_mp_slots()),
        "global": (st.kf_global_pose(1), st.mp_global_pos(np.arange(10))),
        "clone": _store_state(st.clone()),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_store_sequence_matches_jax(seed):
    logs = ([], [])
    stores = (jms.MapStore(map_id=3, kf_capacity=2, mp_capacity=16, n_kp=N_KP,
                           log_fn=lambda *r: logs[0].append(r)),
              map_store.MapStore(map_id=3, kf_capacity=2, mp_capacity=16, n_kp=N_KP,
                                 log_fn=lambda *r: logs[1].append(r)))
    results = [_sequence(st, np.random.RandomState(seed)) for st in stores]
    _assert_same(results[0], results[1], "results")
    _assert_same(_store_state(stores[0]), _store_state(stores[1]))
    assert len(logs[0]) > 100
    _assert_same(logs[0], logs[1], "op log")
    assert map_store.MAP_BASE == jms.MAP_BASE


def test_keyframe_database_matches_jax():
    voc_a, voc_b = jvocab.default_vocabulary(), vocab.default_vocabulary()
    rng = np.random.RandomState(5)
    stores = (jms.MapStore(n_kp=N_KP), map_store.MapStore(n_kp=N_KP))
    dbs = (jkdb.KeyFrameDatabase(voc_a), keyframe_db.KeyFrameDatabase(voc_b))
    base = rng.randint(0, 2**32, (N_KP, 8), dtype=np.uint32)
    for i in range(6):
        kf = _random_kf(rng, N_KP)
        # keyframes share most descriptors with a drifting base view
        kf["desc"] = np.where(rng.rand(N_KP, 1) < 0.7 - 0.1 * i, base, kf["desc"])
        for st, db, voc in zip(stores, dbs, (voc_a, voc_b)):
            k = st.add_keyframe(**kf)
            w, _ = voc.transform_np(kf["desc"])
            st.kf_words[k, :N_KP] = np.where(kf["kp_valid"], w, -1)
            st.add_observations_new_kf(k, np.arange(20), np.arange(20, dtype=np.int32) + i)
            if k > 0:
                st.update_connections(k, min_weight=1)
            db.add(st, k)
    for db in dbs:
        db.erase(4)
    _assert_same(dict(dbs[0].inverted), dict(dbs[1].inverted), "inverted")
    _assert_same(dbs[0].bow, dbs[1].bow, "bow")

    class _Q:  # the frame fields detect_reloc_candidates reads
        pass

    q = _Q()
    w, _ = voc_a.transform_np(base)
    q.words, q.valid = w.astype(np.int32), np.ones(N_KP, bool)
    ca = dbs[0].detect_reloc_candidates(q, stores[0])
    assert ca == dbs[1].detect_reloc_candidates(q, stores[1]) and len(ca) >= 1
    for min_score in (0.0, 0.05):
        la = dbs[0].detect_loop_candidates(stores[0], 5, min_score=min_score)
        assert la == dbs[1].detect_loop_candidates(stores[1], 5, min_score=min_score)


def test_vocabulary_transforms_match_jax():
    voc_a, voc_b = jvocab.default_vocabulary(), vocab.default_vocabulary()
    assert (voc_b.k, voc_b.L, voc_b.node_level) == (voc_a.k, voc_a.L, voc_a.node_level)
    desc = np.random.RandomState(3).randint(0, 2**32, (300, 8), dtype=np.uint32)
    desc[5] = desc[4]  # a repeated descriptor
    w_a, n_a = voc_a.transform_np(desc)
    w_b, n_b = voc_b.transform_np(desc)
    np.testing.assert_array_equal(w_b, w_a)
    np.testing.assert_array_equal(n_b, n_a)
    dw_a, dn_a = voc_a.transform(desc)
    dw_b, dn_b = voc_b.transform(torch.from_numpy(desc.view(np.int32)))
    assert dw_b.dtype == torch.int32
    np.testing.assert_array_equal(dw_b.numpy(), np.asarray(dw_a))
    np.testing.assert_array_equal(dn_b.numpy(), np.asarray(dn_a))
    np.testing.assert_array_equal(dw_b.numpy(), w_a)
    valid = np.arange(300) % 7 != 0
    bow_a, bow_b = voc_a.bow_vector(w_a, valid), voc_b.bow_vector(w_b, valid)
    assert bow_a == bow_b
    other = voc_b.bow_vector(w_b[::2])
    assert vocab.Vocabulary.score(bow_b, other) == jvocab.Vocabulary.score(bow_a, other)


def test_node_mask_matches_jax():
    rng = np.random.RandomState(8)
    nq, nt = rng.randint(-1, 6, 40).astype(np.int32), rng.randint(-1, 6, 50).astype(np.int32)
    vq, vt = rng.rand(40) > 0.2, rng.rand(50) > 0.2
    a = np.asarray(jmatching.node_mask(nq, nt, vq, vt))
    b = matching.node_mask(*(torch.from_numpy(x) for x in (nq, nt, vq, vt)))
    np.testing.assert_array_equal(b.numpy(), a)
    # a bank of query keyframes as a leading batch axis
    bank = matching.node_mask(torch.from_numpy(np.stack([nq, nq[::-1].copy()])),
                              torch.from_numpy(nt).expand(2, -1),
                              torch.from_numpy(np.stack([vq, vq])), torch.from_numpy(vt))
    np.testing.assert_array_equal(bank[0].numpy(), a)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 300, 4096])
def test_pad_slots_matches_jax(n):
    slots = np.arange(n, dtype=np.int64)[::-1] * 3
    for fn in ("pad_slots",):
        pa, va = getattr(jpadding, fn)(slots)
        pb, vb = getattr(padding, fn)(slots)
        _assert_same((pa, va), (pb, vb))
    assert padding.bucket_size(n, 256) == jpadding.bucket_size(n, 256)
    rows = np.ones((n, 3), np.float32)
    _assert_same(jpadding.pad_rows(rows, 128), padding.pad_rows(rows, 128))


@pytest.mark.parametrize("n,budget", [(50, 10), (400, 77), (1200, 300)])
def test_native_octree_matches_jax(n, budget):
    rng = np.random.RandomState(n)
    xs, ys = rng.uniform(0, 320, n), rng.uniform(0, 240, n)
    resp = rng.randint(7, 60, n).astype(np.float32)  # integer FAST scores tie
    bounds = (xs.min(), ys.min(), xs.max() + 1e-3, ys.max() + 1e-3)
    a = jnative.distribute_octree(xs, ys, resp, bounds, budget)
    b = native.distribute_octree(xs, ys, resp, bounds, budget)
    # the quadtree may keep a few more than the budget, as the reference's
    assert b.dtype == bool and b.sum() > 0.8 * budget
    np.testing.assert_array_equal(b, a)


def test_native_covisibility_and_redundancy_match_jax():
    rng = np.random.RandomState(4)
    kf_mp = np.where(rng.rand(12, 80) < 0.6, rng.randint(0, 150, (12, 80)), -1).astype(np.int32)
    alive = rng.rand(12) > 0.15
    oct_ = rng.randint(0, 8, (12, 80)).astype(np.int32)
    for min_shared in (1, 5):
        a = jnative.covisibility(kf_mp, alive, min_shared=min_shared)
        b = native.covisibility(kf_mp, alive, min_shared=min_shared)
        assert len(b[0]) > 0
        _assert_same(tuple(a), tuple(b))
    cands = np.array([0, 3, 7, 11], np.int32)
    _assert_same(tuple(jnative.redundancy(kf_mp, oct_, alive, cands)),
                 tuple(native.redundancy(kf_mp, oct_, alive, cands)))
