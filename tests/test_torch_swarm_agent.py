"""The port's SwarmAgent and map checkpoints against the JAX package's, on
the CPU.

- The distribute rebase gate (tests/test_swarm.py::test_distribute_rebase_gate)
  on both packages' SwarmAgent: the same payload bytes, and the same
  tracker state and store afterwards, exactly.
- `System.save_map` / `load_map` in both formats on a seeded map: JAX's
  checkpoint loads in the port to the same store and keyframe database,
  and the port's save of it is the same bytes as JAX's save of the same
  load, exactly.
- The port alone through tests/test_slam_e2e.py's map-reuse workflow
  (240x320, 40 frames): a missing file loads as False, a saved map loads
  into a fresh client with the same counts, and at least 2 of 3
  mid-sequence frames relocalise against it.  The relocalised poses are
  the one result in this file held to a bar rather than exactly.
"""
import numpy as np
import pytest

import swarmmap_tpu.core.frame as jax_frame
import swarmmap_tpu.core.system as jax_system
import swarmmap_tpu.ops.vocab as jax_vocab
import swarmmap_tpu.swarm as jax_swarm
import swarmmap_tpu.sync.codec as jax_codec
import swarmmap_tpu.sync.oplog as jax_oplog
import swarmmap_tpu.utils.config as jax_config
import swarmmap_tpu_torch.core.frame as port_frame
import swarmmap_tpu_torch.core.system as port_system
import swarmmap_tpu_torch.ops.vocab as port_vocab
import swarmmap_tpu_torch.swarm as port_swarm
import swarmmap_tpu_torch.sync.codec as port_codec
import swarmmap_tpu_torch.sync.oplog as port_oplog
import swarmmap_tpu_torch.utils.config as port_config
from swarmmap_tpu_torch import cells
from swarmmap_tpu_torch.utils import datasets
from test_torch_sync import counter_clock, snap  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PKGS = {
    "jax": dict(swarm=jax_swarm, frame=jax_frame, system=jax_system, vocab=jax_vocab,
                codec=jax_codec, oplog=jax_oplog, config=jax_config, kw={}),
    "port": dict(swarm=port_swarm, frame=port_frame, system=port_system, vocab=port_vocab,
                 codec=port_codec, oplog=port_oplog, config=port_config,
                 kw={"device": "cpu"}),
}


def _settings(config, hw, n_features):
    return config.Settings(
        camera=config.CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                                   fps=20.0, width=hw[1], height=hw[0]),
        orb=config.OrbConfig(n_features=n_features, n_levels=2))


def _rebase_gate(P):
    """tests/test_swarm.py::test_distribute_rebase_gate on package P; returns
    the payloads, the tracker states after each distribute and the store."""
    hw = (240, 320)
    agent = P["swarm"].SwarmAgent(0, _settings(P["config"], hw, 64),
                                  vocab=P["vocab"].default_vocabulary(), **P["kw"])
    st, tr = agent.system.store, agent.system.tracking
    n = st.n_kp
    rng = np.random.RandomState(3)
    k = st.add_keyframe(
        pose_cw=np.eye(4, dtype=np.float32),
        K=np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32),
        kp_uv=rng.rand(n, 2).astype(np.float32) * 200,
        kp_octave=np.zeros(n, np.int32),
        kp_angle=np.zeros(n, np.float32),
        kp_response=rng.rand(n).astype(np.float32),
        kp_valid=np.ones(n, bool),
        desc=rng.randint(0, 2**32, (n, 8), dtype=np.uint32),
        ts=0.0, frame_id=0, hw=hw,
    )
    gid = int(st.kf_gid[k])
    tr.ref_kf = k
    lf = P["frame"].Frame.__new__(P["frame"].Frame)
    lf.pose_cw = np.eye(4, dtype=np.float32)
    tr.last_frame = lf
    vel = np.eye(4, dtype=np.float32)
    vel[0, 3] = 0.01
    tr.velocity = vel.copy()
    payloads, states = [], []
    for dx, dy in ((0.0, 0.002), (1.5, 0.0)):  # millimetric refinement, then a rebase
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[1, 3] = dx, dy
        sl = P["oplog"].MapSlice(map_id=0, kfs=[], mps=[], updates=[
            P["oplog"].UpdateRecord(seq=0, kind="kf", func="SetPose", target=gid, args=(pose,))])
        payloads.append(P["codec"].encode_slice(sl))
        agent.receive_distribute(payloads[-1])
        states.append((None if tr.velocity is None else tr.velocity.copy(),
                       tr.last_frame.pose_cw.copy()))
    return payloads, states, st


def test_distribute_rebase_gate(counter_clock):
    counter_clock()
    ref = _rebase_gate(PKGS["jax"])
    counter_clock()
    out = _rebase_gate(PKGS["port"])
    (vel_small, lf_small), (vel_big, lf_big) = out[1]
    # the bars of tests/test_swarm.py, then the JAX run's state exactly
    assert vel_small is not None
    np.testing.assert_allclose(lf_small, np.eye(4), atol=1e-7)
    assert vel_big is None
    np.testing.assert_allclose(lf_big[0, 3], 1.5, atol=1e-3)
    assert out[0] == ref[0]
    assert snap(out[1]) == snap(ref[1])
    assert snap(out[2]) == snap(ref[2])


def _seeded_map(system, vocab, n_kf=4, n_mp=60):
    """Keyframes with seeded keypoints and descriptors, their BoW words and
    database entries, and map points each seen by two or three of them."""
    st = system.store
    n = st.n_kp
    rng = np.random.RandomState(11)
    K = np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    kfs = []
    for i in range(n_kf):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.1 * i
        desc = rng.randint(0, 2**32, (n, 8), dtype=np.uint32)
        k = st.add_keyframe(
            pose_cw=pose, K=K, kp_uv=(rng.rand(n, 2) * 200).astype(np.float32),
            kp_octave=rng.randint(0, 2, n).astype(np.int32),
            kp_angle=(rng.rand(n) * 360).astype(np.float32),
            kp_response=rng.rand(n).astype(np.float32), kp_valid=np.ones(n, bool),
            desc=desc, ts=0.05 * i, frame_id=i, hw=(240, 320))
        w, nd = vocab.transform_np(desc)
        st.kf_words[k, : len(w)] = w.astype(np.int32)
        st.kf_nodes[k, : len(nd)] = nd.astype(np.int32)
        system.kfdb.add(st, k)
        kfs.append(k)
    for j in range(n_mp):
        seen = rng.choice(n_kf, 2 + j % 2, replace=False)
        m = st.add_map_point(
            np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(2, 5)]),
            st.kf_desc[kfs[seen[0]], j], ref_kf=kfs[seen[0]])
        for k in seen:
            st.add_observation(m, kfs[k], j)
    for k in kfs:
        st.update_connections(k)


def _system(P, hw=(240, 320)):
    voc = P["vocab"].default_vocabulary()
    return P["system"].System(_settings(P["config"], hw, 64), vocab=voc, **P["kw"]), voc


@pytest.mark.parametrize("fmt", ["msgpack", "boost-bin"])
def test_checkpoint_bytes_cross_packages(tmp_path, fmt, counter_clock):
    counter_clock()
    src, voc = _system(PKGS["jax"])
    _seeded_map(src, voc)
    saved = tmp_path / "jax.bin"
    src.save_map(saved, fmt=fmt)

    loaded = {}
    for name in ("jax", "port"):
        counter_clock()
        s, _ = _system(PKGS[name])
        assert s.load_map(saved)
        out = tmp_path / f"{name}-resaved.bin"
        s.save_map(out, fmt=fmt)
        loaded[name] = (s, out.read_bytes())
    (js, jbytes), (ps, pbytes) = loaded["jax"], loaded["port"]
    assert ps.n_keyframes() == src.n_keyframes() == 4
    assert ps.n_map_points() == src.n_map_points() == 60
    assert pbytes == jbytes
    assert snap(ps.store) == snap(js.store)
    assert snap(dict(ps.kfdb.inverted)) == snap(dict(js.kfdb.inverted))


@pytest.fixture(scope="module")
def tracked_port_system():
    """The port's client over test_slam_e2e.py's sequence: 240x320, 350
    landmarks, 40 frames, 400 features and 4 levels."""
    hw = (240, 320)
    seq = datasets.synthesize_sequence(n_frames=40, hw=hw, seed=0, n_points=350, motion="arc")
    system = cells.new_system(seq, "cpu", n_features=400, n_levels=4)
    for i in range(len(seq)):
        system.track_monocular(seq.read(i), seq.timestamps[i])
    return system, seq


@pytest.mark.parametrize("fmt", ["msgpack", "boost-bin"])
def test_save_load_map_relocalises(tmp_path, tracked_port_system, fmt):
    system, seq = tracked_port_system
    assert system.n_keyframes() >= 3
    path = tmp_path / "map-client-0.bin"
    system.save_map(path, fmt=fmt)
    assert path.stat().st_size > 0
    fresh = cells.new_system(seq, "cpu", n_features=400, n_levels=4)
    assert not fresh.load_map(tmp_path / "missing.bin")
    assert fresh.load_map(path)
    assert fresh.n_keyframes() == system.n_keyframes()
    assert fresh.n_map_points() == system.n_map_points()
    ok = cells.relocalised(fresh, seq)
    assert sum(ok) >= 2, f"relocalised {ok} against the loaded map"
