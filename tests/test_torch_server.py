"""Parity of the port's server layer (swarmmap_tpu_torch.server) with the
JAX package's on the CPU: the 14 cases of tests/test_server.py (the joint
group BA without a mesh), tests/test_swarm.py::test_sts_priority_ordering
and the gauge projection of tests/test_scale_gauge.py (its 3 cases and a
CG GBA result; its circuit case is tests/test_torch_scale_gauge.py), each
run on both packages, and tests/test_swarm.py's two-agent merge served by
both on the same push bytes.

Every case keeps the JAX test's own assertions, on each package, and
returns what it computed.  Host-only results (scoring, the enhancer, group
algebra, the scheduler, the gauge projection) must be the same bits; the
results of device programs (the joint group BA in CG) within 1e-4 of the
largest coordinate.  The clocks of both packages' map stores and scorers
are made one counter, since the scores read them.
"""
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarmmap_tpu as jax_root
import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.core.tracking as jax_tracking
import swarmmap_tpu.ops.vocab as jax_vocab
import swarmmap_tpu.server.landmark_scoring as jax_ls
import swarmmap_tpu.server.loop_closing as jax_lc
import swarmmap_tpu.server.map_enhancer as jax_me
import swarmmap_tpu.server.map_manager as jax_mm
import swarmmap_tpu.server.mediator as jax_med
import swarmmap_tpu.server.scheduler as jax_sched
import swarmmap_tpu.swarm as jax_swarm
import swarmmap_tpu.sync.codec as jax_codec
import swarmmap_tpu.sync.oplog as jax_oplog
import swarmmap_tpu.utils.config as jax_config
import swarmmap_tpu.utils.trajectory as jax_traj
import swarmmap_tpu_torch as port_root
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.core.tracking as port_tracking
import swarmmap_tpu_torch.ops.vocab as port_vocab
import swarmmap_tpu_torch.server.landmark_scoring as port_ls
import swarmmap_tpu_torch.server.loop_closing as port_lc
import swarmmap_tpu_torch.server.map_enhancer as port_me
import swarmmap_tpu_torch.server.map_manager as port_mm
import swarmmap_tpu_torch.server.mediator as port_med
import swarmmap_tpu_torch.server.scheduler as port_sched
import swarmmap_tpu_torch.swarm as port_swarm
import swarmmap_tpu_torch.sync.codec as port_codec
import swarmmap_tpu_torch.sync.oplog as port_oplog
import swarmmap_tpu_torch.utils.config as port_config
import swarmmap_tpu_torch.utils.trajectory as port_traj
from swarmmap_tpu.ops import lie as jlie
from test_torch_sync import snap
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pkg(root, ms, tr, voc, ls, lc, me, mm, med, sch, sw, cd, ol, cfg, traj, dev):
    kw = {} if dev is None else {"device": dev}
    return SimpleNamespace(
        MAP_BASE=root.MAP_BASE, MapStore=ms.MapStore, SystemState=tr.SystemState,
        vocab=voc.default_vocabulary, LandmarkScoring=ls.LandmarkScoring,
        MapEnhancer=me.MapEnhancer, lc=lc,
        MapManager=lambda: mm.MapManager(**kw),
        AgentMediator=lambda *a, **k: med.AgentMediator(*a, **k, **kw),
        registry=med.AgentMediator.registry,
        MediatorScheduler=lambda *a, **k: sch.MediatorScheduler(*a, **k),
        SwarmAgent=lambda *a, **k: sw.SwarmAgent(*a, **k, **kw),
        codec=cd, Mapit=ol.Mapit, MapSlice=ol.MapSlice, UpdateRecord=ol.UpdateRecord,
        config=cfg, umeyama_align=traj.umeyama_align,
        project_scale_gauge=lc._project_scale_gauge)


PKGS = {
    "jax": _pkg(jax_root, jax_map_store, jax_tracking, jax_vocab, jax_ls, jax_lc, jax_me,
                jax_mm, jax_med, jax_sched, jax_swarm, jax_codec, jax_oplog, jax_config,
                jax_traj, None),
    "port": _pkg(port_root, port_map_store, port_tracking, port_vocab, port_ls, port_lc,
                 port_me, port_mm, port_med, port_sched, port_swarm, port_codec, port_oplog,
                 port_config, port_traj, "cpu"),
}


@pytest.fixture
def counter_clock(monkeypatch):
    """The map stores' and the scorers' clocks of both packages as one
    counter, restarted by the returned function."""
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.25
        return state["t"]

    for mod in (jax_map_store, port_map_store, jax_ls, port_ls):
        monkeypatch.setattr(mod, "global_clock", clock)
    return lambda: state.update(t=0.0)


def small_map(P, rng, map_id=0, n_kf=4, n_mp=40, n_kp=64):
    st = P.MapStore(map_id=map_id, n_kp=n_kp, kf_capacity=8, mp_capacity=128)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    for i in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * i, 0, 0]
        st.add_keyframe(
            pose_cw=T, K=K,
            kp_uv=rng.uniform(5, 60, (n_kp, 2)).astype(np.float32),
            kp_octave=rng.randint(0, 3, n_kp),
            kp_angle=rng.uniform(0, 360, n_kp).astype(np.float32),
            kp_response=rng.rand(n_kp).astype(np.float32),
            kp_valid=np.ones(n_kp, bool),
            desc=rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32),
            ts=float(i), hw=(64, 64),
        )
    for j in range(n_mp):
        pos = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(2, 5)],
                       np.float32)
        m = st.add_map_point(pos, st.kf_desc[0, j % n_kp], ref_kf=0)
        for k in range(n_kf):
            if rng.rand() < 0.7:
                st.add_observation(m, k, (j + k) % n_kp)
    return st


def _twl(st):
    return (np.asarray(st.Twl_R), np.asarray(st.Twl_t), float(st.Twl_s), st.group_id)


def _sim3(xi):
    """Inputs made alike for both packages: (R, t, s) of a tangent."""
    R, t, s = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(xi)))
    return R, t, s


# --- the cases of tests/test_server.py ---------------------------------------

def scoring_features_and_rank(P, rng, tmp_path):
    st = small_map(P, rng)
    sc = P.LandmarkScoring(st)
    scores = sc.rank()
    assert len(scores) == st.mp_alive.sum()
    assert np.isfinite(scores).all()
    assert len(sc.kf_scores) == st.kf_alive.sum()
    p_first = sc.request_priority(100)
    p_small = sc.request_priority(1)
    assert p_first > p_small
    return scores, sc.kf_scores, p_first, p_small


def scoring_csv(P, rng, tmp_path):
    st = small_map(P, rng)
    sc = P.LandmarkScoring(st)
    sc.rank()
    sc.save_csv(tmp_path / "scores.csv")
    lines = (tmp_path / "scores.csv").read_text().strip().splitlines()
    assert len(lines) == int(st.mp_alive.sum()) + 1
    assert lines[0].startswith("slot,gid")
    return lines


def virtual_keyframe_identical_mode(P, rng, tmp_path):
    st = small_map(P, rng, n_kf=4, n_mp=60)
    enh = P.MapEnhancer(st, P.LandmarkScoring(st))
    vk = enh.generate_keyframe(st.kf_pose_cw[1], ref_kf=1, identical=True)
    assert vk is not None
    assert not st.kf_genuine[vk]
    assert int((st.kf_kp_mp[vk] >= 0).sum()) >= 20
    for kp, m in enumerate(st.kf_kp_mp[vk]):
        if m >= 0:
            assert st.obs[int(m)][vk] == kp
    return vk, st.kf_kp_mp[vk], st.kf_kp_uv[vk], st.kf_pose_cw[vk]


def compression_respects_default_disable(P, rng, tmp_path):
    st = small_map(P, rng, n_kf=8, n_mp=80)
    sc = P.LandmarkScoring(st)
    enh = P.MapEnhancer(st, sc)
    assert enh.compress() == 0
    removed = P.MapEnhancer(st, sc, compression_enabled=True).compress(fraction=0.2)
    assert removed > 0
    return removed, st.kf_alive, st.mp_alive


def merge_group_algebra(P, rng, tmp_path):
    st1, st2 = small_map(P, rng, map_id=0), small_map(P, rng, map_id=1)
    mm = P.MapManager()
    mm.register(st1)
    mm.register(st2)
    R12, t12, s12 = _sim3(np.array([0.1, -0.05, 0.2, 0.4, -0.3, 0.1, 0.15], np.float32))
    assert mm.merge(0, 1, float(s12), R12, t12)
    assert st1.group_id == st2.group_id
    p2 = np.array([0.5, -0.2, 3.0], np.float32)
    p1 = s12 * R12 @ p2 + t12
    g1 = st1.Twl_s * st1.Twl_R @ p1 + st1.Twl_t
    g2 = st2.Twl_s * st2.Twl_R @ p2 + st2.Twl_t
    np.testing.assert_allclose(g1, g2, atol=1e-5)
    return _twl(st1), _twl(st2), mm.groups, mm.fuse_events


def merge_scale_guard(P, rng, tmp_path):
    stores = [small_map(P, rng, map_id=i) for i in range(3)]
    mm = P.MapManager()
    for s in stores:
        mm.register(s)
    assert mm.merge(0, 1, 1.1, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    ok = stores[1].set_transform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 50.0)
    assert not ok
    return [_twl(s) for s in stores]


def background_gba_abort_nonblocking(P, rng, tmp_path):
    """A push arriving mid-GBA neither blocks process_request on the
    optimisation nor lets the aborted GBA apply (LoopClosing.cc:602-680);
    bundle_adjust is slowed by 0.25 s a chunk, as in the JAX test."""
    vocab = P.vocab()
    P.registry.clear()
    mm = P.MapManager()
    sched = P.MediatorScheduler(mm, gba_iters=40, background_gba=True)
    settings = P.config.Settings(
        camera=P.config.CameraConfig(fx=100, fy=100, cx=32, cy=32, fps=20,
                                     width=64, height=64),
        orb=P.config.OrbConfig(n_features=64, n_levels=3))
    agent = P.SwarmAgent(0, settings, vocab)
    med = P.AgentMediator(0, vocab, mm, n_kp=agent.system.store.n_kp)
    sched.register_mediator(med)
    st = agent.system.store
    K = settings.camera.K
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * i, 0, 0]
        st.add_keyframe(
            pose_cw=T, K=K,
            kp_uv=rng.uniform(5, 60, (st.n_kp, 2)).astype(np.float32),
            kp_octave=rng.randint(0, 3, st.n_kp),
            kp_angle=rng.uniform(0, 360, st.n_kp).astype(np.float32),
            kp_response=rng.rand(st.n_kp).astype(np.float32),
            kp_valid=np.ones(st.n_kp, bool),
            desc=rng.randint(0, 2**32, (st.n_kp, 8), dtype=np.uint32),
            ts=float(i), hw=(64, 64),
        )
    for j in range(60):
        pos = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(2, 5)], np.float32)
        m = st.add_map_point(pos, st.kf_desc[0, j % st.n_kp], ref_kf=0)
        for k in range(4):
            st.add_observation(m, k, (j * 4 + k) % st.n_kp)
    real_ba = P.lc.ba_ops.bundle_adjust

    def slow_ba(*a, **kw):
        time.sleep(0.25)
        return real_ba(*a, **kw)

    P.lc.ba_ops.bundle_adjust = slow_ba
    try:
        sched.enqueue_request(0, agent.push_payload())
        t0 = time.perf_counter()
        assert sched.process_pending() == 1
        assert time.perf_counter() - t0 < 2.0, "process_request blocked on GBA"
        gba_thread = sched._gba_threads[0]
        assert gba_thread.is_alive(), "GBA must run on a background thread"
        with med.store.lock:
            poses_before = med.store.kf_pose_cw[: med.store.n_kf].copy()
        m = st.add_map_point(np.array([0, 0, 3.0], np.float32), st.kf_desc[0, 0], ref_kf=0)
        st.add_observation(m, 0, 1)
        t0 = time.perf_counter()
        sched.enqueue_request(0, agent.push_payload())
        assert sched.process_pending() == 1
        assert time.perf_counter() - t0 < 2.0
        assert sched._gba_abort[0].is_set(), "push must abort the in-flight GBA"
        gba_thread.join(timeout=30)
        assert not gba_thread.is_alive()
        with med.store.lock:
            np.testing.assert_array_equal(
                med.store.kf_pose_cw[: len(poses_before)], poses_before)
    finally:
        P.lc.ba_ops.bundle_adjust = real_ba
    return poses_before


def obs_assembly_scales_to_50k(P, rng, tmp_path):
    """BA problem assembly is an array gather, < 10 ms at 50k
    observations, on either package's map store."""
    n_kf, n_mp, per_mp, n_kp = 100, 12500, 4, 1024
    st = P.MapStore(map_id=0, n_kp=n_kp, kf_capacity=128, mp_capacity=16384)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    for i in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, 0, 0]
        st.add_keyframe(
            pose_cw=T, K=K, kp_uv=rng.uniform(0, 64, (n_kp, 2)).astype(np.float32),
            kp_octave=np.zeros(n_kp, np.int32), kp_angle=np.zeros(n_kp, np.float32),
            kp_response=np.ones(n_kp, np.float32), kp_valid=np.ones(n_kp, bool),
            desc=rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32), ts=float(i), hw=(64, 64))
    stride = n_kf - per_mp
    for j in range(n_mp):
        m = st.add_map_point(np.array([0, 0, 2.0], np.float32), st.kf_desc[0, j % n_kp],
                             ref_kf=0)
        base = j % stride
        for k in range(base, base + per_mp):
            st.add_observation(m, k, (j // stride) * per_mp + (k - base), log=False)
    kfs, mps = st.alive_kf_slots(), st.alive_mp_slots()

    def assemble():
        cam_lut = np.full(st.n_kf, -1, np.int32)
        cam_lut[kfs] = np.arange(len(kfs), dtype=np.int32)
        pt_lut = np.full(st.n_mp, -1, np.int32)
        pt_lut[mps] = np.arange(len(mps), dtype=np.int32)
        om, okf, okp = st.obs_arrays()
        sel = (pt_lut[om] >= 0) & (cam_lut[okf] >= 0)
        sel_kf, sel_kp = okf[sel], okp[sel]
        return cam_lut[sel_kf], pt_lut[om[sel]], st.kf_kp_uv[sel_kf, sel_kp]

    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        assemble()
        best = min(best, time.perf_counter() - t0)
    out = assemble()
    assert len(out[0]) >= 50000
    assert best < 0.010, f"assembly took {best*1e3:.1f} ms at 50k obs"
    return out


def group_join_rebase_is_exact(P, rng, tmp_path):
    stores = [small_map(P, rng, map_id=i) for i in range(4)]
    mm = P.MapManager()
    for s in stores:
        mm.register(s)

    def rand_sim3(seed):
        r = np.random.RandomState(seed)
        xi = r.uniform(-0.5, 0.5, 7).astype(np.float32)
        xi[3:6] *= 2.0
        xi[6] *= 0.2
        R, t, s = _sim3(xi)
        return float(s), R, t

    s01, R01, t01 = rand_sim3(1)
    assert mm.merge(0, 1, s01, R01, t01)
    s23, R23, t23 = rand_sim3(2)
    assert mm.merge(2, 3, s23, R23, t23)
    s12, R12, t12 = rand_sim3(3)
    assert mm.merge(1, 2, s12, R12, t12)
    assert len({st.group_id for st in stores}) == 1
    p3 = np.array([0.4, -0.1, 2.5], np.float32)
    p1 = s12 * R12 @ (s23 * R23 @ p3 + t23) + t12
    g_via_1 = stores[1].Twl_s * stores[1].Twl_R @ p1 + stores[1].Twl_t
    g_via_3 = stores[3].Twl_s * stores[3].Twl_R @ p3 + stores[3].Twl_t
    np.testing.assert_allclose(g_via_1, g_via_3, rtol=1e-4, atol=1e-4)
    return [_twl(s) for s in stores], mm.groups


def twl_is_server_owned(P, rng, tmp_path):
    st = small_map(P, rng, map_id=0)
    st.set_transform(np.eye(3, dtype=np.float32), np.array([1.0, 2.0, 3.0], np.float32),
                     1.5, exact=True)
    mapit = P.Mapit(st)
    assert mapit.archive().twl is None
    sl = mapit.archive(include_twl=True)
    assert sl.twl is not None
    replica = small_map(P, rng, map_id=0)
    th = 0.8
    R_old = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                     np.float32)
    replica.set_transform(R_old, np.zeros(3, np.float32), 0.9, exact=True)
    P.Mapit(replica).apply_slice(sl)
    np.testing.assert_allclose(replica.Twl_R, st.Twl_R, atol=1e-6)
    np.testing.assert_allclose(replica.Twl_t, st.Twl_t, atol=1e-6)
    assert abs(float(replica.Twl_s) - float(st.Twl_s)) < 1e-6
    return _twl(replica)


def set_transform_still_blends_estimates(P, rng, tmp_path):
    st = small_map(P, rng, map_id=0)
    st.set_transform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0001)
    st.set_transform(np.eye(3, dtype=np.float32), np.array([1.0, 0, 0], np.float32), 1.0)
    assert 0.0 < float(st.Twl_t[0]) < 1.0
    return _twl(st)


def polish_group_transforms_recovers_gauge(P, rng, tmp_path):
    mgr = P.MapManager()
    st0, st1 = P.MapStore(map_id=0, n_kp=32), P.MapStore(map_id=1, n_kp=32)
    mgr.register(st0)
    mgr.register(st1)
    r = np.random.RandomState(3)
    pts = r.uniform(-4, 4, (60, 3)).astype(np.float32)
    desc = r.randint(0, 2**32, (60, 8), dtype=np.uint32)
    for i in range(60):
        st1.add_map_point(pts[i], desc[i], ref_kf=-1, gid=P.MAP_BASE * 1 + i)
        st0.add_map_point(pts[i], desc[i], ref_kf=-1, gid=P.MAP_BASE * 1 + i)
    st1.group_id = st0.group_id = 0
    mgr.groups = {0: {0, 1}}
    st1.set_transform(np.eye(3, dtype=np.float32), np.array([0.3, -0.2, 0.1], np.float32),
                      1.04, exact=True)

    def misalign():
        return np.linalg.norm(st1.mp_global_pos(np.arange(60))
                              - st0.mp_global_pos(np.arange(60)), axis=1).mean()

    before = misalign()
    mgr.polish_group_transforms()
    after = misalign()
    assert before > 0.2 and after < 0.02, (before, after)
    return before, after, _twl(st1)


def scheduler_per_agent_fifo(P, rng, tmp_path):
    vocab = P.vocab()
    P.registry.clear()
    mm = P.MapManager()
    sched = P.MediatorScheduler(mm, gba_iters=0)
    sched.register_mediator(P.AgentMediator(0, vocab, mm, n_kp=64))
    seen: list[int] = []
    sched.process_request = lambda agent_id, sl: seen.append(len(sl.updates))
    big = P.MapSlice(map_id=0, kfs=[], mps=[], updates=[
        P.UpdateRecord(i, "mp", "SetVisible", 10**6 + i, (1,)) for i in range(50)], twl=None)
    tiny = P.MapSlice(map_id=0, kfs=[], mps=[], updates=[
        P.UpdateRecord(0, "mp", "SetVisible", 10**6, (2,))], twl=None)
    sched.enqueue_request(0, P.codec.encode_slice(big))
    sched.enqueue_request(0, P.codec.encode_slice(tiny))
    assert sched.process_pending() == 2
    assert seen == [50, 1], f"same-agent slices reordered: {seen}"
    return seen


def _build_two_map_group(P, rng, twl1_scale=1.1):
    """tests/test_server.py's two stores in one group over the same
    landmarks (map 0 owns them, map 1 holds foreign copies), on P's map
    store and manager; the geometry is made with numpy and the JAX
    package's lie, alike for both packages."""
    n_pts, n_cams = 150, 8
    pts_w = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                      rng.uniform(5, 9, n_pts)], 1).astype(np.float32)
    K = np.array([[450.0, 0, 160], [0, 450.0, 120], [0, 0, 1]], np.float32)
    Tg = np.zeros((n_cams, 4, 4), np.float32)
    for c in range(n_cams):
        w = np.array([0.0, 0.04 * (c - n_cams / 2), 0.0], np.float32)
        Tg[c, :3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(w)))
        Tg[c, :3, 3] = [-0.3 * c + 1.0, 0.02 * c, 0.01 * c]
        Tg[c, 3, 3] = 1.0
    mgr = P.MapManager()
    st0, st1 = P.MapStore(map_id=0, n_kp=256), P.MapStore(map_id=1, n_kp=256)
    mgr.register(st0)
    mgr.register(st1)
    st1.group_id = st0.group_id = 0
    mgr.groups = {0: {0, 1}}
    th = 0.3
    R1 = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                  np.float32)
    st1.set_transform(R1, np.array([0.5, -0.2, 0.3], np.float32), twl1_scale, exact=True)

    def local_pose(st, c):
        s = float(st.Twl_s)
        R_g, t_g = Tg[c, :3, :3], Tg[c, :3, 3]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_g @ st.Twl_R
        T[:3, 3] = (t_g + R_g @ st.Twl_t) / s
        return T

    for st, cams, owner in ((st0, range(4), True), (st1, range(4, 8), False)):
        pl = (((pts_w - st.Twl_t) @ st.Twl_R) / float(st.Twl_s)).astype(np.float32)
        slots = [st.add_map_point(pl[i] + rng.normal(0, 0.01, 3).astype(np.float32),
                                  np.asarray(rng.randint(0, 2**32, 8, dtype=np.uint32)),
                                  ref_kf=-1, gid=i)
                 for i in range(n_pts)]
        for c in cams:
            pc = pts_w @ Tg[c, :3, :3].T + Tg[c, :3, 3]
            uv = (pc[:, :2] / pc[:, 2:3]) * 450.0 + K[:2, 2]
            vis = np.where((pc[:, 2] > 0.5) & (np.abs(uv[:, 0] - 160) < 170)
                           & (np.abs(uv[:, 1] - 120) < 130))[0][:256]
            kp_uv = np.zeros((256, 2), np.float32)
            kp_uv[: len(vis)] = uv[vis] + rng.normal(0, 0.4, (len(vis), 2))
            valid = np.zeros(256, bool)
            valid[: len(vis)] = True
            xi = (np.zeros(6) if owner and c < 2
                  else np.concatenate([rng.randn(3) * 0.01, rng.randn(3) * 0.03]))
            T0 = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32))) @ local_pose(st, c)
            k = st.add_keyframe(
                pose_cw=T0.astype(np.float32), K=K, kp_uv=kp_uv,
                kp_octave=np.zeros(256, np.int32), kp_angle=np.zeros(256, np.float32),
                kp_response=np.ones(256, np.float32), kp_valid=valid,
                desc=rng.randint(0, 2**32, (256, 8), dtype=np.uint32))
            for kp, j in enumerate(vis):
                st.add_observation(slots[j], k, kp)
    return mgr, st0, st1, pts_w


def group_global_ba_joint_over_members(P, rng, tmp_path):
    """The joint merged-group GBA (CG) couples the member maps through
    their cross-map duplicate observations; on the port, the mesh variant
    of tests/test_server.py (the same group again, sharded over a 2-entry
    CPU obs_mesh) applies, passes the same bars and agrees with mesh=None
    within tests/test_ba.py's sharded bars (poses 2e-3, points 5e-3)."""
    rng = np.random.RandomState(7)
    mgr, st0, st1, pts_w = _build_two_map_group(P, rng)

    def misalign():
        return float(np.linalg.norm(st0.mp_global_pos(np.arange(150))
                                    - st1.mp_global_pos(np.arange(150)), axis=1).mean())

    before = misalign()
    assert mgr.group_global_ba(0, iters=10, mesh=None), "joint GBA did not apply"
    after = misalign()
    assert after < before * 0.1, (before, after)
    est = st0.mp_global_pos(np.arange(150))
    s, R, t = P.umeyama_align(est, pts_w)
    resid = np.linalg.norm(est @ (s * R).T + t - pts_w, axis=1)
    assert np.median(resid) < 0.03, np.median(resid)
    if P is PKGS["port"]:
        from swarmmap_tpu_torch.ops import ba
        from swarmmap_tpu_torch.parallel.mesh import obs_mesh

        mgr_s, st0_s, st1_s, _ = _build_two_map_group(P, np.random.RandomState(7))
        mesh = obs_mesh(devices=["cpu"] * 2)
        calls, inner = [], ba.bundle_adjust_sharded

        def sharded(p, m, **kw):
            calls.append(m)
            return inner(p, m, **kw)

        ba.bundle_adjust_sharded = sharded
        try:
            assert mgr_s.group_global_ba(0, iters=10, mesh=mesh), "sharded joint GBA did not apply"
        finally:
            ba.bundle_adjust_sharded = inner
        assert calls == [mesh]
        gap = float(np.linalg.norm(st0_s.mp_global_pos(np.arange(150))
                                   - st1_s.mp_global_pos(np.arange(150)), axis=1).mean())
        assert gap < before * 0.1, (before, gap)
        for a, b in ((st0, st0_s), (st1, st1_s)):
            np.testing.assert_allclose(b.kf_pose_cw[: b.n_kf], a.kf_pose_cw[: a.n_kf],
                                       rtol=0, atol=2e-3)
            np.testing.assert_allclose(b.mp_pos[: b.n_mp], a.mp_pos[: a.n_mp], rtol=0, atol=5e-3)
    return dict(pose0=st0.kf_pose_cw[: st0.n_kf], pose1=st1.kf_pose_cw[: st1.n_kf],
                pos0=st0.mp_pos[: st0.n_mp], pos1=st1.mp_pos[: st1.n_mp])


SERVER_CASES = [
    scoring_features_and_rank, scoring_csv, virtual_keyframe_identical_mode,
    compression_respects_default_disable, merge_group_algebra, merge_scale_guard,
    background_gba_abort_nonblocking, obs_assembly_scales_to_50k,
    group_join_rebase_is_exact, twl_is_server_owned, set_transform_still_blends_estimates,
    polish_group_transforms_recovers_gauge, scheduler_per_agent_fifo,
    group_global_ba_joint_over_members,
]
DEVICE_CASES = {group_global_ba_joint_over_members}


def test_server_cases_cover_test_server():
    """Every test of tests/test_server.py has its case here."""
    import test_server as ref

    names = {n[len("test_"):] for n in dir(ref) if n.startswith("test_")}
    assert names == {f.__name__ for f in SERVER_CASES}


@pytest.mark.parametrize("case", SERVER_CASES, ids=lambda f: f.__name__)
def test_server_case_on_both_packages(case, counter_clock, tmp_path):
    restart = counter_clock
    out = {}
    for name in ("jax", "port"):
        restart()
        (tmp_path / name).mkdir()
        out[name] = case(PKGS[name], np.random.RandomState(42), tmp_path / name)
    if case in DEVICE_CASES:
        for k, a in out["jax"].items():
            a, b = np.asarray(a), np.asarray(out["port"][k])
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * max(np.abs(a).max(), 1.0),
                                       err_msg=k)
    else:
        assert snap(out["port"]) == snap(out["jax"])


def test_sts_priority_ordering():
    """tests/test_swarm.py::test_sts_priority_ordering on both packages:
    unstable agents outrank stable ones regardless of contribution, and
    the priorities are equal."""
    prios = {}
    for name, P in PKGS.items():
        P.registry.clear()
        mm = P.MapManager()
        sched = P.MediatorScheduler(mm)
        meds = [P.AgentMediator(i, P.vocab(), mm, n_kp=64) for i in range(3)]
        for m in meds:
            sched.register_mediator(m)
        loc = np.zeros(3, np.float32)
        meds[0].set_state(P.SystemState(loc, False, True, 100, 0))   # stable
        meds[1].set_state(P.SystemState(loc, False, False, 5, 3))    # LOST
        meds[2].set_state(P.SystemState(loc, True, True, 15, 0))     # burst + low tracked
        sl = P.MapSlice(map_id=0, kfs=[], mps=[], updates=[])
        p0, p1, p2 = (sched._priority(m, sl) for m in meds)
        assert p1 < p2 < p0  # lost < lost-prevention < enrichment
        prios[name] = (p0, p1, p2)
    assert prios["port"] == prios["jax"]


# --- tests/test_scale_gauge.py: the gauge projection, on both packages -------

def _rand_rot(rng):
    R = np.linalg.qr(rng.randn(3, 3))[0]
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R


def _poses(rng, cs):
    T = np.tile(np.eye(4), (len(cs), 1, 1))
    for i in range(len(cs)):
        T[i, :3, :3] = _rand_rot(rng)
        T[i, :3, 3] = -T[i, :3, :3] @ cs[i]
    return T


def _both_gauges(T, pts, c_pre, n, m):
    out = [P.project_scale_gauge(T, pts, c_pre, n, m) for P in PKGS.values()]
    assert snap(out[1]) == snap(out[0])
    return out[1]


def test_gauge_projection_inverts_pure_scale_drift():
    rng = np.random.RandomState(0)
    n, m = 8, 30
    cs = rng.randn(n, 3)
    T = _poses(rng, cs)
    pts = rng.randn(m, 3)
    s, c0 = 0.7, cs[0]
    T_drift = T.copy()
    for i in range(n):
        T_drift[i, :3, 3] = -T_drift[i, :3, :3] @ (c0 + s * (cs[i] - c0))
    Tn, pn = _both_gauges(T_drift, c0 + s * (pts - c0), cs, n, m)
    cn = np.stack([-Tn[i, :3, :3].T @ Tn[i, :3, 3] for i in range(n)])
    assert np.abs(cn - cs).max() < 1e-5
    assert np.abs(pn - pts).max() < 1e-5
    assert np.abs(Tn[0] - T[0]).max() < 1e-5


def test_gauge_projection_preserves_reprojection():
    rng = np.random.RandomState(1)
    n, m = 5, 40
    cs = 0.3 * rng.randn(n, 3)
    T = _poses(rng, cs)
    pts = rng.randn(m, 3) + np.array([0, 0, 5.0])
    c_pre = cs * 1.3 - 0.3 * cs[0]
    c_pre[0] = cs[0]
    Tn, pn = _both_gauges(T, pts, c_pre, n, m)

    def proj(Ti, p):
        pc = Ti[:3, :3] @ p + Ti[:3, 3]
        return pc[:2] / pc[2]

    for i in range(n):
        for j in range(0, m, 7):
            assert np.abs(proj(T[i], pts[j]) - proj(Tn[i], pn[j])).max() < 1e-5


def test_gauge_projection_noop_when_no_drift():
    rng = np.random.RandomState(2)
    n, m = 4, 10
    cs = rng.randn(n, 3)
    T = _poses(rng, cs)
    pts = rng.randn(m, 3)
    Tn, pn = _both_gauges(T, pts, cs, n, m)
    assert np.abs(Tn - T).max() < 1e-5
    assert np.abs(pn - pts).max() < 1e-5


def test_gauge_projection_on_a_gba_result():
    """The projection of a real CG GBA result (the port's global BA on a
    drifted problem), by both packages alike: the anchor kept exactly and
    the camera-centre spread restored."""
    from swarmmap_tpu_torch.ops import ba
    from test_ba import make_ba_problem
    from test_torch_ba import _to_port

    prob, _, _ = make_ba_problem(np.random.RandomState(11), n_cams=8, n_pts=200)
    res = ba.bundle_adjust(_to_port(prob), mode="cg", iters_a=2, iters_b=2)
    T_pre = np.asarray(prob.Tcw, np.float64)
    c_pre = -np.einsum("kij,kj->ki", T_pre[:, :3, :3].transpose(0, 2, 1), T_pre[:, :3, 3])
    Tn, pn = _both_gauges(res.Tcw.numpy(), res.pts.numpy(), c_pre, 8, 200)
    c_new = -np.einsum("kij,kj->ki", Tn[:, :3, :3].transpose(0, 2, 1).astype(np.float64),
                       Tn[:, :3, 3])
    spread = lambda c: np.sum((c - c[0]) ** 2)  # noqa: E731
    assert abs(spread(c_new) / spread(c_pre) - 1) < 1e-4
    np.testing.assert_allclose(Tn[0], res.Tcw.numpy()[0], atol=1e-6)


def test_two_agent_merge_matches_jax():
    """tests/test_swarm.py's two agents on one landmark field (36 frames,
    350 landmarks, a push every 8 frames, a report every 4) served by both
    packages on the same push bytes, with JAX's Sim3 draws replayed
    (tests/test_torch_loop_closing.py's `TwinServer`): the same decisions
    request by request, the maps merged in the same request with the same
    fuse counts, replicas within that file's bars."""
    from swarmmap_tpu_torch import cells
    from test_torch_loop_closing import _decisions, _run

    seqs = cells.server_sequences("server_swarm", hw=(240, 320), n_points=350,
                                  n_frames=36)[:2]
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # as tests/test_torch_loop_closing.py's run
    try:
        srv, poses = _run(seqs, push_every=8, report_every=4)
    finally:
        torch.set_num_threads(n)
    jl, pl = srv.log["jax"], srv.log["port"]
    assert len(pl) == len(jl) >= 8
    for i, (a, b) in enumerate(zip(jl, pl)):
        assert _decisions(b) == _decisions(a), f"request {i}"
    assert all(not g for gaps in srv.gaps for g in gaps.values()), srv.gaps
    assert [{0, 1}] == srv.merged_groups()
    assert srv.map_manager.fuse_events and sum(n for _, _, n in srv.map_manager.fuse_events) > 0
    assert all(len(p) > 0.5 * len(seqs[0]) for p in poses)
