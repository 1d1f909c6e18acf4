"""The port's server against the JAX package's on the same push bytes, on
the CPU: tests/test_loop_closing.py's circuit (tests/test_swarm.py's
two-agent merge is tests/test_torch_server.py's, through `TwinServer`).

Port clients (`SwarmAgent`, device="cpu") track the sequence and push
every few frames; each push goes into both packages' schedulers, the JAX
server first with its Sim3 RANSAC draws recorded, then the port's with
those draws replayed (`cells.replayed_draws(kind="sim3")`).  The clients
take the port server's distributes.  Both packages' map stores and MBP
scorers read one clock, the frame's timestamp (`cells.FrameClock`).

Per request the two servers must agree exactly on the new keyframes, the
loop decisions (loops closed, the last loop keyframe, fused points), the
merge groups and the fuse events, and must have used the same draws.
After every round the replicas hold the same live keyframes and points,
with poses within 2e-3 and point positions within 1e-2 of the largest
coordinate (the float32 CG global BA of each push in either package,
which a loop correction carries into every point; at one torch thread
the positions part by up to 3.8e-3 after the loop is closed).  The 7
assertions of tests/test_loop_closing.py then run on the port's own end
state.  The run takes two torch threads: at one it alone would take most
of this file's time budget.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.ops.sim3 as jax_sim3
import swarmmap_tpu.server.landmark_scoring as jax_ls
import swarmmap_tpu.server.map_manager as jax_mm
import swarmmap_tpu.server.mediator as jax_med
import swarmmap_tpu.server.scheduler as jax_sched
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.server.landmark_scoring as port_ls
from swarmmap_tpu_torch import cells
from swarmmap_tpu_torch.utils.trajectory import ate_rmse
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW, N_FEATURES, N_LEVELS = (240, 320), 400, 4
STORE_TOL = {"pose": 2e-3, "pos": 1e-2, "mp_alive": 0.0}


@contextlib.contextmanager
def jax_draws_recorded(draws: list):
    """Inside the block, every JAX Sim3 RANSAC appends the draws it makes
    from its key (its own expression, jax.random.randint) to `draws`."""
    orig = jax_sim3.ransac_sim3

    def record(pc1, pc2, valid, K1, K2, key, *a, **k):
        count = max(int(np.sum(np.asarray(valid))), 3)
        draws.append(np.asarray(jax.random.randint(key, (jax_sim3.N_HYPOTHESES, 3), 0, count)))
        return orig(pc1, pc2, valid, K1, K2, key, *a, **k)

    jax_sim3.ransac_sim3 = record
    try:
        yield
    finally:
        jax_sim3.ransac_sim3 = orig


def _decisions(rec: dict) -> dict:
    """A request's record (`cells.log_requests`) without the GBA results:
    JAX's global_ba returns nothing, the port's the iterations it applied."""
    return {k: v for k, v in rec.items() if k != "gba"}


class TwinServer(cells.Server):
    """The port's harness with the JAX package's server beside it: every
    push goes to both, JAX's Sim3 draws are replayed in the port's."""

    def __init__(self, n_agents, settings, clock):
        super().__init__(n_agents, settings, "cpu", clock=clock)
        jax_med.AgentMediator.registry.clear()
        self.jax_mm = jax_mm.MapManager()
        self.jax_sched = jax_sched.MediatorScheduler(self.jax_mm, gba_iters=10)
        orb = settings.orb
        n_kp = ((orb.n_features + 127) // 128) * 128
        self.jax_meds = []
        for i in range(n_agents):
            med = jax_med.AgentMediator(
                i, self.vocab, self.jax_mm, n_kp=n_kp, scale_factor=orb.scale_factor,
                n_levels=orb.n_levels, min_merge_inliers=max(20, int(40 * orb.n_features / 1000)),
                run_global_ba=True)
            self.jax_sched.register_mediator(med)
            self.jax_meds.append(med)
        self.log = {"jax": cells.log_requests(self.jax_sched, self.jax_meds),
                    "port": cells.log_requests(self.scheduler, self.mediators)}
        self.gaps: list[dict] = []
        self.n_draws = 0

    def serve_round(self) -> int:
        payloads = []
        for agent in self.agents:
            p = agent.push_payload()
            if p is not None:
                payloads.append((agent.agent_id, p))
        draws: list = []
        with jax_draws_recorded(draws):
            for a, p in payloads:
                self.jax_sched.enqueue_request(a, p)
            self.jax_sched.process_pending()
        self.n_draws += len(draws)
        with cells.replayed_draws(draws, kind="sim3"):
            for a, p in payloads:
                self.scheduler.enqueue_request(a, p)
            n = self.scheduler.process_pending()
        assert not draws, f"the port made {len(draws)} fewer Sim3 RANSACs than JAX"
        for agent in self.agents:
            batch, self.pending[agent.agent_id] = self.pending[agent.agent_id], []
            for payload in batch:
                agent.receive_distribute(payload)
        self.gaps.append({i: cells.replica_gaps(jm.store, pm.store, STORE_TOL)
                          for i, (jm, pm) in enumerate(zip(self.jax_meds, self.mediators))})
        return n


def _run(seqs, push_every, report_every):
    clock = cells.FrameClock([port_map_store, port_ls, jax_map_store, jax_ls])
    with clock:
        srv = TwinServer(len(seqs), cells.settings_for(seqs[0].world, N_FEATURES, N_LEVELS),
                         clock)
        poses = cells.serve_sequences(srv, seqs, push_every=push_every,
                                      report_every=report_every)
    return srv, poses


@pytest.fixture(scope="module")
def circuit_run():
    """tests/test_loop_closing.py's circuit: 100 frames, 700 landmarks,
    a push every 10 frames, GBA on."""
    seqs = cells.server_sequences("server_loop", hw=HW, n_points=700)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        srv, poses = _run(seqs, push_every=10, report_every=5)
    finally:
        torch.set_num_threads(n)
    return srv, seqs[0], poses[0]


def test_loop_decisions_match_jax(circuit_run):
    """The same requests, keyframes, loop decisions and draws in both
    servers, and replicas within the bar after every round."""
    srv, _, _ = circuit_run
    jl, pl = srv.log["jax"], srv.log["port"]
    assert len(pl) == len(jl) == 10
    for i, (a, b) in enumerate(zip(jl, pl)):
        assert _decisions(b) == _decisions(a), f"request {i}"
    assert srv.n_draws >= 1
    assert all(not g for gaps in srv.gaps for g in gaps.values()), srv.gaps
    assert any(n for rec in pl for n in rec["gba"])
    assert any(ok for rec in pl for *_, ok in rec["loops"])


def test_circuit_tracked(circuit_run):
    _, seq, poses = circuit_run
    assert len(poses) > 0.85 * len(seq)


def test_loop_detected_and_closed(circuit_run):
    srv, _, _ = circuit_run
    assert srv.mediators[0].loop_closing.n_loops_closed >= 1


def test_loop_scale_sane(circuit_run):
    srv, seq, _ = circuit_run
    st = srv.mediators[0].store
    w = seq.world
    est, gt = [], []
    for k in st.alive_kf_slots():
        fi = int(round(st.kf_ts[k] * 20))
        if fi < len(seq):
            est.append(np.linalg.inv(st.kf_pose_cw[k])[:3, 3])
            gt.append(w.poses_wc[fi][:3, 3])
    est, gt = np.stack(est), np.stack(gt)
    rmse = ate_rmse(est, gt)
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert rmse < 0.05 * span, f"ATE {rmse:.3f} on span {span:.1f}"


def test_loop_search_and_fuse(circuit_run):
    srv, _, _ = circuit_run
    lc = srv.mediators[0].loop_closing
    assert lc.n_fused > 0, "SearchAndFuse merged nothing"
    st = srv.mediators[0].store
    kfs = st.alive_kf_slots()
    span = int(kfs.max() - kfs.min())
    cross = sum(1 for m, ob in st.obs.items()
                if st.mp_alive[m] and len(ob) >= 2 and max(ob) - min(ob) > 0.5 * span)
    assert cross > 0, "no landmark observed across the loop boundary"


def test_loop_edges_recorded(circuit_run):
    srv, _, _ = circuit_run
    st = srv.mediators[0].store
    assert sum(len(v) for v in st.kf_loop_edges.values()) >= 2


def test_map_segmentation(circuit_run):
    srv, _, _ = circuit_run
    segs = srv.mediators[0].segment_map()
    assert len(segs) >= 1
    st = srv.mediators[0].store
    assert sum(len(s) for s in segs) == len(st.alive_kf_slots())
    for s in segs:
        assert len(s) >= 8 or s is segs[-1]


def test_global_ba_abort_discards_progress(circuit_run):
    """mbStopGBA: an aborted GBA leaves the map untouched and reports no
    iteration applied; a mesh of more than one device raises (item 17)."""
    from types import SimpleNamespace

    srv, _, _ = circuit_run
    med = srv.mediators[0]
    st = med.store
    kfs = st.alive_kf_slots()
    before = st.kf_pose_cw[kfs].copy()
    pts_before = st.mp_pos[: st.n_mp].copy()
    calls = []

    def abort_after_first():
        calls.append(1)
        return len(calls) >= 2  # allow chunk 1, abort before chunk 2

    assert med.loop_closing.global_ba(iters=8, should_abort=abort_after_first, chunk=2) == 0
    np.testing.assert_array_equal(st.kf_pose_cw[kfs], before)
    np.testing.assert_array_equal(st.mp_pos[: st.n_mp], pts_before)
    assert len(calls) >= 2
    med.loop_closing.mesh = SimpleNamespace(devices=np.zeros(4))
    try:
        with pytest.raises(NotImplementedError, match="item 17"):
            med.loop_closing.global_ba(iters=2)
    finally:
        med.loop_closing.mesh = None
