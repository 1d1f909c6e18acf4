"""The in-process swarm: the port's `swarm.Swarm(device="cpu")` against the
JAX package's `Swarm` on the CPU, and tests/test_swarm.py's assertions on
the port.

Both packages run tests/test_swarm.py's setup side by side on the same
images (2 agents on synthesize_sequence(seed=0), 36 frames, 240x320, 400
features, 4 levels, 350 landmarks, a state report every 4 frames, a push
every 8, no server GBA).  JAX's two-view and Sim3 RANSAC draws are
recorded from its own keys and replayed in the port
(`cells.replayed_draws`), and both packages' map stores and MBP scorers
read one clock, the frame's timestamp (`cells.FrameClock`), since STS
timestamps travel on the wire.

Exact over the whole run: per frame and agent the path (cohort or
staged) and the tracking state, the cohort dispatches, the merges and
loops of every request and the merged groups.  Exact until the first
merge: the frames that insert keyframes, and every request's new
keyframes.  Within bars: tracked poses within 1e-3 before the first
merge; at every sync round before it the server replicas within
tests/test_torch_loop_closing.py's bars (2e-3 of the largest coordinate
for keyframe poses, 1e-2 for point positions, by global id); at the
merge round the same live keyframes with poses within 5e-3, and at most
2% of either replica's live points without a point of the other within
1e-2, and the merge's fused points within 1% (as chip_smoke.py holds
loop fusions).  Float32 drift sets these bars (ROADMAP queue 3): the two
clients' LM and local BA differ in the last bits, so inliers part by 1-2
from frame 8, one client's local mapping keeps 2 more points before the
merge (later points' global ids then differ, so the merge round matches
points by position), agent 1's pose parts by 2.4e-3 at the merge frame,
and at frame 22 an exact tie of two keyframes' covisibility in JAX (141
and 141; 139 and 138 in the port) picks another reference keyframe and
so another keyframe decision.

Then tests/test_swarm.py's assertions on the port's run and on its own
double-buffered, async-mapping and fully async runs; a cohort row against
`pipeline.tracking_step` on that agent's inputs; the double buffer's
chained guess against the same product on the host; and the mesh rule
over a list of CPU devices (the mesh run is tests/test_torch_mesh_swarm.py).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.ops.pnp as jax_pnp
import swarmmap_tpu.ops.sim3 as jax_sim3
import swarmmap_tpu.ops.twoview as jax_twoview
import swarmmap_tpu.server.landmark_scoring as jax_ls
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.server.landmark_scoring as port_ls
from swarmmap_tpu.swarm import Swarm as JSwarm, SwarmConfig as JSwarmConfig
from swarmmap_tpu.utils import config as jconfig
from swarmmap_tpu_torch import MAP_BASE, cells
from swarmmap_tpu_torch.ops import extractor
from swarmmap_tpu_torch.swarm import Swarm, SwarmConfig
from swarmmap_tpu_torch.sync import codec
from swarmmap_tpu_torch.sync.oplog import full_archive
from swarmmap_tpu_torch.utils import datasets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_FRAMES = 36
CADENCE = dict(push_every=8, report_every=4)
TCW_TOL = 1e-3
STORE_TOL = {"pose": 2e-3, "pos": 1e-2, "mp_alive": 0.0}
MERGE_POSE_TOL = 5e-3
LONELY_POINTS = 0.02
FUSED_TOL = 0.01


def _settings(world):
    return cells.settings_for(world, 400, 4)


def _jax_settings(world):
    K = world.K
    return jconfig.Settings(
        camera=jconfig.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                    cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=jconfig.OrbConfig(n_features=400, n_levels=4),
    )


@contextlib.contextmanager
def jax_draws_recorded(twoview: list, sim3: list, pnp: list):
    """Inside the block, every JAX two-view and Sim3 RANSAC appends the
    draws it makes from its key (its own expression, jax.random.randint)
    to `twoview` / `sim3`, and every RANSAC PnP its call to `pnp`."""
    tv, s3, pp = jax_twoview.reconstruct, jax_sim3.ransac_sim3, jax_pnp.ransac_pnp

    def reconstruct(uv1, uv2, valid, K, key, *a, **kw):
        count = jnp.asarray(max(int(np.sum(valid)), 8), jnp.int32)
        twoview.append(np.array(jax.random.randint(key, (jax_twoview.N_HYPOTHESES, 8), 0, count)))
        return tv(uv1, uv2, valid, K, key, *a, **kw)

    def ransac_sim3(pc1, pc2, valid, K1, K2, key, *a, **kw):
        count = max(int(np.sum(np.asarray(valid))), 3)
        sim3.append(np.asarray(jax.random.randint(key, (jax_sim3.N_HYPOTHESES, 3), 0, count)))
        return s3(pc1, pc2, valid, K1, K2, key, *a, **kw)

    def ransac_pnp(*a, **kw):
        pnp.append(1)
        return pp(*a, **kw)

    jax_twoview.reconstruct, jax_sim3.ransac_sim3, jax_pnp.ransac_pnp = (
        reconstruct, ransac_sim3, ransac_pnp)
    try:
        yield
    finally:
        jax_twoview.reconstruct, jax_sim3.ransac_sim3, jax_pnp.ransac_pnp = tv, s3, pp


@pytest.fixture(scope="module")
def seqs():
    return [datasets.synthesize_sequence(n_frames=N_FRAMES, hw=HW, seed=0, agent=a, n_points=350)
            for a in range(2)]


@pytest.fixture(scope="module")
def runs(seqs):
    """Both packages' Swarms frame by frame on the same images, one clock,
    JAX's draws replayed in the port: (JAX SwarmRun, port SwarmRun, the
    two request logs, the frame whose sync merged the maps, the replica
    comparisons of every sync round until then, the JAX RANSAC PnP
    calls)."""
    frames = [[s.read(i) for s in seqs] for i in range(N_FRAMES)]
    clock = cells.FrameClock([port_map_store, port_ls, jax_map_store, jax_ls])
    twoview, sim3, pnp = [], [], []
    with clock, jax_draws_recorded(twoview, sim3, pnp), \
            cells.replayed_draws(twoview, "twoview"), cells.replayed_draws(sim3, "sim3"):
        jsw = JSwarm(2, _jax_settings(seqs[0].world), config=JSwarmConfig(**CADENCE),
                     run_server_gba=False)
        jlog = cells.log_requests(jsw.scheduler, jsw.mediators)
        psw = Swarm(2, _settings(seqs[0].world), config=SwarmConfig(**CADENCE),
                    run_server_gba=False, device="cpu")
        plog = cells.log_requests(psw.scheduler, psw.mediators)
        jrun, prun = cells.SwarmRun(jsw, clock), cells.SwarmRun(psw, clock, record_every=4)
        merged_at, rounds = None, []
        for i in range(N_FRAMES):
            ts = float(seqs[0].timestamps[i])
            jrun.step(frames[i], ts)
            prun.step(frames[i], ts)
            if merged_at is None and prun.steps[-1].sync:
                merged = max(len(g) for g in psw.merged_groups()) > 1
                rounds.append((i, merged, [_replica_disagreements(jm.store, pm.store, merged)
                                           for jm, pm in zip(jsw.mediators, psw.mediators)]))
                merged_at = i if merged else None
        jsw.finish()
        psw.finish()
    assert not twoview and not sim3, "the port made fewer RANSACs than JAX"
    return jrun, prun, jlog, plog, merged_at, rounds, pnp


def _replica_disagreements(sa, sb, merged: bool) -> list:
    """Where two replicas of one map part: by global id within STORE_TOL
    before the merge; at the merge round the same live keyframes with
    poses within MERGE_POSE_TOL, and at most LONELY_POINTS of either
    replica's live points with no live point of the other within
    STORE_TOL["pos"] of the largest coordinate."""
    if not merged:
        gaps = cells.replica_gaps(sa, sb, STORE_TOL)
        return [gaps] if gaps else []
    out = []
    gaps = cells.replica_gaps(sa, sb, {"pose": MERGE_POSE_TOL, "pos": np.inf,
                                       "mp_alive": np.inf})
    if gaps:
        out.append(gaps)
    pa, pb = (st.mp_pos[st.alive_mp_slots()] for st in (sa, sb))
    d = np.linalg.norm(pa[:, None] - pb[None], axis=-1) / max(np.abs(pa).max(), 1.0)
    lonely = max(float((d.min(1) > STORE_TOL["pos"]).mean()),
                 float((d.min(0) > STORE_TOL["pos"]).mean()))
    if lonely > LONELY_POINTS:
        out.append(f"{lonely:.3f} of the points have no counterpart")
    return out


def _decisions(rec: dict) -> dict:
    """A request's record without the GBA results (JAX's global_ba returns
    nothing, the port's the iterations it applied)."""
    return {k: v for k, v in rec.items() if k != "gba"}


def test_paths_states_and_poses_match_jax(runs):
    """Per frame and agent the same path and state, and tracked poses
    within TCW_TOL until the first merge (`cells.swarm_disagreements`)."""
    jrun, prun, *_, pnp = runs
    assert cells.swarm_disagreements(jrun.steps, prun.steps, TCW_TOL)[0] == []
    assert sum(p == "cohort" for s in prun.steps for p in s.paths) > N_FRAMES
    assert not pnp, "a relocalisation drew PnP hypotheses: replay them too"


def test_keyframes_and_dispatches_match_jax(runs):
    jrun, prun, _, _, merged_at, *_ = runs
    assert [s.dispatches for s in prun.steps] == [s.dispatches for s in jrun.steps]
    assert prun.swarm.fused_cohort_dispatches == jrun.swarm.fused_cohort_dispatches
    assert merged_at is not None
    before = slice(0, merged_at + 1)
    assert [s.keyframes for s in prun.steps[before]] == [s.keyframes for s in jrun.steps[before]]
    assert [s.n_kf for s in prun.steps[before]] == [s.n_kf for s in jrun.steps[before]]
    assert sum(k for s in prun.steps[before] for k in s.keyframes) >= 8


def test_requests_decide_like_jax(runs):
    """Every request up to the first merge as JAX's: the agent, its new
    keyframes, merges and loops, and after it the loop closers, the
    groups and the fuse events (fused points within FUSED_TOL).  Over the
    whole run, each agent's requests merge and close loops as JAX's (the
    STS order of later requests follows the agents' states, which part
    after frame 22)."""
    jrun, prun, jlog, plog, *_ = runs
    assert len(plog) == len(jlog) > 0
    first_merge = next(i for i, r in enumerate(jlog) if any(ok for *_, ok in r["merges"]))
    for i, (a, b) in enumerate(zip(jlog[:first_merge + 1], plog)):
        key = ("agent", "new_kfs", "merges", "loops")
        assert [b[k] for k in key] == [a[k] for k in key], f"request {i}"
        (la, ga, fa), (lb, gb, fb) = a["after"], b["after"]
        assert (lb, gb) == (la, ga), f"request {i}"
        assert [e[:2] for e in fb] == [e[:2] for e in fa], f"request {i}"
        assert all(abs(x[2] - y[2]) <= max(1, FUSED_TOL * x[2]) for x, y in zip(fa, fb)), i

    def per_agent(log):
        return sorted((r["agent"], r["merges"], r["loops"]) for r in log)

    assert per_agent(plog) == per_agent(jlog)
    assert prun.swarm.merged_groups() == jrun.swarm.merged_groups() == [{0, 1}]


def test_replicas_match_jax(runs):
    """The server replicas at every sync round until the first merge's
    (`_replica_disagreements`)."""
    rounds = runs[5]
    assert len(rounds) >= 2 and rounds[-1][1]
    assert all(not d for _, _, ds in rounds for d in ds), rounds


def test_cohort_row_is_the_per_agent_step(runs):
    """Row j of a cohort dispatch equals pipeline.tracking_step on agent
    j's own inputs: match_mp and n_inliers exact, Tcw within 1e-5."""
    prun = runs[1]
    assert len(prun.dispatches) >= 3
    assert cells.cohort_row_disagreements(prun.dispatches, 1e-5) == []


# tests/test_swarm.py's assertions, on the port's run


def test_clients_track(runs, seqs):
    swarm = runs[1].swarm
    for agent in swarm.agents:
        assert agent.frames_tracked > 0.5 * len(seqs[0]), agent.frames_tracked
        assert agent.system.n_keyframes() >= 3


def test_agents_batched_into_one_dispatch(runs, seqs):
    swarm = runs[1].swarm
    assert swarm.fused_cohort_dispatches > 0.3 * len(seqs[0]), swarm.fused_cohort_dispatches


def test_server_replicas_mirror_clients(runs):
    swarm = runs[1].swarm
    for agent, med in zip(swarm.agents, swarm.mediators):
        cst = agent.system.store
        alive_gids = {int(g) for g in cst.kf_gid[: cst.n_kf][cst.kf_alive[: cst.n_kf]]}
        missing = {g for g in alive_gids if g not in set(med.store.kf_by_gid)}
        assert len(missing) <= 2, f"server missing {len(missing)} keyframes"
        assert med.store.mp_alive.sum() > 0.5 * cst.mp_alive.sum()


def test_push_sizes_reasonable(runs, seqs):
    swarm = runs[1].swarm
    for agent in swarm.agents:
        assert agent.bytes_pushed > 0
        full = len(codec.encode_slice(full_archive(agent.system.store)))
        n_pushes = len(seqs[0]) // swarm.config.push_every
        assert agent.bytes_pushed < full * max(n_pushes, 1)


def test_cross_agent_fusion(runs):
    swarm = runs[1].swarm
    biggest = max(swarm.merged_groups(), key=len)
    assert len(biggest) == 2, f"maps not merged: {swarm.merged_groups()}"
    assert swarm.mediators[0].store.group_id == swarm.mediators[1].store.group_id


def test_cross_map_point_fusion(runs):
    swarm = runs[1].swarm
    events = swarm.map_manager.fuse_events
    assert events and sum(n for _, _, n in events) > 0, events
    dst, _, _ = max(events, key=lambda e: e[2])
    st_d = swarm.map_manager.stores[dst]
    gids = st_d.mp_gid[: st_d.n_mp][st_d.mp_alive[: st_d.n_mp]]
    assert int(np.sum(gids // MAP_BASE != dst)) > 0
    observed_foreign = sum(1 for m, ob in st_d.obs.items()
                           if st_d.mp_alive[m] and int(st_d.mp_gid[m]) // MAP_BASE != dst and ob)
    assert observed_foreign > 0


@pytest.fixture(scope="module")
def double_buffered(seqs):
    swarm = Swarm(2, _settings(seqs[0].world),
                  config=SwarmConfig(**CADENCE, double_buffer=True),
                  run_server_gba=False, device="cpu")
    run = cells.SwarmRun(swarm, record_every=1)
    for i in range(N_FRAMES):
        run.step([s.read(i) for s in seqs], float(seqs[0].timestamps[i]))
    swarm.finish()
    return run


def test_double_buffered_dispatch_matches_sync(runs, double_buffered, seqs):
    sync_swarm, swarm = runs[1].swarm, double_buffered.swarm
    assert swarm._pending is None, "finish() must flush the in-flight dispatch"
    assert swarm.fused_cohort_dispatches > 0.3 * N_FRAMES
    for agent, ref_agent, (rmse, span) in zip(swarm.agents, sync_swarm.agents,
                                              cells.swarm_ate(swarm, seqs)):
        assert agent.frames_tracked >= min(0.9 * ref_agent.frames_tracked, 0.6 * N_FRAMES), (
            agent.frames_tracked, ref_agent.frames_tracked)
        assert rmse < 0.05 * span, f"ATE {rmse:.3f} vs span {span:.2f}"


def test_chained_guess_matches_host(double_buffered):
    """The double buffer's pose guess, chained on the device from the
    pending dispatch's pose (G = P_prev inv(P_{t-2}) P_prev), equals the
    same product on the host within 1e-5."""
    chained = 0
    for d in double_buffered.dispatches:
        chain = d["chain"]
        if chain is None:
            continue
        for j, (agent, prev) in enumerate(zip(d["agents"], d["prev"])):
            aid = id(agent)
            if aid not in chain["rows"] or aid in chain["invalid"] or prev is None:
                continue
            P = chain["out"].Tcw[chain["rows"][aid]].double().numpy()
            G = P @ np.linalg.inv(prev.astype(np.float64)) @ P
            assert np.abs(d["inputs"].Tcw_guess[j].numpy() - G).max() < 1e-5
            chained += 1
    assert chained > N_FRAMES // 2


def test_async_mapping_mode():
    n_frames = 30
    seq = datasets.synthesize_sequence(n_frames=n_frames, hw=HW, seed=5, agent=0, n_points=350)
    swarm = Swarm(1, _settings(seq.world), config=SwarmConfig(**CADENCE, async_mapping=True),
                  run_server_gba=False, device="cpu")
    for i in range(n_frames):
        swarm.step([seq.read(i)], float(seq.timestamps[i]))
    swarm.agents[0].system.local_mapping.wait_idle()
    swarm.finish()
    a = swarm.agents[0]
    assert a.frames_tracked > 0.8 * n_frames, a.frames_tracked
    st = a.system.store
    assert st.kf_alive[: st.n_kf].sum() >= 2
    assert st.mp_alive[: st.n_mp].sum() > 100
    assert len(swarm.mediators[0].store.kf_by_gid) >= 2


def test_fully_async_combined_mode():
    n_frames = 30
    seqs = [datasets.synthesize_sequence(n_frames=n_frames, hw=HW, seed=5, agent=a, n_points=350)
            for a in range(2)]
    swarm = Swarm(2, _settings(seqs[0].world),
                  config=SwarmConfig(**CADENCE, async_mapping=True, async_server=True),
                  run_server_gba=False, device="cpu")
    for i in range(n_frames):
        swarm.step([s.read(i) for s in seqs], float(seqs[0].timestamps[i]))
    for a in swarm.agents:
        a.system.local_mapping.wait_idle()
    swarm.finish()
    for a in swarm.agents:
        assert a.frames_tracked > 0.8 * n_frames, a.frames_tracked
    for med in swarm.mediators:
        assert len(med.store.kf_by_gid) >= 2
    assert not swarm.scheduler._worker.is_alive()


def test_staged_agents_extract_as_one_batch(seqs, monkeypatch):
    """Agents that are not steady (here both, at their first frame) get
    their features from one batched extraction on the swarm's device."""
    calls = []
    inner = extractor.extract_orb_batched

    def batched(images, **kw):
        calls.append(tuple(images.shape))
        return inner(images, **kw)

    monkeypatch.setattr(extractor, "extract_orb_batched", batched)
    swarm = Swarm(2, _settings(seqs[0].world), config=SwarmConfig(**CADENCE),
                  run_server_gba=False, device="cpu")
    swarm.step([s.read(0) for s in seqs], float(seqs[0].timestamps[0]))
    swarm.finish()
    assert calls == [(2,) + HW]


@pytest.mark.parametrize("mesh_agents", [True, None])
def test_mesh_is_not_ported(seqs, mesh_agents):
    """The JAX package's mesh rule (swarm.py:174-201), forced and auto:
    8 agents over a list of 8 CPU entries build an agent mesh of 8 and an
    observation mesh of 8 on every mediator's loop closer.  With the
    default list on the CPU ([device]) nothing is sharded; 2 agents over 8
    entries build none in auto mode, and, forced, a mesh of 2 (the largest
    divisor of the agents within the devices)."""
    settings = _settings(seqs[0].world)
    swarm = Swarm(8, settings, config=SwarmConfig(mesh_agents=mesh_agents), device="cpu",
                  devices=["cpu"] * 8)
    assert swarm.mesh.size() == 8 and swarm.mesh.axis_names == ("agents",)
    assert swarm.gba_mesh.size() == 8 and swarm.gba_mesh.axis_names == ("obs",)
    assert all(m.loop_closing.mesh is swarm.gba_mesh for m in swarm.mediators)
    swarm.finish()
    swarm = Swarm(2, settings, config=SwarmConfig(mesh_agents=mesh_agents), device="cpu")
    assert swarm.devices == [torch.device("cpu")]
    assert swarm.mesh is None and swarm.gba_mesh is None
    swarm.finish()
    swarm = Swarm(2, settings, config=SwarmConfig(mesh_agents=mesh_agents), device="cpu",
                  devices=["cpu"] * 8)
    assert (swarm.mesh is None) if mesh_agents is None else swarm.mesh.size() == 2
    swarm.finish()
