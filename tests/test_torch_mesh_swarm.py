"""The mesh Swarm: the port's `Swarm` over a list of 8 CPU entries against
the JAX package's `Swarm` over the 8 virtual devices of tests/conftest.py,
and tests/test_swarm.py::test_mesh_sharded_swarm_with_merge's assertions
on the port.

Both packages run that test's setup side by side on the same images: 8
agents on synthesize_sequence(seed=0, agent=a % 3, n_points=350) at
240x320, 400 features, 4 levels, 24 frames, a state report every 4
frames and a push every 8, no server GBA.  Both build an agent mesh of 8
(one shard per agent), so the steady agents' frames run through the
agent-sharded step on a full-width batch whose rows are the agents (the
agents outside a cohort are dummy rows).  As in tests/test_torch_swarm.py
JAX's two-view RANSAC draws are replayed in the port and both packages
read one clock (`cells.FrameClock`).  The server's Sim3 draws are not
replayed: agents a, a + 3 and a + 6 see the same images, so their
requests tie in the STS order and the two packages serve them, and so
draw for them, in another order from the first sync on; the port's
mediators draw from their own generators.

Exact over the whole run: per frame and agent the path (cohort or
staged) and the tracking state, the cohort dispatches, the [8, 8]
overlap hint after every frame and every mediator's overlap-hint dict
after every frame, and the merged groups at the end.  Tracked poses
within POSE_TOL before the first merge: these sequences part by up to
5.4e-3 by frame 6 with or without a mesh (agent 2's two-view start by
2.6e-3 at frame 1), where the 2-agent world of tests/test_torch_swarm.py
stays within 1e-3; an agent's row read from another agent's sequence
would be off by far more.
"""
import numpy as np
import pytest

import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.server.landmark_scoring as jax_ls
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.server.landmark_scoring as port_ls
from swarmmap_tpu.swarm import Swarm as JSwarm, SwarmConfig as JSwarmConfig
from swarmmap_tpu_torch import cells
from swarmmap_tpu_torch.swarm import Swarm, SwarmConfig
from swarmmap_tpu_torch.utils import datasets
from test_torch_swarm import _jax_settings, jax_draws_recorded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_FRAMES = 24
N_AGENTS = 8
CADENCE = dict(push_every=8, report_every=4)
POSE_TOL = 1e-2


def _hints(swarm) -> tuple:
    """The swarm's overlap hint and each mediator's hint dict, copied."""
    hint = None if swarm.overlap_hint is None else np.array(swarm.overlap_hint)
    return hint, [None if m.overlap_hint is None else dict(m.overlap_hint)
                  for m in swarm.mediators]


@pytest.fixture(scope="module")
def seqs():
    return [datasets.synthesize_sequence(n_frames=N_FRAMES, hw=HW, seed=0, agent=a % 3,
                                         n_points=350)
            for a in range(N_AGENTS)]


@pytest.fixture(scope="module")
def runs(seqs):
    """Both packages' mesh Swarms frame by frame on the same images, one
    clock, JAX's two-view draws replayed in the port: (JAX SwarmRun, port
    SwarmRun, JAX hints per frame, port hints per frame)."""
    frames = [[s.read(i) for s in seqs] for i in range(N_FRAMES)]
    clock = cells.FrameClock([port_map_store, port_ls, jax_map_store, jax_ls])
    twoview, sim3, pnp = [], [], []
    with clock, jax_draws_recorded(twoview, sim3, pnp), \
            cells.replayed_draws(twoview, "twoview"):
        jsw = JSwarm(N_AGENTS, _jax_settings(seqs[0].world), config=JSwarmConfig(**CADENCE),
                     run_server_gba=False)
        psw = Swarm(N_AGENTS, cells.settings_for(seqs[0].world, 400, 4),
                    config=SwarmConfig(**CADENCE), run_server_gba=False, device="cpu",
                    devices=["cpu"] * N_AGENTS)
        assert jsw.mesh is not None and jsw.mesh.devices.size == N_AGENTS
        jrun, prun = cells.SwarmRun(jsw, clock), cells.SwarmRun(psw, clock)
        jhints, phints = [], []
        for i in range(N_FRAMES):
            ts = float(seqs[0].timestamps[i])
            jrun.step(frames[i], ts)
            jhints.append(_hints(jsw))
            prun.step(frames[i], ts)
            phints.append(_hints(psw))
        jsw.finish()
        psw.finish()
    assert not twoview, "the port made fewer two-view RANSACs than JAX"
    assert not pnp, "a relocalisation drew PnP hypotheses: replay them too"
    return jrun, prun, jhints, phints


def test_mesh_paths_states_and_dispatches_match_jax(runs):
    """Per frame and agent the same path and state, poses within POSE_TOL
    before the first merge, and the same cohort dispatches."""
    jrun, prun, *_ = runs
    assert cells.swarm_disagreements(jrun.steps, prun.steps, POSE_TOL)[0] == []
    assert [s.dispatches for s in prun.steps] == [s.dispatches for s in jrun.steps]
    assert prun.swarm.fused_cohort_dispatches == jrun.swarm.fused_cohort_dispatches
    # cohorts that leave agents out (dummy rows) and whole-swarm ones both ran
    cohorts = [sum(p == "cohort" for p in s.paths) for s in prun.steps]
    assert any(0 < c < N_AGENTS for c in cohorts) and N_AGENTS in cohorts, cohorts
    assert prun.swarm.merged_groups() == jrun.swarm.merged_groups()


def test_overlap_hint_matches_jax(runs):
    """After every frame the [8, 8] overlap hint equals JAX's, and every
    mediator's hint dict equals its JAX counterpart's."""
    _, _, jhints, phints = runs
    for i, ((jh, jmeds), (ph, pmeds)) in enumerate(zip(jhints, phints)):
        assert (jh is None) == (ph is None), f"frame {i}"
        if jh is not None:
            assert ph.shape == (N_AGENTS, N_AGENTS) and ph.dtype == np.int32
            np.testing.assert_array_equal(ph, jh, err_msg=f"frame {i}")
        assert pmeds == jmeds, f"frame {i}"
    assert phints[-1][0] is not None


def test_overlap_hint_reaches_only_the_cohort(runs):
    """A frame's hint is fed to the mediators of that frame's cohort only,
    each from its own agent's row; the others keep their earlier hint."""
    _, prun, _, phints = runs
    before = [None] * N_AGENTS
    for i, (step, (hint, meds)) in enumerate(zip(prun.steps, phints)):
        for a, path in enumerate(step.paths):
            if path == "cohort":
                want = {o: float(hint[a, o]) / 128.0 for o in range(N_AGENTS) if o != a}
                assert meds[a] == want, f"frame {i} agent {a}"
            else:
                assert meds[a] == before[a], f"frame {i} agent {a}"
        before = meds


def test_mesh_sharded_swarm_with_merge(runs):
    """tests/test_swarm.py::test_mesh_sharded_swarm_with_merge's bars on
    the port's run."""
    swarm = runs[1].swarm
    assert swarm.mesh is not None, "8 agents on 8 devices must build a mesh"
    assert swarm.mesh.size() == N_AGENTS
    assert all(m.loop_closing.mesh is swarm.gba_mesh for m in swarm.mediators)
    tracked = [a.frames_tracked for a in swarm.agents]
    assert sum(t > 0.5 * N_FRAMES for t in tracked) >= 6, tracked
    assert swarm.fused_cohort_dispatches > 0, "mesh cohort never dispatched"
    assert swarm._mesh_step is not None
    # the cross-agent overlap prefilter reached the server side
    assert swarm.overlap_hint is not None
    assert swarm.overlap_hint.shape == (N_AGENTS, N_AGENTS)
    assert np.asarray(swarm.overlap_hint).dtype == np.int32
    assert any(m.overlap_hint for m in swarm.mediators)
    # same-world agents must merge into a multi-map group
    biggest = max(swarm.merged_groups(), key=len)
    assert len(biggest) >= 2, f"no merge: {swarm.merged_groups()}"
