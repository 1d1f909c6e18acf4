"""Tests of the port that need a CUDA device: the hand-written LM pose
kernel (csrc/pose_lm.cu, its register and streaming builds) against its
plain PyTorch version, the batched tracking step and the per-agent tracker
on the card against the same on the CPU, RANSAC PnP with its refinement
through the kernel, a map saved, loaded and relocalised against, and the
server's device programs (the CG bundle adjustment and the pose graph,
bit-equal across card runs) and one server request, card against CPU;
`utils.device.fetch` / `fetch_async` waiting on their own copies only;
the in-process swarm (`swarm.Swarm`) on the card against the CPU, with
one cohort dispatch's pose stage against the plain version; and the
stereo path (`stereo_depths`, the left extraction repeated bit for bit,
five stereo frames) and the dynamic-object segmenter, card against CPU.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a CUDA device every test skips.
"""
import numpy as np
import pytest
import torch

from swarmmap_tpu_torch import pipeline
from swarmmap_tpu_torch.bench_pose import against_plain, pose_problems, record_pose_calls
from swarmmap_tpu_torch.cells import compare_records, new_tracker, render_frames, track_sequence, tracker_world
from swarmmap_tpu_torch.ops import pnp, pose_kernel, pose_opt
from swarmmap_tpu_torch.utils import datasets
from swarmmap_tpu_torch.utils.stats import STATS

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pose kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [300, 1000, 1024, 2048])
@pytest.mark.parametrize("n_agents", [1, 3, 8])
@pytest.mark.parametrize("rounds,iters,min_agree", [(2, 8, 0.99), (4, 10, 0.98)])
def test_pose_kernel_matches_plain(cuda, rounds, iters, min_agree, n_agents, n):
    """Ragged (300), EuRoC/TUM (1000 features: N = 1000 and its padded 1024,
    the 4-points-per-thread build) and KITTI (2048, the 8-points build)
    widths, at 1, 3 and 8 agents."""
    rng = np.random.RandomState(40 + rounds + n + n_agents)
    args = [x.to(cuda) for x in pose_problems(rng, n_agents, n, cold=(rounds == 4))]
    before = pose_kernel.pose_lm_launches
    k = pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > min_agree
    ok = k.inliers & p.inliers
    torch.testing.assert_close(k.chi2[ok], p.chi2[ok], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rounds,iters", [(0, 8), (1, 1)])
def test_pose_kernel_edge_schedules(cuda, rounds, iters):
    """rounds = 0 returns T0 and the inliers gated at T0; 1x1 is one step."""
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(3), 3, 1000, False)]
    k = pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    if rounds == 0:
        assert torch.equal(k.Tcw, args[0])
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > 0.99
    torch.testing.assert_close(k.chi2, p.chi2, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n", [2049, 4096])
@pytest.mark.parametrize("rounds,iters,min_agree", [(0, 8, 0.99), (2, 8, 0.99), (4, 10, 0.98)])
def test_pose_kernel_streaming_build_matches_plain(cuda, rounds, iters, min_agree, n):
    """Above 2048 points the streaming build (points read from global
    memory on each pass), at 3 agents, within the register builds' bars."""
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(2 + n), 3, n, rounds == 4)]
    before = pose_kernel.pose_lm_launches
    k = pose_opt.pose_optimize_auto(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    if rounds == 0:
        assert torch.equal(k.Tcw, args[0])
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > min_agree
    ok = k.inliers & p.inliers
    torch.testing.assert_close(k.chi2[ok], p.chi2[ok], rtol=1e-2, atol=1e-2)


def test_pose_kernel_refuses_bad_inputs(cuda):
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(1), 2, 300, False)]
    before = pose_kernel.pose_lm_launches
    bad_dtype = list(args)
    bad_dtype[2] = args[2].double()
    bad_layout = list(args)
    bad_layout[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    bad_shape = list(args)
    bad_shape[4] = args[4][:, :-1]
    for bad in (bad_dtype, bad_layout, bad_shape):
        with pytest.raises(ValueError):
            pose_kernel.pose_optimize_cuda(*bad)
    assert pose_kernel.pose_lm_launches == before


def test_batched_step_on_gpu_matches_cpu(cuda):
    """Small-size batched tracking step: one kernel launch, and the same
    pose and inliers as the CPU step (plain versions throughout)."""
    kw = dict(n_features=256, n_levels=3, hw=(240, 320))
    inp = pipeline.stack_inputs([
        pipeline.realistic_track_inputs(hw=(240, 320), n_map_points=512, n_features=256,
                                        n_levels=3, seed=s, device="cpu")
        for s in range(3)])
    cpu = pipeline.batched_tracking_step(inp, **kw)
    before = pose_kernel.pose_lm_launches
    gpu = pipeline.batched_tracking_step(pipeline.TrackInputs(*(x.to(cuda) for x in inp)), **kw)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((gpu.Tcw.cpu() - cpu.Tcw).abs().max()) < 5e-3
    diff = (gpu.n_inliers.cpu() - cpu.n_inliers).abs()
    assert bool((diff <= torch.clamp(0.05 * cpu.n_inliers, min=3)).all())
    assert int(cpu.n_inliers.min()) >= 20


# the tracker at the CPU tests' size: 240x320, 400 features, 4 levels
TRACKER_KW = dict(n_features=400, n_levels=4)


@pytest.fixture(scope="module")
def small_world():
    world = tracker_world(hw=(240, 320), n_points=600)
    return world, render_frames(world, 6)


@pytest.mark.parametrize("path", ["rgbd", "fused"])
def test_tracker_on_gpu_matches_cpu(cuda, small_world, path):
    """Six frames, RGB-D (the staged path) or a depth frame then monocular
    frames (the fused path): the card's tracker follows the CPU's within
    the parity bars (|dTcw| < 1e-3; the kernel runs a fixed schedule, the
    CPU version stops early), and every pose optimisation is one kernel
    launch."""
    world, frames = small_world
    depth_frames = range(6) if path == "rgbd" else {0}
    cpu = track_sequence(new_tracker(world, "cpu", **TRACKER_KW), frames, depth_frames)
    STATS.reset()
    before = pose_kernel.pose_lm_launches
    gpu = track_sequence(new_tracker(world, cuda, **TRACKER_KW), frames, depth_frames)
    torch.cuda.synchronize()
    assert compare_records(cpu, gpu) == []
    assert [r.state for r in gpu] == ["OK"] * 6
    calls = STATS.counts["pose_opt_frame"] + STATS.counts.get("fused_step", 0)
    assert pose_kernel.pose_lm_launches - before == calls
    if path == "fused":
        assert gpu[-1].fused_frames == 4 and STATS.counts["fused_step"] == 4
    else:
        assert STATS.counts["pose_opt_frame"] == 10


@pytest.mark.parametrize("frames", [(0, 1, 2, 3, 25, 26), (0, 1, 2, 3, 40, 41)],
                         ids=["fused_fallback", "recently_lost"])
def test_tracker_jumps_on_gpu_match_cpu(cuda, frames):
    """A jump along the trajectory after a depth bootstrap and monocular
    frames: the fused step's staged fallback (features fetched late) and
    the RECENTLY_LOST hold, on the card as on the CPU."""
    world = tracker_world(hw=(240, 320), n_points=600)
    seq = [datasets.render_frame(world, i, return_depth=True) for i in frames]
    cpu = track_sequence(new_tracker(world, "cpu", **TRACKER_KW), seq, {0})
    gpu = track_sequence(new_tracker(world, cuda, **TRACKER_KW), seq, {0})
    torch.cuda.synchronize()
    assert compare_records(cpu, gpu) == []
    assert [r.state for r in gpu] == ["OK"] * len(frames)


def test_tracker_relocalises_on_gpu(cuda, small_world):
    """LOST after the depth initialisation: frame 1 relocalises, with RANSAC
    PnP on the card and both refinements (3x8 and 4x10) in the kernel, each
    launch within the bars of the plain version on the same tensors."""
    world, frames = small_world
    tracker = new_tracker(world, cuda, **TRACKER_KW)
    tracker.grab(frames[0][0], 0.0, depth_image=frames[0][1])
    tracker.state = type(tracker.state).LOST
    STATS.reset()
    before = pose_kernel.pose_lm_launches
    with record_pose_calls() as calls:
        tracker.grab(frames[1][0], 0.05)
    torch.cuda.synchronize()
    assert tracker.state.name == "OK" and STATS.counts["relocalized"] == 1
    assert pose_kernel.pose_lm_launches - before == len(calls) == (
        STATS.counts["ransac_pnp"] + STATS.counts["pose_opt_frame"])
    rows = against_plain(calls)
    assert {r["schedule"] for r in rows} == {(3, 8), (4, 10)}
    for r in rows:
        assert r["err"] < 1e-3 and r["agree"] > 0.98, r


def test_ransac_pnp_on_gpu_matches_cpu(cuda):
    """The same draws on both devices: the same success and inliers (to
    1%), poses within 1e-3 (cuSOLVER and LAPACK round the minimal solves
    differently; the refinement is the kernel on the card)."""
    rng = np.random.RandomState(0)
    n = 200
    P = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], 1)
    K = np.array([[400, 0, 160], [0, 400, 120], [0, 0, 1]], np.float32)
    pc = P + np.array([0.2, -0.1, 0.3])
    uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 160, 400 * pc[:, 1] / pc[:, 2] + 120], 1)
    uv += rng.randn(n, 2)
    uv[:40] += rng.uniform(-50, 50, (40, 2))
    pts, uvs, ok = np.zeros((256, 3), np.float32), np.zeros((256, 2), np.float32), np.zeros(256, bool)
    pts[:n], uvs[:n], ok[:n] = P, uv, True
    args = [torch.from_numpy(x) for x in (pts, uvs, ok, K)]
    draws = pnp.draw_indices(args[2], torch.Generator().manual_seed(0))
    rc = pnp.ransac_pnp_draws(*args, draws, min_inliers=20)
    before = pose_kernel.pose_lm_launches
    rg = pnp.ransac_pnp_draws(*(x.to(cuda) for x in args), draws.to(cuda), min_inliers=20)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert bool(rc.success) and bool(rg.success)
    assert float((rg.inliers.cpu() == rc.inliers).float().mean()) >= 0.99
    assert float((rg.Tcw.cpu() - rc.Tcw).abs().max()) < 1e-3
    gen = torch.Generator(device=cuda).manual_seed(0)
    assert bool(pnp.ransac_pnp(*(x.to(cuda) for x in args), gen, min_inliers=20).success)


def test_monocular_system_on_gpu_matches_cpu(cuda):
    """The monocular client (two-view initialisation, dense BA, local
    mapping) at 240x320, 400 features, 4 levels: 12 frames on the card,
    then on the CPU with the card's two-view draws replayed; the same
    states, keyframe and point counts, |dTcw| < 1e-3; every pose_lm launch
    within the plain version's bars."""
    from swarmmap_tpu_torch.cells import (mono_sequence, new_system, recorded_draws,
                                          replayed_draws, state_disagreements, track_mono)

    seq = mono_sequence(hw=(240, 320), n_points=350)
    with record_pose_calls() as calls, recorded_draws() as draws:
        card = track_mono(new_system(seq, cuda, 400, 4), seq, 12)
    with replayed_draws(list(draws)):
        cpu = track_mono(new_system(seq, "cpu", 400, 4), seq, 12)
    assert state_disagreements(card, cpu) == []
    assert card[-1].n_kf >= 3 and card[-1].state == "OK"
    rows = against_plain(calls)
    assert rows and max(r["err"] for r in rows) < 1e-3


def test_dense_ba_on_gpu_matches_cpu(cuda):
    """One local-BA-sized problem on the card and on the CPU: |dTcw| <
    1e-3, points within 1e-3 relative; two card runs give the same bits."""
    from swarmmap_tpu_torch.ops import ba, lie

    rng = np.random.RandomState(0)
    n_cams, n_pts = 8, 300
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(5, 9, n_pts)], 1)
    Tcw = np.tile(np.eye(4), (n_cams, 1, 1))
    Tcw[:, 0, 3] = -0.4 * np.arange(n_cams)
    obs = [(c, j) for c in range(n_cams) for j in range(n_pts) if rng.rand() > 0.3]
    cam, pt = np.array(obs).T
    pc = pts[pt] + Tcw[cam, :3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 450.0 + K[:2, 2] + rng.normal(0, 0.5, (len(obs), 2))
    jitter = lie.se3_exp(torch.tensor(rng.randn(n_cams, 6) * 0.01, dtype=torch.float32)).numpy()
    args = (jitter @ Tcw, np.tile(K, (n_cams, 1, 1)), np.arange(n_cams) < 2,
            pts + rng.normal(0, 0.05, pts.shape), cam, pt, uv, np.ones(len(obs)))
    prob = ba.build_padded_problem(*args, device=cuda)
    rc, rc2 = ba.bundle_adjust(prob), ba.bundle_adjust(prob)
    rp = ba.bundle_adjust(ba.build_padded_problem(*args, device="cpu"))
    assert all(torch.equal(getattr(rc, f), getattr(rc2, f)) for f in ba.BAResult._fields)
    assert float((rc.Tcw.cpu() - rp.Tcw).abs().max()) < 1e-3
    rel = (rc.pts.cpu() - rp.pts).abs().amax(1) / rp.pts.abs().amax(1).clamp(min=1e-6)
    assert float(rel.max()) < 1e-3


def test_save_load_map_relocalises_on_gpu(cuda, tmp_path):
    """tests/test_slam_e2e.py's map reuse on the card (240x320, 400
    features, 4 levels, 40 frames): a saved map loads into a fresh client
    with the same counts in both formats, and at least 2 of 3 mid-sequence
    frames relocalise against it, every pose_lm launch within the plain
    version's bars."""
    from swarmmap_tpu_torch.cells import mono_sequence, new_system, relocalised

    seq = mono_sequence(hw=(240, 320), n_points=350)
    system = new_system(seq, cuda, 400, 4)
    for i in range(len(seq)):
        system.track_monocular(seq.read(i), seq.timestamps[i])
    assert system.n_keyframes() >= 3
    for fmt in ("msgpack", "boost-bin"):
        path = tmp_path / f"map-{fmt}.bin"
        system.save_map(path, fmt=fmt)
        fresh = new_system(seq, cuda, 400, 4)
        assert not fresh.load_map(tmp_path / "missing.bin")
        assert fresh.load_map(path)
        assert (fresh.n_keyframes(), fresh.n_map_points()) == (
            system.n_keyframes(), system.n_map_points())
        with record_pose_calls() as calls:
            ok = relocalised(fresh, seq)
        assert sum(ok) >= 2, ok
        rows = against_plain(calls)
        assert rows and all(r["err"] < 1e-3 and r["agree"] > 0.98 for r in rows), rows


def _ba_problem(device, n_cams=8, n_pts=300):
    """test_dense_ba_on_gpu_matches_cpu's problem on `device`."""
    from swarmmap_tpu_torch.ops import ba, lie

    rng = np.random.RandomState(0)
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(5, 9, n_pts)], 1)
    Tcw = np.tile(np.eye(4), (n_cams, 1, 1))
    Tcw[:, 0, 3] = -0.4 * np.arange(n_cams)
    obs = [(c, j) for c in range(n_cams) for j in range(n_pts) if rng.rand() > 0.3]
    cam, pt = np.array(obs).T
    pc = pts[pt] + Tcw[cam, :3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 450.0 + K[:2, 2] + rng.normal(0, 0.5, (len(obs), 2))
    jitter = lie.se3_exp(torch.tensor(rng.randn(n_cams, 6) * 0.01, dtype=torch.float32)).numpy()
    return ba.build_padded_problem(jitter @ Tcw, np.tile(K, (n_cams, 1, 1)), np.arange(n_cams) < 2,
                                   pts + rng.normal(0, 0.05, pts.shape), cam, pt, uv,
                                   np.ones(len(obs)), device=device)


def test_cg_ba_on_gpu_matches_cpu(cuda):
    """The CG backend of global BA on the card and on the CPU: |dTcw| <
    1e-3, points within 1e-3 relative; two card runs give the same bits."""
    from swarmmap_tpu_torch.ops import ba

    prob = _ba_problem(cuda)
    rc, rc2 = (ba.bundle_adjust(prob, mode="cg") for _ in range(2))
    rp = ba.bundle_adjust(_ba_problem("cpu"), mode="cg")
    assert all(torch.equal(getattr(rc, f), getattr(rc2, f)) for f in ba.BAResult._fields)
    assert float((rc.Tcw.cpu() - rp.Tcw).abs().max()) < 1e-3
    rel = (rc.pts.cpu() - rp.pts).abs().amax(1) / rp.pts.abs().amax(1).clamp(min=1e-6)
    assert float(rel.max()) < 1e-3


def test_pose_graph_on_gpu_same_bits(cuda):
    """The essential-graph optimiser on a drifted 24-node chain with a loop
    edge: two card runs give the same bits (its blocks are summed through
    a presorted plan, no atomics), and the card agrees with the CPU to
    1e-4."""
    from swarmmap_tpu_torch.ops import lie, pose_graph

    g = torch.Generator().manual_seed(0)
    n = 24
    steps = torch.randn(n - 1, 7, generator=g) * 0.15
    steps[:, 6] *= 0.1
    R, t, s = [torch.eye(3)], [torch.zeros(3)], [torch.tensor(1.0)]
    for i in range(n - 1):
        Ri, ti, si = lie.sim3_mul(*lie.sim3_exp(steps[i]), R[-1], t[-1], s[-1])
        R.append(Ri), t.append(ti), s.append(si)
    R, t, s = torch.stack(R), torch.stack(t), torch.stack(s)
    ei = torch.cat([torch.arange(n - 1), torch.tensor([0])])
    ej = torch.cat([torch.arange(1, n), torch.tensor([n - 1])])
    mR, mt, ms = lie.sim3_mul(R[ej], t[ej], s[ej], *lie.sim3_inv(R[ei], t[ei], s[ei]))
    noise = torch.randn(n, 7, generator=g) * 0.02 * torch.arange(n)[:, None] / n
    R0, t0, s0 = lie.sim3_mul(*lie.sim3_exp(noise), R, t, s)
    fixed = torch.arange(n) == 0
    args = (R0, t0, s0, ei, ej, mR, mt, ms, torch.ones(n, dtype=torch.bool), fixed,
            torch.ones(n, dtype=torch.bool))

    def run(dev):
        R_, t_, s_, *rest = (x.to(dev) for x in args)
        return pose_graph.optimize_pose_graph(pose_graph.Sim3Nodes(R_, t_, s_), *rest)

    a, b, c = run(cuda), run(cuda), run("cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert float((x.cpu() - z).abs().max()) < 1e-4


def test_server_request_on_gpu_matches_cpu(cuda):
    """One server request on the card and on the CPU on the same push
    bytes (a CPU client's first push on the circuit at 240x320, 400
    features, 4 levels), with one clock and the card's Sim3 draws replayed
    on the CPU: the same new keyframes and decisions, GBA iterations
    applied, and replicas within the server phase's bars."""
    from swarmmap_tpu_torch import cells

    seqs = cells.server_sequences("server_loop", hw=(240, 320), n_points=700)
    settings = cells.settings_for(seqs[0].world, 400, 4)
    with cells.FrameClock() as clock:
        client = cells.Server(1, settings, "cpu", clock=clock)
        cells.serve_sequences(client, seqs, n=20, push_every=20, report_every=5)
        events = client.events
        runs = {}
        for dev in (cuda, "cpu"):
            srv = cells.Server(1, settings, dev, clock=clock, agents=False)
            log = cells.log_requests(srv.scheduler, srv.mediators)
            if dev == "cpu":
                with cells.replayed_draws(draws, kind="sim3"):
                    srv.replay(events)
            else:
                with cells.recorded_draws(kind="sim3") as draws:
                    srv.replay(events)
            runs[str(dev)] = (srv, log)
    (gpu, glog), (cpu, clog) = runs[str(cuda)], runs["cpu"]
    assert [e[0] for e in events].count("push") == 1
    assert len(glog) == 1 and glog == clog
    assert glog[0]["new_kfs"] and glog[0]["gba"] == [10]
    assert not cells.replica_gaps(gpu.mediators[0].store, cpu.mediators[0].store,
                                  {"pose": 2e-3, "pos": 1e-2, "mp_alive": 0.01})


def test_background_gba_on_gpu(cuda):
    """The scheduler's background GBA (`background_gba=True`) issues its
    card work from a second host thread: it runs to its end on the card
    and applies under store.lock (the anchor kept, the other keyframes
    moved), within 1e-3 of the same pass on the CPU."""
    from swarmmap_tpu_torch.ops.vocab import default_vocabulary
    from swarmmap_tpu_torch.server.map_manager import MapManager
    from swarmmap_tpu_torch.server.mediator import AgentMediator
    from swarmmap_tpu_torch.server.scheduler import MediatorScheduler
    from swarmmap_tpu_torch.swarm import SwarmAgent
    from swarmmap_tpu_torch.utils.config import CameraConfig, OrbConfig, Settings

    vocab = default_vocabulary()
    settings = Settings(camera=CameraConfig(fx=100, fy=100, cx=32, cy=32, fps=20,
                                            width=64, height=64),
                        orb=OrbConfig(n_features=64, n_levels=3))
    agent = SwarmAgent(0, settings, vocab, device="cpu")
    st = agent.system.store
    rng = np.random.RandomState(0)
    K = settings.camera.K
    pts = np.stack([rng.uniform(-1, 1, 60), rng.uniform(-1, 1, 60), rng.uniform(3, 5, 60)],
                   1).astype(np.float32)
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-0.2 * i, 0, 0]
        uv = np.zeros((st.n_kp, 2), np.float32)
        pc = pts + T[:3, 3]
        uv[:60] = pc[:, :2] / pc[:, 2:] * 100.0 + 32.0 + rng.normal(0, 0.3, (60, 2))
        if i > 1:
            T[:3, 3] += rng.normal(0, 0.03, 3)        # the GBA's work
        st.add_keyframe(pose_cw=T, K=K, kp_uv=uv, kp_octave=np.zeros(st.n_kp, np.int32),
                        kp_angle=np.zeros(st.n_kp, np.float32),
                        kp_response=np.ones(st.n_kp, np.float32),
                        kp_valid=np.arange(st.n_kp) < 60,
                        desc=rng.randint(0, 2**32, (st.n_kp, 8), dtype=np.uint32),
                        ts=float(i), hw=(64, 64))
    for j in range(60):
        m = st.add_map_point(pts[j], st.kf_desc[0, j], ref_kf=0)
        for k in range(4):
            st.add_observation(m, k, j)
    payload = agent.push_payload()
    poses = {}
    for dev in (cuda, "cpu"):
        AgentMediator.registry.clear()
        mm = MapManager(device=dev)
        sched = MediatorScheduler(mm, gba_iters=10, background_gba=True)
        med = AgentMediator(0, vocab, mm, n_kp=st.n_kp, device=dev)
        sched.register_mediator(med)
        sched.enqueue_request(0, payload)
        assert sched.process_pending() == 1
        thread = sched._gba_threads[0]
        thread.join(timeout=120)
        assert not thread.is_alive()
        with med.store.lock:
            poses[str(dev)] = med.store.kf_pose_cw[: med.store.n_kf].copy()
    assert np.abs(poses[str(cuda)][1:] - st.kf_pose_cw[1:4]).max() > 1e-3   # it applied
    np.testing.assert_array_equal(poses[str(cuda)][0], st.kf_pose_cw[0])      # the anchor
    np.testing.assert_allclose(poses[str(cuda)], poses["cpu"], atol=1e-3)


SLEEP_CYCLES = 200_000_000   # torch.cuda._sleep: 0.1 s and more at the H100's clocks


def test_fetch_waits_for_its_own_copies_only(cuda):
    """A fetch returns while unrelated work on another stream still runs
    (a device-wide synchronize would wait for it)."""
    from swarmmap_tpu_torch.utils.device import fetch

    a = torch.arange(1000, device=cuda, dtype=torch.float32) * 2
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
    host = fetch(a)
    assert not slept.query(), "fetch waited for the other stream's work"
    np.testing.assert_array_equal(host, np.arange(1000, dtype=np.float32) * 2)
    torch.cuda.synchronize()


def test_fetch_async_result_ahead_of_later_work(cuda):
    """The double buffer's case: a fetch_async handle taken of A gives A's
    values while B, enqueued after it on the same stream, still runs."""
    from swarmmap_tpu_torch.utils.device import fetch_async

    a = torch.arange(1000, device=cuda, dtype=torch.int32) + 7
    handle = fetch_async(a, {"twice": a * 2})
    torch.cuda._sleep(SLEEP_CYCLES)
    b = a * 3
    done_b = torch.cuda.Event()
    done_b.record()
    host, extra = handle.result()
    assert not done_b.query(), "result() waited for work enqueued after the copies"
    np.testing.assert_array_equal(host, np.arange(1000, dtype=np.int32) + 7)
    np.testing.assert_array_equal(extra["twice"], 2 * (np.arange(1000, dtype=np.int32) + 7))
    assert handle.result()[0] is host
    torch.cuda.synchronize()
    assert int(b[0]) == 21


SWARM_KW = dict(n_frames=12, hw=(240, 320), n_points=350, n_features=400, n_levels=4,
                record_every=4)


@pytest.fixture(scope="module")
def swarm_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pose kernel is CUDA C++ for sm_90a)")
    from swarmmap_tpu_torch import cells

    return cells.run_swarm(torch.device("cuda", 0), **SWARM_KW)


def test_swarm_on_gpu_matches_cpu(swarm_on_card):
    """A 3-agent Swarm for 12 frames at 240x320 on the card, and the same
    run on the CPU with the card's two-view draws: the same path and
    state per frame and agent, poses within 2e-3 until the first merge
    and while an agent's keyframes are the same in both runs
    (`cells.swarm_disagreements`), every cohort dispatch one launch.
    2e-3, not the tracker's 1e-3: the initial BA's first step is
    ill-conditioned (each device lands ~1e-3 of the step from the float64
    solve, ROADMAP queue 3), and agent 1's initial map parts by 1.4e-3
    here."""
    from swarmmap_tpu_torch import cells

    card = swarm_on_card
    cpu = cells.run_swarm("cpu", draws={"twoview": card.draws["twoview"]}, **SWARM_KW)
    assert cells.swarm_disagreements(card.steps, cpu.steps, 2e-3)[0] == []
    assert any(all(p == "cohort" for p in st.paths) for st in card.steps)
    assert card.dispatch_launches == card.n_dispatches > 0


def test_swarm_cohort_pose_kernel_matches_plain(swarm_on_card):
    """One cohort dispatch's pose stage (A = 3 agents in one pose_lm
    launch) against pose_optimize(step_tol=0) on the same problem."""
    d = swarm_on_card.dispatches[-1]
    prob = pipeline.match_frame(d["inputs"], **d["kw"])[3]
    assert prob.Tcw0.shape[0] == 3
    rk = pose_opt.pose_optimize_auto(*prob, rounds=2, iters=8)
    rp = pose_opt.pose_optimize(*prob, rounds=2, iters=8, step_tol=0.0)
    assert float((rk.Tcw - rp.Tcw).abs().max()) < 1e-3
    assert float((rk.inliers == rp.inliers).float().mean()) > 0.99


def test_stereo_depths_on_gpu_matches_cpu(cuda):
    """`stereo_depths` on the card against the CPU on the same features
    (one pair of the stereo cell at full width, 1000 features, 8 levels):
    the same matched set, depths within 1e-6 relative."""
    from swarmmap_tpu_torch.cells import STEREO_BASELINE, stereo_pairs
    from swarmmap_tpu_torch.ops import extractor, stereo

    world = tracker_world()
    left, right = stereo_pairs(world, 1)[0]
    fL, fR = (extractor.extract_orb(torch.from_numpy(x), n_features=1000, n_levels=8)
              for x in (left, right))
    args = [getattr(f, k) for f in (fL, fR) for k in ("xy", "desc", "octave", "valid")]
    kw = dict(fx=float(world.K[0, 0]), baseline=STEREO_BASELINE)
    cpu = stereo.stereo_depths(*args, **kw).numpy()
    card = stereo.stereo_depths(*(a.to(cuda) for a in args), **kw).cpu().numpy()
    ok = cpu > 0
    assert ok.sum() > 100
    np.testing.assert_array_equal(card > 0, ok)
    np.testing.assert_array_less(np.abs(card[ok] - cpu[ok]), 1e-6 * cpu[ok])


def test_left_extraction_repeats_on_gpu(cuda):
    """`System.track_stereo` computes depths on one extraction of the left
    image and `build_frame` extracts it again: on the card the two give
    the same bits (480x752, 1000 features, 8 levels)."""
    from swarmmap_tpu_torch.cells import stereo_pairs
    from swarmmap_tpu_torch.ops import extractor

    left = torch.from_numpy(stereo_pairs(tracker_world(), 1)[0][0]).to(cuda)
    a, b = (extractor.extract_orb(left, n_features=1000, n_levels=8) for _ in range(2))
    for f in ("xy", "desc", "octave", "valid", "angle", "response"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_segmenter_on_gpu_matches_cpu(cuda):
    """The shipped segmenter on the card against the CPU module on frames
    of the dynamic cell (480x752): masks equal wherever |logit| > 1e-4;
    each device's float32 logits within 1.5e-5 of a float64 forward, so
    within 3e-5 of each other.  (Logits reach |16| here, where a float32
    ulp is 1.9e-6: each device sums its 200-term dot products in its own
    order and lands 0.7-1.1e-5 from the exact result, card against CPU
    1.0-1.3e-5 apart; the 1e-5 bar of the CPU parity test, JAX's im2col
    against the port at 240x320, holds there at 7.6e-6.)"""
    import copy

    from swarmmap_tpu_torch.cells import dynamic_sequence
    from swarmmap_tpu_torch.core.dynamic import load_segmenter

    seq = dynamic_sequence()
    card, cpu = load_segmenter(cuda), load_segmenter("cpu")
    exact = copy.deepcopy(cpu).double()
    assert card.convs[0].weight.device.type == "cuda"
    for i in (0, 20, 39):
        img = seq.read(i)
        lc, lp = card.logits(img).cpu().numpy(), cpu.logits(img).numpy()
        x = (torch.from_numpy(img.astype(np.float64)) / 255.0)[None, None]
        with torch.no_grad():
            for li, conv in enumerate(exact.convs):
                x = conv(x) if li + 1 == len(exact.convs) else torch.relu(conv(x))
        l64 = x[0, 0].numpy()
        assert np.abs(lc - l64).max() < 1.5e-5 and np.abs(lp - l64).max() < 1.5e-5
        assert np.abs(lc - lp).max() < 3e-5
        sure = np.abs(lp) > 1e-4
        np.testing.assert_array_equal(card(img)[sure], (lp > 0)[sure])


def test_stereo_on_gpu_matches_cpu(cuda):
    """Five stereo frames at 240x320 (400 features, 4 levels) on the card
    and on the CPU: the tracker's parity bars, two pose_lm launches a
    frame after the first."""
    from swarmmap_tpu_torch.cells import new_system, stereo_pairs, track_stereo

    world = tracker_world(hw=(240, 320), n_points=350)
    pairs = stereo_pairs(world, 5)
    cpu = track_stereo(new_system(world, "cpu", 400, 4), pairs)
    card = track_stereo(new_system(world, cuda, 400, 4), pairs)
    torch.cuda.synchronize()
    assert compare_records(cpu, card) == []
    assert [r.state for r in card] == ["OK"] * 5
    assert [r.counts["pose_lm"] for r in card[1:]] == [2] * 4


# a small fake EuRoC: 240x320, EuRoC cam0's distortion, 400 features, 4 levels
CLI_SETTINGS = ("%YAML:1.0\nCamera.fx: 230.0\nCamera.fy: 230.0\nCamera.cx: 160.0\n"
                "Camera.cy: 120.0\nCamera.k1: -0.28340811\nCamera.k2: 0.07395907\n"
                "Camera.p1: 0.00019359\nCamera.p2: 1.76187114e-05\nCamera.fps: 20.0\n"
                "Camera.width: 320\nCamera.height: 240\nORBextractor.nFeatures: 400\n"
                "ORBextractor.nLevels: 4\n")
# Where the card's and the CPU's runs of the CLI tree part: agent 0 loses
# its first map at frame 2 and initialises again at frame 4, and that
# map's first BA (ill-conditioned, ROADMAP queue 3) parts the devices by
# 5.24e-3 there and by 7.6e-4 to 4.15e-3 in frames 5-11 (H100, two runs
# alike); agents 1 and 2 stay within 1.3e-5.  From frame 4 on agent 0's
# poses are held at 1e-2; every other pose at
# test_swarm_on_gpu_matches_cpu's 2e-3.
CLI_TCW_TOL = 2e-3
CLI_REINIT = {0: (4, 1e-2)}


def test_swarm_map_cli_on_gpu_matches_cpu(cuda, tmp_path, monkeypatch):
    """`swarm_map -d <tree> -c 3` on a 12-frame fake EuRoC (written with
    utils/png.py) on the card by default, and again with --device cpu on
    the card's two-view draws, one clock: held as
    test_swarm_on_gpu_matches_cpu holds the swarm (the same path and state
    per frame and agent, poses within 2e-3 before a merge and while an
    agent's keyframes agree, every cohort dispatch one launch), but for
    agent 0's poses after its re-initialisation (CLI_REINIT)."""
    from swarmmap_tpu_torch import cells
    from swarmmap_tpu_torch.cli import swarm_map
    from swarmmap_tpu_torch.utils.config import Settings

    (tmp_path / "s.yaml").write_text(CLI_SETTINGS)
    cells.write_euroc_tree(tmp_path / "data", Settings.load(tmp_path / "s.yaml"), 12, n_points=350)
    cfg = tmp_path / "ds.yaml"
    cfg.write_text(f"%YAML:1.0\nTYPE: 'euroc'\nSETTING: '{tmp_path / 's.yaml'}'\nIMAGES: ["
                   + ", ".join(f"'/{n}/mav0/cam0/data'" for n in cells.EUROC_SEQS) + "]\n")
    monkeypatch.setenv("SWARMMAP_DATA", str(tmp_path / "data"))
    argv = ["-d", str(cfg), "-c", "3", "-l", "warning"]
    clock = cells.FrameClock()
    with clock, cells.stepped_swarms(swarm_map, clock), cells.recorded_draws("twoview") as draws:
        card = swarm_map.main(argv + ["-o", str(tmp_path / "card")])
        torch.cuda.synchronize()
    with clock, cells.stepped_swarms(swarm_map, clock), cells.replayed_draws(draws, "twoview"):
        cpu = swarm_map.main(argv + ["-o", str(tmp_path / "cpu"), "--device", "cpu"])
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    assert cells.swarm_disagreements(card.run.steps, cpu.run.steps, CLI_TCW_TOL,
                                     CLI_REINIT)[0] == []
    assert any(all(p == "cohort" for p in st.paths) for st in card.run.steps)
    assert card.run.dispatch_launches == card.run.n_dispatches > 0
    assert (tmp_path / "card" / "map-server-0.bin").exists()


def test_cli_raises_without_a_visible_card(tmp_path):
    """With no card visible (CUDA_VISIBLE_DEVICES empty) and no --device, a
    CLI raises default_device's error: no fallback to the CPU.  Runs
    without a card too."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, [str(repo), os.environ.get("PYTHONPATH")])))
    code = ("from swarmmap_tpu_torch.cli import mono; "
            f"mono.main(['--synthetic', '--frames', '2', '-o', {str(tmp_path / 'out')!r}])")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    assert not (tmp_path / "out").exists()
