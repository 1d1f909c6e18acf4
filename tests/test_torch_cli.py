"""The port's CLIs (`swarmmap_tpu_torch/cli/`) with `--device cpu` beside
the JAX package's, on tests/test_datasets.py's and
tests/test_dress_rehearsal.py's on-disk trees (written with cv2, as those
files write them).

- tests/test_datasets.py's `test_dataset_config_resolution` and
  `test_mono_cli_on_fixture` on the port's CLI code, each loaded sequence
  equal to the JAX CLI's and the trajectory files byte-equal;
- tests/test_dress_rehearsal.py on the port: the committed
  config/mh123.yaml through EuRoC.yaml into a fake EuRoC tree (480x752,
  the EuRoC cam0 distortion, 25 frames per agent) and a 3-agent
  `swarm_map` run at `--features 300`, held to that file's bars; and the
  same command run by JAX's `swarm_map` on the same tree, with JAX's
  two-view and Sim3 draws replayed in the port and one clock
  (`cells.FrameClock`), held as tests/test_torch_swarm.py holds two
  swarms: per frame and agent the same path and tracking state over the
  whole run, the same cohort dispatches, frames tracked and merged
  groups, and each agent's keyframe frames exact and tracked poses within
  TCW_TOL until the frame where its two runs part (POSE_PARTS,
  KEYFRAMES_PART);
- the viewers: the port's HTML map, live view and matplotlib map write
  the JAX package's bytes for JAX's run;
- `swarm_server`'s `Server` and `swarm_client` in this process over
  loopback websockets;
- `relocalizer` (plain and `--bone`) on the port's saved server map,
  beside JAX's on the same map and images with JAX's PnP draws replayed:
  the same frames relocalise.
"""
import contextlib
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import swarmmap_tpu.cli.swarm_map as jswarm_map
import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.ops.pnp as jax_pnp
import swarmmap_tpu.server.landmark_scoring as jax_ls
import swarmmap_tpu_torch.cli.swarm_map as pswarm_map
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.server.landmark_scoring as port_ls
from swarmmap_tpu.cli import common as jcommon, mono as jmono, relocalizer as jreloc
from swarmmap_tpu.utils import config as jconfig
from swarmmap_tpu_torch import cells
from swarmmap_tpu_torch.cli import common as pcommon, mono as pmono, relocalizer as preloc
from swarmmap_tpu_torch.ops import pnp
from swarmmap_tpu_torch.utils.trajectory import umeyama_align
from test_datasets import _euroc_tree, _tum_tree, _write_settings
from test_dress_rehearsal import N_FRAMES, SEQ_NAMES, _render_fake_euroc
from test_torch_swarm import jax_draws_recorded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
HW = (120, 160)
TCW_TOL = 1e-3       # tracked poses before the first merge (tests/test_torch_swarm.py)
FEATURES = "300"     # tests/test_dress_rehearsal.py's cut
# Where the two packages' runs of the rehearsal part (no merge happens in
# its 25 frames).  At width 752 their front ends differ (pyramid levels
# and IC angles, ROADMAP queue 3), so agent 0's initial map parts at its
# first tracked frame (|dTcw| 6.3e-3 at frame 3) and its keyframe
# decisions at frame 5 (JAX inserts one there, the port at frame 6), and
# agent 1's pose at frame 7 (2.7e-3); agent 2 agrees throughout (1e-5).
POSE_PARTS = {0: 3, 1: 7, 2: N_FRAMES}
KEYFRAMES_PART = {0: 5, 1: N_FRAMES, 2: N_FRAMES}


@contextlib.contextmanager
def _two_threads():
    """Two torch threads for the full-width runs: at one the port's
    rehearsal alone takes 135 s; its records are the same at 1, 2 and 4."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    from swarmmap_tpu_torch.utils import datasets

    w = datasets.make_world(n_points=120, n_frames=5, hw=HW, seed=3)
    return [datasets.render_frame(w, i) for i in range(5)]


def _same_sequences(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.timestamps, y.timestamps)
        assert x.paths == y.paths
        for i in range(len(x)):
            np.testing.assert_array_equal(x.read(i), y.read(i))


def test_dataset_config_resolution(tmp_path, frames, monkeypatch):
    """tests/test_datasets.py::test_dataset_config_resolution on the port:
    a dataset config yaml (TYPE/SETTING/IMAGES/TIMES, resolved against
    $SWARMMAP_DATA) through cli.common.load_world, equal to JAX's."""
    from swarmmap_tpu_torch.utils.config import DatasetConfig, Settings

    data = tmp_path / "data"
    cam, times, _ = _euroc_tree(data / "euroc_seq", frames)
    _write_settings(tmp_path / "mini.yaml")
    cfg = tmp_path / "ds.yaml"
    cfg.write_text(
        "%YAML:1.0\nTYPE: 'euroc'\n"
        f"SETTING: '{tmp_path / 'mini.yaml'}'\n"
        f"IMAGES: ['/{cam.relative_to(data)}']\n"
        f"TIMES: ['/{times.relative_to(data)}']\n"
        "HOST: '127.0.0.1'\nPORT: 2327\n"
    )
    monkeypatch.setenv("SWARMMAP_DATA", str(data))
    dc = DatasetConfig.load(str(cfg))
    assert dc.type == "euroc" and dc.port == 2327
    settings = Settings.load(dc.setting)
    assert abs(settings.camera.fx - 115.0) < 1e-6 and settings.orb.n_features == 200
    args = types.SimpleNamespace(synthetic=False, dataset=str(cfg), frames=0, features=0,
                                 log="warning")
    got_settings, seqs = pcommon.load_world(args, 1)
    want_settings, want = jcommon.load_world(args, 1)
    assert len(seqs) == 1 and len(seqs[0]) == 5
    assert abs(got_settings.camera.fx - 115.0) < 1e-6
    assert repr(got_settings) == repr(want_settings).replace("swarmmap_tpu.", "swarmmap_tpu_torch.")
    _same_sequences(seqs, want)


def test_mono_cli_on_fixture(tmp_path, frames, monkeypatch):
    """tests/test_datasets.py::test_mono_cli_on_fixture on the port: config
    resolution, the TUM loader, extraction and both trajectory files,
    byte-equal to JAX's `mono` on the same tree."""
    data = tmp_path / "data"
    _tum_tree(data / "fr_mini", frames)
    _write_settings(tmp_path / "mini.yaml")
    cfg = tmp_path / "ds.yaml"
    cfg.write_text("%YAML:1.0\nTYPE: 'tum'\n"
                   f"SETTING: '{tmp_path / 'mini.yaml'}'\nIMAGES: ['/fr_mini']\n")
    monkeypatch.setenv("SWARMMAP_DATA", str(data))
    pout, jout = tmp_path / "pout", tmp_path / "jout"
    system = pmono.main(["-d", str(cfg), "-o", str(pout), "-l", "warning", "--device", "cpu"])
    jmono.main(["-d", str(cfg), "-o", str(jout), "-l", "warning"])
    assert system.tracking.device.type == "cpu"
    for name in ("KeyFrameTrajectory.txt", "FrameTrajectory.txt"):
        assert (pout / name).exists()
        assert (pout / name).read_bytes() == (jout / name).read_bytes(), name


# -- the dress rehearsal, both packages -----------------------------------------

@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """Both packages' `swarm_map -d config/mh123.yaml -c 3 --features 300`
    on one cv2-written fake EuRoC tree: (tree root, rendered worlds, JAX
    swarm, port swarm, output dirs)."""
    settings = jconfig.Settings.load(REPO / "config/settings/EuRoC.yaml")
    root = tmp_path_factory.mktemp("rehearsal")
    worlds = _render_fake_euroc(root / "data", settings)
    out = {"jax": root / "jout", "port": root / "pout"}
    argv = ["-d", str(REPO / "config/mh123.yaml"), "-c", "3", "--features", FEATURES,
            "-l", "warning"]
    clock = cells.FrameClock([port_map_store, port_ls, jax_map_store, jax_ls])
    twoview, sim3, pnp_calls = [], [], []
    with _two_threads(), pytest.MonkeyPatch.context() as mp, clock:
        mp.setenv("SWARMMAP_DATA", str(root / "data"))
        with cells.stepped_swarms(jswarm_map, clock), jax_draws_recorded(twoview, sim3, pnp_calls):
            jsw = jswarm_map.main(argv + ["-o", str(out["jax"])])
        with cells.stepped_swarms(pswarm_map, clock), cells.replayed_draws(twoview, "twoview"), \
                _replayed_then_own(sim3, "sim3"):
            psw = pswarm_map.main(argv + ["-o", str(out["port"]), "--device", "cpu"])
    assert not twoview and not sim3, "the port made fewer RANSACs than JAX"
    return root, worlds, jsw, psw, out


@contextlib.contextmanager
def _replayed_then_own(draws: list, kind: str):
    """`cells.replayed_draws` while `draws` lasts, then the port's own
    generator: once two runs part, the port's server may try a Sim3 that
    JAX's did not (here one more at `finish`, with no merge in either)."""
    module, name = cells._draw_site(kind)
    inner = getattr(module, name)

    def draw(valid, generator):
        if draws:
            return torch.as_tensor(np.array(draws.pop(0))).long().to(valid.device)
        return inner(valid, generator)

    setattr(module, name, draw)
    try:
        yield
    finally:
        setattr(module, name, inner)


def test_mh123_config_resolves_into_3agent_swarm(rehearsal):
    """tests/test_dress_rehearsal.py's bars on the port's run: each agent
    tracks 60% of its frames, fused frames are 30% of the tracked ones,
    ATE under 5% of the ground truth's span, the outputs where the
    reference writes them."""
    _, worlds, _, swarm, out = rehearsal
    assert swarm.device.type == "cpu"
    for a, (agent, w) in enumerate(zip(swarm.agents, worlds)):
        tr = agent.system.tracking
        assert agent.frames_tracked >= 0.6 * N_FRAMES, (a, agent.frames_tracked)
        assert tr.fused_frames >= 0.3 * agent.frames_tracked, (a, tr.fused_frames)
        traj = tr.trajectory
        assert len(traj) >= 10
        est = np.stack([T[:3, 3] for _, T in traj])
        ts0 = 1403636579763555584 / 1e9
        idx = [min(int(round((t - ts0) / 0.05)), N_FRAMES - 1) for t, _ in traj]
        gt = w.poses_wc[idx][:, :3, 3]
        s, R, t = umeyama_align(est, gt)
        resid = np.linalg.norm(est @ (s * R).T + t - gt, axis=1)
        span = np.linalg.norm(gt.max(0) - gt.min(0))
        ate = float(np.sqrt((resid ** 2).mean()))
        assert ate < 0.05 * span, (a, ate, span)
    for name in ("KeyFrameTrajectory-client-0.txt", "map-server-0.bin"):
        assert (out["port"] / name).exists()


def test_rehearsal_matches_jax(rehearsal):
    """The port's run against JAX's: exact paths, states, dispatches,
    frames tracked and groups; per agent, keyframe frames and keyframe
    counts exact before KEYFRAMES_PART and poses within TCW_TOL before
    POSE_PARTS."""
    _, _, jsw, psw, _ = rehearsal
    jsteps, psteps = jsw.run.steps, psw.run.steps
    assert len(psteps) == len(jsteps) == N_FRAMES
    for i, (j, p) in enumerate(zip(jsteps, psteps)):
        assert (p.paths, p.states, p.dispatches) == (j.paths, j.states, j.dispatches), i
        assert not p.merged and not j.merged
    assert [a.frames_tracked for a in psw.agents] == [a.frames_tracked for a in jsw.agents]
    assert [a.system.tracking.fused_frames for a in psw.agents] == \
        [a.system.tracking.fused_frames for a in jsw.agents]
    assert psw.merged_groups() == jsw.merged_groups()
    for a in range(3):
        for i in range(KEYFRAMES_PART[a]):
            assert psteps[i].keyframes[a] == jsteps[i].keyframes[a], (a, i)
            assert psteps[i].n_kf[a] == jsteps[i].n_kf[a], (a, i)
        for i in range(POSE_PARTS[a]):
            p, j = psteps[i].poses[a], jsteps[i].poses[a]
            assert (p is None) == (j is None), (a, i)
            assert p is None or np.abs(p - j).max() < TCW_TOL, (a, i, np.abs(p - j).max())


def test_viewers_match_jax(rehearsal, tmp_path):
    """The port's viewers (copies) write the JAX package's bytes for the
    same maps and swarm (JAX's run): the HTML map, the live view's
    scene.jsonl and live.html, and the matplotlib map; and they run on
    the port's own swarm."""
    from swarmmap_tpu.viz import html_viewer as jhtml, live as jlive, viewer as jviewer
    from swarmmap_tpu_torch.viz import html_viewer as phtml, live as plive, viewer as pviewer

    _, _, jsw, psw, _ = rehearsal
    stores = [m.store for m in jsw.mediators]
    jhtml.export_html(stores, tmp_path / "j.html", title="t")
    phtml.export_html(stores, tmp_path / "p.html", title="t")
    assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    for mod, name in ((jlive, "j"), (plive, "p")):
        stream = mod.LiveStream(tmp_path / name)
        stream.emit(jsw)
        stream.emit(jsw)
    for f in ("scene.jsonl", "live.html"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    phtml.export_html([m.store for m in psw.mediators], tmp_path / "own.html")
    plive.LiveStream(tmp_path / "own").emit(psw)
    assert (tmp_path / "own" / "scene.jsonl").read_text().count("\n") == 1
    pytest.importorskip("matplotlib")
    jviewer.draw_map(stores[0], tmp_path / "j.png")
    pviewer.draw_map(stores[0], tmp_path / "p.png")
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# -- swarm_server + swarm_client over loopback --------------------------------

def test_server_and_client_over_loopback(rehearsal, tmp_path, monkeypatch):
    """`swarm_server.Server` on a free port and `swarm_client.main` for
    agent 0 on MH_01_easy, in this process: the client registers, its
    state reports and pushes arrive and the push is applied to the
    server's replica (which then holds the client's keyframes), a
    DistributeMap reaches the client, and every message is received as
    the bytes of `Request.encode()` of what was sent.  The settings are
    EuRoC.yaml at 10 fps, so the client's cadence (a report every 5
    frames, a push every 20) pushes once before its last frame."""
    from swarmmap_tpu_torch.cli import swarm_client, swarm_server
    from swarmmap_tpu_torch.ops.vocab import default_vocabulary
    from swarmmap_tpu_torch.server.mediator import AgentMediator
    from swarmmap_tpu_torch.swarm import SwarmAgent
    from test_network import free_port

    root = rehearsal[0]
    text = (REPO / "config/settings/EuRoC.yaml").read_text()
    (tmp_path / "euroc10.yaml").write_text(text.replace("Camera.fps: 20.0", "Camera.fps: 10.0"))
    cfg = tmp_path / "mh1.yaml"
    cfg.write_text(f"%YAML:1.0\nTYPE: 'euroc'\nSETTING: '{tmp_path / 'euroc10.yaml'}'\n"
                   f"IMAGES: ['/{SEQ_NAMES[0]}/mav0/cam0/data']\n")
    monkeypatch.setenv("SWARMMAP_DATA", str(root / "data"))
    distributes = []
    inner = SwarmAgent.receive_distribute
    monkeypatch.setattr(SwarmAgent, "receive_distribute",
                        lambda self, payload: (distributes.append(len(payload)),
                                               inner(self, payload))[1])
    dport = free_port()
    server = swarm_server.Server("127.0.0.1", dport, default_vocabulary(), n_kp=384,
                                 data_port_base=free_port(), device="cpu")
    server.start()
    try:
        with _two_threads(), cells.wire_log() as wire:
            agent = swarm_client.main([
                "-d", str(cfg), "--port", str(dport), "--features", FEATURES,
                "-o", str(tmp_path / "out"), "-l", "warning", "--device", "cpu"])
            server.scheduler.wait_queue_idle()
    finally:
        server.stop()
    assert agent.agent_id == 0 and agent.frames_tracked >= 0.6 * N_FRAMES
    med = AgentMediator.registry[0]
    cst = agent.system.store
    alive = {int(g) for g in cst.kf_gid[: cst.n_kf][cst.kf_alive[: cst.n_kf]]}
    assert len(alive) >= 3
    assert len(alive - set(med.store.kf_by_gid)) <= 2, "the replica misses keyframes"
    assert distributes, "no DistributeMap reached the client"
    sent = {(p, b) for p, b in wire["sent"]}
    assert all(m in sent for m in wire["received"])
    paths = [p for p, _ in wire["received"]]
    assert paths.count("PushMap") == 2 and paths.count("ReportState") == N_FRAMES // 5
    assert paths.count("DistributeMap") >= 1 and paths.count("Register") == 2
    assert (tmp_path / "out" / "KeyFrameTrajectory-client-0.txt").exists()


# -- relocalizer, both packages -----------------------------------------------------

@contextlib.contextmanager
def _jax_pnp_draws_recorded(draws: list):
    """Every JAX RANSAC PnP appends the draws it makes from its key."""
    inner = jax_pnp.ransac_pnp

    def ransac_pnp(pts_w, uv, valid, K, key, *a, **kw):
        count = max(int(np.sum(np.asarray(valid))), jax_pnp.MIN_SET)
        draws.append(np.asarray(jax.random.randint(
            key, (jax_pnp.N_HYPOTHESES, jax_pnp.MIN_SET), 0, count)))
        return inner(pts_w, uv, valid, K, key, *a, **kw)

    jax_pnp.ransac_pnp = ransac_pnp
    try:
        yield
    finally:
        jax_pnp.ransac_pnp = inner


@contextlib.contextmanager
def _port_pnp_draws_replayed(draws: list):
    inner = pnp.draw_indices
    pnp.draw_indices = lambda valid, generator: torch.from_numpy(draws.pop(0).copy()).long()
    try:
        yield
    finally:
        pnp.draw_indices = inner


@pytest.mark.parametrize("bone", [False, True])
def test_relocalizer_matches_jax(rehearsal, monkeypatch, bone):
    """Both packages' `relocalizer` on the port's saved server map of
    agent 0 and MH_01_easy's images, JAX's PnP draws replayed in the port:
    the same frames relocalise (plain, and against a keyframe bone)."""
    import swarmmap_tpu.core.tracking as jtracking
    import swarmmap_tpu_torch.core.tracking as ptracking

    root, _, _, _, out = rehearsal
    monkeypatch.setenv("SWARMMAP_DATA", str(root / "data"))
    argv = ["-d", str(REPO / "config/mh123.yaml"), "--map", str(out["port"] / "map-server-0.bin"),
            "--features", FEATURES, "-l", "warning"] + (["--bone"] if bone else [])
    ok = {"jax": [], "port": []}
    for name, mod in (("jax", jtracking), ("port", ptracking)):
        inner = mod.Tracking._relocalize
        monkeypatch.setattr(mod.Tracking, "_relocalize",
                            lambda self, frame, _i=inner, _ok=ok[name]:
                            (_ok.append(bool(r := _i(self, frame))), r)[1])
    draws = []
    with _two_threads():
        with _jax_pnp_draws_recorded(draws):
            jrate = jreloc.main(argv)
        with _port_pnp_draws_replayed(draws):
            prate = preloc.main(argv + ["--device", "cpu"])
    assert not draws, "the port made fewer PnP RANSACs than JAX"
    assert len(ok["port"]) == N_FRAMES
    assert ok["port"] == ok["jax"] and prate == jrate
    assert prate > 0
