"""Parity of the port's tracking step (swarmmap_tpu_torch.pipeline) with the
JAX package on the CPU at 240x320, 256 features, 3 levels, 512 map points,
plus the guards that keep the port free of JAX.

The step is compared on JAX-made inputs: |dTcw| < 5e-3, matched
(keypoint xy, map point) pairs overlap >= 95% (pairs, not positions: the
pyramid's +-1 pixels can shift keypoint order), n_inliers within
max(3, 5%).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu import pipeline as jpipe
from swarmmap_tpu.utils import datasets as jdata
from swarmmap_tpu_torch import convert, pipeline
from swarmmap_tpu_torch.core import frame, keyframe_db, map_store, tracking
from swarmmap_tpu_torch.ops import vocab
from swarmmap_tpu_torch.utils import config, datasets, device
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
HW = (240, 320)
KW = dict(n_features=256, n_levels=3, hw=HW)
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def jax_inputs():
    return [jpipe.realistic_track_inputs(hw=HW, n_map_points=512, n_features=256,
                                         n_levels=3, seed=s) for s in SEEDS]


def _pairs(out):
    """{(x, y, map point)} of the keypoints that tracked an inlier."""
    xy, mm = np.asarray(out.features.xy), np.asarray(out.match_mp)
    return {(float(x), float(y), int(m)) for (x, y), m in zip(xy, mm) if m >= 0}


def _assert_step_agrees(a, b):
    """a: the JAX package's TrackOutputs (one agent), b: the port's, as numpy."""
    assert np.abs(np.asarray(a.Tcw) - b.Tcw).max() < 5e-3
    pa, pb = _pairs(a), _pairs(b)
    assert len(pa & pb) >= 0.95 * max(len(pa), len(pb)), (len(pa), len(pb), len(pa & pb))
    na, nb = int(a.n_inliers), int(b.n_inliers)
    assert abs(na - nb) <= max(3, 0.05 * na), (na, nb)
    assert na >= 20


@pytest.mark.parametrize("seed", SEEDS)
def test_tracking_step_matches_jax(jax_inputs, seed):
    inp = jax_inputs[seed]
    a = jpipe.tracking_step(inp, **KW)
    b = convert.track_outputs_to_numpy(
        pipeline.tracking_step(convert.track_inputs_from_numpy(inp, device="cpu"), **KW))
    assert b.Tcw.shape == (4, 4) and b.match_mp.shape == (256,)
    assert b.features.desc.dtype == np.uint32
    _assert_step_agrees(a, b)


def _agent(out, i):
    """Agent i of a batched TrackOutputs (JAX arrays or numpy), as numpy."""
    f = out.features
    return jpipe.TrackOutputs(*(np.asarray(x)[i] for x in out[:3]),
                              type(f)(*(np.asarray(x)[i] for x in f)),
                              np.asarray(out.xy_ud)[i])


def test_batched_tracking_step_matches_jax(jax_inputs):
    batch = jpipe.TrackInputs(*(jnp.stack(xs) for xs in zip(*jax_inputs)))
    a = jpipe.batched_tracking_step(batch, **KW)
    b = convert.track_outputs_to_numpy(
        pipeline.batched_tracking_step(convert.track_inputs_from_numpy(batch, device="cpu"), **KW))
    assert b.Tcw.shape == (3, 4, 4) and b.n_inliers.shape == (3,)
    for i in range(3):
        _assert_step_agrees(_agent(a, i), _agent(b, i))


def test_distorted_step_matches_jax():
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    inp = jpipe.realistic_track_inputs(hw=HW, n_map_points=512, n_features=256,
                                       n_levels=3, seed=1, dist=dist)
    a = jpipe.tracking_step(inp, **KW)
    b = convert.track_outputs_to_numpy(
        pipeline.tracking_step(convert.track_inputs_from_numpy(inp, device="cpu"), **KW))
    np.testing.assert_allclose(b.xy_ud, np.asarray(a.xy_ud), atol=1e-2)
    _assert_step_agrees(a, b)


def test_multi_agent_step_matches_jax(jax_inputs):
    batch = jpipe.TrackInputs(*(jnp.stack(xs) for xs in zip(*jax_inputs)))
    _, ov_a, tot_a = jpipe.make_multi_agent_step(**KW)(batch)
    _, ov_b, tot_b = pipeline.make_multi_agent_step(**KW)(convert.track_inputs_from_numpy(batch, device="cpu"))
    ov_a = np.asarray(ov_a)
    assert ov_b.shape == (3, 3)
    assert np.abs(ov_b.numpy() - ov_a).max() <= 2, (ov_a, ov_b)
    assert abs(int(tot_b) - int(tot_a)) <= max(3, 0.05 * int(tot_a))
    with pytest.raises(NotImplementedError):
        pipeline.make_multi_agent_step(mesh=object())


def test_realistic_inputs_match_jax(jax_inputs):
    """The port's own realistic_track_inputs (its extractor, its world) gives the
    JAX package's state."""
    for seed in SEEDS:
        a = jax_inputs[seed]
        b = pipeline.realistic_track_inputs(hw=HW, n_map_points=512, n_features=256,
                                            n_levels=3, seed=seed, device="cpu")
        for f in ("image", "Tcw_guess", "K", "dist"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
        rows_a = {r.tobytes() for r in np.asarray(a.mp_pos)[np.asarray(a.mp_valid)]}
        rows_b = {r.tobytes() for r in b.mp_pos.numpy()[b.mp_valid.numpy()]}
        assert len(rows_a & rows_b) >= 0.98 * max(len(rows_a), len(rows_b))
    e_a = jpipe.example_track_inputs(hw=HW, n_map_points=64, seed=4)
    e_b = pipeline.example_track_inputs(hw=HW, n_map_points=64, seed=4, device="cpu")
    for f in e_a._fields:
        np.testing.assert_array_equal(convert.to_numpy(getattr(e_b, f), uint32=(f == "mp_desc")),
                                      np.asarray(getattr(e_a, f)))


@pytest.mark.parametrize("motion,dist", [
    ("arc", None), ("circuit", None),
    ("arc", np.array([-0.28, 0.07, 2e-4, 2e-5, 0.0], np.float32)),
])
def test_synthetic_world_identical(motion, dist):
    kw = dict(n_points=300, n_frames=12, hw=HW, seed=7, agent=1, motion=motion, dist=dist)
    wa, wb = jdata.make_world(**kw), datasets.make_world(**kw)
    for f in ("points", "textures", "poses_wc", "K", "dist"):
        np.testing.assert_array_equal(getattr(wb, f), getattr(wa, f))
    for i in (0, 5, 11):
        ia, da = jdata.render_frame(wa, i, return_depth=True)
        ib, db = datasets.render_frame(wb, i, return_depth=True)
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(db, da)
    with pytest.raises(NotImplementedError):
        datasets.make_world(n_dynamic=3)


@pytest.mark.parametrize("entry", [
    lambda: pipeline.realistic_track_inputs(hw=HW, n_map_points=64),
    lambda: pipeline.example_track_inputs(hw=HW, n_map_points=64),
    lambda: convert.to_tensor(np.zeros(3, np.float32)),
    lambda: convert.track_inputs_from_numpy(pipeline.example_track_inputs(
        hw=HW, n_map_points=64, device="cpu")),
    lambda: tracking.Tracking(config.Settings.default(), map_store.MapStore(),
                              keyframe_db.KeyFrameDatabase(vocab.default_vocabulary()),
                              vocab.default_vocabulary()),
    lambda: frame.build_frame(np.zeros(HW, np.uint8), 0.0, config.Settings.default().camera,
                              config.OrbConfig(n_features=256, n_levels=3)),
], ids=["realistic_track_inputs", "example_track_inputs", "to_tensor",
        "track_inputs_from_numpy", "Tracking", "build_frame"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device named, an entry point asks for the card and raises
    where there is none: no silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.default_device() == torch.device("cuda", 0)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_never_reaches_jax():
    """Guard: with jax, jaxlib, the JAX package, PyYAML and msgpack made
    unimportable, the port imports (its sync layer, SwarmAgent, bench and
    every server module too), runs a small tracking step on its plain
    path, tracks three RGB-D frames with its tracker, round-trips its map
    through the codec and serves it as one push to a scheduler."""
    code = (
        "import sys\n"
        "blocked = ('jax', 'jaxlib', 'swarmmap_tpu', 'yaml', 'msgpack')\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in blocked]:\n"
        "    del sys.modules[m]\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "import swarmmap_tpu_torch\n"
        "from swarmmap_tpu_torch import bench, convert, pipeline, swarm\n"
        "from swarmmap_tpu_torch.sync import boost_bin, boost_text, codec, msgpack_wire, oplog\n"
        "from swarmmap_tpu_torch.core import keyframe_db, map_store, tracking\n"
        "from swarmmap_tpu_torch.ops import vocab\n"
        "from swarmmap_tpu_torch.utils import config, datasets, device, stats\n"
        "inp = pipeline.realistic_track_inputs(hw=(240, 320), n_map_points=512,"
        " n_features=256, n_levels=3, device='cpu')\n"
        "out = pipeline.tracking_step(inp, n_features=256, n_levels=3, hw=(240, 320))\n"
        "host = device.fetch(out)\n"
        "assert stats.STATS.counts['rpc_fetch'] == 1\n"
        "w = datasets.make_world(seed=4, hw=(240, 320))\n"
        "K = w.K\n"
        "s = config.Settings(camera=config.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]),"
        " cx=float(K[0, 2]), cy=float(K[1, 2]), fps=20.0),"
        " orb=config.OrbConfig(n_features=400, n_levels=4))\n"
        "voc = vocab.default_vocabulary()\n"
        "t = tracking.Tracking(s, map_store.MapStore(), keyframe_db.KeyFrameDatabase(voc), voc,"
        " device='cpu')\n"
        "for i in range(3):\n"
        "    img, d = datasets.render_frame(w, i, return_depth=True)\n"
        "    assert t.grab(img, i / 20.0, depth_image=d) is not None\n"
        "assert t.state.name == 'OK' and t.matches_inliers >= 100, t.matches_inliers\n"
        "sl = codec.decode_slice(codec.encode_slice(oplog.full_archive(t.store)))\n"
        "assert len(sl.kfs) == t.store.n_kf and len(sl.mps) == t.store.n_mp > 0\n"
        "from swarmmap_tpu_torch.ops import ba, matching, pose_graph, sim3, sim3_opt\n"
        "from swarmmap_tpu_torch.server import (landmark_scoring, loop_closing, map_enhancer,"
        " map_manager, mediator, scheduler, sim3_match)\n"
        "mm = map_manager.MapManager(device='cpu')\n"
        "sch = scheduler.MediatorScheduler(mm, device='cpu')\n"
        "sch.register_mediator(mediator.AgentMediator(0, voc, mm, n_kp=t.store.n_kp, n_levels=4,"
        " run_global_ba=True, device='cpu'))\n"
        "sch.enqueue_request(0, codec.encode_slice(oplog.full_archive(t.store)))\n"
        "assert sch.process_pending() == 1 and sch.processed == 1\n"
        "assert mm.stores[0].n_kf == t.store.n_kf and mm.stores[0].n_mp == t.store.n_mp\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in blocked"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('inliers', int(host.n_inliers))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 20


def test_chip_smoke_fails_without_gpu(tmp_path):
    """Guard: chip_smoke.py needs a card.  Without one it exits non-zero
    and prints no result, from the repo and from a directory holding
    nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd, env in ((REPO / "chip_smoke.py", REPO, _env()),
                             (alone, tmp_path, {**_env(), "PYTHONPATH": ""})):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        lines = r.stdout.strip().splitlines()
        assert not lines or '"ok": true' not in lines[-1]
