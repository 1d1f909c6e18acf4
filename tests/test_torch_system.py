"""The monocular client as a whole: the port's System(device="cpu") against
the JAX package's System on the CPU, on test_slam_e2e.py's sequence
(synthesize_sequence(seed=0, motion="arc"), 240x320, 400 features,
4 levels, 350 landmarks, 40 frames).

Two-view initialisation draws its RANSAC hypotheses from each package's
own generator, so the test records the draws of every
`twoview.reconstruct` call of the JAX tracker (wrapping the JAX function)
and replays them in the port (`cells.replayed_draws`).  Bars: the same
initialisation frame and initial point count; for the first 10 frames the
same states, keyframe and point counts and |dTcw| < 1e-3; over the 40
frames keyframes within +-1, map points within 5%, and both ATEs under 5%
of the trajectory's span and within 1 point of each other (LM accept /
reject steps flip on float32 ulps, so later frames may part by a point or
an association).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarmmap_tpu.core.system import System as JSystem
from swarmmap_tpu.ops import twoview as jtwoview
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch.cells import (ate_share, frame_record, replayed_draws, settings_for,
                                      state_disagreements)
from swarmmap_tpu_torch.core import tracking
from swarmmap_tpu_torch.core.system import System
from swarmmap_tpu_torch.utils import datasets
from swarmmap_tpu_torch.utils.stats import STATS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_FRAMES = 40
TCW_TOL = 1e-3


def _jax_settings(world):
    K = world.K
    return jconfig.Settings(
        camera=jconfig.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                    cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=jconfig.OrbConfig(n_features=400, n_levels=4),
    )


@pytest.fixture(scope="module")
def seq():
    return jdata.synthesize_sequence(n_frames=N_FRAMES, hw=HW, seed=0, n_points=350,
                                     motion="arc")


@pytest.fixture(scope="module")
def runs(seq):
    """Both Systems frame by frame on the same images; per frame the two
    `frame_record`s, and per System the {frame: Tcw} of tracked frames."""
    draws, orig = [], jtwoview.reconstruct

    def record(uv1, uv2, valid, K, key, *args, **kw):
        count = jnp.asarray(max(int(np.sum(valid)), 8), jnp.int32)
        draws.append(np.array(jax.random.randint(key, (jtwoview.N_HYPOTHESES, 8), 0, count)))
        return orig(uv1, uv2, valid, K, key, *args, **kw)

    a = JSystem(_jax_settings(seq.world))
    b = System(settings_for(seq.world, 400, 4), device="cpu")
    recs, poses = [], ({}, {})
    STATS.reset()
    jtwoview.reconstruct = record
    try:
        with replayed_draws(draws):
            for i in range(N_FRAMES):
                img, ts = seq.read(i), seq.timestamps[i]
                for s, p in zip((a, b), poses):
                    T = s.track_monocular(img, ts)
                    if T is not None:
                        p[i] = T
                recs.append((frame_record(a.tracking), frame_record(b.tracking)))
    finally:
        jtwoview.reconstruct = orig
    assert not draws   # every recorded draw was replayed
    return a, b, recs, poses, dict(STATS.counts), dict(STATS.times)


def test_initialises_like_jax(runs):
    _, b, recs, _, counts, times = runs
    init = [next(i for i, r in enumerate(side) if r.state == "OK")
            for side in zip(*recs)]
    assert init[0] == init[1] <= 2
    ra, rb = recs[init[0]]
    assert ra.n_kf == rb.n_kf == 2 and ra.n_mp == rb.n_mp > 100
    assert len(times["twoview"]) >= 1


def test_first_frames_match_jax(runs):
    recs = runs[2][:10]
    assert state_disagreements(*zip(*recs), TCW_TOL) == []
    # frames since the last keyframe, once there is one (frame ids come from
    # a process-wide counter in each package)
    assert ([r.since_kf for r, _ in recs if r.state == "OK"]
            == [r.since_kf for _, r in recs if r.state == "OK"])


def test_sequence_maps_like_jax(runs, seq):
    a, b, recs, poses, counts, times = runs
    assert b.state == tracking.TrackingState.OK
    assert len(poses[1]) >= 36
    assert b.n_keyframes() >= 3 and b.n_map_points() > 100
    assert abs(b.n_keyframes() - a.n_keyframes()) <= 1
    assert abs(b.n_map_points() - a.n_map_points()) <= 0.05 * a.n_map_points()
    # local mapping ran for every inserted keyframe, with its local BA
    assert len(times["lm_process_new"]) >= 3 and len(times["lm_local_ba"]) >= 3
    ates = [ate_share(p, seq.world) for p in poses]
    share = [rmse / span for rmse, span in ates]
    assert max(share) < 0.05 and abs(share[0] - share[1]) < 0.01, share


def test_trajectory_outputs(runs, tmp_path):
    """The TUM writers and the STS state, as the JAX package's tests read
    them."""
    a, b, *_ = runs
    for name in ("save_keyframe_trajectory_tum", "save_frame_trajectory_tum"):
        pa, pb = tmp_path / f"a_{name}.txt", tmp_path / f"b_{name}.txt"
        getattr(a, name)(pa)
        getattr(b, name)(pb)
        la, lb = pa.read_text().splitlines(), pb.read_text().splitlines()
        assert len(la) == len(lb) and all(len(x.split()) == 8 for x in lb)
    assert len(lb) == len(b.tracking.trajectory)
    sa, sb = a.get_system_state(), b.get_system_state()
    assert sa.stable == sb.stable and sb.stable
    assert sb.location.shape == (3,)


def test_async_mapping_worker():
    """The mapping worker thread: keyframes queue while tracking goes on,
    wait_idle drains the queue, stop_async joins the thread."""
    s_ = datasets.synthesize_sequence(n_frames=16, hw=HW, seed=0, n_points=350, motion="arc")
    s = System(settings_for(s_.world, 400, 4), device="cpu")
    mapper = s.local_mapping
    mapper.start_async()
    assert mapper._thread.is_alive()
    STATS.reset()
    for i in range(len(s_)):
        s.track_monocular(s_.read(i), s_.timestamps[i])
    mapper.wait_idle(timeout=60.0)
    assert not mapper.busy and not mapper.queue
    assert s.state.name == "OK" and s.n_keyframes() >= 3
    assert len(STATS.times["lm_process_new"]) >= 1
    s.shutdown()
    assert mapper._thread is not None and not mapper._thread.is_alive()
    assert not mapper._async
