"""Parity of the port's per-agent tracker (swarmmap_tpu_torch.core.tracking)
with the JAX package's on the CPU, on `make_world(seed=4)` at 240x320, 400
features, 4 levels.

Bars: the same tracking state every frame, the same keyframe and map-point
counts, |dTcw| < 1e-3, inliers within max(2, 2%), (keypoint, map point)
association sets agreeing >= 0.99.  Frame ids come from a process-wide
counter in each package, so ids are compared as differences.  Relocalisation
draws its RANSAC hypotheses from another generator on each side, so its
poses are held after the final pose optimisation, not hypothesis by
hypothesis; `ransac_pnp` itself is held on the JAX package's own draws in
tests/test_torch_pnp.py.
"""
import numpy as np
import pytest

from swarmmap_tpu.core import frame as jframe, keyframe_db as jkdb
from swarmmap_tpu.core import map_store as jms, tracking as jtracking
from swarmmap_tpu.ops import vocab as jvocab
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch.cells import frame_disagreements, frame_record
from swarmmap_tpu_torch.core import frame, keyframe_db, map_store, tracking
from swarmmap_tpu_torch.ops import vocab
from swarmmap_tpu_torch.utils import config
from swarmmap_tpu_torch.utils.stats import STATS
from test_torch_mapstore import CLOCK_FIELDS, _assert_same
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
TCW_TOL = 1e-3


@pytest.fixture(scope="module")
def world():
    return jdata.make_world(seed=4, hw=HW)


def _settings(mod, world):
    K = world.K
    return mod.Settings(
        camera=mod.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=mod.OrbConfig(n_features=400, n_levels=4),
    )


def _trackers(world):
    """(JAX tracker, port tracker on the CPU), each on an empty map."""
    va, vb = jvocab.default_vocabulary(), vocab.default_vocabulary()
    a = jtracking.Tracking(_settings(jconfig, world), jms.MapStore(),
                           jkdb.KeyFrameDatabase(va), va)
    b = tracking.Tracking(_settings(config, world), map_store.MapStore(),
                          keyframe_db.KeyFrameDatabase(vb), vb, device="cpu")
    return a, b


def _assert_frame_agrees(a, b, i):
    """The parity bars of `cells.frame_disagreements`, shared with the
    card-vs-CPU checks."""
    assert frame_disagreements(frame_record(a), frame_record(b), TCW_TOL) == [], i


def _grab(trackers, world, i, depth=True):
    img, d = jdata.render_frame(world, i, return_depth=True)
    return [t.grab(img, i / 20.0, depth_image=d if depth else None) for t in trackers]


def test_build_frame_matches_jax(world):
    """Same image -> the same keypoints, descriptors, quadtree-refined
    validity and depths; IC angles within 0.1 degree (atan2 rounds
    differently in each framework; no angle crosses a steering bin here,
    as the identical descriptors show)."""
    img, d = jdata.render_frame(world, 3, return_depth=True)
    sa, sb = _settings(jconfig, world), _settings(config, world)
    fa = jframe.build_frame(img, 0.15, sa.camera, sa.orb, depth_image=d)
    fb = frame.build_frame(img, 0.15, sb.camera, sb.orb, depth_image=d, device="cpu")
    for f in ("xy", "xy_raw", "octave", "response", "desc", "valid", "sigma2",
              "kp_depth", "K"):
        a, b = getattr(fa, f), getattr(fb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert np.abs(fa.angle - fb.angle).max() < 0.1
    assert fb.hw == fa.hw and fb.valid.sum() > 300
    va, vb = jvocab.default_vocabulary(), vocab.default_vocabulary()
    fa.compute_bow(va)
    fb.compute_bow(vb)
    np.testing.assert_array_equal(fb.words, fa.words)
    np.testing.assert_array_equal(fb.nodes, fa.nodes)


@pytest.fixture(scope="module")
def rgbd_run(world):
    """20 RGB-D frames through both trackers; returns the trackers and the
    per-frame failures of the bars (checked by the test)."""
    trackers = _trackers(world)
    STATS.reset()
    for i in range(20):
        _grab(trackers, world, i)
        _assert_frame_agrees(*trackers, i)
    return trackers, dict(STATS.counts)


def test_rgbd_tracker_matches_jax(rgbd_run):
    (a, b), counts = rgbd_run
    assert b.state == tracking.TrackingState.OK
    assert b.store.n_kf == 1 and b.store.n_mp > 300
    # one extraction fetch + per stage one matching and one pose fetch
    assert counts["pose_opt_frame"] == 2 * 19
    assert counts["rpc_fetch"] >= 1 + 4 * 19
    assert len(b.trajectory) == len(a.trajectory) == 20
    sa, sb = a.system_state(), b.system_state()
    assert sa.stable == sb.stable and sa.lost_count == sb.lost_count
    assert np.abs(sa.location - sb.location).max() < TCW_TOL


def test_create_new_keyframe_matches_jax(rgbd_run):
    """The RGB-D path never creates a second keyframe on its own (queue 3
    of ROADMAP.md), so both trackers call it directly from the same state:
    the store rows it writes (the keyframe, its depth-seeded points, their
    observations and connections) are identical, but for the keyframe's
    IC angles, which agree to 0.1 degree as in build_frame's test."""
    (a, b), _ = rgbd_run
    fa, fb = a.last_frame, b.last_frame
    assert np.abs(fa.pose_cw - fb.pose_cw).max() < TCW_TOL
    fb.pose_cw = fa.pose_cw.copy()    # the same state on both sides
    b.mean_speed = a.mean_speed
    n_mp = a.store.n_mp
    a._create_new_keyframe(fa)
    b._create_new_keyframe(fb)
    assert b.store.n_kf == 2 and n_mp + 200 < b.store.n_mp == a.store.n_mp
    assert a.ref_kf == b.ref_kf == 1
    skip = CLOCK_FIELDS | {"lock", "log_fn", "transform_guard", "kf_frame_id"}
    va, vb = vars(a.store), vars(b.store)
    for k in va:
        if k in skip:
            continue
        if k == "kf_kp_angle":  # the IC angles of build_frame's test
            assert np.abs(vb[k] - va[k]).max() < 0.1
        else:
            _assert_same(va[k], vb[k], k)
    ids_a, ids_b = a.store.kf_frame_id[:2], b.store.kf_frame_id[:2]
    assert ids_a[1] - ids_a[0] == ids_b[1] - ids_b[0] == 19
    np.testing.assert_array_equal(fb.mp, fa.mp)


def test_fused_tracker_matches_jax(world):
    """A depth bootstrap, then monocular frames: frame 1 is staged (no
    velocity yet), every later one takes the fused step."""
    trackers = _trackers(world)
    STATS.reset()
    for i in range(12):
        _grab(trackers, world, i, depth=(i == 0))
        _assert_frame_agrees(*trackers, i)
    a, b = trackers
    assert b.fused_frames == a.fused_frames == 10
    assert STATS.counts["fused_step"] == 10 and STATS.counts["pose_opt_frame"] == 2


def test_relocalisation_after_depth_init_matches_jax(world):
    """LOST after frame 0's depth initialisation: frame 1 relocalises
    against keyframe 0 on both sides."""
    trackers = _trackers(world)
    _grab(trackers, world, 0)
    STATS.reset()
    for t in trackers:
        t.state = type(t.state).LOST
    _grab(trackers, world, 1, depth=False)
    _assert_frame_agrees(*trackers, 1)
    assert all(t.state.name == "OK" and t.ref_kf == 0 for t in trackers)
    assert STATS.counts["relocalized"] == 1 and STATS.counts["ransac_pnp"] == 1
    _grab(trackers, world, 2, depth=False)
    _assert_frame_agrees(*trackers, 2)


def test_relocalisation_failure_resets_like_jax(world):
    """LOST before frame 6: relocalisation fails, the tracker resets its
    map (lost right after init), and frame 7 initialises again."""
    trackers = _trackers(world)
    for i in range(6):
        _grab(trackers, world, i)
        _assert_frame_agrees(*trackers, i)
    for t in trackers:
        t.state = type(t.state).LOST
    STATS.reset()
    poses = _grab(trackers, world, 6)
    assert poses == [None, None]
    assert STATS.counts["ransac_pnp"] >= 1 and "relocalized" not in STATS.counts
    for t in trackers:
        assert t.state.name == "NOT_INITIALIZED" and t.ref_kf == -1
        assert t.store.n_kf == 0 and t.store.n_mp == 0 and not t.kfdb.bow
    for i in (7, 8):
        _grab(trackers, world, i)
        _assert_frame_agrees(*trackers, i)
    assert trackers[1].store.n_kf == 1 and trackers[1].state.name == "OK"


def test_unported_paths_raise(world, tmp_path):
    """Dynamic filtering, stereo and the conjugate-gradient BA wait for
    later slices and say so; nothing falls back.  The map checkpoints,
    ported, round-trip an empty map."""
    from swarmmap_tpu_torch.core.system import System
    from swarmmap_tpu_torch.ops import ba

    vb = vocab.default_vocabulary()

    def make(**params):
        return tracking.Tracking(_settings(config, world), map_store.MapStore(),
                                 keyframe_db.KeyFrameDatabase(vb), vb, device="cpu",
                                 params=tracking.TrackingParams(**params))

    for params in (dict(dynamic_filter=True), dict(dynamic_segment="conv")):
        with pytest.raises(NotImplementedError, match="item 19"):
            make(**params)
    img = jdata.render_frame(world, 0)
    s = System(_settings(config, world), vocab=vb, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        s.track_stereo(img, img, 0.0)
    # map checkpoints are ported (item 20): an empty map saves and loads
    s.save_map(tmp_path / "map.bin")
    s2 = System(_settings(config, world), vocab=vb, device="cpu")
    assert not s2.load_map(tmp_path / "missing.bin")
    assert s2.load_map(tmp_path / "map.bin") and s2.n_keyframes() == s2.n_map_points() == 0
    prob = ba.build_padded_problem(np.eye(4)[None], np.eye(3)[None], [True], np.ones((1, 3)),
                                   [0], [0], [[0.0, 0.0]], [1.0], device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        ba.bundle_adjust(prob, mode="cg")
    # monocular initialisation is ported: a first monocular frame waits for
    # a second one
    assert s.track_monocular(img, 0.0) is None
    assert s.state.name == "NOT_INITIALIZED" and s.tracking.init_frame is not None


@pytest.mark.parametrize("frames,expect", [
    ((0, 1, 2, 3, 25, 26), "fallback"),
    ((0, 1, 2, 3, 40, 41), "recently_lost"),
], ids=["fused_fallback", "recently_lost"])
def test_jumps_match_jax(world, frames, expect):
    """A depth bootstrap, monocular frames, then a jump along the
    trajectory.  A short jump drops the fused step below its inlier bar and
    onto the staged path with the features fetched late (`commit_fused`'s
    fallback); a long one fails every stage, relocalisation included, and
    holds the motion model (RECENTLY_LOST, `_grace_reacquire`)."""
    trackers = _trackers(world)
    for n, i in enumerate(frames):
        STATS.reset()
        _grab(trackers, world, i, depth=(n == 0))
        _assert_frame_agrees(*trackers, i)
        assert trackers[0].grace == trackers[1].grace, i
    a, b = trackers
    if expect == "fallback":
        assert b.grace == 0 and b.fused_frames == 2 and b.state.name == "OK"
        assert STATS.counts["fused_step"] == 1 and STATS.counts["pose_opt_frame"] == 2
    else:
        assert b.grace == 2 and STATS.counts["ransac_pnp"] >= 1
        assert "relocalized" not in STATS.counts
