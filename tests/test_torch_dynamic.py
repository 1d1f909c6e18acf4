"""Dynamic-object filtering in the port (swarmmap_tpu_torch.core.dynamic and
its wiring in the tracker) against the JAX package's on the CPU.

- The eight cases of tests/test_dynamic.py on the port (the Swarm cases
  with device="cpu"); the LK flow and the mask propagation, host numpy
  copied line for line, bit-equal to the JAX package's on the same inputs.
- The shipped segmenter, carried across by `convert.segmenter_from_numpy`
  as torch convolutions, against the JAX package's numpy im2col: logits
  within 1e-5 (float32 sums in another order), masks equal wherever
  |logit| > 1e-4; then test_dynamic_e2e.py's centre-accuracy bars on the
  port.
- A tracker with dynamic_filter=True beside the JAX package's on RGB-D
  frames of a world with a moving flock (every frame staged, each pose
  optimisation casting residual votes), associations and votes keyed by
  position (`cells.by_position`): the same associations and votes frame
  by frame until an LM inlier gate flips on a float32 ulp, then apart on
  at most the tracker's inlier bar, max(2, 2%).
"""
import numpy as np
import pytest
import torch

from swarmmap_tpu.core import dynamic as jdynamic, keyframe_db as jkdb
from swarmmap_tpu.core import map_store as jms, tracking as jtracking
from swarmmap_tpu.ops import vocab as jvocab
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch import convert
from swarmmap_tpu_torch.cells import by_position, frame_record, settings_for, state_disagreements
from swarmmap_tpu_torch.core import keyframe_db, map_store, tracking
from swarmmap_tpu_torch.core.dynamic import (SHIPPED_SEGMENTER, DynamicExtractor,
                                             DynamicRunner, lk_flow, load_segmenter,
                                             propagate_mask)
from swarmmap_tpu_torch.core.map_store import MapStore
from swarmmap_tpu_torch.ops import vocab
from swarmmap_tpu_torch.swarm import Swarm, SwarmConfig
from swarmmap_tpu_torch.utils import datasets
from swarmmap_tpu_torch.utils.config import CameraConfig, OrbConfig, Settings
from swarmmap_tpu_torch.utils.trajectory import ate_rmse
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)


def make_store_with_kf(rng, n_kp=64):
    st = MapStore(map_id=0, n_kp=n_kp, kf_capacity=4, mp_capacity=128)
    k = st.add_keyframe(
        pose_cw=np.eye(4, dtype=np.float32),
        K=np.array([[100, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32),
        kp_uv=rng.uniform(0, 64, (n_kp, 2)).astype(np.float32),
        kp_octave=np.zeros(n_kp, np.int32),
        kp_angle=np.zeros(n_kp, np.float32),
        kp_response=np.ones(n_kp, np.float32),
        kp_valid=np.ones(n_kp, bool),
        desc=rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32),
        hw=(64, 64),
    )
    for i in range(32):
        m = st.add_map_point(np.array([0, 0, 2.0]), st.kf_desc[k, i], ref_kf=k)
        st.add_observation(m, k, i)
    return st, k


def _settings(world, n_features=400, hw=HW):
    return Settings(
        camera=CameraConfig(fx=float(world.K[0, 0]), fy=float(world.K[1, 1]),
                            cx=float(world.K[0, 2]), cy=float(world.K[1, 2]),
                            fps=20.0, width=hw[1], height=hw[0]),
        orb=OrbConfig(n_features=n_features, n_levels=4),
    )


# ---------------------------------------------------------------- test_dynamic.py's cases

def test_mask_voting_flags_dynamic_points(rng):
    st, k = make_store_with_kf(rng)
    # dynamic object occupies the left half of the image
    mask = np.zeros((64, 64), bool)
    mask[:, :32] = True
    runner = DynamicRunner(st, segment_fn=lambda img: mask)
    img = np.zeros((64, 64), np.uint8)
    for _ in range(4):
        runner.enqueue(k, img, score=1.0)
    runner.process(max_items=4)
    slots = np.arange(st.n_mp)
    dyn = runner.votes.is_dynamic(slots)
    uv = st.kf_kp_uv[k][: st.n_mp]
    left = uv[:, 0] < 32
    # points on the object flagged, others not
    assert dyn[left].mean() > 0.9
    assert dyn[~left].sum() == 0


def test_residual_voting():
    st = MapStore(map_id=0, n_kp=8, kf_capacity=2, mp_capacity=16)
    runner = DynamicRunner(st)
    slots = np.arange(8)
    for _ in range(4):
        chi2 = np.array([100.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])
        runner.vote_from_residuals(slots, chi2)
    keep = runner.filter_static(slots)
    assert not keep[0]
    assert keep[1:].all()


def test_dynamic_filter_wired_into_tracking():
    """dynamic_filter=True in a port Swarm: pose-opt outliers accumulate
    dynamic votes and voted points disappear from the tracking candidate
    sets."""
    seq = datasets.synthesize_sequence(n_frames=16, hw=HW, seed=3, agent=0, n_points=350)
    swarm = Swarm(1, _settings(seq.world), config=SwarmConfig(push_every=8),
                  tracking_params=tracking.TrackingParams(dynamic_filter=True),
                  run_server_gba=False, device="cpu")
    for i in range(16):
        swarm.step([seq.read(i)], float(seq.timestamps[i]))
    swarm.finish()
    tr = swarm.agents[0].system.tracking
    assert tr.dynamic is not None
    # votes accumulated (static-world sequence: static votes dominate)
    assert tr.dynamic.votes.stat.sum() > 0
    assert swarm.agents[0].frames_tracked > 12
    # a hand-voted dynamic point is excluded by filter_static, and from the
    # fused local map
    st = swarm.agents[0].system.store
    m = int(np.where(st.mp_alive[: st.n_mp])[0][0])
    for _ in range(5):
        tr.dynamic.votes.vote(np.array([m]), np.array([True]))
    assert not tr.dynamic.filter_static(np.array([m]))[0]
    assert m not in set(tr._collect_local_slots().tolist())


def test_lk_flow_recovers_translation():
    """Pyramidal LK on a textured frame shifted by a known offset; the
    port's flow and convergence bit-equal to the JAX package's."""
    w = datasets.make_world(n_points=150, n_frames=2, hw=(120, 160), seed=4)
    img = datasets.render_frame(w, 0).astype(np.float32)
    dx, dy = 3, 2
    nxt = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    pts = np.stack(np.meshgrid(np.arange(30, 130, 12),
                               np.arange(30, 90, 12)), -1).reshape(-1, 2)
    flow, ok = lk_flow(img, nxt, pts.astype(np.float32))
    assert ok.sum() >= 10
    med = np.median(flow[ok], axis=0)
    np.testing.assert_allclose(med, [dx, dy], atol=0.5)
    jflow, jok = jdynamic.lk_flow(img, nxt, pts.astype(np.float32))
    np.testing.assert_array_equal(flow, jflow)
    np.testing.assert_array_equal(ok, jok)


def test_mask_propagation_follows_object():
    """A mask over a moving textured block follows it to the next frame
    (reference: DynamicExtractor.h:40-53), bit-equal to the JAX
    package's propagation."""
    rng = np.random.RandomState(0)
    h, w = 120, 160
    base = rng.randint(20, 60, (h, w)).astype(np.float32)
    block = rng.randint(120, 255, (40, 40)).astype(np.float32)

    def frame(ox):
        f = base.copy()
        f[40:80, ox:ox + 40] = block
        return f.astype(np.uint8)

    prev, nxt = frame(30), frame(36)
    mask = np.zeros((h, w), bool)
    mask[40:80, 30:70] = True
    out = propagate_mask(prev, nxt, mask)
    truth = np.zeros((h, w), bool)
    truth[40:80, 36:76] = True
    iou = (out & truth).sum() / max((out | truth).sum(), 1)
    assert iou > 0.55, f"IoU {iou:.2f}"
    np.testing.assert_array_equal(out, jdynamic.propagate_mask(prev, nxt, mask))


def test_dynamic_extractor_cadence():
    """Segment every N frames, flow-propagate in between."""
    calls = []
    rng = np.random.RandomState(1)
    base = rng.randint(0, 255, (64, 64)).astype(np.uint8)

    def seg(img):
        calls.append(1)
        m = np.zeros(img.shape, bool)
        m[20:40, 20:40] = True
        return m

    ex = DynamicExtractor(seg, segment_every=3)
    for _ in range(6):
        m = ex.mask_for(base)
        assert m.dtype == bool and m.shape == base.shape
    assert len(calls) == 2  # frames 0 and 3


def test_dynamic_filter_improves_tracking_on_moving_object(rng):
    """A textured block sweeping across the static world: residual voting
    flags its landmarks dynamic, and filtered tracking is at least as
    accurate as unfiltered, in a port Swarm."""
    n_frames = 24
    seq = datasets.synthesize_sequence(n_frames=n_frames, hw=HW, seed=6, agent=0, n_points=320)
    w = seq.world
    block = rng.randint(100, 255, (48, 48)).astype(np.uint8)
    frames = []
    for i in range(n_frames):
        f = seq.read(i).copy()
        # object crosses the image against the camera's apparent motion
        ox, oy = 20 + 9 * i, 90
        if ox + 48 < HW[1]:
            f[oy:oy + 48, ox:ox + 48] = np.maximum(f[oy:oy + 48, ox:ox + 48], block)
        frames.append(f)

    def run(dyn: bool):
        swarm = Swarm(1, _settings(w), config=SwarmConfig(push_every=50),
                      tracking_params=tracking.TrackingParams(dynamic_filter=dyn),
                      run_server_gba=False, device="cpu")
        for i in range(n_frames):
            swarm.step([frames[i]], float(seq.timestamps[i]))
        swarm.finish()
        tr = swarm.agents[0].system.tracking
        est, gt = [], []
        for ts, Twc in tr.trajectory:
            fi = int(round(ts * 20))
            if fi < n_frames:
                est.append(Twc[:3, 3])
                gt.append(w.poses_wc[fi][:3, 3])
        return swarm, ate_rmse(np.stack(est), np.stack(gt)), len(est)

    swarm_f, ate_f, n_f = run(True)
    _, ate_u, n_u = run(False)
    tr = swarm_f.agents[0].system.tracking
    assert tr.dynamic.votes.dyn.sum() > 0, "no dynamic votes accumulated"
    assert n_f >= 0.8 * n_frames
    assert ate_f <= ate_u * 1.1 + 1e-3, (ate_f, ate_u)


def test_torch_segmenter_model_through_hook():
    """A torch conv net as segment_fn (a box filter segmenting a moving
    bright square); the DynamicExtractor cadence and flow propagation
    consume its masks."""
    net = torch.nn.Conv2d(1, 1, 5, padding=2, bias=False)
    with torch.no_grad():
        net.weight[:] = 1.0 / 25.0  # 5x5 box filter: local brightness

    def segment(img):
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(img, np.float32))[None, None]
            heat = net(x)[0, 0].numpy()
        return heat > 128.0

    ex = DynamicExtractor(segment, segment_every=2)
    h, w = 120, 160
    for t in range(4):
        img = np.full((h, w), 40, np.float32)
        x0 = 40 + 8 * t
        img[30:60, x0:x0 + 30] = 250.0
        mask = ex.mask_for(img)
        assert mask[45, x0 + 15], f"frame {t}: object center not masked"
        assert not mask[100, 20], f"frame {t}: background masked"


# ---------------------------------------------------------------- the segmenter

def _jax_logits(seg, image):
    """The JAX package's ConvSegmenter forward without its threshold."""
    x = (np.asarray(image, np.float32) / 255.0)[None]
    for li, (w, b) in enumerate(seg.layers):
        x = jdynamic._conv2d(x, w, b)
        if li + 1 < len(seg.layers):
            np.maximum(x, 0.0, out=x)
    return x[0]


@pytest.fixture(scope="module")
def flock_world():
    return datasets.make_world(n_points=350, n_frames=6, hw=HW, seed=11, motion="arc",
                               n_dynamic=60)


def test_segmenter_matches_jax(flock_world):
    """The npz through convert.segmenter_from_numpy against the JAX
    package's ConvSegmenter on flock frames and a float image."""
    jseg = jdynamic.load_segmenter()
    seg = convert.segmenter_from_numpy(dict(np.load(SHIPPED_SEGMENTER)), "cpu")
    assert [tuple(c.weight.shape) for c in seg.convs] == [w.shape for w, _ in jseg.layers]
    assert torch.equal(seg.convs[0].weight, load_segmenter("cpu").convs[0].weight)
    images = [datasets.render_frame(flock_world, i) for i in (0, 3, 5)]
    images.append(images[0].astype(np.float64) * 0.9)
    for img in images:
        ja, lb = _jax_logits(jseg, img), seg.logits(img).numpy()
        assert np.abs(lb - ja).max() < 1e-5
        mask = seg(img)
        assert mask.dtype == bool and mask.shape == HW
        sure = np.abs(ja) > 1e-4
        np.testing.assert_array_equal(mask[sure], jseg(img)[sure])


def test_segmenter_center_accuracy(flock_world):
    """test_dynamic_e2e.py::test_segmenter_center_accuracy on the port: >=60%
    recall on flock patch centres, <=5% false positives on static landmark
    centres."""
    seg = load_segmenter("cpu")
    w = flock_world
    hits_d = tot_d = hits_s = tot_s = 0
    for i in range(6):
        img, mask_gt = datasets.render_frame(w, i, return_dyn_mask=True)
        m = seg(img)
        T = w.poses_wc[i]
        R_cw = T[:3, :3].T
        t_cw = -R_cw @ T[:3, 3]
        for pts, is_dyn in ((w.dyn_at(i), True), (w.points, False)):
            pc = pts @ R_cw.T + t_cw
            z = pc[:, 2]
            uv = (pc[:, :2] / np.maximum(z[:, None], 1e-6)) @ np.diag(
                [w.K[0, 0], w.K[1, 1]]) + w.K[:2, 2]
            for j in range(len(pts)):
                u, v = int(round(uv[j, 0])), int(round(uv[j, 1]))
                if z[j] <= 0.3 or not (8 <= u < HW[1] - 8 and 8 <= v < HW[0] - 8):
                    continue
                if not is_dyn and mask_gt[v, u]:
                    continue  # static landmark occluded by the flock
                hit = bool(m[v - 1: v + 2, u - 1: u + 2].any())
                if is_dyn:
                    tot_d += 1
                    hits_d += hit
                else:
                    tot_s += 1
                    hits_s += hit
    assert hits_d / max(tot_d, 1) >= 0.6, (hits_d, tot_d)
    assert hits_s / max(tot_s, 1) <= 0.05, (hits_s, tot_s)


# ---------------------------------------------------------------- residual votes side by side

def _tallies(tracker) -> dict:
    """{map point position: (dynamic votes, static votes)} of the points
    voted on."""
    st, v = tracker.store, tracker.dynamic.votes
    n = st.n_mp
    return {tuple(p): (int(d), int(s)) for p, d, s in
            zip(st.mp_pos[:n].tolist(), v.dyn[:n], v.stat[:n]) if d + s}


def test_residual_votes_match_jax():
    """JAX's and the port's trackers with dynamic_filter=True on 16 RGB-D
    frames of a flock world (make_world(seed=5, n_dynamic=60), 350
    landmarks), with associations and votes keyed by position
    (`cells.by_position`).  Every frame: the same state, keyframe and
    point counts, |dTcw| < 1e-3 and inliers within max(2, 2%).  While the
    two trackers' inlier counts have agreed on every frame: the same
    associations and the same vote tallies on every point.  After an LM
    inlier gate has flipped on a float32 ulp (60-150 associations here,
    so one flip is 1-2% of them): associations and tallies apart on at
    most max(2, 2%) of them."""
    w = jdata.make_world(n_points=350, n_frames=16, hw=HW, seed=5, n_dynamic=60)
    va, vb = jvocab.default_vocabulary(), vocab.default_vocabulary()
    K = w.K
    js = jconfig.Settings(
        camera=jconfig.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                    cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=jconfig.OrbConfig(n_features=400, n_levels=4))
    a = jtracking.Tracking(js, jms.MapStore(), jkdb.KeyFrameDatabase(va), va,
                           params=jtracking.TrackingParams(dynamic_filter=True))
    b = tracking.Tracking(settings_for(w, 400, 4), map_store.MapStore(),
                          keyframe_db.KeyFrameDatabase(vb), vb, device="cpu",
                          params=tracking.TrackingParams(dynamic_filter=True))
    inliers_agreed, exact_frames = True, 0
    for i in range(16):
        img, d = jdata.render_frame(w, i, return_depth=True)
        for t in (a, b):
            t.grab(img, i / 20.0, depth_image=d)
        ra, rb = (by_position(frame_record(t), t) for t in (a, b))
        assert state_disagreements([ra], [rb]) == [], i
        slack = max(2, 0.02 * ra.inliers)
        assert abs(ra.inliers - rb.inliers) <= slack, (i, ra.inliers, rb.inliers)
        inliers_agreed &= ra.inliers == rb.inliers
        ta, tb = _tallies(a), _tallies(b)
        apart = {p for p in ta.keys() | tb.keys() if ta.get(p) != tb.get(p)}
        if inliers_agreed:
            assert ra.pairs == rb.pairs and not apart, (i, sorted(apart)[:4])
            exact_frames += 1
        else:
            assert len(ra.pairs ^ rb.pairs) <= slack, (i, len(ra.pairs ^ rb.pairs))
            assert len(apart) <= max(2, 0.02 * len(ta)), (i, len(apart), len(ta))
    assert exact_frames >= 4
    assert b.dynamic.votes.dyn.sum() > 0 and b.dynamic.votes.stat.sum() > 0
