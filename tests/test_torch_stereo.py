"""The stereo sensor path: the port's ops/stereo.py, render_stereo_pair and
System.track_stereo against the JAX package's on the CPU, on
test_rgbd_stereo.py's world (make_world(seed=4), 350 landmarks, 240x320,
400 features, 4 levels, baseline 0.12 m, 20 frames).

`stereo_depths` is held index-exact on the JAX package's own features
(the mask, the mutual-best match and the matched set are integer
decisions) and its depths within 1e-6 relative (one float32 division).
The two Systems are held frame by frame to the tracker's parity bars
(`cells.compare_records`), with each association keyed by its keypoint's
position instead of its index (`cells.by_position`), as
tests/test_torch_pipeline.py keys them: the two front ends' pyramid
levels differ by +-1 in a few pixels,
so two keypoints' FAST scores can differ by one and their order swap (in
frame 13 keypoints 360 and 361 swap, with the same positions and map
points).  Then test_rgbd_stereo.py's two stereo assertions run on the
port.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.core.system import System as JSystem
from swarmmap_tpu.ops import extractor as jex, matching as jmatching, stereo as jstereo
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch import convert
from swarmmap_tpu_torch.cells import by_position, compare_records, frame_record, settings_for
from swarmmap_tpu_torch.core.system import System
from swarmmap_tpu_torch.ops import extractor as ex, matching, stereo
from swarmmap_tpu_torch.utils import datasets
from swarmmap_tpu_torch.utils.stats import STATS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_FRAMES = 20
BASELINE = 0.12
TCW_TOL = 1e-3


@pytest.fixture(scope="module")
def world():
    return jdata.make_world(n_points=350, n_frames=N_FRAMES, hw=HW, seed=4)


@contextlib.contextmanager
def _recorded_matches(module):
    """Within the block, every `masked_match` that `module` (one package's
    matching module) runs is kept as numpy (idx, valid)."""
    inner, kept = module.masked_match, []

    def recorded(*args, **kw):
        m = inner(*args, **kw)
        kept.append((np.asarray(m.idx), np.asarray(m.valid)))
        return m

    module.masked_match = recorded
    try:
        yield kept
    finally:
        module.masked_match = inner


def _features_to_tensors(f):
    return ex.FrameFeatures(*(convert.to_tensor(np.asarray(getattr(f, k)), "cpu")
                              for k in ex.FrameFeatures._fields))


def _depths(mod, fL, fR, fx):
    return mod.stereo_depths(fL.xy, fL.desc, fL.octave, fL.valid,
                             fR.xy, fR.desc, fR.octave, fR.valid, fx=fx, baseline=BASELINE)


@pytest.mark.parametrize("i", [0, 9, 19])
def test_stereo_depths_index_exact(world, i):
    """On the JAX package's features of one pair: the same mutual-best
    match index and validity for every left keypoint, the same matched
    set, depths within 1e-6 relative."""
    left, right = jdata.render_stereo_pair(world, i, baseline=BASELINE)
    fL = jex.extract_orb(jnp.asarray(left), n_features=400, n_levels=4)
    fR = jex.extract_orb(jnp.asarray(right), n_features=400, n_levels=4)
    fx = float(world.K[0, 0])
    with _recorded_matches(jmatching) as ja:
        da = np.asarray(_depths(jstereo, fL, fR, fx))
    with _recorded_matches(matching) as pa:
        db = _depths(stereo, _features_to_tensors(fL), _features_to_tensors(fR), fx).numpy()
    (ia, va), (ib, vb) = ja[0], pa[0]
    np.testing.assert_array_equal(vb, va)
    np.testing.assert_array_equal(ib[va], ia[va])
    np.testing.assert_array_equal(db > 0, da > 0)
    assert (da > 0).sum() > 50
    ok = da > 0
    np.testing.assert_array_less(np.abs(db[ok] - da[ok]), 1e-6 * da[ok])
    np.testing.assert_array_equal(db[~ok], da[~ok])


def test_render_stereo_pair_identical(world):
    wb = datasets.make_world(n_points=350, n_frames=N_FRAMES, hw=HW, seed=4)
    for i in (0, 7, 19):
        for baseline in (0.12, 0.3):
            for a, b in zip(jdata.render_stereo_pair(world, i, baseline),
                            datasets.render_stereo_pair(wb, i, baseline)):
                np.testing.assert_array_equal(b, a)


def _jax_settings(world):
    K = world.K
    return jconfig.Settings(
        camera=jconfig.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                    cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=jconfig.OrbConfig(n_features=400, n_levels=4),
    )


@pytest.fixture(scope="module")
def runs(world):
    """JAX's and the port's System.track_stereo on the same pairs: per
    frame the two `frame_record`s and the two returned poses; the port's
    System and its STATS stages."""
    a = JSystem(_jax_settings(world))
    b = System(settings_for(world, 400, 4), device="cpu")
    recs, poses = [], []
    STATS.reset()
    for i in range(N_FRAMES):
        left, right = jdata.render_stereo_pair(world, i, baseline=BASELINE)
        poses.append([s.track_stereo(left, right, i / 20.0, baseline=BASELINE) for s in (a, b)])
        recs.append(tuple(by_position(frame_record(s.tracking), s.tracking) for s in (a, b)))
    return b, recs, poses, dict(STATS.times)


def test_track_stereo_matches_jax(runs):
    _, recs, poses, times = runs
    assert compare_records(*zip(*recs), tcw_tol=TCW_TOL) == []
    assert [pa is None for pa, _ in poses] == [pb is None for _, pb in poses]
    # every frame: two extractions, one depth program, one fetch, one grab
    assert len(times["stereo_extract"]) == 2 * N_FRAMES
    for k in ("stereo_depths", "stereo_fetch", "stereo_grab"):
        assert len(times[k]) == N_FRAMES


def test_stereo_depths_accuracy(world):
    """test_rgbd_stereo.py::test_stereo_depths_accuracy on the port."""
    left, right = datasets.render_stereo_pair(world, 0, baseline=BASELINE)
    fL = ex.extract_orb(torch.from_numpy(left), n_features=400, n_levels=4)
    fR = ex.extract_orb(torch.from_numpy(right), n_features=400, n_levels=4)
    d = _depths(stereo, fL, fR, float(world.K[0, 0])).numpy()
    _, depth_gt = datasets.render_frame(world, 0, return_depth=True)
    xy = fL.xy.numpy()
    ok = d > 0
    assert ok.sum() > 50, f"only {ok.sum()} stereo matches"
    errs = []
    for i in np.where(ok)[0]:
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        gt = depth_gt[y, x]
        if np.isfinite(gt):
            errs.append(abs(d[i] - gt) / gt)
    assert np.median(errs) < 0.08, np.median(errs)


def test_stereo_tracking_end_to_end(runs):
    """test_rgbd_stereo.py::test_stereo_tracking_end_to_end on the port."""
    b, _, poses, _ = runs
    assert b.state.name == "OK"
    assert sum(pb is not None for _, pb in poses) > 0.7 * N_FRAMES
    assert b.n_map_points() > 100
