"""Parity of the port's ORB front end (swarmmap_tpu_torch.ops) with the
JAX package on the CPU, at 240x320 with 3 levels.

Per-module tests feed both sides the JAX package's own level images, so
they compare the module and not the pyramid's rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import brief as jbrief
from swarmmap_tpu.ops import extractor as jext
from swarmmap_tpu.ops import fast as jfast
from swarmmap_tpu.ops import orientation as jori
from swarmmap_tpu.ops import pyramid as jpyr
from swarmmap_tpu.utils import datasets as jdata
from swarmmap_tpu_torch import convert
from swarmmap_tpu_torch.ops import brief, extractor, fast, orientation, pyramid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_LEVELS = 3
N_FEATURES = 256


@pytest.fixture(scope="module")
def frame():
    """A rendered synthetic frame (uint8 [240,320])."""
    w = jdata.make_world(n_points=600, n_frames=40, hw=HW, seed=3)
    return jdata.render_frame(w, 20)


@pytest.fixture(scope="module")
def jax_levels(frame):
    return [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(frame), N_LEVELS, 1.2)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("pattern", ["synthetic", "opencv"])
def test_brief_tables_identical(pattern):
    np.testing.assert_array_equal(brief.brief_pattern(pattern), jbrief.brief_pattern(pattern))
    np.testing.assert_array_equal(brief._binned_weights(pattern), jbrief._binned_weights(pattern))


def test_pyramid_levels_within_one(frame):
    """Levels are rounded at every step, and the rounding is not
    bit-reproducible across frameworks: at most 0.1% of a level's pixels
    may differ, by at most 1."""
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 256, HW).astype(np.uint8)
    for img in (frame, noise):
        jl = jpyr.build_pyramid(jnp.asarray(img), N_LEVELS, 1.2)
        tl = pyramid.build_pyramid(_t(img), N_LEVELS, 1.2)
        for a, b in zip(jl, tl):
            d = np.abs(np.asarray(a) - b.numpy())
            assert d.shape == np.asarray(a).shape
            assert d.max() <= 1.0
            assert (d > 0).mean() <= 1e-3


def test_resize_weights_and_shapes_identical():
    assert pyramid.level_shapes(480, 752, 8, 1.2) == jpyr.level_shapes(480, 752, 8, 1.2)
    np.testing.assert_array_equal(pyramid._resize_weights(320, 267),
                                  jpyr._resize_weights(320, 267))


def test_gaussian_blur_matches(jax_levels):
    for lvl in jax_levels:
        a = np.asarray(jpyr.gaussian_blur(jnp.asarray(lvl)))
        b = pyramid.gaussian_blur(_t(lvl)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-3)


def test_fast_score_map_identical(jax_levels):
    for lvl in jax_levels:
        a = np.asarray(jfast.fast_score_map(jnp.asarray(lvl)))
        np.testing.assert_array_equal(fast.fast_score_map(_t(lvl)).numpy(), a)


def test_detect_fast_identical_order(jax_levels):
    """The same keypoint list in the same order: FAST scores are integers,
    so the top-k's tie-break (lower flat index first) decides the list."""
    budgets = jext.level_budgets(N_FEATURES, N_LEVELS, 1.2)
    for lvl, k in zip(jax_levels, budgets):
        a = jfast.detect_fast(jnp.asarray(lvl), k)
        b = fast.detect_fast(_t(lvl), k)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_top_k_ties_go_to_lower_index():
    vals, idx = fast.top_k_stable(torch.tensor([1.0, 5, 5, 3, 5, 0, 5, 2]), 3)
    assert idx.tolist() == [1, 2, 4]
    assert vals.tolist() == [5, 5, 5]


def test_moment_maps_and_angles_identical(jax_levels):
    """Exact at width 320: the running sums stay below 2^24."""
    for lvl in jax_levels:
        a10, a01 = (np.asarray(x) for x in jori.moment_maps(jnp.asarray(lvl)))
        b10, b01 = orientation.moment_maps(_t(lvl))
        np.testing.assert_array_equal(b10.numpy(), a10)
        np.testing.assert_array_equal(b01.numpy(), a01)
        kps = jfast.detect_fast(jnp.asarray(lvl), 64)
        xy, valid = np.asarray(kps.xy), np.asarray(kps.valid)
        ja = np.asarray(jori.ic_angles_conv(jnp.asarray(a10), jnp.asarray(a01),
                                            kps.xy, kps.valid))
        ta = orientation.ic_angles_conv(b10, b01, _t(xy), _t(valid)).numpy()
        np.testing.assert_allclose(ta, ja, atol=1e-3)
        jd = np.asarray(jori.ic_angles(jnp.asarray(lvl), kps.xy, kps.valid))
        td = orientation.ic_angles(_t(lvl), _t(xy), _t(valid)).numpy()
        np.testing.assert_allclose(td, jd, atol=1e-3)


def _level_keypoints(lvl, k=96):
    kps = jfast.detect_fast(jnp.asarray(lvl), k)
    m10, m01 = jori.moment_maps(jnp.asarray(lvl))
    ang = jori.ic_angles_conv(m10, m01, kps.xy, kps.valid)
    blurred = jpyr.gaussian_blur(jnp.asarray(lvl))
    return kps, ang, blurred


@pytest.mark.parametrize("pattern", ["synthetic", "opencv"])
def test_descriptors_from_patches_bit_identical(jax_levels, pattern):
    for lvl in jax_levels:
        kps, ang, blurred = _level_keypoints(lvl)
        img_u = jnp.round(jnp.clip(blurred, 0.0, 255.0))
        jp = np.asarray(jbrief.extract_patches(img_u, kps.xy))
        tp = brief.extract_patches(_t(img_u), _t(kps.xy)).numpy()
        np.testing.assert_array_equal(tp, jp)
        jd = np.asarray(jbrief.descriptors_from_patches(jnp.asarray(jp), ang, kps.valid,
                                                         pattern=pattern))
        td = brief.descriptors_from_patches(_t(jp), _t(ang), _t(kps.valid), pattern=pattern)
        np.testing.assert_array_equal(convert.to_numpy(td, uint32=True), jd)


def test_compute_descriptors_exact_bit_identical(jax_levels):
    for lvl in jax_levels:
        kps, ang, blurred = _level_keypoints(lvl)
        jd = np.asarray(jbrief.compute_descriptors(blurred, kps.xy, ang, kps.valid))
        td = brief.compute_descriptors(_t(blurred), _t(kps.xy), _t(ang), _t(kps.valid))
        np.testing.assert_array_equal(convert.to_numpy(td, uint32=True), jd)


def test_pack_unpack_round_trip():
    rng = np.random.RandomState(1)
    words = rng.randint(0, 2**32, (17, 8), dtype=np.uint32)
    bits = brief.unpack_bits(convert.to_tensor(words, device="cpu"))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbrief.unpack_bits(jnp.asarray(words))))
    np.testing.assert_array_equal(convert.to_numpy(brief._pack_bits(bits), uint32=True), words)


def test_extract_orb_end_to_end(frame):
    """Whole extractor on a rendered frame: >= 98% of the JAX package's
    valid (xy, octave) keypoints are in the port's output, with identical
    descriptors on >= 99% of them (the rest comes from the pyramid's +-1
    pixels and angle-bin flips).  Layout and padding are the same."""
    a = jext.extract_orb(jnp.asarray(frame), n_features=N_FEATURES, n_levels=N_LEVELS)
    b = convert.frame_features_to_numpy(
        extractor.extract_orb(_t(frame), n_features=N_FEATURES, n_levels=N_LEVELS))
    a = jext.FrameFeatures(*(np.asarray(x) for x in a))
    assert b.xy.shape == a.xy.shape == (256, 2)
    assert b.desc.shape == a.desc.shape and b.desc.dtype == np.uint32
    np.testing.assert_array_equal(b.octave, a.octave)
    np.testing.assert_array_equal(b.valid, a.valid)
    port = {(x, y, o): d.tobytes() for (x, y), o, d, v in
            zip(b.xy, b.octave, b.desc, b.valid) if v}
    found = same = total = 0
    for (x, y), o, d, v in zip(a.xy, a.octave, a.desc, a.valid):
        if not v:
            continue
        total += 1
        if (x, y, o) in port:
            found += 1
            same += port[(x, y, o)] == d.tobytes()
    assert total > 100
    assert found >= 0.98 * total, (found, total)
    assert same >= 0.99 * found, (same, found)


def test_extract_orb_batched_equals_per_image(frame):
    """The agent axis is a batch dimension: a stacked batch gives each
    image's own result (angles to an ulp: atan2 is vectorised by shape)."""
    imgs = np.stack([frame, np.ascontiguousarray(frame[:, ::-1])])
    batched = extractor.extract_orb_batched(_t(imgs), n_features=N_FEATURES, n_levels=N_LEVELS)
    for i in range(2):
        one = extractor.extract_orb(_t(imgs[i]), n_features=N_FEATURES, n_levels=N_LEVELS)
        for name, x, y in zip(one._fields, batched, one):
            if name == "angle":
                np.testing.assert_allclose(x[i].numpy(), y.numpy(), rtol=0, atol=1e-4)
            else:
                np.testing.assert_array_equal(x[i].numpy(), y.numpy())


def test_undistort_points_matches():
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 300, (64, 2)).astype(np.float32)
    K = np.array([[458.0, 0, 160], [0, 457.0, 120], [0, 0, 1]], np.float32)
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0], np.float32)
    a = np.asarray(jext.undistort_points(jnp.asarray(xy), jnp.asarray(K), jnp.asarray(dist)))
    b = extractor.undistort_points(_t(xy), _t(K), _t(dist)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3)
    assert extractor.level_budgets(1000, 8, 1.2) == jext.level_budgets(1000, 8, 1.2)
    np.testing.assert_array_equal(extractor.scale_sigma2(8, 1.2), jext.scale_sigma2(8, 1.2))
