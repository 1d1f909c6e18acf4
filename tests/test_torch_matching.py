"""Parity of the port's Hamming distances and matching core
(swarmmap_tpu_torch.ops.hamming / matching) with the JAX package on the
CPU.  Integer outputs and tie-breaks must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import hamming as jham
from swarmmap_tpu.ops import matching as jmatch
from swarmmap_tpu_torch import convert
from swarmmap_tpu_torch.ops import hamming, matching
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return convert.to_tensor(a, device="cpu")


def _descs(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint32)


def test_hamming_matrix_exact(rng):
    q, t = _descs(rng, 130), _descs(rng, 97)
    t[:5] = q[:5]                        # zero distances
    t[5] = ~q[6]                         # distance 256
    a = np.asarray(jham.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    b = hamming.hamming_matrix(_t(q), _t(t))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(
        hamming.hamming_pairs(_t(q[:97]), _t(t)).numpy(),
        np.asarray(jham.hamming_pairs(jnp.asarray(q[:97]), jnp.asarray(t))))
    np.testing.assert_array_equal(hamming.popcount_desc(_t(q)).numpy(),
                                  np.asarray(jham.popcount_desc(jnp.asarray(q))))


def test_hamming_matrix_batched(rng):
    q, t = _descs(rng, 3 * 40).reshape(3, 40, 8), _descs(rng, 3 * 50).reshape(3, 50, 8)
    b = hamming.hamming_matrix(_t(q), _t(t)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            b[i], np.asarray(jham.hamming_matrix(jnp.asarray(q[i]), jnp.asarray(t[i]))))


def _geometry(rng, nq=200, nt=256):
    q_uv = rng.uniform(0, 320, (nq, 2)).astype(np.float32)
    t_uv = rng.uniform(0, 320, (nt, 2)).astype(np.float32)
    radius = rng.uniform(10, 40, nq).astype(np.float32)
    q_valid = rng.rand(nq) < 0.9
    t_valid = rng.rand(nt) < 0.9
    t_oct = rng.randint(0, 3, nt).astype(np.int32)
    pred = rng.randint(0, 3, nq).astype(np.int32)
    return q_uv, t_uv, radius, q_valid, t_valid, t_oct, pred


def test_window_mask_matches(rng):
    q_uv, t_uv, radius, qv, tv, t_oct, pred = _geometry(rng)
    a = jmatch.window_mask(jnp.asarray(q_uv), jnp.asarray(t_uv), jnp.asarray(radius),
                           jnp.asarray(qv), jnp.asarray(tv), t_octave=jnp.asarray(t_oct),
                           oct_lo=jnp.asarray(pred - 1), oct_hi=jnp.asarray(pred + 1))
    b = matching.window_mask(_t(q_uv), _t(t_uv), _t(radius), _t(qv), _t(tv),
                             t_octave=_t(t_oct), oct_lo=_t(pred - 1), oct_hi=_t(pred + 1))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    a = jmatch.window_mask(jnp.asarray(q_uv), jnp.asarray(t_uv), 15.0,
                           jnp.asarray(qv), jnp.asarray(tv))
    b = matching.window_mask(_t(q_uv), _t(t_uv), 15.0, _t(qv), _t(tv))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_project_to_frame_and_octave_match(rng):
    pts = np.stack([rng.uniform(-4, 4, 300), rng.uniform(-3, 3, 300),
                    rng.uniform(-1, 10, 300)], 1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array([[458.0, 0, 160], [0, 457.0, 120], [0, 0, 1]], np.float32)
    for bounds in (None, (-5.0, 330.0, -3.0, 250.0)):
        a = jmatch.project_to_frame(jnp.asarray(T), jnp.asarray(K), jnp.asarray(pts),
                                    (240, 320), bounds=bounds)
        b = matching.project_to_frame(_t(T), _t(K), _t(pts), (240, 320), bounds=bounds)
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    depth = rng.uniform(0.5, 12, 500).astype(np.float32)
    maxd = rng.uniform(1, 20, 500).astype(np.float32)
    np.testing.assert_array_equal(
        matching.predicted_octave(_t(depth), _t(maxd), 1.2, 8).numpy(),
        np.asarray(jmatch.predicted_octave(jnp.asarray(depth), jnp.asarray(maxd), 1.2, 8)))


def _tie_problem(rng, nq=160, nt=192):
    """Descriptors built so that many rows and columns have several
    minimal entries: targets repeat in blocks, queries copy targets."""
    base = _descs(rng, 24)
    t = base[rng.randint(0, 24, nt)]
    q = t[rng.randint(0, nt, nq)].copy()
    flip = rng.rand(nq) < 0.3
    q[flip, 0] ^= np.uint32(1) << rng.randint(0, 32, flip.sum()).astype(np.uint32)
    mask = rng.rand(nq, nt) < 0.5
    return q, t, mask


@pytest.mark.parametrize("max_dist,ratio", [(jmatch.TH_HIGH, 0.0), (jmatch.TH_LOW, 0.9)])
def test_masked_match_identical_with_ties(rng, max_dist, ratio):
    q, t, mask = _tie_problem(rng)
    a = jmatch.masked_match(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
                            max_dist=max_dist, ratio=ratio)
    b = matching.masked_match(_t(q), _t(t), _t(mask), max_dist=max_dist, ratio=ratio)
    for name in ("idx", "dist", "valid", "target_q"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)
    assert np.asarray(a.valid).sum() > 0


def test_masked_match_rotation_and_batch(rng):
    q, t, mask = _tie_problem(rng)
    ang_q = rng.uniform(0, 360, len(q)).astype(np.float32)
    ang_t = rng.uniform(0, 360, len(t)).astype(np.float32)
    a = jmatch.masked_match(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
                            max_dist=jmatch.TH_HIGH, angle_q=jnp.asarray(ang_q),
                            angle_t=jnp.asarray(ang_t), check_rotation=True)
    b = matching.masked_match(_t(q), _t(t), _t(mask), max_dist=matching.TH_HIGH,
                              angle_q=_t(ang_q), angle_t=_t(ang_t), check_rotation=True)
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    # a leading batch axis gives each member its own result
    q2, t2, mask2 = _tie_problem(rng)
    bb = matching.masked_match(_t(np.stack([q, q2])), _t(np.stack([t, t2])),
                               _t(np.stack([mask, mask2])), max_dist=matching.TH_HIGH)
    for i, (qq, tt, mm) in enumerate(((q, t, mask), (q2, t2, mask2))):
        one = matching.masked_match(_t(qq), _t(tt), _t(mm), max_dist=matching.TH_HIGH)
        for x, y in zip(bb, one):
            np.testing.assert_array_equal(x[i].numpy(), y.numpy())


def test_resolve_conflicts_and_rotation_consistency_match(rng):
    nq, nt = 300, 40
    best = rng.randint(0, nt, nq).astype(np.int32)
    dist = rng.randint(0, 60, nq).astype(np.int32)
    valid = rng.rand(nq) < 0.8
    a = jmatch.resolve_conflicts(jnp.asarray(best), jnp.asarray(dist), jnp.asarray(valid), nt)
    b = matching.resolve_conflicts(_t(best), _t(dist), _t(valid), nt)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rot = np.concatenate([rng.normal(30, 3, 200), rng.uniform(-360, 360, 100),
                          np.full(20, 96.0), np.full(20, 108.0)]).astype(np.float32)
    v = rng.rand(len(rot)) < 0.9
    a = jmatch.rotation_consistency(jnp.asarray(rot), jnp.asarray(v))
    b = matching.rotation_consistency(_t(rot), _t(v))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
