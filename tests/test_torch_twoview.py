"""Parity of the port's two-view initialisation (swarmmap_tpu_torch.ops.twoview)
with the JAX package's on the CPU, on the JAX package's own RANSAC draws.

The draws are held apart from the solve (`draw_indices` and
`reconstruct_draws`), so both sides score the same 256 minimal sets.  Bars:
`success`, `used_h` and the triangulated inlier set exact; R21 and t21
within 5e-3 (the SVD refits round differently with the LAPACK build).  The
scenes are tests/test_geometry.py's: a general 3D scene, a pure rotation
(no baseline: rejected) and a slanted plane (the homography wins).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import twoview as jtwoview
from swarmmap_tpu_torch.ops import twoview
from test_geometry import make_scene, project, small_rotation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 5e-3


def _case(name):
    """(uv1, uv2, valid, K, key) of test_geometry's scene `name`, drawn
    from RandomState(42) in that test's order; "masked" is the general
    scene with 40 slots invalid and 20 gross outliers."""
    rng = np.random.RandomState(42)
    pts, K = make_scene(rng, 300, planar=(name == "planar"))
    if name == "rotation":
        R, t, noise, key = small_rotation(rng, 0.08), np.zeros(3), 0.3, 1
    elif name == "planar":
        R, t, noise, key = small_rotation(rng, 0.05), np.array([0.5, 0.1, 0.0]), 0.3, 2
    else:
        R, t, noise, key = small_rotation(rng, 0.05), np.array([0.6, 0.0, 0.05]), 0.4, 0
    uv1, _ = project(K, np.eye(3), np.zeros(3), pts)
    uv2, _ = project(K, R, t, pts)
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    valid = np.ones(300, bool)
    if name == "masked":
        valid[rng.permutation(300)[:40]] = False
        uv2[:20] += rng.uniform(-40, 40, (20, 2))
    return (uv1.astype(np.float32), uv2.astype(np.float32), valid,
            K.astype(np.float32), jax.random.PRNGKey(key))


def jax_draws(key, valid) -> np.ndarray:
    """The [256, 8] draws `twoview.reconstruct` makes from `key`."""
    count = jnp.asarray(max(int(np.sum(valid)), 8), jnp.int32)
    return np.array(jax.random.randint(key, (jtwoview.N_HYPOTHESES, 8), 0, count))


@pytest.mark.parametrize("name", ["general", "rotation", "planar", "masked"])
def test_reconstruct_on_jax_draws_matches_jax(name):
    uv1, uv2, valid, K, key = _case(name)
    ra = jtwoview.reconstruct(*(jnp.asarray(x) for x in (uv1, uv2, valid, K)), key)
    rb = twoview.reconstruct_draws(*(torch.from_numpy(x) for x in (uv1, uv2, valid, K)),
                                   torch.from_numpy(jax_draws(key, valid)).long())
    assert bool(rb.success) == bool(ra.success)
    assert bool(rb.used_h) == bool(ra.used_h)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    assert np.abs(rb.R21.numpy() - np.asarray(ra.R21)).max() < TOL
    assert np.abs(rb.t21.numpy() - np.asarray(ra.t21)).max() < TOL
    inl = rb.inliers.numpy()
    np.testing.assert_allclose(rb.pts3d.numpy()[inl], np.asarray(ra.pts3d)[inl],
                               rtol=TOL, atol=TOL)
    if name == "general":
        assert bool(rb.success) and inl.sum() > 200
    elif name == "rotation":
        assert not bool(rb.success)
    elif name == "planar":
        assert bool(rb.used_h)


def test_draw_indices_cover_the_valid_entries():
    """Draws are uniform in [0, max(valid.sum(), 8)) and stay in range."""
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::3] = True
    d = twoview.draw_indices(valid, torch.Generator().manual_seed(0))
    assert d.shape == (twoview.N_HYPOTHESES, twoview.MIN_SET) and d.dtype == torch.int64
    assert int(d.min()) == 0 and int(d.max()) == 99
    d = twoview.draw_indices(torch.zeros(300, dtype=torch.bool), torch.Generator().manual_seed(0))
    assert int(d.max()) <= 7


def test_decompositions_are_sign_free():
    """The 4 motions of E and the 8 of H form the same set whatever signs
    the SVD gives (only their order moves): E and -E, H and -H."""
    rng = np.random.RandomState(3)
    R = torch.from_numpy(small_rotation(rng, 0.1)).double()
    t = torch.tensor([0.6, 0.1, 0.05], dtype=torch.float64)
    tx = torch.tensor([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                      dtype=torch.float64)
    K = torch.tensor([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], dtype=torch.float64)
    n = torch.tensor([0.1, -0.2, 1.0], dtype=torch.float64)
    H = K @ (R + torch.outer(t, n) / 6.0) @ torch.linalg.inv(K)

    def as_set(Rs, ts):
        return sorted(tuple(np.round(np.concatenate([r.numpy().ravel(), v.numpy()]), 6))
                      for r, v in zip(Rs, ts))

    for a, b in ((twoview._decompose_e(tx @ R), twoview._decompose_e(-(tx @ R))),
                 (twoview._decompose_h(H, K), twoview._decompose_h(-H, K))):
        np.testing.assert_allclose(as_set(*a), as_set(*b), atol=1e-6)
