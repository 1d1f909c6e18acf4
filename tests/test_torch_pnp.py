"""Parity of the port's RANSAC PnP (swarmmap_tpu_torch.ops.pnp) with the
JAX package's on the CPU, on the JAX package's own draws.

The draws are held apart from the solve (`draw_indices` and
`ransac_pnp_draws`), so both sides see the same minimal sets.  The solves
agree exactly where the arithmetic decides them (float64, 6 distinct
points, the same eigenvector signs); in float32 the winner may differ with
the LAPACK build, and the result is held on its success and inlier set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import pnp as jpnp
from swarmmap_tpu_torch.ops import pnp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pnp_problem(dtype, seed=0):
    """256 slots, 150 valid scattered among them, 30 gross outliers."""
    rng = np.random.RandomState(seed)
    N, n = 256, 150
    P = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], 1)
    K = np.array([[400, 0, 160], [0, 400, 120], [0, 0, 1]], np.float64)
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    pc = P @ R.T + np.array([0.2, -0.1, 0.3])
    uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                   K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], 1) + rng.randn(n, 2)
    uv[:30] += rng.uniform(-50, 50, (30, 2))
    slots = rng.permutation(N)[:n]
    pts, uvs, ok = np.zeros((N, 3)), np.zeros((N, 2)), np.zeros(N, bool)
    pts[slots], uvs[slots], ok[slots] = P, uv, True
    return pts.astype(dtype), uvs.astype(dtype), ok, K.astype(dtype)


def _jax_draws(ok, seed):
    key = jax.random.PRNGKey(seed)
    draws = jax.random.randint(key, (jpnp.N_HYPOTHESES, jpnp.MIN_SET), 0, max(ok.sum(), 6))
    return key, np.asarray(draws)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_on_jax_draws_matches_jax(seed):
    """float32, as the tracker runs it: on the JAX package's draws the port
    finds the same success and the same inlier set.  The poses agree to
    5e-3, not exactly: in float32 the minimal solves differ with the LAPACK
    build (see the next test), so the winning hypothesis may differ, and
    the 3x8 refinement stops at its step tolerance from another start (the
    tracker's 4x10 `_pose_opt_frame` that follows takes both to 1e-5)."""
    pts, uv, ok, K = _pnp_problem(np.float32, seed)
    key, draws = _jax_draws(ok, seed + 3)
    ra = jpnp.ransac_pnp(*(jnp.asarray(x) for x in (pts, uv, ok, K)), key, min_inliers=20)
    rb = pnp.ransac_pnp_draws(*(torch.from_numpy(x) for x in (pts, uv, ok, K)),
                              torch.tensor(draws).long(), min_inliers=20)
    assert bool(rb.success) and bool(ra.success)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    assert rb.inliers.sum() >= 110
    assert np.abs(rb.Tcw.numpy() - np.asarray(ra.Tcw)).max() < 5e-3


def test_ransac_pnp_hypotheses_match_jax():
    """The minimal solves and their scores, hypothesis by hypothesis, in
    float64 on both sides so that LAPACK's rounding does not decide.  EPnP
    depends on the sign that eigh gives each PCA axis (another sign gives
    other control points and another approximate solution), and that sign
    is the LAPACK build's choice; a draw that repeats a point is rank
    deficient and its nullspace arbitrary.  So a hypothesis is held, to
    1e-9 and with the same loose-gate score, wherever its 6 points are
    distinct and both sides' axes have the same signs.  Then the winner,
    its refinement and the result are exact."""
    pts, uv, ok, K = _pnp_problem(np.float64)
    with jax.enable_x64(True):
        key, draws = _jax_draws(ok, 3)
        ra = jpnp.ransac_pnp(*(jnp.asarray(x) for x in (pts, uv, ok, K)), key, min_inliers=20)
        sets = np.asarray(jnp.argsort(~jnp.asarray(ok)))[draws]
        nuv = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], 1)
        Ta = np.asarray(jax.vmap(
            lambda s: jpnp._solve_epnp(jnp.asarray(pts)[s], jnp.asarray(nuv)[s]))(jnp.asarray(sets)))

        def axes(p):
            c = p - p.mean(0)
            return np.asarray(jnp.linalg.eigh(jnp.asarray(c.T @ c / len(p)))[1])
        axes_a = np.stack([axes(pts[s]) for s in sets])
    t = [torch.from_numpy(x) for x in (pts, uv, ok, K)]
    hyp = pnp.hypotheses(*t, torch.tensor(draws).long())
    cov = torch.stack([torch.from_numpy(pts[s] - pts[s].mean(0)) for s in sets])
    axes_b = torch.linalg.eigh(cov.transpose(1, 2) @ cov / 6)[1].numpy()
    distinct = np.array([len(set(s)) == pnp.MIN_SET for s in sets])
    same = np.all(np.abs(axes_a - axes_b) < 1e-9, axis=(1, 2)) & distinct
    assert same.sum() >= 64, same.sum()
    d = np.abs(hyp.Tcw.numpy() - Ta).reshape(len(Ta), -1).max(1)
    assert d[same].max() < 1e-9
    # the JAX package's loose score of its own hypotheses
    pc = np.einsum("hij,nj->hni", Ta[:, :3, :3], pts) + Ta[:, None, :3, 3]
    z = pc[..., 2]
    e2 = ((K[0, 0] * pc[..., 0] / np.maximum(z, 1e-9) + K[0, 2] - uv[:, 0]) ** 2
          + (K[1, 1] * pc[..., 1] / np.maximum(z, 1e-9) + K[1, 2] - uv[:, 1]) ** 2)
    n_loose_a = (ok & (z > 0) & (e2 < 100.0 * 5.991)).sum(1)
    np.testing.assert_array_equal(hyp.n_loose.numpy()[same], n_loose_a[same])
    rb = pnp.ransac_pnp_draws(*t, torch.tensor(draws).long(), min_inliers=20)
    assert bool(rb.success) == bool(ra.success)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    assert np.abs(rb.Tcw.numpy() - np.asarray(ra.Tcw)).max() < 1e-9


def test_ransac_pnp_draws_follow_the_generator():
    pts, uv, ok, K = _pnp_problem(np.float32)
    gens = [torch.Generator().manual_seed(s) for s in (5, 5, 6)]
    d = [pnp.draw_indices(torch.from_numpy(ok), g) for g in gens]
    assert d[0].shape == (pnp.N_HYPOTHESES, pnp.MIN_SET)
    assert torch.equal(d[0], d[1]) and not torch.equal(d[0], d[2])
    assert int(d[0].min()) >= 0 and int(d[0].max()) < ok.sum()
    r = pnp.ransac_pnp(*(torch.from_numpy(x) for x in (pts, uv, ok, K)),
                       torch.Generator().manual_seed(1), min_inliers=20)
    assert bool(r.success) and int(r.inliers.sum()) >= 110


def test_dlt_hypotheses_match_jax():
    """The alternative minimal solver, the 6-point DLT, on the JAX package's
    draws in float64: its null vector's sign is fixed by the centroid's
    depth, so every draw of 6 distinct points agrees to 1e-9 (a draw that
    repeats a point has no unique null vector)."""
    pts, uv, ok, K = _pnp_problem(np.float64, seed=2)
    with jax.enable_x64(True):
        _, draws = _jax_draws(ok, 4)
        sets = np.asarray(jnp.argsort(~jnp.asarray(ok)))[draws]
        nuv = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], 1)
        Ta = np.asarray(jax.vmap(
            lambda s: jpnp._solve_dlt(jnp.asarray(pts)[s], jnp.asarray(nuv)[s]))(jnp.asarray(sets)))
    hyp = pnp.hypotheses(*(torch.from_numpy(x) for x in (pts, uv, ok, K)),
                         torch.tensor(draws).long(), solver="dlt")
    distinct = np.array([len(set(s)) == pnp.MIN_SET for s in sets])
    d = np.abs(hyp.Tcw.numpy() - Ta).reshape(len(Ta), -1).max(1)
    assert distinct.sum() >= 200 and d[distinct].max() < 1e-9
