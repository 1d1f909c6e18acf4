"""Parity of the port's dense bundle adjustment (swarmmap_tpu_torch.ops.ba)
with the JAX package's on the CPU, on tests/test_ba.py's problems.

Bars: |dTcw| < 1e-3, points within 1e-3 relative, and `obs_inlier` equal
except for observations whose final chi2 lies within 1% of the 5.991 bar
(LM accept/reject and the pruning gate sit on float32 comparisons).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import ba as jba
from swarmmap_tpu_torch.ops import ba
from test_ba import cam_errors, make_ba_problem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _to_port(prob) -> ba.BAProblem:
    f = {k: torch.from_numpy(np.array(getattr(prob, k))) for k in prob._fields}
    f["obs_cam"], f["obs_pt"] = f["obs_cam"].long(), f["obs_pt"].long()
    return ba.BAProblem(**f)


def _assert_agrees(ra, rb, chi2_th=ba.CHI2_MONO):
    Ta, Tb = np.asarray(ra.Tcw), rb.Tcw.numpy()
    assert np.abs(Ta - Tb).max() < 1e-3
    pa, pb = np.asarray(ra.pts), rb.pts.numpy()
    rel = np.abs(pa - pb).max(1) / np.maximum(np.abs(pa).max(1), 1e-6)
    assert rel.max() < 1e-3, rel.max()
    chi2 = np.asarray(ra.obs_chi2)
    edge = np.abs(chi2 - chi2_th) <= 0.01 * chi2_th
    diff = np.asarray(ra.obs_inlier) != rb.obs_inlier.numpy()
    assert not (diff & ~edge).any(), np.where(diff & ~edge)


def test_dense_ba_converges_like_jax(rng):
    prob, Tcw_gt, pts_gt = make_ba_problem(rng)
    ra = jba.bundle_adjust(prob, mode="dense")
    rb = ba.bundle_adjust(_to_port(prob), mode="dense")
    _assert_agrees(ra, rb)
    angs, dts = cam_errors(rb.Tcw.numpy(), Tcw_gt)
    assert angs.max() < 0.15 and dts.max() < 0.02
    assert rb.obs_inlier.float().mean() > 0.95


def test_dense_ba_prunes_outliers_like_jax(rng):
    prob, Tcw_gt, pts_gt = make_ba_problem(rng, noise=0.3)
    uv = np.asarray(prob.obs_uv).copy()
    bad = rng.rand(len(uv)) < 0.15
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    prob = prob._replace(obs_uv=jnp.asarray(uv))
    ra = jba.bundle_adjust(prob, mode="dense")
    rb = ba.bundle_adjust(_to_port(prob), mode="dense")
    _assert_agrees(ra, rb)
    inl = rb.obs_inlier.numpy()
    assert inl[bad].mean() < 0.05 and inl[~bad].mean() > 0.9


def test_dense_ba_keeps_fixed_cameras(rng):
    prob, _, _ = make_ba_problem(rng)
    rb = ba.bundle_adjust(_to_port(prob), mode="dense")
    np.testing.assert_array_equal(rb.Tcw.numpy()[:2], np.asarray(prob.Tcw)[:2])


def test_padded_problem_matches_jax(rng):
    """build_padded_problem's buckets and padding are the JAX package's,
    and the padded problem solves alike: dead cameras and points stay."""
    prob, Tcw_gt, _ = make_ba_problem(rng, n_cams=6, n_pts=100)
    args = [np.asarray(getattr(prob, k)) for k in
            ("Tcw", "K", "cam_fixed", "pts", "obs_cam", "obs_pt", "obs_uv", "obs_inv_sigma2")]
    pa = jba.build_padded_problem(*args)
    pb = ba.build_padded_problem(*args, device="cpu")
    for k in ba.BAProblem._fields:
        a, b = np.asarray(getattr(pa, k)), getattr(pb, k).numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)
    assert pb.Tcw.shape[0] == 8 and pb.pts.shape[0] == 256 and pb.obs_cam.shape[0] == 1024
    ra = jba.bundle_adjust(pa, iters_a=10, iters_b=10)
    rb = ba.bundle_adjust(pb, iters_a=10, iters_b=10)
    _assert_agrees(ra, rb)
    np.testing.assert_allclose(rb.Tcw.numpy()[6:], np.broadcast_to(np.eye(4), (2, 4, 4)),
                               atol=1e-6)
    np.testing.assert_allclose(rb.pts.numpy()[100:], 0.0, atol=1e-6)
    angs, _ = cam_errors(rb.Tcw.numpy()[:6], Tcw_gt)
    assert angs.max() < 0.5


def _linearized(rng):
    prob, _, _ = make_ba_problem(rng, n_cams=5, n_pts=60)
    pb = _to_port(prob)
    active = np.asarray(prob.obs_valid).astype(np.float32)
    la = jba._linearize(prob.Tcw, prob.K, prob.pts, prob, jnp.asarray(active))
    lb = ba._linearize(pb.Tcw, pb.pts, pb, torch.from_numpy(active))
    return prob, pb, la[:4], lb


@pytest.mark.parametrize("lam", [1e-2, 1.0])
def test_blocks_match_jax(rng, lam):
    """One LM iteration's pieces: residuals and Jacobians, and the Schur
    step within 1e-4 of its largest component at a damping where the
    reduced system is well conditioned (for the first step's 1e-4, see
    the next test); the 3x3 inverse with its determinant clamp."""
    prob, pb, la, lb = _linearized(rng)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    da = jba._dense_schur_solve(*la, prob, lam, 5, 60)
    db = ba._dense_schur_solve(*lb, pb, torch.tensor(lam), ba.segment_plan(pb))
    for a, b in zip(da, db):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * np.abs(a).max())
    M = rng.randn(50, 3, 3).astype(np.float32)
    M[:5] *= 1e-5     # determinants below the 1e-12 clamp
    np.testing.assert_allclose(ba._inv3x3(torch.from_numpy(M)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(M))), rtol=1e-4)


def test_first_step_is_as_close_to_float64_as_jax(rng):
    """At LM's first damping, 1e-4, the float32 Schur solve of either
    package lies ~1e-3 (of the step's largest component) from the same
    solve in float64, so the two are held to the float64 solve: the port
    within 2e-3 of it, and no further from it than twice JAX's step is."""
    prob, pb, la, lb = _linearized(rng)
    plan = ba.segment_plan(pb)
    f64 = {k: (v.double() if v.is_floating_point() else v) for k, v in pb._asdict().items()}
    d64 = ba._dense_schur_solve(*(x.double() for x in lb), ba.BAProblem(**f64),
                                torch.tensor(1e-4, dtype=torch.float64), plan)
    da = jba._dense_schur_solve(*la, prob, 1e-4, 5, 60)
    db = ba._dense_schur_solve(*lb, pb, torch.tensor(1e-4), plan)
    for a, b, c in zip(da, db, d64):
        c = c.numpy()
        port, jax = np.abs(b.numpy() - c).max(), np.abs(np.asarray(a) - c).max()
        assert port < 2e-3 * np.abs(c).max()
        assert port <= 2 * jax, (port, jax)


@pytest.mark.parametrize("threads", [1, 4])
def test_dense_ba_same_bits_every_run(rng, threads):
    """Two runs of one BA give the same bits, with one torch thread or
    several: every segment sum is a copy to unique slots and a sum, with
    no accumulation whose order depends on threads.  The problem is large
    enough (O*18 >= 32768) for torch's CPU kernels to split their work
    across threads."""
    prob, _, _ = make_ba_problem(rng, n_cams=10, n_pts=300)
    assert int(np.asarray(prob.obs_valid).sum()) * 18 >= 32768
    pb = _to_port(prob)
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        r1, r2 = (ba.bundle_adjust(pb) for _ in range(2))
    finally:
        torch.set_num_threads(n)
    for f in ba.BAResult._fields:
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f


def test_segment_sum_matches_index_add():
    """The planned segment sum equals an index_add_ in float64 over the
    valid rows, with the padded rows (obs_valid False) left out."""
    g = np.random.default_rng(0)
    C, P, O = 4, 50, 300
    cam, pt = g.integers(0, C, O), g.integers(0, P, O)
    valid = np.arange(O) < 260
    prob = ba.BAProblem(
        Tcw=torch.zeros(C, 4, 4), K=torch.zeros(C, 3, 3), cam_fixed=torch.zeros(C, dtype=bool),
        cam_valid=torch.ones(C, dtype=bool), pts=torch.zeros(P, 3),
        pt_valid=torch.ones(P, dtype=bool), obs_cam=torch.from_numpy(cam),
        obs_pt=torch.from_numpy(pt), obs_uv=torch.zeros(O, 2), obs_inv_sigma2=torch.ones(O),
        obs_valid=torch.from_numpy(valid))
    plan = ba.segment_plan(prob)
    x = torch.from_numpy(g.standard_normal((O, 6, 3)))
    for seg, key, n in ((plan.cam, cam, C), (plan.pt, pt, P), (plan.pt_cam, pt * C + cam, C * P)):
        want = torch.zeros((n, 6, 3), dtype=x.dtype).index_add_(
            0, torch.from_numpy(key[valid]), x[torch.from_numpy(valid)])
        torch.testing.assert_close(ba._segment_sum(x, seg), want, rtol=1e-12, atol=1e-12)


def test_cg_mode_is_not_ported(rng):
    prob, _, _ = make_ba_problem(rng, n_cams=4, n_pts=30)
    with pytest.raises(NotImplementedError, match="item 15"):
        ba.bundle_adjust(_to_port(prob), mode="cg")
