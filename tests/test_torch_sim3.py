"""Parity of the port's server math with the JAX package's on the CPU:
Umeyama and Sim3 RANSAC (on JAX's draws), the Sim3 refinements, the
essential-graph optimiser and Sim3-guided matching (the CG backend of
bundle adjustment is held in tests/test_torch_ba.py).

Bars: RANSAC's success flag and inlier mask equal on the same draws, the
Sim3 within 1e-4 (scale, rotation) and 1e-3 (translation); the
refinements within 1e-3; pose-graph nodes within 1e-4; guided-match
indices and masks exact.  The port's results also pass the JAX tests'
own assertions.  The pose graph gives the same bits on every run at 1
and 4 torch threads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import lie as jlie
from swarmmap_tpu.ops import matching as jmatching
from swarmmap_tpu.ops import pose_graph as jpg
from swarmmap_tpu.ops import sim3 as jsim3
from swarmmap_tpu.ops import sim3_opt as jsim3_opt
from swarmmap_tpu_torch.ops import lie, matching, pose_graph, sim3, sim3_opt
from test_geometry import small_rotation
from test_sim3_posegraph import _chain_nodes, _rel
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def T(x, dtype=None):
    """numpy / jax array -> CPU tensor (uint32 words as int32 bits)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def test_umeyama_matches_jax(rng):
    """tests/test_geometry.py::test_umeyama_recovers_sim3 on both
    packages, and a batch of weighted problems solved as one call."""
    src = rng.randn(40, 3)
    R = small_rotation(rng, 0.7)
    s_true, t_true = 1.7, np.array([0.3, -1.0, 2.0])
    dst = s_true * src @ R.T + t_true
    sj, Rj, tj = jsim3.umeyama(jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32))
    s, R_est, t_est = sim3.umeyama(T(src, torch.float32), T(dst, torch.float32))
    assert abs(float(s) - s_true) < 1e-3
    np.testing.assert_allclose(R_est.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(t_est.numpy(), t_true, atol=1e-3)
    assert abs(float(s) - float(sj)) < 1e-5
    np.testing.assert_allclose(R_est.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(tj), atol=1e-4)
    # batched and weighted, with reflections in the raw covariance
    srcs = rng.randn(16, 12, 3).astype(np.float32)
    dsts = rng.randn(16, 12, 3).astype(np.float32)
    ws = (rng.rand(16, 12) > 0.3).astype(np.float32)
    sb, Rb, tb = sim3.umeyama(T(srcs), T(dsts), weights=T(ws))
    for i in range(16):
        sa, Ra, ta = jsim3.umeyama(jnp.asarray(srcs[i]), jnp.asarray(dsts[i]),
                                   weights=jnp.asarray(ws[i]))
        assert abs(float(sb[i]) - float(sa)) < 1e-4 * max(1.0, abs(float(sa)))
        np.testing.assert_allclose(Rb[i].numpy(), np.asarray(Ra), atol=1e-4)
        np.testing.assert_allclose(tb[i].numpy(), np.asarray(ta), atol=1e-4)
        assert abs(np.linalg.det(Rb[i].numpy()) - 1) < 1e-4


def _ransac_problem(rng):
    n = 80
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]])
    pc2 = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1)
    R = small_rotation(rng, 0.5)
    s_true, t_true = 1.3, np.array([0.5, 0.1, 0.4])
    pc1 = s_true * pc2 @ R.T + t_true
    out = rng.rand(n) < 0.25
    pc1[out] += rng.uniform(1.0, 3.0, (out.sum(), 3))
    return pc1, pc2, K, R, s_true, out


def _jax_draws(key, valid):
    """The draws jsim3.ransac_sim3 makes from `key` (its own expression)."""
    count = max(int(np.sum(valid)), 3)
    return np.asarray(jax.random.randint(key, (jsim3.N_HYPOTHESES, 3), 0, count))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_sim3_on_jax_draws(rng, fix_scale):
    """tests/test_geometry.py::test_ransac_sim3_with_outliers: the same
    success flag and inlier mask on JAX's draws, the Sim3 within 1e-4,
    and JAX's bars on the port's result; padded rows never drawn."""
    pc1, pc2, K, R, s_true, out = _ransac_problem(rng)
    n = len(pc1)
    b = 128                                 # a bucket, as the server pads
    valid = np.arange(b) < n
    pad = lambda a: np.concatenate([a, np.zeros((b - n, 3))]).astype(np.float32)  # noqa: E731
    key = jax.random.PRNGKey(4)
    ra = jsim3.ransac_sim3(jnp.asarray(pad(pc1)), jnp.asarray(pad(pc2)), jnp.asarray(valid),
                           jnp.asarray(K, jnp.float32), jnp.asarray(K, jnp.float32), key,
                           fix_scale=fix_scale)
    draws = T(_jax_draws(key, valid)).long()
    rb = sim3.ransac_sim3(T(pad(pc1)), T(pad(pc2)), T(valid), T(K, torch.float32),
                          T(K, torch.float32), draws, fix_scale=fix_scale)
    assert bool(rb.success) == bool(ra.success)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    if int(rb.inliers.sum()) >= 3:   # else the refit has no points: any rotation
        assert abs(float(rb.s) - float(ra.s)) < 1e-4
        np.testing.assert_allclose(rb.R.numpy(), np.asarray(ra.R), atol=1e-4)
        np.testing.assert_allclose(rb.t.numpy(), np.asarray(ra.t), atol=1e-3)
    if not fix_scale:
        assert bool(rb.success)
        assert abs(float(rb.s) - s_true) < 0.05
        np.testing.assert_allclose(rb.R.numpy(), R, atol=0.02)
        assert rb.inliers.numpy()[:n][~out].mean() > 0.85
    else:
        assert float(rb.s) == 1.0 and not bool(rb.success)
    g = torch.Generator().manual_seed(0)
    d = sim3.ransac_sim3_draws(T(valid), g)
    assert d.shape == (sim3.N_HYPOTHESES, 3) and int(d.min()) >= 0 and int(d.max()) < n


def test_optimize_sim3_matches_jax(rng):
    """tests/test_sim3_posegraph.py::test_optimize_sim3_refines_noisy_init
    on both packages (and with fix_scale, whose scale stays put)."""
    n = 60
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
    pc2 = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1
    ).astype(np.float32)
    xi_true = np.array([0.1, -0.2, 0.15, 0.4, 0.1, -0.3, 0.2], np.float32)
    R, t, s = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(xi_true)))
    pc1 = (s * pc2 @ R.T + t).astype(np.float32)
    uv1 = np.array(jsim3_opt._project(jnp.asarray(K), jnp.asarray(pc1)))
    uv2 = np.array(jsim3_opt._project(jnp.asarray(K), jnp.asarray(pc2)))
    uv1 += rng.normal(0, 0.3, uv1.shape)
    uv2 += rng.normal(0, 0.3, uv2.shape)
    xi0 = xi_true + rng.normal(0, 0.03, 7).astype(np.float32)
    R0, t0, s0 = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(xi0)))
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    valid[::7] = False
    for fix_scale in (False, True):
        ra = jsim3_opt.optimize_sim3(
            jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pc1),
            jnp.asarray(pc2), jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
            jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(valid), jnp.asarray(K),
            jnp.asarray(K), fix_scale=fix_scale)
        rb = sim3_opt.optimize_sim3(
            T(s0), T(R0), T(t0), T(pc1), T(pc2), T(uv1, torch.float32),
            T(uv2, torch.float32), T(ones), T(ones), T(valid), T(K), T(K),
            fix_scale=fix_scale)
        np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
        assert abs(float(rb.s) - float(ra.s)) < 1e-3
        np.testing.assert_allclose(rb.R.numpy(), np.asarray(ra.R), atol=1e-3)
        np.testing.assert_allclose(rb.t.numpy(), np.asarray(ra.t), atol=1e-3)
        if fix_scale:
            assert abs(float(rb.s) - float(s0)) < 1e-4
    # JAX's bars on the port's free-scale result (with every pair valid)
    rb = sim3_opt.optimize_sim3(T(s0), T(R0), T(t0), T(pc1), T(pc2), T(uv1, torch.float32),
                                T(uv2, torch.float32), T(ones), T(ones),
                                torch.ones(n, dtype=torch.bool), T(K), T(K))
    assert int(rb.n_inliers) > n * 0.9
    assert abs(float(rb.s) - s) < 0.01
    np.testing.assert_allclose(rb.R.numpy(), R, atol=5e-3)
    np.testing.assert_allclose(rb.t.numpy(), t, atol=2e-2)


def test_sim3_jacobians_match_jax(rng):
    """The refinements' closed-form Jacobians against JAX's jacfwd of the
    same residuals at a Sim3 away from the identity (within 1e-4 of the
    largest entry)."""
    n = 40
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
    pc2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                   1).astype(np.float32)
    pc1 = (pc2 + rng.normal(0, 0.1, pc2.shape)).astype(np.float32)
    R, t, s = jlie.sim3_exp(jnp.asarray([0.1, -0.2, 0.15, 0.4, 0.1, -0.3, 0.2], jnp.float32))

    def jax_res(d):
        Rd, td, sd = jlie.sim3_mul(*jlie.sim3_exp(d), R, t, s)
        p2in1 = sd * (pc2 @ Rd.T) + td
        p1in2 = (1.0 / sd) * ((pc1 - td) @ Rd)
        return jnp.concatenate([jsim3_opt._project(K, p2in1), jsim3_opt._project(K, p1in2)], 0)

    captured = {}
    inner = sim3_opt._lm

    def capture(xi, res_and_jac, *a):
        captured["rj"] = res_and_jac
        return inner(xi, res_and_jac, *a)

    sim3_opt._lm = capture
    try:
        z = torch.zeros(n, 2)
        sim3_opt.optimize_sim3(T(s), T(R), T(t), T(pc1), T(pc2), z, z, torch.ones(n),
                               torch.ones(n), torch.ones(n, dtype=torch.bool), T(K), T(K), iters=1)
    finally:
        sim3_opt._lm = inner
    r, J = captured["rj"](T(R), T(t), T(s))
    Jj = np.asarray(jax.jacfwd(jax_res)(jnp.zeros(7)))
    np.testing.assert_allclose(J.numpy(), Jj, rtol=0, atol=1e-4 * np.abs(Jj).max())
    np.testing.assert_allclose(r.numpy(), np.asarray(jax_res(jnp.zeros(7))), rtol=1e-5, atol=1e-3)

    def jax_pts(d):
        Rd, td, sd = jlie.sim3_mul(*jlie.sim3_exp(d), R, t, s)
        return pc1 - (sd * (pc2 @ Rd.T) + td)

    sim3_opt._lm = capture
    try:
        sim3_opt.optimize_sim3_points(T(s), T(R), T(t), T(pc1), T(pc2),
                                      torch.ones(n, dtype=torch.bool), iters=1)
    finally:
        sim3_opt._lm = inner
    r, J = captured["rj"](T(R), T(t), T(s))
    Jj = np.asarray(jax.jacfwd(jax_pts)(jnp.zeros(7)))
    np.testing.assert_allclose(J.numpy(), Jj, rtol=0, atol=1e-4 * np.abs(Jj).max())


def test_optimize_sim3_points_matches_jax(rng):
    """tests/test_sim3_posegraph.py::test_optimize_sim3_points_edge_semantics
    on both packages: the same inliers, the Sim3 within 1e-3."""
    n = 120
    p2 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    w = rng.normal(0, 0.2, 3)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))
    s_gt, t_gt = 1.35, np.array([0.4, -1.2, 2.0], np.float32)
    p1 = (s_gt * p2 @ R_gt.T + t_gt).astype(np.float32)
    p1 += rng.normal(0, 0.01, p1.shape).astype(np.float32)
    out = rng.rand(n) < 0.2
    p1[out] += rng.uniform(1.0, 3.0, (out.sum(), 3)).astype(np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(w + rng.normal(0, 0.05, 3), jnp.float32)))
    t0 = (t_gt + rng.normal(0, 0.2, 3)).astype(np.float32)
    ra = jsim3_opt.optimize_sim3_points(
        jnp.asarray(1.2, jnp.float32), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(p1), jnp.asarray(p2), jnp.ones(n, bool), chi2_th=0.05)
    rb = sim3_opt.optimize_sim3_points(
        torch.tensor(1.2), T(R0), T(t0), T(p1), T(p2), torch.ones(n, dtype=torch.bool),
        chi2_th=0.05)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    assert abs(float(rb.s) - float(ra.s)) < 1e-3
    np.testing.assert_allclose(rb.R.numpy(), np.asarray(ra.R), atol=1e-3)
    np.testing.assert_allclose(rb.t.numpy(), np.asarray(ra.t), atol=1e-3)
    assert abs(float(rb.s) - s_gt) < 0.01
    assert _angle_deg(rb.R.numpy(), R_gt) < 0.5
    np.testing.assert_allclose(rb.t.numpy(), t_gt, atol=0.03)
    inl = rb.inliers.numpy()
    assert inl[~out].mean() > 0.95 and inl[out].mean() < 0.05


def _loop_graph(rng, n=12):
    """tests/test_sim3_posegraph.py::test_pose_graph_closes_loop's graph:
    a drifted chain with true odometry edges and one loop edge."""
    R_gt, t_gt, s_gt = _chain_nodes(rng, n)
    R0, t0, s0 = [R_gt[0]], [t_gt[0]], [s_gt[0]]
    for i in range(1, n):
        noise = rng.normal(0, 0.02, 7).astype(np.float32) * i / n
        noise[6] *= 0.5
        dR, dt, ds = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(noise)))
        R2, t2, s2 = (np.asarray(x) for x in jlie.sim3_mul(
            jnp.asarray(dR), jnp.asarray(dt), jnp.asarray(ds),
            jnp.asarray(R_gt[i]), jnp.asarray(t_gt[i]), jnp.asarray(s_gt[i])))
        R0.append(R2); t0.append(t2); s0.append(np.float32(s2))
    ei, ej, mR, mt, ms = [], [], [], [], []
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        Rr, tr, sr = _rel(R_gt[i], t_gt[i], s_gt[i], R_gt[j], t_gt[j], s_gt[j])
        ei.append(i); ej.append(j)
        mR.append(np.asarray(Rr)); mt.append(np.asarray(tr)); ms.append(float(sr))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    args = (np.stack(R0), np.stack(t0), np.stack(s0).astype(np.float32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.asarray(ms, np.float32), np.ones(len(ei), bool), fixed, np.ones(n, bool))
    return args, (R_gt, t_gt, s_gt)


def _run_both(args, **kw):
    R, t, s, *rest = args
    ja = jpg.optimize_pose_graph(jpg.Sim3Nodes(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)),
                                 *(jnp.asarray(x) for x in rest), **kw)
    pb = pose_graph.optimize_pose_graph(pose_graph.Sim3Nodes(T(R), T(t), T(s)),
                                        *(T(x) for x in rest), **kw)
    for a, b in zip(ja, pb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    return pb


def test_pose_graph_closes_loop_like_jax(rng):
    """tests/test_sim3_posegraph.py::test_pose_graph_closes_loop: the port
    within 1e-4 of JAX, and every node back near the ground truth."""
    args, (R_gt, t_gt, s_gt) = _loop_graph(rng)
    out = _run_both(args)
    for i in range(len(R_gt)):
        assert _angle_deg(out.R[i].numpy(), R_gt[i]) < 0.5, i
        assert np.linalg.norm(out.t[i].numpy() - t_gt[i]) < 0.05, i
        assert abs(float(out.s[i]) - s_gt[i]) < 0.02, i


def test_pose_graph_keeps_fixed_node_like_jax(rng):
    """tests/test_sim3_posegraph.py::test_pose_graph_keeps_fixed_node, and
    the fix_scale and invalid-edge branches on the loop graph."""
    n = 5
    R_gt, t_gt, s_gt = _chain_nodes(rng, n)
    mR, mt, ms = [], [], []
    for i in range(n - 1):
        Rr, tr, sr = _rel(R_gt[i], t_gt[i], s_gt[i], R_gt[i + 1], t_gt[i + 1], s_gt[i + 1])
        mR.append(np.asarray(Rr)); mt.append(np.asarray(tr)); ms.append(float(sr))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    out = _run_both((R_gt, t_gt, s_gt.astype(np.float32), np.arange(n - 1, dtype=np.int32),
                     np.arange(1, n, dtype=np.int32), np.stack(mR).astype(np.float32),
                     np.stack(mt).astype(np.float32), np.asarray(ms, np.float32),
                     np.ones(n - 1, bool), fixed, np.ones(n, bool)))
    np.testing.assert_allclose(out.R[0].numpy(), R_gt[0], atol=1e-5)
    np.testing.assert_allclose(out.t[0].numpy(), t_gt[0], atol=1e-5)
    args, _ = _loop_graph(rng, n=8)
    out = _run_both(args, fix_scale=True, iters=6)
    np.testing.assert_array_equal(out.s.numpy(), args[2])
    ev = args[8].copy()
    ev[[2, 7]] = False
    nv = args[10].copy()
    nv[5] = False
    out = _run_both(args[:8] + (ev, args[9], nv), iters=6)
    np.testing.assert_array_equal(out.R[5].numpy(), args[0][5])


def test_pose_graph_jacobians_match_jax(rng):
    """The closed-form edge Jacobians (inverse left Jacobian of sim(3) and
    two adjoints) against JAX's jacfwd of the same residual on the loop
    graph (float32, within 1e-4 of the largest entry), and against central
    differences of the port's own residual in float64 at a residual of
    |e| ~ 1 (within 1e-6)."""
    args, _ = _loop_graph(rng)
    R, t, s, ei, ej, mR, mt, ms = args[:8]
    e, J = pose_graph._edges_r_and_j(*(T(x) for x in (R[ei], t[ei], s[ei], R[ej], t[ej],
                                                      s[ej], mR, mt, ms)))
    for k in range(len(ei)):
        i, j = ei[k], ej[k]
        f = lambda x: jpg._edge_residual(x[:7], x[7:], R[i], t[i], s[i], R[j], t[j], s[j],  # noqa: E731
                                         mR[k], mt[k], ms[k])
        Jj = np.asarray(jax.jacfwd(f)(jnp.zeros(14)))
        np.testing.assert_allclose(J[k].numpy(), Jj, rtol=0, atol=1e-4 * np.abs(Jj).max())
        np.testing.assert_allclose(e[k].numpy(), np.asarray(f(jnp.zeros(14))), atol=1e-5)
    D = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    t_far = t + np.random.RandomState(0).randn(*t.shape) * 0.3
    edge = [D(x) for x in (R[ei], t_far[ei], s[ei], R[ej], t_far[ej], s[ej], mR, mt, ms)]
    e64, J64 = pose_graph._edges_r_and_j(*edge)
    assert float(e64.abs().max()) > 0.5
    h = 1e-6
    for k in range(14):
        d = torch.zeros(len(ei), 14, dtype=torch.float64)
        d[:, k] = h

        def moved(sign):
            Ri, ti, si = lie.sim3_mul(*lie.sim3_exp(sign * d[:, :7]), *edge[:3])
            Rj, tj, sj = lie.sim3_mul(*lie.sim3_exp(sign * d[:, 7:]), *edge[3:6])
            return pose_graph._edge_residual(Ri, ti, si, Rj, tj, sj, *edge[6:])[0]

        np.testing.assert_allclose(J64[:, :, k].numpy(), ((moved(1) - moved(-1)) / (2 * h)).numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("threads", [1, 4])
def test_pose_graph_same_bits_every_run(rng, threads):
    """Two runs of one pose graph give the same bits, at one torch thread
    or several: its blocks are summed through a presorted plan, with no
    accumulation whose order depends on threads or atomics."""
    args, _ = _loop_graph(rng, n=24)
    R, t, s, *rest = (T(x) for x in args)
    n_thr = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        a, b = (pose_graph.optimize_pose_graph(pose_graph.Sim3Nodes(R, t, s), *rest)
                for _ in range(2))
    finally:
        torch.set_num_threads(n_thr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _guided_problem(rng, n_kp=256, n_shared=90, scale=1.2, n_levels=4):
    """Two keyframes seeing n_shared common points (each with the same
    descriptor up to one flipped bit, at a known Sim3, the keypoint at the
    octave its partner predicts) among random distractor keypoints.
    Returns the arguments of sim3_guided_match as numpy arrays."""
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    hw = np.array([240.0, 320.0], np.float32)
    R12 = small_rotation(rng, 0.1).astype(np.float32)
    s12, t12 = np.float32(1.1), np.array([0.2, -0.05, 0.1], np.float32)
    p2 = np.stack([rng.uniform(-1, 1, n_shared), rng.uniform(-0.7, 0.7, n_shared),
                   rng.uniform(3, 7, n_shared)], 1).astype(np.float32)
    p1 = (s12 * p2 @ R12.T + t12).astype(np.float32)
    desc = rng.randint(0, 2**32, (n_shared, 8), dtype=np.uint32)

    def side(p, p_other, perm):
        uv = rng.uniform(0, [320, 240], (n_kp, 2)).astype(np.float32)
        pc = np.stack([rng.uniform(-2, 2, n_kp), rng.uniform(-1.5, 1.5, n_kp),
                       rng.uniform(3, 7, n_kp)], 1).astype(np.float32)
        d = rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32)
        oct_ = rng.randint(0, n_levels, n_kp).astype(np.int32)
        proj = p @ K.T
        uv[perm] = proj[:, :2] / proj[:, 2:] + rng.normal(0, 0.5, (n_shared, 2))
        pc[perm] = p
        noisy = desc.copy()
        noisy[:, 0] ^= (1 << rng.randint(0, 32, n_shared)).astype(np.uint32)
        d[perm] = noisy
        dist = np.linalg.norm(pc, axis=1)
        maxd = (1.5 * dist).astype(np.float32)
        # the octave the partner's projection predicts for this keypoint
        ratio = 1.5 * np.linalg.norm(p_other, axis=1) / np.linalg.norm(p, axis=1)
        oct_[perm] = np.clip(np.ceil(np.log(ratio) / np.log(scale)), 0, n_levels - 1)
        ok = rng.rand(n_kp) > 0.1
        return (pc, ok, d, (0.5 * dist).astype(np.float32), maxd,
                uv, oct_, np.ones(n_kp, bool), d, K, hw)

    a = side(p1, p2, rng.permutation(n_kp)[:n_shared])
    b = side(p2, p1, rng.permutation(n_kp)[:n_shared])
    return a + b + (s12, R12, t12)


def test_sim3_guided_match_exact(rng):
    """Mutual Sim3-guided matching: the same indices and masks as JAX,
    exactly, and the shared points found."""
    args = _guided_problem(rng)
    th, scale, n_levels = 7.5, 1.2, 4
    ia, va = jmatching.sim3_guided_match(
        *(jnp.asarray(x) for x in args), jnp.asarray(th, jnp.float32),
        jnp.asarray(scale, jnp.float32), jnp.asarray(n_levels, jnp.int32))
    ib, vb = matching.sim3_guided_match(*(T(x) for x in args), th, scale, n_levels)
    va, ia = np.asarray(va), np.asarray(ia)
    np.testing.assert_array_equal(vb.numpy(), va)
    np.testing.assert_array_equal(ib.numpy()[va], ia[va])
    assert va.sum() >= 40
