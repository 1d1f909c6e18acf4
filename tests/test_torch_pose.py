"""Parity of the port's Lie algebra and LM pose optimiser
(swarmmap_tpu_torch.ops.lie / pose_opt / pose_kernel) with the JAX package
on the CPU.  The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_gpu.py, which imports no JAX so that it runs there too.

Tolerances: |dTcw| < 1e-3 and inlier agreement > 0.99 (> 0.98 for the
cold-start 4x10 schedule), because the two sides sum the normal equations
in different orders in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import lie as jlie
from swarmmap_tpu.ops import pallas_pose
from swarmmap_tpu.ops import pose_opt as jpose
from swarmmap_tpu_torch.ops import lie, pose_kernel, pose_opt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEDULES = [(2, 8), (4, 10)]


def setup(rng, n=256, noise=0.5, outlier_frac=0.2, cold=False):
    """Noisy projections of random points with outliers, and a perturbed
    initial pose (motion-model grade, or cold for 4x10)."""
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1
    )
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.3, jnp.float32)))
    t = np.array([0.2, -0.1, 0.3])
    pc = pts @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3]) @ np.diag([450.0, 450.0]) + K[:2, 2]
    uv += rng.normal(0, noise, uv.shape)
    out = rng.rand(n) < outlier_frac
    uv[out] += rng.uniform(15, 60, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    s_w, s_t = (0.05, 0.15) if cold else (0.02, 0.05)
    xi = np.concatenate([rng.randn(3) * s_w, rng.randn(3) * s_t]).astype(np.float32)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(xi))) @ T
    is2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n).astype(np.float32)
    valid = rng.rand(n) < 0.95
    return (T0.astype(np.float32), K, pts.astype(np.float32), uv.astype(np.float32),
            is2, valid)


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _agree(a, b, tol_T, min_agree):
    err = np.abs(np.asarray(a.Tcw) - b.Tcw.numpy()).max()
    agree = (np.asarray(a.inliers) == b.inliers.numpy()).mean()
    assert err < tol_T, err
    assert agree > min_agree, agree
    np.testing.assert_allclose(b.chi2.numpy(), np.asarray(a.chi2), rtol=1e-2, atol=1e-2)


def test_lie_matches(rng):
    w = (rng.randn(16, 3) * 0.8).astype(np.float32)
    w[:3] = [[0, 0, 0], [1e-6, 0, 0], [0, 2e-5, -1e-5]]
    xi = (rng.randn(16, 6) * 0.5).astype(np.float32)
    xi7 = (rng.randn(16, 7) * 0.4).astype(np.float32)
    xi7[:2, 6] = 0.0
    tw, txi, txi7 = (torch.from_numpy(x) for x in (w, xi, xi7))
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lie.so3_exp(tw).numpy(), np.asarray(jlie.so3_exp(w)), **close)
    T = lie.se3_exp(txi)
    jT = jlie.se3_exp(xi)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), **close)
    np.testing.assert_allclose(lie.se3_log(T).numpy(), np.asarray(jlie.se3_log(jT)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lie.se3_inv(T).numpy(), np.asarray(jlie.se3_inv(jT)), **close)
    R = lie.so3_exp(tw)
    np.testing.assert_allclose(lie.so3_log(R).numpy(), np.asarray(jlie.so3_log(jnp.asarray(R.numpy()))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lie.mat_to_quat(R).numpy(),
                               np.asarray(jlie.mat_to_quat(jnp.asarray(R.numpy()))), **close)
    Rs, ts, ss = lie.sim3_exp(txi7)
    jR, jt, js = jlie.sim3_exp(xi7)
    for a, b in ((Rs, jR), (ts, jt), (ss, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    np.testing.assert_allclose(lie.sim3_log(Rs, ts, ss).numpy(),
                               np.asarray(jlie.sim3_log(jR, jt, js)), rtol=1e-5, atol=1e-5)
    p = (rng.randn(16, 3) * 2 + [0, 0, 5]).astype(np.float32)
    np.testing.assert_allclose(lie.transform(T, torch.from_numpy(p)).numpy(),
                               np.asarray(jlie.transform(jT, p)), **close)
    K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(lie.project(torch.from_numpy(K), torch.from_numpy(p)).numpy(),
                               np.asarray(jlie.project(K, p)), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rounds,iters", SCHEDULES)
def test_pose_optimize_matches_jax(rounds, iters):
    rng = np.random.RandomState(10 * rounds + iters)
    for _ in range(3):
        args = setup(rng, cold=(rounds, iters) == (4, 10))
        a = jpose.pose_optimize(*(jnp.asarray(x) for x in args), rounds=rounds, iters=iters)
        b = pose_opt.pose_optimize(*_torch(args), rounds=rounds, iters=iters)
        _agree(a, b, 1e-3, 0.99)


@pytest.mark.parametrize("rounds,iters,n", [
    pytest.param(2, 8, 512, id="2-8"), pytest.param(4, 10, 512, id="4-10"),
    pytest.param(2, 8, 2048, id="2-8-n2048"), pytest.param(4, 10, 2048, id="4-10-n2048"),
])
def test_fixed_schedule_matches_pallas_interpret(rounds, iters, n):
    """The kernel's plain counterpart, pose_optimize(step_tol=0), against
    the TPU kernel run in interpret mode; N = 2048 is KITTI's width (2000
    features), the CUDA kernel's 8-points-per-thread build."""
    rng = np.random.RandomState(300 + rounds)
    for _ in range(2):
        args = setup(rng, n=n, cold=(rounds, iters) == (4, 10))
        a = pallas_pose.pose_optimize_pallas(*(jnp.asarray(x) for x in args),
                                             rounds=rounds, iters=iters, interpret=True)
        b = pose_opt.pose_optimize(*_torch(args), rounds=rounds, iters=iters, step_tol=0.0)
        _agree(a, b, 1e-3, 0.99 if (rounds, iters) == (2, 8) else 0.98)


def test_batched_agents_converge_independently():
    """Over an agent axis each agent stops on its own (vmap of the JAX
    while_loop), and a stopped agent's carry stays frozen.  The agents
    start at different distances from the optimum (motion-model grade,
    cold, at the optimum); with this seed agents 0 and 1 stop after the
    4th step of round 2 while agent 2 runs all 8."""
    rng = np.random.RandomState(5)
    probs = [setup(rng, n=200, cold=c) for c in (False, True, False)]
    exact = jpose.pose_optimize(*(jnp.asarray(x) for x in probs[2]), rounds=2, iters=8)
    probs[2] = (np.asarray(exact.Tcw),) + probs[2][1:]
    stacked = [np.stack(x) for x in zip(*probs)]
    a = jax.vmap(lambda *x: jpose.pose_optimize(*x, rounds=2, iters=8))(
        *(jnp.asarray(x) for x in stacked))
    b = pose_opt.pose_optimize(*_torch(stacked), rounds=2, iters=8)
    for i in range(3):
        _agree(jpose.PoseOptResult(*(x[i] for x in a)),
               pose_opt.PoseOptResult(*(x[i] for x in b)), 1e-3, 0.99)


def test_auto_dispatch_on_cpu_runs_plain_version():
    rng = np.random.RandomState(6)
    args = _torch(setup(rng))
    before = pose_kernel.pose_lm_launches
    a = pose_opt.pose_optimize_auto(*args, rounds=2, iters=8)
    b = pose_opt.pose_optimize(*args, rounds=2, iters=8)
    assert pose_kernel.pose_lm_launches == before
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("n,ppt", [(1, 4), (300, 4), (1000, 4), (1024, 4), (1025, 8), (2048, 8)])
def test_launch_config_picks_the_instantiation(n, ppt):
    assert pose_kernel.launch_config(n) == pose_kernel.LaunchConfig(ppt=ppt, threads=256)


@pytest.mark.parametrize("n", [2049, 4096, 100_000])
def test_launch_config_streams_more_than_2048_points(n):
    """Above the register builds' 2048 points the streaming build takes
    any N (no upper limit)."""
    assert pose_kernel.launch_config(n) == pose_kernel.LaunchConfig(
        ppt=pose_kernel.STREAMING, threads=256)


@pytest.mark.parametrize("rounds,iters", [(0, 8), (1, 1), (2, 8)])
def test_pose_bound_charges_what_the_data_needs(rounds, iters):
    """bench_pose.bound: a full pass per LM step over each round's active
    points only; the outliers gated out after round 0 cost one chi2."""
    from swarmmap_tpu_torch import bench_pose as bp

    prob = bp.pose_problems(np.random.RandomState(8), 2, 256, cold=False)
    A, N = prob[5].shape
    valid = int(prob[5].sum())
    active = bp.active_per_round(prob, rounds, iters)
    assert len(active) == rounds and active[:1] == [valid][:rounds]
    if rounds == 2:  # the 20% outliers leave the active set after round 0
        assert 0.7 * valid < active[1] < 0.9 * valid
    last = active[-1] if active else 0
    flops = (sum(active) * (iters + 1) * bp.FLOP_PER_POINT_PASS
             + (A * N - last) * bp.FLOP_CHI2 + A * rounds * iters * bp.FLOP_PER_STEP)
    nbytes = A * N * bp.BYTES_PER_POINT + A * bp.BYTES_PER_AGENT
    ms, by = bp.bound(prob, rounds, iters)
    assert ms == pytest.approx(1e3 * max(flops / bp.PEAK_FP32_FLOPS, nbytes / bp.PEAK_BYTES_PER_S))
    assert by == ("operations" if flops / bp.PEAK_FP32_FLOPS >= nbytes / bp.PEAK_BYTES_PER_S
                  else "bytes")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper has no CPU fallback: it raises."""
    rng = np.random.RandomState(7)
    args = [x[None] for x in _torch(setup(rng))]
    before = pose_kernel.pose_lm_launches
    with pytest.raises(ValueError, match="expected a tensor on"):
        pose_kernel.pose_optimize_cuda(*args)
    assert pose_kernel.pose_lm_launches == before
