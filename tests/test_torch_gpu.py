"""Tests of the port that need a CUDA device: the hand-written LM pose
kernel (csrc/pose_lm.cu) against its plain PyTorch version, and the
batched tracking step on the card against the same step on the CPU.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a CUDA device every test skips.
"""
import numpy as np
import pytest
import torch

from swarmmap_tpu_torch import pipeline
from swarmmap_tpu_torch.ops import lie, pose_kernel, pose_opt

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pose kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda", 0)


def pose_problems(rng, n_agents, n, cold):
    """[A, ...] pose problems: noisy projections with 20% outliers, and a
    perturbed start (motion-model grade, or cold as the 4x10 staged path)."""
    out = []
    for _ in range(n_agents):
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(4, 8, n)], 1)
        K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1]], np.float32)
        R = lie.so3_exp(torch.from_numpy((rng.randn(3) * 0.3).astype(np.float32))).numpy()
        t = np.array([0.2, -0.1, 0.3])
        pc = pts @ R.T + t
        uv = (pc[:, :2] / pc[:, 2:3]) * 450.0 + K[:2, 2]
        uv += rng.normal(0, 0.5, uv.shape)
        bad = rng.rand(n) < 0.2
        uv[bad] += rng.uniform(15, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        s_w, s_t = (0.05, 0.15) if cold else (0.02, 0.05)
        xi = np.concatenate([rng.randn(3) * s_w, rng.randn(3) * s_t]).astype(np.float32)
        T0 = lie.se3_exp(torch.from_numpy(xi)).numpy() @ T
        is2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n).astype(np.float32)
        out.append((T0.astype(np.float32), K, pts.astype(np.float32),
                    uv.astype(np.float32), is2, rng.rand(n) < 0.95))
    return [torch.from_numpy(np.stack(x)) for x in zip(*out)]


@pytest.mark.parametrize("rounds,iters,min_agree", [(2, 8, 0.99), (4, 10, 0.98)])
def test_pose_kernel_matches_plain(cuda, rounds, iters, min_agree):
    rng = np.random.RandomState(40 + rounds)
    args = [x.to(cuda) for x in pose_problems(rng, 3, 1024, cold=(rounds == 4))]
    before = pose_kernel.pose_lm_launches
    k = pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > min_agree
    ok = k.inliers & p.inliers
    torch.testing.assert_close(k.chi2[ok], p.chi2[ok], rtol=1e-2, atol=1e-2)


def test_pose_kernel_refuses_bad_inputs(cuda):
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(1), 2, 300, False)]
    before = pose_kernel.pose_lm_launches
    bad_dtype = list(args)
    bad_dtype[2] = args[2].double()
    bad_layout = list(args)
    bad_layout[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    bad_shape = list(args)
    bad_shape[4] = args[4][:, :-1]
    for bad in (bad_dtype, bad_layout, bad_shape):
        with pytest.raises(ValueError):
            pose_kernel.pose_optimize_cuda(*bad)
    assert pose_kernel.pose_lm_launches == before


def test_batched_step_on_gpu_matches_cpu(cuda):
    """Small-size batched tracking step: one kernel launch, and the same
    pose and inliers as the CPU step (plain versions throughout)."""
    kw = dict(n_features=256, n_levels=3, hw=(240, 320))
    inp = pipeline.stack_inputs([
        pipeline.realistic_track_inputs(hw=(240, 320), n_map_points=512, n_features=256,
                                        n_levels=3, seed=s) for s in range(3)])
    cpu = pipeline.batched_tracking_step(inp, **kw)
    before = pose_kernel.pose_lm_launches
    gpu = pipeline.batched_tracking_step(pipeline.TrackInputs(*(x.to(cuda) for x in inp)), **kw)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((gpu.Tcw.cpu() - cpu.Tcw).abs().max()) < 5e-3
    diff = (gpu.n_inliers.cpu() - cpu.n_inliers).abs()
    assert bool((diff <= torch.clamp(0.05 * cpu.n_inliers, min=3)).all())
    assert int(cpu.n_inliers.min()) >= 20
