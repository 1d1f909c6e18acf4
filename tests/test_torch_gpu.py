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
from swarmmap_tpu_torch.bench_pose import pose_problems
from swarmmap_tpu_torch.ops import pose_kernel, pose_opt

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pose kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [300, 1000, 1024, 2048])
@pytest.mark.parametrize("n_agents", [1, 3, 8])
@pytest.mark.parametrize("rounds,iters,min_agree", [(2, 8, 0.99), (4, 10, 0.98)])
def test_pose_kernel_matches_plain(cuda, rounds, iters, min_agree, n_agents, n):
    """Ragged (300), EuRoC/TUM (1000 features: N = 1000 and its padded 1024,
    the 4-points-per-thread build) and KITTI (2048, the 8-points build)
    widths, at 1, 3 and 8 agents."""
    rng = np.random.RandomState(40 + rounds + n + n_agents)
    args = [x.to(cuda) for x in pose_problems(rng, n_agents, n, cold=(rounds == 4))]
    before = pose_kernel.pose_lm_launches
    k = pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > min_agree
    ok = k.inliers & p.inliers
    torch.testing.assert_close(k.chi2[ok], p.chi2[ok], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rounds,iters", [(0, 8), (1, 1)])
def test_pose_kernel_edge_schedules(cuda, rounds, iters):
    """rounds = 0 returns T0 and the inliers gated at T0; 1x1 is one step."""
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(3), 3, 1000, False)]
    k = pose_kernel.pose_optimize_cuda(*args, rounds=rounds, iters=iters)
    p = pose_opt.pose_optimize(*args, rounds=rounds, iters=iters, step_tol=0.0)
    torch.cuda.synchronize()
    if rounds == 0:
        assert torch.equal(k.Tcw, args[0])
    assert float((k.Tcw - p.Tcw).abs().max()) < 1e-3
    assert float((k.inliers == p.inliers).float().mean()) > 0.99
    torch.testing.assert_close(k.chi2, p.chi2, rtol=1e-2, atol=1e-2)


def test_pose_kernel_refuses_more_points_than_its_builds(cuda):
    args = [x.to(cuda) for x in pose_problems(np.random.RandomState(2), 1, 2049, False)]
    before = pose_kernel.pose_lm_launches
    with pytest.raises(ValueError, match="at most 2048"):
        pose_kernel.pose_optimize_cuda(*args)
    assert pose_kernel.pose_lm_launches == before


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
                                        n_levels=3, seed=s, device="cpu")
        for s in range(3)])
    cpu = pipeline.batched_tracking_step(inp, **kw)
    before = pose_kernel.pose_lm_launches
    gpu = pipeline.batched_tracking_step(pipeline.TrackInputs(*(x.to(cuda) for x in inp)), **kw)
    torch.cuda.synchronize()
    assert pose_kernel.pose_lm_launches == before + 1
    assert float((gpu.Tcw.cpu() - cpu.Tcw).abs().max()) < 5e-3
    diff = (gpu.n_inliers.cpu() - cpu.n_inliers).abs()
    assert bool((diff <= torch.clamp(0.05 * cpu.n_inliers, min=3)).all())
    assert int(cpu.n_inliers.min()) >= 20
