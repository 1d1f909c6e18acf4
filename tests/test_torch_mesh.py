"""Multi-device: the port's device-list meshes (swarmmap_tpu_torch.parallel)
against the JAX package's meshes on the CPU.

The port shards over lists of repeated CPU devices (`["cpu"] * 8`), the
JAX package over the 8 virtual CPU devices of tests/conftest.py.  Sizes
are the dry runs' small ones (the port's `--small`, the JAX package's
`SWARMMAP_DRYRUN_SMALL`): 240x320, 256 features, 3 levels, 512 map
points, `realistic_track_inputs` seeds 0-7.

Bars: the sharded step's integer outputs (n_inliers, match_mp, the
overlap hint, the total) equal JAX's sharded step's and the port's plain
step's; Tcw within the pipeline parity test's 5e-3 of JAX's, and within
1e-4 of the port's plain step (on the CPU the plain pose solve of one
agent and of a batch round differently, up to 5.2e-5 here; each shard's
rows are its own batched step bit for bit).  The observation-sharded BA
on tests/test_ba.py's problem: Tcw within 2e-3, points within 5e-3 and
inlier agreement above 0.99 against JAX's sharded BA and the port's
one-device CG (shard partials are summed in another order), and the
same bits on two runs at 4 torch threads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from swarmmap_tpu import pipeline as jpipe
from swarmmap_tpu.ops import ba as jba
from swarmmap_tpu.parallel import mesh as jmesh
from swarmmap_tpu_torch import convert, pipeline
from swarmmap_tpu_torch.ops import ba
from swarmmap_tpu_torch.parallel import dryrun, mesh
from test_ba import cam_errors, make_ba_problem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
KW = dict(n_features=256, n_levels=3, hw=HW)
N = 8
TCW_JAX = 5e-3      # tests/test_torch_pipeline.py's step parity bar
TCW_PLAIN = 1e-4
BA_BARS = {"Tcw": 2e-3, "pts": 5e-3, "agree": 0.99}   # tests/test_ba.py:149-185


def cpus(n: int) -> list[str]:
    return ["cpu"] * n


@pytest.fixture(scope="module")
def jax_inputs():
    single = [jpipe.realistic_track_inputs(hw=HW, n_map_points=512, n_features=256,
                                           n_levels=3, seed=s) for s in range(N)]
    return jpipe.TrackInputs(*(jnp.stack(xs) for xs in zip(*single)))


@pytest.fixture(scope="module")
def jax_sharded(jax_inputs):
    step = jpipe.make_multi_agent_step(**KW, mesh=JMesh(np.array(jax.devices()[:N]), ("agents",)))
    out, overlap, total = step(jax_inputs)
    return out, np.asarray(overlap), int(total)


@pytest.fixture(scope="module")
def port_inputs(jax_inputs):
    return convert.track_inputs_from_numpy(jax_inputs, device="cpu")


@pytest.fixture(scope="module")
def port_plain(port_inputs):
    return pipeline.make_multi_agent_step(**KW)(port_inputs)


def test_sharded_step_matches_jax(jax_sharded, port_inputs):
    """The port's step over an 8-entry agent mesh against JAX's
    shard_map'd step over 8 devices: integer outputs and the overlap hint
    equal, Tcw within the parity bar."""
    a, ov_a, tot_a = jax_sharded
    out, ov_b, tot_b = pipeline.make_multi_agent_step(
        **KW, mesh=mesh.agent_mesh(devices=cpus(N)))(port_inputs)
    np.testing.assert_array_equal(out.n_inliers.numpy(), np.asarray(a.n_inliers))
    np.testing.assert_array_equal(out.match_mp.numpy(), np.asarray(a.match_mp))
    np.testing.assert_array_equal(ov_b.numpy(), ov_a)
    assert int(tot_b) == tot_a == int(np.asarray(a.n_inliers).sum())
    assert np.abs(out.Tcw.numpy() - np.asarray(a.Tcw)).max() < TCW_JAX
    assert ov_b.shape == (N, N) and min(out.n_inliers.tolist()) > 0


@pytest.mark.parametrize("n_shards", [8, 4])
def test_sharded_step_equals_plain(port_inputs, port_plain, n_shards):
    """The mesh branch against the plain branch on the same 8 agents: the
    integer outputs, the keypoints, descriptors and the overlap hint
    equal, IC angles within 1e-4 degrees (atan2 on the CPU rounds a batch
    of one and of eight apart in the last bit), Tcw within TCW_PLAIN; each
    shard's rows are its own batched step, in agent order."""
    m = mesh.agent_mesh(devices=cpus(n_shards))
    out, overlap, total = pipeline.make_multi_agent_step(**KW, mesh=m)(port_inputs)
    ref, ref_overlap, ref_total = port_plain
    assert torch.equal(out.n_inliers, ref.n_inliers)
    assert torch.equal(out.match_mp, ref.match_mp)
    assert torch.equal(overlap, ref_overlap)
    assert int(total) == int(ref_total)
    for f in ("xy", "response", "octave", "desc", "valid"):
        assert torch.equal(getattr(out.features, f), getattr(ref.features, f)), f
    assert torch.equal(out.xy_ud, ref.xy_ud)
    assert (out.features.angle - ref.features.angle).abs().max() < 1e-4
    assert (out.Tcw - ref.Tcw).abs().max() < TCW_PLAIN
    k = N // n_shards
    for i, shard in enumerate(mesh.shard_agents(m, port_inputs)):
        one = pipeline.batched_tracking_step(shard, **KW)
        assert torch.equal(out.Tcw[i * k:(i + 1) * k], one.Tcw)


def test_shard_agents_splits_contiguous_chunks():
    """shard_agents puts contiguous chunks of the leading axis on each
    entry (JAX's P("agents")), and refuses an axis that does not divide."""
    tree = pipeline.PoseProblem(*(torch.arange(12).reshape(6, 2) + i for i in range(6)))
    m = mesh.agent_mesh(devices=cpus(3))
    parts = mesh.shard_agents(m, tree)
    assert len(parts) == 3 and all(type(p) is pipeline.PoseProblem for p in parts)
    for i, part in enumerate(parts):
        for x, full in zip(part, tree):
            assert torch.equal(x, full[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="must divide"):
        mesh.shard_agents(mesh.agent_mesh(devices=cpus(4)), tree)


@pytest.mark.parametrize("n_dev,size", [(3, 2), (5, 4), (6, 4), (8, 8)])
def test_obs_mesh_takes_largest_power_of_two(n_dev, size):
    """obs_mesh keeps the largest power of two of the devices, as JAX's
    does over as many of its virtual devices; agent_mesh keeps them all."""
    m = mesh.obs_mesh(devices=cpus(n_dev))
    assert m.size() == size and m.axis_names == ("obs",)
    assert jmesh.obs_mesh(n_dev).devices.size == size
    assert mesh.obs_mesh(n_dev, devices=cpus(8)).size() == size
    assert mesh.agent_mesh(devices=cpus(n_dev)).size() == n_dev


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py::test_sharded_gba_matches_single_device's problem
    (12 cameras, 300 points, padded to power-of-two buckets)."""
    rng = np.random.RandomState(42)
    prob, Tcw_gt, pts_gt = make_ba_problem(rng, n_cams=12, n_pts=300)
    prob = jba.build_padded_problem(
        *(np.asarray(getattr(prob, k)) for k in
          ("Tcw", "K", "cam_fixed", "pts", "obs_cam", "obs_pt", "obs_uv", "obs_inv_sigma2")))
    return prob, Tcw_gt, pts_gt


def _to_port(prob) -> ba.BAProblem:
    f = {k: torch.from_numpy(np.array(getattr(prob, k))) for k in prob._fields}
    f["obs_cam"], f["obs_pt"] = f["obs_cam"].long(), f["obs_pt"].long()
    return ba.BAProblem(**f)


def _assert_ba_agrees(res, ref):
    Tcw, pts, inl = (np.asarray(x) for x in (ref.Tcw, ref.pts, ref.obs_inlier))
    assert np.abs(res.Tcw.numpy()[:12] - Tcw[:12]).max() < BA_BARS["Tcw"]
    assert np.abs(res.pts.numpy()[:300] - pts[:300]).max() < BA_BARS["pts"]
    assert (res.obs_inlier.numpy() == inl).mean() > BA_BARS["agree"]


def test_sharded_ba_matches_jax_and_one_device(ba_problem):
    """bundle_adjust_sharded over an 8-entry obs mesh converges like
    tests/test_ba.py's sharded BA, and agrees with JAX's sharded BA over 8
    devices and with the port's one-device CG."""
    prob, Tcw_gt, pts_gt = ba_problem
    pb = _to_port(prob)
    res = ba.bundle_adjust_sharded(pb, mesh.obs_mesh(devices=cpus(8)), cg_iters=40)
    assert res.obs_chi2.shape == pb.obs_cam.shape == res.obs_inlier.shape
    angs, dts = cam_errors(res.Tcw.numpy()[:12], Tcw_gt)
    assert angs.max() < 0.15 and dts.max() < 0.02, (angs, dts)
    assert np.median(np.linalg.norm(res.pts.numpy()[:300] - pts_gt, axis=1)) < 0.03
    _assert_ba_agrees(res, jba.bundle_adjust_sharded(
        prob, JMesh(np.array(jax.devices()[:8]), ("obs",)), cg_iters=40))
    _assert_ba_agrees(res, ba.bundle_adjust(pb, mode="cg", cg_iters=40))


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_ba_same_bits_every_run(n_shards):
    """Two runs of the sharded BA give the same bits at 4 torch threads:
    each shard's segment sums are copies to unique slots and sums, and the
    shards' partials add in shard order.  The problem (8192 observation
    slots) is large enough for torch's CPU kernels to split their work."""
    prob, _, _ = make_ba_problem(np.random.RandomState(3), n_cams=16, n_pts=600)
    pb = ba.build_padded_problem(
        *(np.asarray(getattr(prob, k)) for k in
          ("Tcw", "K", "cam_fixed", "pts", "obs_cam", "obs_pt", "obs_uv", "obs_inv_sigma2")),
        device="cpu")
    assert pb.obs_cam.shape[0] == 8192
    m = mesh.obs_mesh(devices=cpus(n_shards))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        r1, r2 = (ba.bundle_adjust_sharded(pb, m) for _ in range(2))
    finally:
        torch.set_num_threads(n)
    for f in ba.BAResult._fields:
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f


def test_sharded_ba_refuses_an_axis_that_does_not_divide(ba_problem):
    """A mesh whose size does not divide the observation axis is refused
    with JAX's ValueError, on both packages."""
    prob, _, _ = ba_problem
    three = mesh.Mesh((torch.device("cpu"),) * 3, ("obs",))
    msg = f"obs axis {prob.obs_cam.shape[0]} must divide mesh size 3"
    with pytest.raises(ValueError, match=msg):
        ba.bundle_adjust_sharded(_to_port(prob), three)
    with pytest.raises(ValueError, match=msg):
        jba.bundle_adjust_sharded(prob, JMesh(np.array(jax.devices()[:3]), ("obs",)))


def test_dryrun_on_eight_cpu_entries(jax_sharded, capsys):
    """parallel/dryrun.py at the small size on cpu x 8: the sharded step
    tracks every agent with JAX's sharded inliers, and the two-map group
    GBA sharded over 8 entries closes the duplicate gap (1,909
    observations in a 2,048 bucket, as MULTICHIP_r05.json's JAX run)."""
    got = dryrun.dryrun_multichip(N, ["cpu"], small=True)
    assert got["per_agent"] == np.asarray(jax_sharded[0].n_inliers).tolist()
    assert got["total"] == jax_sharded[2]
    assert got["gap"] < 1e-3
    printed = capsys.readouterr().out
    assert f"dryrun_multichip OK: {N} agents sharded over {N} devices" in printed
    assert "dryrun group GBA OK: 2 maps merged" in printed
