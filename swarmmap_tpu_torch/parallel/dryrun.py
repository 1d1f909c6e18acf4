"""Multi-device dry run: the agent-sharded tracking step at full width,
then one observation-sharded joint GBA over two merged maps.

    python -m swarmmap_tpu_torch.parallel.dryrun [--devices DEV ...] [--n 8] [--small]

The mesh has `--n` entries taken in turn from `--devices` (by default
every visible card): `--devices cuda:0 --n 8` shards 8 agents over 8
entries of one card, `--devices cpu --n 8` runs on the CPU.  Phase 1 runs
`pipeline.make_multi_agent_step` over an agent mesh on
`realistic_track_inputs` seeds 0..n-1 at EuRoC geometry (480x752, 1000
features, 8 levels, 2048 map points; --small: 240x320, 256 features,
3 levels, 512 map points) and asserts that every
agent tracks.  Phase 2 builds two map replicas sharing 300 landmarks,
merges them into one group and runs `MapManager.group_global_ba` sharded
over `obs_mesh(n)`; the duplicate copies must coincide within 1e-3.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .mesh import agent_mesh, obs_mesh, visible_devices


def mesh_devices(n: int, devices=None) -> list[torch.device]:
    """n entries taken in turn from `devices` (by default every visible
    card)."""
    devs = visible_devices() if devices is None else [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("no CUDA device: pass --devices cpu to run on the CPU")
    return [devs[i % len(devs)] for i in range(n)]


def dryrun_multichip(n_devices: int, devices=None, small: bool = False) -> dict:
    """Phase 1 (the sharded step) and phase 2 (`dryrun_group_gba`); prints
    one line per phase and returns their numbers."""
    from .. import pipeline

    devs = mesh_devices(n_devices, devices)
    hw = (240, 320) if small else (480, 752)
    n_feat, n_lvl, n_mp = (256, 3, 512) if small else (1000, 8, 2048)
    mesh = agent_mesh(devices=devs)
    step = pipeline.make_multi_agent_step(
        n_features=n_feat, n_levels=n_lvl, scale=1.2, hw=hw, mesh=mesh)
    batched = pipeline.stack_inputs([
        pipeline.realistic_track_inputs(hw=hw, n_map_points=n_mp, seed=i, n_features=n_feat,
                                        n_levels=n_lvl, device=mesh.lead)
        for i in range(n_devices)])
    out, overlap, total = step(batched)
    assert tuple(out.Tcw.shape) == (n_devices, 4, 4)
    total = int(total)
    per_agent = out.n_inliers.tolist()
    assert total > 0, f"sharded tracking found no inliers: {per_agent}"
    assert min(per_agent) > 0, f"an agent shard tracked nothing: {per_agent}"
    print(f"dryrun_multichip OK: {n_devices} agents sharded over {n_devices} devices; "
          f"poses {tuple(out.Tcw.shape)}, per-agent inliers {per_agent}, global inliers "
          f"{total}, overlap {tuple(overlap.shape)}", flush=True)
    gap = dryrun_group_gba(n_devices, devs)
    return {"per_agent": per_agent, "total": total, "overlap": overlap.tolist(), "gap": gap}


def two_map_group(device, seed: int = 11, n_pts: int = 300, n_kp: int = 256):
    """Two map replicas of one landmark field (map 0 owns the points, map 1
    holds foreign duplicate copies), 4 keyframes each with noisy poses
    but map 0's first two, merged into group 0 of a MapManager on
    `device`.  Returns (manager, store 0, store 1)."""
    from .. import MAP_BASE
    from ..core.map_store import MapStore
    from ..server.map_manager import MapManager

    rng = np.random.RandomState(seed)
    pts_w = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                      rng.uniform(5, 9, n_pts)], 1).astype(np.float32)
    K = np.array([[450.0, 0, 160], [0, 450.0, 120], [0, 0, 1]], np.float32)
    mgr = MapManager(device=device)
    st0 = MapStore(map_id=0, n_kp=n_kp)
    st1 = MapStore(map_id=1, n_kp=n_kp)
    mgr.register(st0)
    mgr.register(st1)
    st1.group_id = st0.group_id = 0
    mgr.groups = {0: {0, 1}}
    for st, cams, anchor in ((st0, range(4), True), (st1, range(4, 8), False)):
        slots = [
            st.add_map_point(
                pts_w[i] + rng.normal(0, 0.01, 3).astype(np.float32),
                np.asarray(rng.randint(0, 2**32, 8, dtype=np.uint32)),
                ref_kf=-1, gid=MAP_BASE * 0 + i)
            for i in range(n_pts)
        ]
        for c in cams:
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = [-0.3 * c + 1.0, 0.0, 0.0]
            pc = pts_w @ T[:3, :3].T + T[:3, 3]
            uv = (pc[:, :2] / pc[:, 2:3]) * 450.0 + K[:2, 2]
            vis = np.where((pc[:, 2] > 0.5) & (np.abs(uv[:, 0] - 160) < 170)
                           & (np.abs(uv[:, 1] - 120) < 130))[0][:n_kp]
            kp_uv = np.zeros((n_kp, 2), np.float32)
            kp_uv[: len(vis)] = uv[vis] + rng.normal(0, 0.3, (len(vis), 2))
            valid = np.zeros(n_kp, bool)
            valid[: len(vis)] = True
            T0 = T.copy()
            if not (anchor and c < 2):  # the two gauge anchors stay exact
                T0[:3, 3] += rng.normal(0, 0.02, 3)
            k = st.add_keyframe(
                pose_cw=T0, K=K, kp_uv=kp_uv,
                kp_octave=np.zeros(n_kp, np.int32),
                kp_angle=np.zeros(n_kp, np.float32),
                kp_response=np.ones(n_kp, np.float32), kp_valid=valid,
                desc=rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32))
            for kp, j in enumerate(vis):
                st.add_observation(slots[j], k, kp)
    return mgr, st0, st1


def dryrun_group_gba(n_devices: int, devices) -> float:
    """`two_map_group` jointly optimised with the observation axis sharded
    over obs_mesh(n_devices) of `devices`; returns the mean distance of
    the duplicate copies after the pass."""
    mesh = obs_mesh(n_devices, devices=devices)
    assert mesh.size() == n_devices, mesh
    mgr, st0, st1 = two_map_group(mesh.lead)
    ok = mgr.group_global_ba(0, iters=4, mesh=mesh)
    assert ok, "sharded joint group GBA did not apply"
    n = st0.n_mp
    gap = float(np.linalg.norm(st0.mp_global_pos(np.arange(n))
                               - st1.mp_global_pos(np.arange(n)), axis=1).mean())
    assert gap < 1e-3, f"duplicate copies disagree after joint GBA: {gap}"
    print(f"dryrun group GBA OK: 2 maps merged, joint BA sharded over {n_devices} devices "
          f"('obs' axis), duplicate gap {gap:.2e}", flush=True)
    return gap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=None,
                    help="devices the mesh entries are taken from in turn (default: every card)")
    ap.add_argument("--n", type=int, default=8, help="mesh entries (agents, shards)")
    ap.add_argument("--small", action="store_true",
                    help="240x320, 256 features, 3 levels, 512 map points")
    args = ap.parse_args(argv)
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    dryrun_multichip(args.n, args.devices, args.small)


if __name__ == "__main__":
    main()
