"""The JAX package's run of the port's two server cells, on the CPU.

    python tests/jax_server_cells.py {swarm,loop} N_POINTS

Runs swarmmap_tpu's Swarm (its SwarmAgents, AgentMediators and
MediatorScheduler, with server GBA) the way the port's server harness
(`swarmmap_tpu_torch.cells.Server`) runs: every agent tracks each frame
(`SwarmAgent.track`), a state report every 5 frames and a push / serve /
distribute round (`Swarm.sync`) every 10, then `Swarm.finish`.  The cells
are the port's (`cells.server_sequences`): "swarm", 3 agents for 60 frames
on synthesize_sequence(seed=0, agent=a), and "loop", one agent for 100
frames on the seed-2 circuit; EuRoC geometry (480x752), 1000 features, 8
levels, N_POINTS landmarks.  Prints a line per round and one JSON line:
frames tracked, groups, fuse events, loops closed and fused, the loop
cell's ATE over its span.  At full width a cell takes 5-6 minutes on two
cores.
"""
import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from swarmmap_tpu.swarm import Swarm, SwarmConfig  # noqa: E402
from swarmmap_tpu.utils import datasets  # noqa: E402
from swarmmap_tpu.utils.config import CameraConfig, OrbConfig, Settings  # noqa: E402
from swarmmap_tpu.utils.trajectory import ate_rmse  # noqa: E402

HW = (480, 752)


def main(cell: str, n_points: int) -> dict:
    if cell == "loop":
        n_frames = 100
        seqs = [datasets.synthesize_sequence(n_frames=n_frames, hw=HW, seed=2, agent=0,
                                             n_points=n_points, motion="circuit")]
    else:
        n_frames = 60
        seqs = [datasets.synthesize_sequence(n_frames=n_frames, hw=HW, seed=0, agent=a,
                                             n_points=n_points) for a in range(3)]
    w = seqs[0].world
    settings = Settings(camera=CameraConfig(fx=float(w.K[0, 0]), fy=float(w.K[1, 1]),
                                            cx=float(w.K[0, 2]), cy=float(w.K[1, 2]),
                                            fps=20.0, width=HW[1], height=HW[0]),
                        orb=OrbConfig(n_features=1000, n_levels=8))
    swarm = Swarm(len(seqs), settings, config=SwarmConfig(push_every=10, report_every=5),
                  run_server_gba=True)
    t0 = time.time()
    poses = [dict() for _ in seqs]
    for i in range(n_frames):
        for a, agent in enumerate(swarm.agents):
            T = agent.track(seqs[a].read(i), float(seqs[a].timestamps[i]))
            if T is not None:
                poses[a][i] = T
        swarm.frame_count += 1
        if swarm.frame_count % 5 == 0:
            for agent in swarm.agents:
                swarm.scheduler.report_state(agent.agent_id, agent.system.get_system_state())
        if swarm.frame_count % 10 == 0:
            swarm.sync()
            print("frame", i, "s", round(time.time() - t0), "groups", swarm.merged_groups(),
                  "loops", [m.loop_closing.n_loops_closed for m in swarm.mediators], flush=True)
    swarm.finish()
    out = dict(cell=cell, n_points=n_points, tracked=[len(p) for p in poses],
               groups=[sorted(g) for g in swarm.merged_groups()],
               fuse_events=[list(e) for e in swarm.map_manager.fuse_events],
               loops=[m.loop_closing.n_loops_closed for m in swarm.mediators],
               n_fused=[m.loop_closing.n_fused for m in swarm.mediators],
               seconds=time.time() - t0)
    if cell == "loop":
        st = swarm.mediators[0].store
        est, gt = [], []
        for k in st.alive_kf_slots():
            fi = int(round(st.kf_ts[k] * 20))
            if fi < n_frames:
                est.append(np.linalg.inv(st.kf_pose_cw[k])[:3, 3])
                gt.append(w.poses_wc[fi][:3, 3])
        est, gt = np.stack(est), np.stack(gt)
        out["ate"] = float(ate_rmse(est, gt))
        out["span"] = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], int(sys.argv[2])), default=str), flush=True)
