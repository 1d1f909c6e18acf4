"""tests/test_scale_gauge.py's end-to-end case on the port: the monocular
scale holds over a circuit while the server re-runs GBA on every push.

Seed 11 was the JAX package's canonical collapse (scale ratio 0.13
end/start before the gauge projection of `loop_closing.global_ba`).  A
port client (`SwarmAgent`, device="cpu") on the 240x320 circuit (100
frames, 700 landmarks, 400 features, 4 levels) pushes every 10 frames to
the port's server with GBA on (`cells.Server`); the keyframe spacing's
scale at the end must stay within 0.5x-2x of the start's and the loop
must close, the JAX test's bars.  The projection itself is held to the
JAX package's in tests/test_torch_server.py.  The run takes two torch
threads, as tests/test_torch_loop_closing.py's.
"""
import numpy as np
import torch

from swarmmap_tpu_torch import cells
from swarmmap_tpu_torch.utils import datasets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_circuit_scale_stays_stable_under_push_gba():
    n_frames = 100
    seq = datasets.synthesize_sequence(n_frames=n_frames, hw=(240, 320), seed=11, agent=0,
                                       n_points=700, motion="circuit")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with cells.FrameClock() as clock:
            srv = cells.Server(1, cells.settings_for(seq.world, 400, 4), "cpu", clock=clock)
            cells.serve_sequences(srv, [seq], push_every=10, report_every=5)
            srv.finish()
    finally:
        torch.set_num_threads(n)
    st = srv.agents[0].system.store
    alive = np.where(st.kf_alive[: st.n_kf])[0]
    T = st.kf_pose_cw[alive]
    c_est = -np.einsum("kij,kj->ki", T[:, :3, :3].transpose(0, 2, 1), T[:, :3, 3])
    fidx = np.clip(np.round(st.kf_ts[alive] / 0.05).astype(int), 0, n_frames - 1)
    c_gt = seq.world.poses_wc[fidx, :3, 3]
    scales = []
    for i in range(5, len(alive), 5):
        d_gt = np.linalg.norm(c_gt[i] - c_gt[i - 5])
        if d_gt > 1e-6:
            scales.append(np.linalg.norm(c_est[i] - c_est[i - 5]) / d_gt)
    ratio = np.mean(scales[-3:]) / max(np.mean(scales[:3]), 1e-9)
    assert 0.5 < ratio < 2.0, f"scale drifted {ratio:.3f}x over the circuit"
    assert srv.mediators[0].loop_closing.n_loops_closed >= 1
