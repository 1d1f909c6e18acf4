"""First-call and warm costs of the server's device programs on the card.

    python -m swarmmap_tpu_torch.profile_server [--out DIR]

In a fresh process, times each of the server's device programs on
synthetic inputs at the server cells' sizes, first call apart from the
next three (host clock to an idle card): the pieces a first call may pay
for (a batched 3x3 SVD, a 7x7 `solve_ex`, a `torch.func.jacfwd`), then
`sim3.ransac_sim3`, `sim3_opt.optimize_sim3`,
`pose_graph.optimize_pose_graph` (64 nodes, a loop edge), a CG
`ba.bundle_adjust` chunk (4 LM iterations, a 32-keyframe, 2048-point
problem) and `matching.sim3_guided_match`.  Then one warm call of each
under `torch.profiler`: kernel launches, device ms and the device's idle
share of the call.  Prints one JSON line; with --out DIR also writes
DIR/profile_server.txt (the profiler's tables).  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _problems(dev):
    """Synthetic inputs of each program, made from seed 0."""
    from .ops import ba, lie, pose_graph, sim3

    g = torch.Generator().manual_seed(0)
    f32 = dict(dtype=torch.float32)
    K = torch.tensor([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]], **f32)
    n = 256
    pc2 = torch.stack([torch.rand(n, generator=g) * 4 - 2, torch.rand(n, generator=g) * 3 - 1.5,
                       torch.rand(n, generator=g) * 5 + 3], 1)
    R, t, s = lie.sim3_exp(torch.tensor([0.05, -0.1, 0.02, 0.3, 0.1, -0.2, 0.05]))
    pc1 = s * pc2 @ R.T + t
    valid = torch.arange(n) < 200
    uv1, uv2 = lie.project(K, pc1), lie.project(K, pc2)
    ones = torch.ones(n)
    gen = torch.Generator(dev).manual_seed(0)
    sim3_args = [x.to(dev) for x in (pc1, pc2, valid, K, K)]
    opt_args = [x.to(dev) for x in (s, R, t, pc1, pc2, uv1, uv2, ones, ones, valid, K, K)]
    # a drifted chain of 64 Sim3 nodes with odometry edges and one loop edge
    m = 64
    steps = torch.randn(m - 1, 7, generator=g) * 0.1
    steps[:, 6] *= 0.1
    Rs, ts, ss = [torch.eye(3)], [torch.zeros(3)], [torch.tensor(1.0)]
    for i in range(m - 1):
        Ri, ti, si = lie.sim3_mul(*lie.sim3_exp(steps[i]), Rs[-1], ts[-1], ss[-1])
        Rs.append(Ri), ts.append(ti), ss.append(si)
    Rn, tn, sn = torch.stack(Rs), torch.stack(ts), torch.stack(ss)
    ei = torch.cat([torch.arange(m - 1), torch.tensor([0])])
    ej = torch.cat([torch.arange(1, m), torch.tensor([m - 1])])
    mR, mt, ms = lie.sim3_mul(Rn[ej], tn[ej], sn[ej], *lie.sim3_inv(Rn[ei], tn[ei], sn[ei]))
    pg_args = [x.to(dev) for x in (Rn, tn, sn, ei, ej, mR, mt, ms, torch.ones(m, dtype=torch.bool),
                                   torch.arange(m) == 0, torch.ones(m, dtype=torch.bool))]
    # a global-BA-sized problem: 32 keyframes along x, 2048 points
    rng = np.random.RandomState(0)
    C, P = 32, 2048
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(5, 9, P)], 1)
    Tcw = np.tile(np.eye(4), (C, 1, 1))
    Tcw[:, 0, 3] = -0.05 * np.arange(C)
    obs = [(c, j) for c in range(C) for j in range(P) if rng.rand() > 0.85]
    cam, pt = np.array(obs).T
    pcs = pts[pt] + Tcw[cam, :3, 3]
    uv = pcs[:, :2] / pcs[:, 2:] * 458.0 + np.array([367.0, 248.0]) + rng.normal(0, 0.5, (len(obs), 2))
    prob = ba.build_padded_problem(Tcw, np.tile(K.numpy(), (C, 1, 1)), np.arange(C) < 1,
                                   pts + rng.normal(0, 0.02, pts.shape), cam, pt, uv,
                                   np.ones(len(obs)), device=dev)
    # guided match: 1024 keypoints a keyframe
    kp = 1024
    desc = torch.randint(-2**31, 2**31 - 1, (kp, 8), generator=g, dtype=torch.int64).to(torch.int32)
    side = [torch.stack([torch.rand(kp, generator=g) * 4 - 2, torch.rand(kp, generator=g) * 3 - 1.5,
                         torch.rand(kp, generator=g) * 5 + 3], 1), torch.ones(kp, dtype=torch.bool),
            desc, torch.full((kp,), 0.5), torch.full((kp,), 20.0),
            torch.rand(kp, 2, generator=g) * torch.tensor([752.0, 480.0]),
            torch.randint(0, 8, (kp,), generator=g, dtype=torch.int32),
            torch.ones(kp, dtype=torch.bool), desc, K, torch.tensor([480.0, 752.0])]
    gm_args = [x.to(dev) for x in side + side + [s, R, t]]
    draws = sim3.ransac_sim3_draws(sim3_args[2], gen)
    return {
        "ransac_sim3": lambda: sim3.ransac_sim3(*sim3_args, draws),
        "optimize_sim3": lambda: sim3_opt_call(opt_args),
        "optimize_pose_graph": lambda: pose_graph.optimize_pose_graph(
            pose_graph.Sim3Nodes(*pg_args[:3]), *pg_args[3:], iters=15),
        "bundle_adjust_cg_chunk": lambda: ba.bundle_adjust(prob, iters_a=2, iters_b=2,
                                                           mode="cg", cg_iters=32),
        "sim3_guided_match": lambda: matching_call(gm_args),
    }


def profiled(fn) -> tuple[dict, str]:
    """One call of fn under torch.profiler from an idle card: its wall ms,
    kernel launches (copies and sets left out), device events, summed
    device ms and the device's idle share; and the profiler's table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return ({"wall_ms": wall, "kernel_launches": len(kernels), "device_events": len(events),
             "device_ms": dev_ms, "idle_share": max(0.0, 1.0 - dev_ms / wall)},
            prof.key_averages().table(sort_by="device_time_total", row_limit=15))


def sim3_opt_call(args):
    from .ops import sim3_opt

    return sim3_opt.optimize_sim3(*args)


def matching_call(args):
    from .ops import matching

    return matching.sim3_guided_match(*args, 7.5, 1.2, 8)


def run(out_dir: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_server needs a CUDA device")
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    dev = torch.device("cuda", 0)
    rec = {"first_ms": {}, "warm_ms": {}}
    a = torch.randn(128, 3, 3, device=dev)
    rec["first_ms"]["svd_128x3x3"] = _ms(lambda: torch.linalg.svd(a))
    rec["warm_ms"]["svd_128x3x3"] = _ms(lambda: torch.linalg.svd(a))
    h = torch.randn(7, 7, device=dev) + 7 * torch.eye(7, device=dev)
    b = torch.randn(7, device=dev)
    rec["first_ms"]["solve_ex_7x7"] = _ms(lambda: torch.linalg.solve_ex(h, b))
    rec["warm_ms"]["solve_ex_7x7"] = _ms(lambda: torch.linalg.solve_ex(h, b))
    x = torch.zeros(1, 7, device=dev)
    f = lambda d: torch.sin(d) * 2.0 + d ** 2  # noqa: E731
    rec["first_ms"]["jacfwd"] = _ms(lambda: torch.func.jacfwd(f)(x))
    rec["warm_ms"]["jacfwd"] = _ms(lambda: torch.func.jacfwd(f)(x))
    progs = _problems(dev)
    for name, fn in progs.items():
        rec["first_ms"][name] = _ms(fn)
        rec["warm_ms"][name] = sorted(_ms(fn) for _ in range(3))[1]
    rec["profiled"] = {}
    tables = []
    for name, fn in progs.items():
        rec["profiled"][name], table = profiled(fn)
        tables.append(f"== {name}\n{table}")
    if out_dir:
        from pathlib import Path

        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / "profile_server.txt").write_text("\n".join(tables))
    return rec


if __name__ == "__main__":
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    print(json.dumps(run(out)))
