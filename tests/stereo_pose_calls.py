"""The `stereo` cell's pose_lm calls against the plain version, in float32
on the card and on the CPU and in float64 on the card.

    python tests/stereo_pose_calls.py [--min-err E]

Runs the `stereo` cell (`cells.tracker_world`, 40 rectified pairs through
`System.track_stereo`) twice on the card with every `pose_optimize_auto`
call recorded, and says whether the two runs' kernel results are
bit-equal.  Then, for every call whose kernel result is at least E
(default 3e-4) from the plain version's on the card, prints its schedule,
its valid points, the plain version's inliers after each round (the last
round runs on the next-to-last count), max |dTcw| of the kernel against
the plain version on the card and on the CPU, of the plain version
against its float64 run and of the kernel against the float64 run, the
pose's |t|, and the chi2 summed over the valid points at the kernel's,
the plain version's and the start pose.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from swarmmap_tpu_torch.bench_pose import record_pose_calls  # noqa: E402
from swarmmap_tpu_torch.cells import (STEREO_FRAMES, new_system, stereo_pairs,  # noqa: E402
                                      track_stereo, tracker_world)
from swarmmap_tpu_torch.ops import pose_opt  # noqa: E402


def _chi2_sum(Tcw, args) -> float:
    r, _, _ = pose_opt._residuals_jac(Tcw, args["K"], args["pts_w"], args["uv"])
    return float(((r * r).sum(-1) * args["inv_sigma2"])[args["valid"].bool()].sum())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min-err", type=float, default=3e-4)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stereo_pose_calls.py needs a CUDA device")
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    dev = torch.device("cuda", 0)
    world = tracker_world()
    pairs = stereo_pairs(world, STEREO_FRAMES)
    runs = []
    for _ in range(2):
        with record_pose_calls() as calls:
            track_stereo(new_system(world, dev), pairs)
        runs.append(calls)
    print(f"{len(runs[0])} and {len(runs[1])} calls; kernel results bit-equal across runs: "
          f"{all(torch.equal(a[1].Tcw, b[1].Tcw) for a, b in zip(*runs))}")
    for i, (args, res) in enumerate(runs[0]):
        plain = pose_opt.pose_optimize(**args, step_tol=0.0)
        err = float((res.Tcw - plain.Tcw).abs().max())
        if err < opt.min_err:
            continue
        wide = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in args.items()}
        exact = pose_opt.pose_optimize(**wide, step_tol=0.0).Tcw
        on_cpu = pose_opt.pose_optimize(
            **{k: v.cpu() if torch.is_tensor(v) else v for k, v in args.items()}, step_tol=0.0)
        after = [int(pose_opt.pose_optimize(**{**args, "rounds": r}, step_tol=0.0).inliers.sum())
                 for r in range(1, args["rounds"] + 1)]
        print(f"call {i} {args['rounds']}x{args['iters']}: valid {int(args['valid'].sum())}, "
              f"inliers after each round {after}; |dTcw| kernel-plain {err:.4g}, "
              f"kernel-plain(CPU) {float((res.Tcw.cpu() - on_cpu.Tcw).abs().max()):.4g}, "
              f"plain-float64 {float((plain.Tcw.double() - exact).abs().max()):.4g}, "
              f"kernel-float64 {float((res.Tcw.double() - exact).abs().max()):.4g}; "
              f"|t| {float(plain.Tcw[..., :3, 3].norm()):.3g}; chi2 kernel "
              f"{_chi2_sum(res.Tcw, args):.6g}, plain {_chi2_sum(plain.Tcw, args):.6g}, "
              f"start {_chi2_sum(args['Tcw0'], args):.6g}")


if __name__ == "__main__":
    main()
