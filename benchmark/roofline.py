"""The card's peaks and the least time of the pose kernel's problem.

The operation and byte counts are a frozen copy of the port's
`bench_pose.bound` (counted from the body of `csrc/pose_lm.cu` when the
benchmark was defined): a FLOP is one add, multiply, compare, reciprocal
or square root; each input byte is read once and each output byte
written once.  The active points of each LM round come from the problem's
own data (the reference's plain LM run for that many rounds), so the
bound is what these inputs need, not the most they could.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3

# the chi2 of a point at one pose: R X + t 18, clamp and 1/z 2, the u and v
# residuals 8, chi2 4, the z > 0 test 1
FLOP_CHI2 = 33
# an active point in one pass: its chi2 33, Huber norm, weight and cost 9,
# d(uv)/d(pc) 7, the Jacobian rows 10, the weighted rows 10, the 21 H terms
# 60, the 6 b terms 20, the cost 2
FLOP_PER_POINT_PASS = 151
# one LM step of one agent: the damped 6x6 solve 227, the SE(3) exp and
# its composition 157, the accept test and damping 4
FLOP_PER_STEP = 388
BYTES_PER_POINT = 30   # pts 12, uv 8, 1/sigma^2 4, valid 1 in; chi2 4, inlier 1 out
BYTES_PER_AGENT = 164  # Tcw0 64, K 36 in; Tcw 64 out


def pose_bound(agents: int, n: int, valid: int, active: list[int],
               rounds: int, iters: int) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes") of one launch over
    `agents` x `n` point slots, `valid` of them valid, with active[r]
    points in LM round r: a pass over a round's active points at its start
    and at each step's candidate, the chi2 of each point outside a round's
    active set where the next re-gate or the output reads it, one solve
    and exp per agent and step."""
    flops = (sum(active) * (iters + 1) * FLOP_PER_POINT_PASS
             + sum(valid - a for a in active[:-1]) * FLOP_CHI2
             + (agents * n - (active[-1] if active else 0)) * FLOP_CHI2
             + agents * rounds * iters * FLOP_PER_STEP)
    nbytes = agents * n * BYTES_PER_POINT + agents * BYTES_PER_AGENT
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
