"""pose_lm_roofline (%): the least time of the traced steps' pose problems
over the pose_lm kernel's mean time in the trace.  Each problem is the
plain reference's for that step's inputs, with its active points per LM
round counted (`roofline.pose_bound`); standard error says whether bytes
or operations bind it."""
from benchmark import roofline
from benchmark.reference import track as ref_track


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_keys:
        return None
    ks = [d for name, _, d in t.kernels() if "pose_lm" in name]
    if not ks:
        return None
    cfg = ctx.cell.cfg
    rounds, iters = cfg["pose_rounds"], cfg["pose_iters"]
    bounds = []
    for key in ctx.traced_keys:
        prob = ctx.reference(key)["problem"]
        valid = prob[-1]
        bounds.append(roofline.pose_bound(*valid.shape, int(valid.sum()),
                                          ref_track.active_per_round(prob, rounds, iters),
                                          rounds, iters))
    bound_ms = sum(b[0] for b in bounds) / len(bounds)
    ctx.log(f"pose_lm bound: {bound_ms} ms, bound by {sorted({b[1] for b in bounds})}")
    return 100.0 * bound_ms / (sum(ks) / len(ks) / 1e6)
