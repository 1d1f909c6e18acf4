"""match_frame_device_ms (ms): device time per traced step of every kernel
but pose_lm: the front end, undistortion, projection and matching
(pipeline.match_frame), from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    ks = [d for name, _, d in t.kernels() if "pose_lm" not in name]
    return sum(ks) / 1e6 / t.steps if ks else None
