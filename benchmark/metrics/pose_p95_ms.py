"""pose_p95_ms (ms): the 95th percentile, over every agent frame of the
window, of the host time from its step's inputs being ready to its pose
being on the host."""
import numpy as np


def read(ctx):
    w = ctx.window
    if not w.latency_s:
        return None
    return float(np.percentile(np.repeat(w.latency_s, w.agents), 95)) * 1e3
