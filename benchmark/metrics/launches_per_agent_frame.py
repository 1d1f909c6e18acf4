"""launches_per_agent_frame (launches/frame): kernels launched in the
traced window over the agent frames it holds (copies not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    n = len(t.kernels())
    return n / (t.steps * t.agents) if n else None
