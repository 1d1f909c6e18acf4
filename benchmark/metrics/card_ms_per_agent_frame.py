"""card_ms_per_agent_frame (ms): the card's busy time per agent frame in
the traced tail after the window (the union of its operations' intervals,
copies included, from the profiler's trace): what one agent frame costs
the H100, however fast the host feeds it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / (t.steps * t.agents)
