"""agent_fps (frames/s/agent): every agent frame completed in the window,
over the window's host-clock seconds and the agent count."""


def read(ctx):
    w = ctx.window
    return w.frames / w.seconds / w.agents if w.frames and w.seconds > 0 else None
