"""fetch_wait_ms (ms): host time blocked fetching Tcw and n_inliers per
step of the window (the card's work left after the call returned, and the
copies)."""


def read(ctx):
    w = ctx.window
    return 1e3 * sum(w.fetch_s) / len(w.fetch_s) if w.fetch_s else None
