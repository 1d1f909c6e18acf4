"""step_enqueue_ms (ms): host time inside the call to
pipeline.batched_tracking_step per step of the window (the launch cost;
the call returns before the card has finished)."""


def read(ctx):
    w = ctx.window
    return 1e3 * sum(w.enqueue_s) / len(w.enqueue_s) if w.enqueue_s else None
