"""setup_s (s): from the harness's first line to the window's start,
less the benchmark's own making of the inputs from the seed: imports,
kernel builds or loads, warm-up at the cell's shapes."""


def read(ctx):
    return ctx.setup_s
