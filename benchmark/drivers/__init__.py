"""Drivers: each runs one kind of traffic against the program.

A mix names its driver (`"driver"` in `traffic/<mix>.json`).  A driver's
`Driver(cfg, mix, seed, device)` makes its inputs (taking `inputs_s`
seconds) and warms up; then
`window(seconds)` gives a `Window`, `traced(steps)` a `trace.Trace` (and
sets `traced_keys`, the traced steps' keys), `outputs()` the sampled
steps' outputs on the host, keyed, and `reference(key, tf32=False)` the
plain reference's outputs for a key.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import reference
from ..reference import track as ref_track

# the batched step's inputs, in pipeline.TrackInputs' order
FIELDS = ("image", "Tcw_guess", "K", "dist", "mp_pos", "mp_desc", "mp_max_dist", "mp_valid")
OUTPUTS = ("xy", "octave", "desc", "valid", "match_mp", "Tcw", "n_inliers")


class Window:
    """Host-clock record of the measured steps."""

    def __init__(self, agents: int):
        self.agents = agents
        self.start = self.end = 0.0
        self.latency_s: list[float] = []   # per step: inputs ready -> poses on the host
        self.enqueue_s: list[float] = []   # per step: host time inside the step's call
        self.fetch_s: list[float] = []     # per step: host time blocked fetching its poses
        self.tracked_frames = 0            # agent frames that met the tracked bar

    @property
    def steps(self) -> int:
        return len(self.latency_s)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def frames(self) -> int:
        return self.steps * self.agents


def fetch_outputs(fetch, out) -> dict:
    """A step's compared outputs (pipeline.TrackOutputs) on the host."""
    f = out.features
    return dict(zip(OUTPUTS, fetch(f.xy, f.octave, f.desc, f.valid, out.match_mp,
                                   out.Tcw, out.n_inliers)))


def run_reference(cfg: dict, device, host_inputs, tf32: bool = False) -> dict:
    """The plain reference's outputs on a step's host inputs (FIELDS order)."""
    inp = {f: torch.from_numpy(np.asarray(x)).to(device) for f, x in zip(FIELDS, host_inputs)}
    with torch.no_grad(), reference.precision(tf32):
        return ref_track.track(inp, cfg)
