"""Closed-loop driver of the port's steady-state cohort step.

Each step does what `Swarm._dispatch_fused` and `Swarm._commit_pending`
do for a cohort of steady agents: stack every agent's next frame, local
map and pose guess on the host, upload them (`utils.device.upload`), make
one call to `pipeline.batched_tracking_step`, and fetch Tcw and n_inliers
(`utils.device.fetch`).  Only then does the next step start.  The inputs
are the generator's rings (`generator.track_ring`), kept on the host.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import check, generator, trace
from . import FIELDS, Window, fetch_outputs, run_reference


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from swarmmap_tpu_torch import pipeline
        from swarmmap_tpu_torch.utils import device as transfer

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.pipeline, self.transfer = pipeline, transfer
        t0 = time.perf_counter()
        self.rings = generator.track_ring(cfg, mix, seed, self.device)
        t1 = time.perf_counter()
        self.inputs_s = t1 - t0
        self.R = len(self.rings[0])
        self.kw = dict(n_features=cfg["n_features"], n_levels=cfg["n_levels"],
                       scale=cfg["scale_factor"], hw=(cfg["height"], cfg["width"]),
                       window_th=cfg["window_th"])
        self.sample = check.Reservoir(mix["sample_steps"], generator.rng(seed, generator.SAMPLE))
        self.i = 0
        for _ in range(mix["warmup_steps"]):
            self.step(None)
        self.i = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"set-up: inputs {t1 - t0:.3f} s, warm-up {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)

    def host_inputs(self, r: int) -> list[np.ndarray]:
        return [np.stack([ring[r][f] for ring in self.rings]) for f in FIELDS]

    def step(self, win: Window | None, tracing: bool = False):
        """One closed-loop step over ring index i mod R; returns its outputs."""
        r = self.i % self.R
        self.i += 1
        with trace.span("harness", tracing):
            host = self.host_inputs(r)
        t0 = time.perf_counter()
        with trace.span("upload", tracing):
            inputs = self.pipeline.TrackInputs(*self.transfer.upload(*host, device=self.device))
        t1 = time.perf_counter()
        with trace.span("step", tracing):
            out = self.pipeline.batched_tracking_step(inputs, **self.kw)
        t2 = time.perf_counter()
        with trace.span("fetch", tracing):
            _tcw, n_inl = self.transfer.fetch(out.Tcw, out.n_inliers)
        t3 = time.perf_counter()
        if win is not None:
            win.latency_s.append(t3 - t0)
            win.enqueue_s.append(t2 - t1)
            win.fetch_s.append(t3 - t2)
            win.tracked_frames += int((n_inl >= self.cfg["min_tracked_inliers"]).sum())
            self.sample.offer((r, out))
        return out

    def window(self, seconds: float) -> Window:
        win = Window(self.cfg["n_agents"])
        win.start = time.perf_counter()
        stop = win.start + seconds
        while time.perf_counter() < stop:
            self.step(win)
        win.end = time.perf_counter()
        quarters = np.array_split(np.asarray(win.latency_s) * 1e3, 4)
        print("window: step ms median by quarter "
              + " ".join(f"{np.median(q):.2f}" for q in quarters if len(q)), file=sys.stderr)
        return win

    def traced(self, steps: int) -> trace.Trace:
        """`steps` more steps under the profiler."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof = trace.profiler()
        first = self.i
        with prof:
            for _ in range(steps):
                self.step(None, tracing=True)
        self.traced_keys = [(first + k) % self.R for k in range(steps)]
        return trace.parse(prof, steps, self.cfg["n_agents"])

    def outputs(self) -> list[tuple[int, dict]]:
        """The sampled steps' outputs on the host, and the program's device
        state let go."""
        got = [(r, fetch_outputs(self.transfer.fetch, out)) for r, out in self.sample.items]
        self.sample.items = []
        return got

    def reference(self, r: int, tf32: bool = False) -> dict:
        """The plain reference's outputs on ring index r's host inputs."""
        return run_reference(self.cfg, self.device, self.host_inputs(r), tf32)
