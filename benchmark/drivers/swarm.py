"""Closed-loop driver of the whole in-process swarm (`swarm.Swarm.step`).

Every step hands `Swarm.step` each agent's next frame, in order from the
generator's sequences (`generator.sequences`), with the mix's report and
push cadence: tracking, the fused cohort, keyframes with inline local
mapping, and the server's passes at each sync.  The mix's first frames
(initialisation) are set-up; the window runs until its time is up or the
frames run out.  For `correct`, a sample of the window's cohort
dispatches (`pipeline.batched_tracking_step`, as `Swarm._dispatch_fused`
calls it) is kept with its inputs and run again through the plain
reference.
"""
from __future__ import annotations

import time

import torch

from .. import check, generator, trace
from . import Window, fetch_outputs, run_reference


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from swarmmap_tpu_torch import pipeline
        from swarmmap_tpu_torch.swarm import Swarm, SwarmConfig
        from swarmmap_tpu_torch.utils import device as transfer
        from swarmmap_tpu_torch.utils.config import CameraConfig, OrbConfig, Settings

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.transfer = transfer
        t0 = time.perf_counter()
        self.frames, self.ts = generator.sequences(cfg, mix, seed)
        self.inputs_s = time.perf_counter() - t0
        settings = Settings(
            camera=CameraConfig(fx=cfg["fx"], fy=cfg["fy"], cx=cfg["cx"], cy=cfg["cy"],
                                k1=cfg["k1"], k2=cfg["k2"], p1=cfg["p1"], p2=cfg["p2"],
                                k3=cfg["k3"], fps=cfg["fps"], width=cfg["width"],
                                height=cfg["height"]),
            orb=OrbConfig(n_features=cfg["n_features"], scale_factor=cfg["scale_factor"],
                          n_levels=cfg["n_levels"], ini_th_fast=cfg["ini_th_fast"],
                          min_th_fast=cfg["min_th_fast"]))
        self.swarm = Swarm(cfg["n_agents"], settings,
                           config=SwarmConfig(push_every=mix["push_every"],
                                              report_every=mix["report_every"]),
                           device=self.device)
        self.sample = check.Reservoir(mix["sample_steps"], generator.rng(seed, generator.SAMPLE))
        self.recording = False
        self.kept: dict[int, tuple] = {}
        self.n_dispatch = 0
        inner = pipeline.batched_tracking_step

        def recorded(inputs, **kw):
            out = inner(inputs, **kw)
            if self.recording:
                self.sample.offer((self.n_dispatch, inputs, out))
                self.n_dispatch += 1
            return out

        # Swarm._dispatch_fused looks the step up on the module at each call
        pipeline.batched_tracking_step = recorded
        self.i = 0
        for _ in range(mix["warmup_frames"]):
            self.step(None)
        self.traced_keys: list = []

    def step(self, win: Window | None, tracing: bool = False) -> bool:
        if self.i >= self.frames.shape[1]:
            return False
        tracked0 = sum(a.frames_tracked for a in self.swarm.agents)
        with trace.span("harness", tracing):
            images = list(self.frames[:, self.i])
        t0 = time.perf_counter()
        with trace.span("step", tracing):
            self.swarm.step(images, float(self.ts[self.i]))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.i += 1
        if win is not None:
            win.latency_s.append(t1 - t0)
            win.tracked_frames += sum(a.frames_tracked for a in self.swarm.agents) - tracked0
        return True

    def window(self, seconds: float) -> Window:
        win = Window(self.cfg["n_agents"])
        self.recording = True
        win.start = time.perf_counter()
        stop = win.start + seconds
        while time.perf_counter() < stop and self.step(win):
            pass
        win.end = time.perf_counter()
        self.recording = False
        return win

    def traced(self, steps: int) -> trace.Trace:
        prof = trace.profiler()
        with prof:
            for _ in range(steps):
                self.step(None, tracing=True)
        return trace.parse(prof, steps, self.cfg["n_agents"])

    def outputs(self) -> list[tuple[int, dict]]:
        got = []
        for key, inputs, out in self.sample.items:
            self.kept[key] = self.transfer.fetch(*inputs)
            got.append((key, fetch_outputs(self.transfer.fetch, out)))
        self.sample.items = []
        return got

    def reference(self, key: int, tf32: bool = False) -> dict:
        return run_reference(self.cfg, self.device, self.kept[key], tf32)
