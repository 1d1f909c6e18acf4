"""The cells the port is measured in, shared by chip_smoke.py,
bench_step.py, profile_step.py and profile_tracker.py.

The batched step's two cells are the JAX package's bench configuration
(`bench.py:24-28`, `:367`), uncut: 3 agents at EuRoC geometry (480x752),
1000 features, 8 levels, 2048 map points, `realistic_track_inputs` seeds
0-2.  `pinhole` has no distortion; `distorted` has EuRoC cam0's
radial-tangential coefficients.

The per-agent tracker runs on the synthetic world `make_world(seed=4)` at
the same geometry and ORB settings with 1500 landmarks (`tracker_world`,
`new_tracker`): RGB-D frames take the staged path, monocular frames after
a depth bootstrap the fused one.  `track_sequence` drives a tracker over
rendered frames and keeps one `FrameRecord` per frame; `compare_records`
holds two runs to the tracker's parity bars.

The monocular client (`core/system.py`, tracking with local mapping) runs
on `mono_sequence()`: synthesize_sequence(seed=0, motion="arc") with 1500
landmarks, 40 frames, at the same geometry and ORB settings
(`new_system`, `track_mono`).  Its two-view initialisation draws RANSAC
hypotheses from the tracker's generator; `recorded_draws` and
`replayed_draws` let a second run on another device (or the JAX package's
draws) take the same ones, for the server's Sim3 RANSAC too.

The edge server's cells (`server_sequences`): `server_swarm`, 3 agents
on one landmark field (synthesize_sequence(seed=0, agent=a), 60 frames,
350 landmarks), and `server_loop`, one agent on the seed-2 circuit (100
frames, 1500 landmarks), at the same geometry and ORB settings.
`Server` wires port SwarmAgents to the port's MediatorScheduler as the
JAX package's `Swarm.sync` does, records every request it is given
(`events`) and can `replay` them into another server; `FrameClock` makes
the map stores' clock the frame's timestamp; `log_requests` and
`replica_gaps` are the parity bars of two servers.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from .utils.stats import STATS

N_AGENTS = 3
HW = (480, 752)
N_FEATURES = 1000
N_LEVELS = 8
N_MAP_POINTS = 2048
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
CELLS = {"pinhole": (0.0,) * 5, "distorted": EUROC_DIST}
# keyword arguments of pipeline.batched_tracking_step / match_frame in both cells
STEP_KW = dict(n_features=N_FEATURES, n_levels=N_LEVELS, hw=HW)


# the per-agent tracker's world: landmarks and frames of make_world
TRACKER_LANDMARKS = 1500
TRACKER_SEED = 4


def tracker_world(hw: tuple[int, int] = HW, n_points: int = TRACKER_LANDMARKS):
    """The synthetic world the tracker cells render (80 frames, the default
    trajectory)."""
    from .utils import datasets

    return datasets.make_world(n_points=n_points, hw=hw, seed=TRACKER_SEED)


def settings_for(world, n_features: int = N_FEATURES, n_levels: int = N_LEVELS):
    """Settings of the world's pinhole camera at 20 fps with these ORB
    settings."""
    from .utils import config

    K = world.K
    return config.Settings(
        camera=config.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]),
                                   cx=float(K[0, 2]), cy=float(K[1, 2]), fps=20.0,
                                   width=world.hw[1], height=world.hw[0]),
        orb=config.OrbConfig(n_features=n_features, n_levels=n_levels),
    )


def new_tracker(world, device, n_features: int = N_FEATURES, n_levels: int = N_LEVELS):
    """A tracker on an empty map with the world's pinhole camera at 20 fps,
    on `device`."""
    from .core import keyframe_db, map_store, tracking
    from .ops import vocab

    voc = vocab.default_vocabulary()
    return tracking.Tracking(settings_for(world, n_features, n_levels), map_store.MapStore(),
                             keyframe_db.KeyFrameDatabase(voc), voc, device=device)


# the monocular client's cell: a System mapping a synthetic arc sequence
MONO_FRAMES = 40
MONO_LANDMARKS = 1500
MONO_SEED = 0


def mono_sequence(hw: tuple[int, int] = HW, n_points: int = MONO_LANDMARKS,
                  n_frames: int = MONO_FRAMES):
    """synthesize_sequence(seed=0, motion="arc"): the monocular cell's
    frames with the ground truth attached (`.world`)."""
    from .utils import datasets

    return datasets.synthesize_sequence(n_frames=n_frames, hw=hw, seed=MONO_SEED,
                                        n_points=n_points, motion="arc")


def new_system(seq, device, n_features: int = N_FEATURES, n_levels: int = N_LEVELS,
               rng_seed: int = 0):
    """A monocular System (tracking + local mapping) on an empty map with
    the sequence's camera, on `device`, its RANSAC draws seeded by
    rng_seed."""
    from .core.system import System

    return System(settings_for(seq.world, n_features, n_levels), rng_seed=rng_seed,
                  device=device)


def ate_share(poses: dict, world) -> tuple[float, float]:
    """(ATE RMSE after Sim(3) alignment, span of the ground-truth
    positions) of {frame index: Tcw}."""
    from .utils.trajectory import ate_rmse

    idx = sorted(poses)
    est = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in idx])
    gt = world.poses_wc[idx][:, :3, 3]
    return ate_rmse(est, gt), float(np.linalg.norm(gt.max(0) - gt.min(0)))


def relocalised(system, seq, frames=(10, 20, 30)) -> list[bool]:
    """For each index of `seq` in `frames`, whether a fresh frame of it,
    built on the system's device, relocalises against the system's map
    (`Tracking._relocalize`: BoW candidates, RANSAC PnP, pose refinement):
    the map-reuse check of tests/test_slam_e2e.py."""
    from .core.frame import build_frame

    s, tr = system.settings, system.tracking
    return [bool(tr._relocalize(build_frame(seq.read(i), float(seq.timestamps[i]), s.camera,
                                            s.orb, device=tr.device)))
            for i in frames]


class FrameRecord(NamedTuple):
    state: str
    pose_cw: np.ndarray | None
    inliers: int
    pairs: frozenset          # {(keypoint index, map point)}
    n_kf: int
    n_mp: int
    fused_frames: int
    since_kf: int             # frame id minus the last keyframe's frame id
    ms: float                 # host clock around grab (ends in a fetch)
    counts: dict              # STATS counters bumped by this frame


def frame_record(tracker, ms: float = 0.0, counts: dict | None = None) -> FrameRecord:
    """The state a tracker left after its last grab.  Reads only what the
    JAX package's tracker has too, so its tests hold the two alike."""
    f = tracker.last_frame
    return FrameRecord(
        state=tracker.state.name,
        pose_cw=None if f.pose_cw is None else np.array(f.pose_cw),
        inliers=int(tracker.matches_inliers),
        pairs=frozenset((i, int(m)) for i, m in enumerate(f.mp) if m >= 0),
        n_kf=int(tracker.store.n_kf), n_mp=int(tracker.store.n_mp),
        fused_frames=int(tracker.fused_frames),
        since_kf=int(f.frame_id - tracker.last_kf_frame_id),
        ms=ms, counts=counts or {},
    )


def render_frames(world, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(image, depth) of frames 0..n-1."""
    from .utils import datasets

    return [datasets.render_frame(world, i, return_depth=True) for i in range(n)]


def _launches() -> int:
    from .ops import pose_kernel

    return pose_kernel.pose_lm_launches


def timed_record(grab, tracker) -> FrameRecord:
    """Run grab(), then the record of `tracker` with grab's host time, its
    STATS counts and the pose_lm launches it made (`counts["pose_lm"]`)."""
    before, launches = dict(STATS.counts), _launches()
    t0 = time.perf_counter()
    grab()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v - before.get(k, 0) for k, v in STATS.counts.items()
              if v != before.get(k, 0)}
    counts["pose_lm"] = _launches() - launches
    return frame_record(tracker, ms, counts)


def track_frame(tracker, image, depth, timestamp: float) -> FrameRecord:
    """One grab, timed and counted (`timed_record`)."""
    return timed_record(lambda: tracker.grab(image, timestamp, depth_image=depth), tracker)


def track_mono(system, seq, n: int | None = None) -> list[FrameRecord]:
    """`System.track_monocular` on the first n frames of `seq` at their
    timestamps, one timed and counted record per frame."""
    return [timed_record(lambda i=i: system.track_monocular(seq.read(i), seq.timestamps[i]),
                   system.tracking)
            for i in range(len(seq) if n is None else n)]


def track_sequence(tracker, frames, depth_frames) -> list[FrameRecord]:
    """Grab frames[i] at i / 20 s, with its depth where i is in
    `depth_frames` (a container of indices)."""
    return [track_frame(tracker, img, d if i in depth_frames else None, i / 20.0)
            for i, (img, d) in enumerate(frames)]


def frame_disagreements(x: FrameRecord, y: FrameRecord, tcw_tol: float = 1e-3) -> list[str]:
    """Where two trackers' states after one frame break the tracker's
    parity bars: the same state, keyframe and point counts, fused frames
    and frames since the last keyframe, |dTcw| < tcw_tol, inliers within
    max(2, 2%), association sets agreeing >= 0.99.  Empty when they agree."""
    out = []
    key = ("state", "n_kf", "n_mp", "fused_frames", "since_kf")
    if [getattr(x, k) for k in key] != [getattr(y, k) for k in key]:
        out.append(f"{'/'.join(key)} {[getattr(x, k) for k in key]} vs "
                   f"{[getattr(y, k) for k in key]}")
    if (x.pose_cw is None) != (y.pose_cw is None):
        out.append("pose present in one run only")
    elif x.pose_cw is not None and not np.abs(x.pose_cw - y.pose_cw).max() < tcw_tol:
        out.append(f"|dTcw| {np.abs(x.pose_cw - y.pose_cw).max():.3g}")
    if abs(x.inliers - y.inliers) > max(2, 0.02 * x.inliers):
        out.append(f"inliers {x.inliers} vs {y.inliers}")
    common = len(x.pairs & y.pairs)
    if common < 0.99 * max(len(x.pairs), len(y.pairs)):
        out.append(f"associations {common} shared of {len(x.pairs)} / {len(y.pairs)}")
    return out


def compare_records(a: list[FrameRecord], b: list[FrameRecord],
                    tcw_tol: float = 1e-3) -> list[str]:
    """`frame_disagreements` of two runs of one sequence, frame by frame."""
    return [f"frame {i}: {d}" for i, (x, y) in enumerate(zip(a, b))
            for d in frame_disagreements(x, y, tcw_tol)]


def _draw_site(kind: str):
    """(module, attribute) of a RANSAC's draw function: "twoview" for the
    two-view initialisation, "sim3" for the server's Sim3 RANSAC."""
    from .ops import sim3, twoview

    return {"twoview": (twoview, "draw_indices"), "sim3": (sim3, "ransac_sim3_draws")}[kind]


@contextlib.contextmanager
def recorded_draws(kind: str = "twoview"):
    """Record, as CPU tensors in call order, every set of RANSAC draws of
    `kind` (see `_draw_site`) made inside the block."""
    module, name = _draw_site(kind)
    draws, orig = [], getattr(module, name)

    def record(valid, generator):
        d = orig(valid, generator)
        draws.append(d.cpu())
        return d

    setattr(module, name, record)
    try:
        yield draws
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def replayed_draws(draws: list, kind: str = "twoview"):
    """Inside the block, the RANSAC of `kind` takes its draws from `draws`
    (popped from the front, moved to the points' device) instead of its
    generator: the card's and the CPU's generators give different streams
    for one seed, and the JAX package draws from its own keys."""
    module, name = _draw_site(kind)
    orig = getattr(module, name)

    def replay(valid, generator):
        return torch.as_tensor(np.array(draws.pop(0))).long().to(valid.device)

    setattr(module, name, replay)
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_disagreements(a: list[FrameRecord], b: list[FrameRecord],
                        tcw_tol: float = 1e-3) -> list[str]:
    """Where two runs of one sequence part on the monocular client's
    per-frame bars: the same state, keyframe and map-point counts, and
    |dTcw| < tcw_tol.  Empty when they agree."""
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        key = ("state", "n_kf", "n_mp")
        if [getattr(x, k) for k in key] != [getattr(y, k) for k in key]:
            out.append(f"frame {i}: state/n_kf/n_mp {[getattr(x, k) for k in key]} vs "
                       f"{[getattr(y, k) for k in key]}")
        elif (x.pose_cw is None) != (y.pose_cw is None):
            out.append(f"frame {i}: pose present in one run only")
        elif x.pose_cw is not None and not np.abs(x.pose_cw - y.pose_cw).max() < tcw_tol:
            out.append(f"frame {i}: |dTcw| {np.abs(x.pose_cw - y.pose_cw).max():.3g}")
    return out


def build_cells(dev: torch.device) -> dict:
    """{cell name: [A, ...] TrackInputs on dev}, agents 0..N_AGENTS-1."""
    from . import pipeline

    return {name: pipeline.stack_inputs([
        pipeline.realistic_track_inputs(
            hw=HW, n_map_points=N_MAP_POINTS, seed=a, n_features=N_FEATURES,
            n_levels=N_LEVELS, dist=dist, device=dev)
        for a in range(N_AGENTS)]) for name, dist in CELLS.items()}


def timed_call(fn) -> tuple[float, float]:
    """(CUDA-event ms, host-clock ms) of one call of fn, from an idle
    device to the end of its work."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), (time.perf_counter() - h0) * 1e3


# the server's cells: SwarmAgents serving against one MediatorScheduler
SERVER_SWARM_AGENTS = 3
SERVER_SWARM_FRAMES = 60
SERVER_LOOP_FRAMES = 100
SERVER_LANDMARKS = {"server_swarm": 350, "server_loop": 1500}
SERVER_REPORT_EVERY = 5
SERVER_PUSH_EVERY = 10


def server_sequences(cell: str, hw: tuple[int, int] = HW, n_points: int | None = None,
                     n_frames: int | None = None) -> list:
    """The sequences of a server cell, one per agent: "server_swarm",
    three agents on one shared landmark field (tests/test_swarm.py's
    world, seed 0), or "server_loop", one agent on
    tests/test_loop_closing.py's circuit (seed 2)."""
    from .utils import datasets

    n_points = SERVER_LANDMARKS[cell] if n_points is None else n_points
    if cell == "server_swarm":
        n = SERVER_SWARM_FRAMES if n_frames is None else n_frames
        return [datasets.synthesize_sequence(n_frames=n, hw=hw, seed=0, agent=a,
                                             n_points=n_points)
                for a in range(SERVER_SWARM_AGENTS)]
    n = SERVER_LOOP_FRAMES if n_frames is None else n_frames
    return [datasets.synthesize_sequence(n_frames=n, hw=hw, seed=2, agent=0,
                                         n_points=n_points, motion="circuit")]


class FrameClock:
    """A settable clock in place of the map stores' and the MBP scorer's
    `global_clock` (`core.map_store`, `server.landmark_scoring`) inside
    `with clock:`; `clock.t` is what it reads.  The server harness sets it
    to each frame's timestamp, so two runs of one sequence (on the card
    and on the CPU, or in both packages) stamp map elements alike and the
    scores that pick virtual keyframes agree; the host's clock would
    differ between runs."""

    def __init__(self, modules=None):
        from .core import map_store
        from .server import landmark_scoring

        self.modules = list(modules or (map_store, landmark_scoring))
        self.t = 0.0
        self._saved = []

    def __call__(self) -> float:
        return self.t

    def __enter__(self):
        self._saved = [m.global_clock for m in self.modules]
        for m in self.modules:
            m.global_clock = self
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.modules, self._saved):
            m.global_clock = f


class Server:
    """N port SwarmAgents and the server they push to, wired as the JAX
    package's `Swarm.__init__` wires them (swarm.py:142-166): one
    MapManager, one MediatorScheduler whose distributes queue up for
    their agent, one AgentMediator per agent.  It is the harness of the
    server's tests and chip phase, not a port of `Swarm` (item 12).

    Everything the server is given goes into `events` (state reports and
    pushes with their bytes, serve rounds, the finish, each with the
    clock's time), so `replay` can feed another server, with no agents,
    the same requests in the same order."""

    def __init__(self, n_agents: int, settings, device, run_server_gba: bool = True,
                 vocab=None, clock: FrameClock | None = None, agents: bool = True):
        """`clock`, where given, is set to each frame's timestamp (see
        `FrameClock`; the caller enters it).  agents=False builds the
        server side only, for `replay`."""
        from .ops.vocab import default_vocabulary
        from .server.map_manager import MapManager
        from .server.mediator import AgentMediator
        from .server.scheduler import MediatorScheduler
        from .swarm import SwarmAgent

        self.vocab = vocab or default_vocabulary()
        self.settings = settings
        AgentMediator.registry.clear()
        self.map_manager = MapManager(device=device)
        self.pending: dict[int, list[bytes]] = {i: [] for i in range(n_agents)}
        self.scheduler = MediatorScheduler(
            self.map_manager, distribute_fn=lambda a, p: self.pending[a].append(p),
            gba_iters=10 if run_server_gba else 0, device=device)
        orb = settings.orb
        n_kp = ((orb.n_features + 127) // 128) * 128
        self.agents = [SwarmAgent(i, settings, self.vocab, device=device)
                       for i in range(n_agents)] if agents else []
        # the merge gate scales with the feature budget (the reference's
        # 40 assumes 1000 features a frame), as in Swarm.__init__
        min_merge = max(20, int(40 * orb.n_features / 1000))
        self.mediators = []
        for i in range(n_agents):
            med = AgentMediator(i, self.vocab, self.map_manager, n_kp=n_kp,
                                scale_factor=orb.scale_factor, n_levels=orb.n_levels,
                                min_merge_inliers=min_merge,
                                run_global_ba=run_server_gba, device=device)
            self.scheduler.register_mediator(med)
            self.mediators.append(med)
        self.frame_count = 0
        self.clock = clock
        self.events: list[tuple] = []
        self.distributed: list[tuple[int, int]] = []   # (agent, bytes)

    def _now(self) -> float:
        return 0.0 if self.clock is None else self.clock.t

    def report_states(self):
        """Every agent's state report, through its wire bytes."""
        from .sync import codec

        for agent in self.agents:
            data = agent.state_payload()
            self.events.append(("state", agent.agent_id, data, self._now()))
            self.scheduler.report_state(agent.agent_id, codec.decode_state(data))

    def serve_round(self) -> int:
        """What `Swarm.sync` + `_deliver_pending` do (swarm.py:521-544):
        every agent pushes, the scheduler serves every request, and every
        distribute goes to its agent.  Returns the requests served."""
        for agent in self.agents:
            with agent.system.store.lock:
                payload = agent.push_payload()
            if payload is not None:
                self.events.append(("push", agent.agent_id, payload, self._now()))
                self.scheduler.enqueue_request(agent.agent_id, payload)
        self.events.append(("serve", self._now()))
        n = self.scheduler.process_pending()
        for agent in self.agents:
            batch, self.pending[agent.agent_id] = self.pending[agent.agent_id], []
            for payload in batch:
                self.distributed.append((agent.agent_id, len(payload)))
                agent.receive_distribute(payload)
        return n

    def step(self, images, timestamps, report_every: int = SERVER_REPORT_EVERY,
             push_every: int = SERVER_PUSH_EVERY) -> list:
        """One frame of every agent (`SwarmAgent.track`), then the
        cadence: a state report every report_every frames, a serve round
        every push_every.  Returns each agent's pose (None where lost)."""
        if self.clock is not None:
            self.clock.t = float(timestamps[0])
        poses = [agent.track(img, float(ts))
                 for agent, img, ts in zip(self.agents, images, timestamps)]
        self.frame_count += 1
        if self.frame_count % report_every == 0:
            self.report_states()
        if self.frame_count % push_every == 0:
            self.serve_round()
        return poses

    def _finish_server(self):
        mm = self.map_manager
        mm.polish_group_transforms()
        for gid, members in list(mm.groups.items()):
            if len(members) >= 2:
                mm.group_global_ba(gid, scale_factor=self.settings.orb.scale_factor)
        mm.polish_group_transforms()

    def finish(self):
        """The server's part of `Swarm.finish` (swarm.py:562-592): polish
        the group transforms, one joint GBA per merged group, polish
        again, and a last serve round."""
        self.events.append(("finish", self._now()))
        self._finish_server()
        self.serve_round()

    def replay(self, events: list[tuple]):
        """Feed this server (built with agents=False) another server's
        `events`, at their clock times; its distributes are dropped."""
        from .sync import codec

        for ev in events:
            if self.clock is not None:
                self.clock.t = ev[-1]
            if ev[0] == "state":
                self.scheduler.report_state(ev[1], codec.decode_state(ev[2]))
            elif ev[0] == "push":
                self.scheduler.enqueue_request(ev[1], ev[2])
            elif ev[0] == "serve":
                self.scheduler.process_pending()
                for q in self.pending.values():
                    q.clear()
            else:
                self._finish_server()

    def merged_groups(self) -> list[set[int]]:
        return [set(v) for v in self.map_manager.groups.values()]


def log_requests(scheduler, mediators) -> list[dict]:
    """Instrument a scheduler and its mediators (of either package: only
    their public methods are wrapped) to append one record per request
    to the returned list: the agent, the new keyframe slots, every loop
    correction tried (keyframe, loop keyframe, accepted), every merge
    tried (map1, map2, accepted), every global BA's result, and after the
    request the loop closers' (loops closed, last loop keyframe, fused
    points), the groups and the fuse events."""
    log: list[dict] = []
    for med in mediators:
        lc = med.loop_closing
        on_push, correct, gba = med.on_push, lc.correct_loop, lc.global_ba

        def push(sl, med=med, on_push=on_push):
            rec = {"agent": med.map_id, "loops": [], "merges": [], "gba": []}
            log.append(rec)
            rec["new_kfs"] = [int(k) for k in on_push(sl)]
            return rec["new_kfs"]

        def correct_loop(k, loop_kf, *a, correct=correct, **kw):
            ok = correct(k, loop_kf, *a, **kw)
            log[-1]["loops"].append((int(k), int(loop_kf), bool(ok)))
            return ok

        def global_ba(*a, gba=gba, **kw):
            out = gba(*a, **kw)
            log[-1]["gba"].append(out)
            return out

        med.on_push, lc.correct_loop, lc.global_ba = push, correct_loop, global_ba
    mm = scheduler.map_manager
    merge, process = mm.merge, scheduler.process_request

    def merge_maps(map1, map2, *a, **kw):
        ok = merge(map1, map2, *a, **kw)
        log[-1]["merges"].append((int(map1), int(map2), bool(ok)))
        return ok

    def process_request(agent_id, sl):
        process(agent_id, sl)
        log[-1]["after"] = (
            [(m.loop_closing.n_loops_closed, int(m.loop_closing.last_loop_kf),
              m.loop_closing.n_fused) for m in mediators],
            sorted(sorted(g) for g in mm.groups.values()),
            [tuple(int(x) for x in e) for e in mm.fuse_events])

    mm.merge, scheduler.process_request = merge_maps, process_request
    return log


def replica_gaps(sa, sb, tol: dict) -> dict:
    """Where two replicas of one map part beyond `tol`, element by global
    id (slots may be reused): live keyframes ("kf_alive": how many are
    live in one only; any is a gap), live points ("mp_alive": how many are
    live in one only, a gap above tol["mp_alive"] of the live points), and
    the largest pose (position) difference of the keyframes (points) live
    in both, relative to the largest coordinate, above tol["pose"]
    (tol["pos"]).  Empty where they agree."""
    def live(st, kind):
        slots = st.alive_kf_slots() if kind == "kf" else st.alive_mp_slots()
        return dict(zip(getattr(st, f"{kind}_gid")[slots].tolist(), slots.tolist()))

    gaps = {}
    for kind, name, vals in (("kf", "pose", "kf_pose_cw"), ("mp", "pos", "mp_pos")):
        a, b = live(sa, kind), live(sb, kind)
        only = len(a.keys() ^ b.keys())
        if only > (0 if kind == "kf" else tol["mp_alive"] * max(len(a), 1)):
            gaps[f"{kind}_alive"] = only
        common = sorted(a.keys() & b.keys())
        va = getattr(sa, vals)[[a[g] for g in common]]
        vb = getattr(sb, vals)[[b[g] for g in common]]
        gap = float(np.abs(va - vb).max() / max(np.abs(va).max(), 1.0)) if common else 0.0
        if gap > tol[name]:
            gaps[name] = gap
    return gaps


def serve_sequences(server: Server, seqs: list, n: int | None = None, **cadence) -> list[dict]:
    """Drive `server` over the first n frames of every agent's sequence;
    returns {frame index: Tcw} of each agent's tracked frames."""
    poses = [dict() for _ in seqs]
    for i in range(len(seqs[0]) if n is None else n):
        for a, T in enumerate(server.step([s.read(i) for s in seqs],
                                          [s.timestamps[i] for s in seqs], **cadence)):
            if T is not None:
                poses[a][i] = T
    return poses
