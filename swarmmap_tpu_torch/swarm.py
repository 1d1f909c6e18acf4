"""In-process multi-agent harness (combined mode).

Port of swarmmap_tpu/swarm.py (reference spec:
Examples/Monocular/swarm_map.cc — N clients + N mediators + the global
scheduler in ONE process, stepped frame by frame, with state reports
every 500 ms and map pushes every 2 s, :122-164).  `SwarmAgent` is one
client: its SLAM system, change log and sync endpoints.  `Swarm` runs N
of them against the port's server: every steady agent's frame goes into
one batched device dispatch (`pipeline.batched_tracking_step`, one
`pose_lm` launch for the whole cohort on the card), optionally double
buffered; the other agents' extractions run as one batch.  Given more
than one device (`devices=`), `Swarm` shards the cohort over an agent
mesh as the JAX package does (`pipeline.make_multi_agent_step` with a
mesh, one `pose_lm` launch per shard), feeds the cross-agent overlap hint
to the mediators, and runs the server's global BA observation-sharded.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

from .core.system import System
from .core.tracking import TrackingParams
from .ops.vocab import Vocabulary, default_vocabulary
from .server.map_manager import MapManager
from .server.mediator import AgentMediator
from .server.scheduler import MediatorScheduler
from .sync import codec
from .sync.oplog import Mapit
from .utils.config import Settings
from .utils.device import default_device
from .utils.logging import get_logger
from .utils.stats import STATS

_log = get_logger("swarm")


class SwarmAgent:
    """Client-side stack: SLAM system + change-log + sync endpoints."""

    def __init__(self, agent_id: int, settings: Settings, vocab: Vocabulary,
                 tracking_params: TrackingParams | None = None,
                 device: torch.device | str | None = None):
        """`device` runs the system's device programs; by default the card
        (`utils.device.default_device`).  Tests pass device="cpu"."""
        self.agent_id = agent_id
        self.system = System(settings, vocab, map_id=agent_id,
                             tracking_params=tracking_params, rng_seed=agent_id,
                             device=device)
        self.mapit = Mapit(self.system.store)
        self.vocab = vocab
        self.frames_tracked = 0
        self.bytes_pushed = 0

    def track(self, image: np.ndarray, ts: float, features=None):
        pose = self.system.tracking.grab(image, ts, features=features)
        if pose is not None:
            self.frames_tracked += 1
        return pose

    def state_payload(self) -> bytes:
        return codec.encode_state(self.system.get_system_state())

    def push_payload(self) -> bytes | None:
        sl = self.mapit.archive()
        if not any(sl.counts()) and sl.twl is None:
            return None
        data = codec.encode_slice(sl)
        self.bytes_pushed += len(data)
        return data

    def receive_distribute(self, payload: bytes):
        sl = codec.decode_slice(payload)
        tr = self.system.tracking
        st = self.system.store
        if sl.updates or sl.kfs or sl.mps:
            mix: dict[str, int] = {}
            for u in sl.updates:
                mix[u.func] = mix.get(u.func, 0) + 1
            _log.info("agent %d distribute: %d kfs %d mps ops=%s",
                      self.agent_id, len(sl.kfs), len(sl.mps), mix)
        with st.lock:  # vs. async local mapping worker
            # a distribute may REBASE the map (merge/GBA rewrites poses,
            # reference: MediatorScheduler::MapDistribute) — carry the
            # tracker's frame-to-frame state across it via the reference
            # keyframe's pose change, else the motion model goes stale
            # and the agent drops to relocalization
            ref = tr.ref_kf
            T_ref_old = (st.kf_pose_cw[ref].copy()
                         if 0 <= ref < st.n_kf and st.kf_alive[ref] else None)
            self.mapit.apply_slice(sl, vocab=self.vocab)
            if (T_ref_old is not None
                    and not np.allclose(st.kf_pose_cw[ref], T_ref_old,
                                        atol=1e-6)):
                T_ref_new = st.kf_pose_cw[ref]
                # only a LARGE jump (merge rebase, loop correction) needs
                # the carry — ordinary GBA refinements move poses by
                # millimeters every push, and touching the tracker state
                # for those measurably degrades tracking (the optimizer
                # re-converges from the slightly-stale guess on its own)
                D = T_ref_new @ np.linalg.inv(T_ref_old)
                dt = float(np.linalg.norm(D[:3, 3]))
                ang = float(np.arccos(np.clip(
                    (np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
                if dt > 0.2 or ang > np.deg2rad(5.0):
                    if (tr.last_frame is not None
                            and tr.last_frame.pose_cw is not None):
                        rel = tr.last_frame.pose_cw @ np.linalg.inv(T_ref_old)
                        tr.last_frame.pose_cw = (rel @ T_ref_new).astype(
                            np.float32)
                    tr.velocity = None


@dataclasses.dataclass
class SwarmConfig:
    push_every: int = 20        # frames between map pushes (~2 s at 20 fps)
    report_every: int = 10      # frames between state reports (~500 ms)
    # run each agent's local mapping in a worker thread, overlapping with
    # tracking (reference: free LocalMapping::Run thread). Default off —
    # the synchronous path is deterministic.
    async_mapping: bool = False
    # drain the server's STS queue on a worker thread instead of inline
    # in step() (reference: MediatorScheduler::Run worker,
    # MediatorScheduler.cc:130-143). Default off for determinism.
    async_server: bool = False
    # shard agents across a device mesh (SURVEY.md §2.10 row 1: the
    # reference's one-thread-per-agent becomes agent data parallelism).
    # None = auto: on when the swarm has more than one device and at
    # least one agent per device.
    mesh_agents: bool | None = None
    # double-buffered dispatch: dispatch frame t's cohort BEFORE
    # committing frame t-1's results — the pose guess chains on device
    # (constant-velocity from the still-device-resident previous pose),
    # so host commit work and the fetch overlap the next frame's device
    # execution.  The local-map bucket is one commit staler than the
    # synchronous path; opt-in.
    double_buffer: bool = False


class Swarm:
    """N agents + per-agent mediators + the STS scheduler, in-process."""

    def __init__(self, n_agents: int, settings: Settings,
                 vocab: Vocabulary | None = None,
                 config: SwarmConfig | None = None,
                 tracking_params: TrackingParams | None = None,
                 run_server_gba: bool = True,
                 device: torch.device | str | None = None,
                 devices: list | None = None):
        """`device` runs every agent's and the server's device programs; by
        default the card (`utils.device.default_device`), which raises
        where there is none.  Tests pass device="cpu".  `devices` is the
        list that the agent mesh and the sharded global BA may span; by
        default `device` followed by every other visible card when `device`
        is one (so `device` leads the mesh), else [device].  A repeated
        entry (["cpu"] * 8) shards on one device."""
        self.device = torch.device(default_device() if device is None else device)
        self.config = config or SwarmConfig()
        if devices is None:
            from .parallel.mesh import visible_devices

            devices = [self.device] + ([d for d in visible_devices() if d != self.device]
                                       if self.device.type == "cuda" else [])
        self.devices = [torch.device(d) for d in devices]
        self.vocab = vocab or default_vocabulary()
        self.settings = settings
        AgentMediator.registry.clear()
        self.map_manager = MapManager(device=self.device)
        self.scheduler = MediatorScheduler(
            self.map_manager, distribute_fn=self._distribute,
            gba_iters=10 if run_server_gba else 0, device=self.device,
        )
        n_kp = ((settings.orb.n_features + 127) // 128) * 128
        self.agents = [
            SwarmAgent(i, settings, self.vocab, tracking_params, device=self.device)
            for i in range(n_agents)
        ]
        self.mediators = []
        # merge-acceptance threshold scales with the feature budget (the
        # reference's 40 assumes 1000 features/frame)
        min_merge = max(20, int(40 * settings.orb.n_features / 1000))
        for i in range(n_agents):
            med = AgentMediator(
                i, self.vocab, self.map_manager, n_kp=n_kp,
                scale_factor=settings.orb.scale_factor,
                n_levels=settings.orb.n_levels,
                min_merge_inliers=min_merge,
                run_global_ba=run_server_gba, device=self.device,
            )
            self.scheduler.register_mediator(med)
            self.mediators.append(med)
        self._pending_distribute: dict[int, list[bytes]] = {i: [] for i in range(n_agents)}
        self._dist_lock = threading.Lock()
        if self.config.async_mapping:
            for a in self.agents:
                a.system.local_mapping.start_async()
        if self.config.async_server:
            self.scheduler.start_worker()
        # agent mesh: shard the fused cohort across devices when there
        # are enough devices AND agents (the production multi-device path;
        # the 'agents' axis carries the cross-agent overlap prefilter)
        self.mesh = None
        self._mesh_step = None
        self._pending = None  # double-buffer: in-flight fused dispatch
        self._n_overlap_desc = 128  # prefilter descriptor-bank size D
        self._overlap_norm = float(self._n_overlap_desc)
        self.overlap_hint = None  # [N,N] cross-agent descriptor overlap
        n_dev = len(self.devices)
        want_mesh = (self.config.mesh_agents
                     if self.config.mesh_agents is not None
                     else (n_dev > 1 and n_agents >= n_dev))
        self.gba_mesh = None
        if want_mesh and n_dev > 1:
            from .parallel.mesh import agent_mesh, obs_mesh

            d = max(x for x in range(1, n_dev + 1) if n_agents % x == 0)
            self.mesh = agent_mesh(d, devices=self.devices)
            _log.info("agent mesh: %d agents sharded over %d devices",
                      n_agents, d)
            # server-side GBA shards the observation axis over all
            # devices (power-of-two count so padded buckets divide)
            self.gba_mesh = obs_mesh(devices=self.devices)
            for med in self.mediators:
                med.loop_closing.mesh = self.gba_mesh
        self.frame_count = 0
        self.fused_cohort_dispatches = 0  # frames where ALL steady agents ran as ONE dispatch
        # single worker: waits for the cohort's feature copies beside the
        # pose fetch (both transfers share one round-trip window)
        self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="feat-prefetch")

    # -- transport (loopback function calls) --------------------------------
    def _distribute(self, agent_id: int, payload: bytes):
        with self._dist_lock:
            self._pending_distribute[agent_id].append(payload)

    # -- stepping ------------------------------------------------------------
    def step(self, images: list[np.ndarray | None], ts: float):
        """Advance every agent by one frame and run the sync cadence.

        Steady-state agents run their ENTIRE frame (extraction + local-map
        matching + pose optimization) as ONE batched device dispatch with
        one fetch; initializing/lost agents batch their extractions
        (SURVEY.md §2.10: the reference's N per-agent CUDA pipelines,
        swarm_map.cc:310-341, become a single batched program)."""
        live = [(a, img) for a, img in zip(self.agents, images) if img is not None]
        handled = [False] * len(live)

        # 1. the fused cohort: agents in steady state with a motion model
        fused: list[tuple[int, object, np.ndarray]] = []  # (live idx, inputs, slots)
        with STATS.stage("prepare"):
            for i, (a, img) in enumerate(live):
                tr = a.system.tracking
                if tr.fused_eligible() and img.shape == live[0][1].shape:
                    prep = tr.prepare_fused(img)
                    if prep is not None:
                        fused.append((i, prep[0], prep[1]))
        if len(fused) > 1:
            if self.config.double_buffer:
                self._step_fused_double_buffered(live, fused, ts)
            else:
                self._step_fused_cohort(live, fused, ts)
            for i, _, _ in fused:
                handled[i] = True
        else:
            # no cohort this frame: commit any in-flight speculative
            # dispatch before agents take the staged path
            self._flush_pending()
        # (a single fused agent goes through agent.track -> _track_fused,
        # same program unbatched)

        # 2. batch-extract for the remaining (initializing / lost) agents
        feats_per_agent: list = [None] * len(live)
        needs_ext = [i for i in range(len(live)) if not handled[i]]
        if len(needs_ext) > 1 and all(
            live[i][1].shape == live[needs_ext[0]][1].shape for i in needs_ext
        ):
            from .ops import extractor as ex

            orb = self.settings.orb
            batch = ex.extract_orb_batched(
                torch.from_numpy(np.stack([live[i][1] for i in needs_ext])).to(self.device),
                n_features=orb.n_features, n_levels=orb.n_levels,
                scale=orb.scale_factor, th_high=float(orb.ini_th_fast),
                th_low=float(orb.min_th_fast),
            )
            for j, i in enumerate(needs_ext):
                feats_per_agent[i] = ex.FrameFeatures(
                    *(leaf[j] for leaf in batch)
                )
        with STATS.stage("staged_track"):
            for i, (agent, img) in enumerate(live):
                if not handled[i]:
                    agent.track(img, ts, features=feats_per_agent[i])
        # emergency brake against map starvation: a tracker whose inlier
        # support is collapsing while the async mapping worker is
        # backlogged is outrunning its own map (new keyframes queued but
        # not yet triangulated).  Drain that agent's queue before the
        # next frame — a rare, bounded stall beats the death spiral into
        # relocalization (the reference never hits this because its
        # mapping thread is never minutes behind a 20 fps camera).
        for agent, _img in live:
            tr = agent.system.tracking
            lm = agent.system.local_mapping
            if (lm.busy and tr.state.name == "OK"
                    and tr.matches_inliers < 1.5 * tr.p.min_inliers_local):
                _log.info("agent %d starving (inliers=%d, queue=%d) — "
                          "draining mapping queue", agent.agent_id,
                          tr.matches_inliers, len(lm.queue))
                lm.wait_idle(timeout=30.0)
        self.frame_count += 1
        if self.frame_count % self.config.report_every == 0:
            for agent in self.agents:
                self.scheduler.report_state(
                    agent.agent_id, agent.system.get_system_state()
                )
        if self.frame_count % self.config.push_every == 0:
            # a distribute may rebase the map; a pending speculative
            # dispatch would then commit old-gauge poses — flush first
            self._flush_pending()
            with STATS.stage("sync"):
                self.sync()

    def _step_fused_cohort(self, live, fused, ts: float):
        """Run all steady-state agents' frames as ONE device dispatch +
        ONE batched fetch, then commit each agent's result on host."""
        self._flush_pending()
        pend = self._dispatch_fused(live, fused, ts)
        self._commit_pending(pend)

    def _step_fused_double_buffered(self, live, fused, ts: float):
        """Dispatch frame t BEFORE committing frame t-1.

        The previous frame's results are still device-resident when t is
        dispatched: the pose guess chains on device (constant velocity
        from the uncommitted pose), so the device starts t's extraction
        while the host fetches and commits t-1 — the fetch and all host
        commit work overlap device execution.  Costs one commit of
        staleness in the local-map bucket; a cohort change or a sync
        boundary flushes first."""
        pend = self._pending
        cur_ids = {id(live[i][0]) for i, _, _ in fused}
        if pend is not None and set(pend["rows"]) != cur_ids:
            self._flush_pending()
            pend = None
        self._pending = None
        new_pend = self._dispatch_fused(live, fused, ts, chain=pend)
        if pend is not None:
            fallen = self._commit_pending(pend)
            # a fallen agent's speculative guess chained off a bad pose:
            # its frame-t row commits via the staged path instead
            new_pend["invalid"] |= fallen
        self._pending = new_pend

    def _flush_pending(self):
        if self._pending is not None:
            pend, self._pending = self._pending, None
            self._commit_pending(pend)

    def _dispatch_fused(self, live, fused, ts: float, chain=None) -> dict:
        """Stack + upload the cohort inputs and dispatch the batched step;
        returns the pending-commit record.  With `chain`, pose guesses for
        agents present in the previous (uncommitted) dispatch are chained
        ON DEVICE: guess(t) = V P(t-1) with V = P(t-1) P(t-2)^-1 — no host
        fetch on the critical path."""
        from . import pipeline
        from .utils.device import fetch_async, upload

        orb = self.settings.orb
        hw = tuple(live[fused[0][0]][1].shape[:2])
        mesh_mode = self.mesh is not None
        if mesh_mode:
            # full-width batch (one row per agent; non-fused rows are
            # dummies whose outputs are discarded) so every shard holds
            # its agents; the batch and its outputs live on the mesh's
            # lead device
            rows = {id(live[i][0]): self.agents.index(live[i][0])
                    for i, _, _ in fused}
            n_rows = len(self.agents)
            dev = self.mesh.lead
        else:
            rows = {id(live[i][0]): j for j, (i, _, _) in enumerate(fused)}
            n_rows = len(fused)
            dev = self.device
        with STATS.stage("h2d"):
            ref_inp = fused[0][1]
            stacked = []
            for f in pipeline.TrackInputs._fields:
                proto = getattr(ref_inp, f)
                buf = np.zeros((n_rows,) + np.shape(proto),
                               np.asarray(proto).dtype)
                if f == "Tcw_guess":
                    buf[:] = np.eye(4, dtype=np.float32)
                elif f == "K":
                    buf[:] = self.settings.camera.K.astype(np.float32)
                elif f == "dist":
                    buf[:] = self.settings.camera.dist.astype(np.float32)
                for i, inp, _ in fused:
                    buf[rows[id(live[i][0])]] = getattr(inp, f)
                # descriptor words are int32 on the device (same bits)
                stacked.append(buf.view(np.int32) if buf.dtype == np.uint32 else buf)
            inputs = pipeline.TrackInputs(*upload(*stacked, device=dev))
        if chain is not None:
            sel_new, sel_old, Ppp_inv = [], [], []
            for i, _inp, _slots in fused:
                agent = live[i][0]
                aid = id(agent)
                lf = agent.system.tracking.last_frame
                if (aid in chain["rows"] and aid not in chain["invalid"]
                        and lf is not None and lf.pose_cw is not None):
                    sel_new.append(rows[aid])
                    sel_old.append(chain["rows"][aid])
                    Ppp_inv.append(np.linalg.inv(lf.pose_cw))
            if sel_new:
                P_prev = chain["out"].Tcw[torch.tensor(sel_old, device=dev)]
                G = P_prev @ torch.from_numpy(
                    np.stack(Ppp_inv).astype(np.float32)).to(dev) @ P_prev
                # a new guess tensor: the uploaded one is not written in place
                inputs = inputs._replace(Tcw_guess=inputs.Tcw_guess.index_put(
                    (torch.tensor(sel_new, device=dev),), G))
        with STATS.stage("dispatch"):
            STATS.bump("rpc_dispatch")
            window_th = self.agents[0].system.tracking.p.fused_window_th
            if mesh_mode:
                if self._mesh_step is None:
                    self._mesh_step = pipeline.make_multi_agent_step(
                        n_features=orb.n_features, n_levels=orb.n_levels,
                        scale=orb.scale_factor, hw=hw,
                        window_th=window_th, mesh=self.mesh,
                        n_overlap_desc=self._n_overlap_desc,
                    )
                out, overlap_dev, _total = self._mesh_step(inputs)
            else:
                out = pipeline.batched_tracking_step(
                    inputs, n_features=orb.n_features, n_levels=orb.n_levels,
                    scale=orb.scale_factor, hw=hw, window_th=window_th,
                )
                overlap_dev = None
        feats = out.features
        # enqueue the feature D2H now, behind the step: the copies stream
        # while the blocking pose fetch is in flight, so a keyframe frame's
        # ensure_features() finds the bytes already host-resident instead
        # of paying its own round trip
        feat_copy = fetch_async(feats.xy, out.xy_ud, feats.octave, feats.angle,
                                feats.response, feats.desc, feats.valid)
        feats_host: list = []
        feats_lock = threading.Lock()

        def _fetch_all_feats():
            """ONE whole-cohort feature fetch, shared by every agent's
            lazy provider (2 KFs in one step = still one fetch)."""
            with feats_lock:
                if not feats_host:
                    xy, xy_ud, octv, ang, resp, desc, valid = feat_copy.result()
                    feats_host.append((xy, xy_ud, octv, ang, resp,
                                       desc.view(np.uint32), valid))
                return feats_host[0]

        # wait for the feature copies on the pool thread, concurrently with
        # the pose fetch at commit time: a keyframe frame's
        # ensure_features() is then a host-memory hit
        self._prefetch_pool.submit(_fetch_all_feats)
        self.fused_cohort_dispatches += 1
        return {
            "out": out, "overlap_dev": overlap_dev, "rows": rows,
            "items": [(live[i][0], live[i][1], slots) for i, _, slots in fused],
            "ts": ts, "invalid": set(), "fetch_feats": _fetch_all_feats,
        }

    def _commit_pending(self, pend: dict) -> set:
        """Fetch the dispatch's (pose, inliers, matches) and commit every
        agent's frame on host.  Returns the ids of agents whose commit
        fell back to the staged path (low inliers) — a double-buffered
        successor dispatch chained its guess off those rows and must not
        trust its speculative result."""
        from .utils.device import fetch

        out, rows, ts = pend["out"], pend["rows"], pend["ts"]
        with STATS.stage("fetch"):
            # steady path fetches ONLY (pose, inliers, matches) — the
            # feature arrays stay device-resident behind per-agent lazy
            # providers and leave the device only on keyframe / fallback
            # frames (~1 in 4-20)
            if pend["overlap_dev"] is not None:
                Tcw_b, ninl_b, match_b, overlap = fetch(
                    out.Tcw, out.n_inliers, out.match_mp, pend["overlap_dev"])
                self._update_overlap_hint(overlap, rows)
            else:
                Tcw_b, ninl_b, match_b = fetch(out.Tcw, out.n_inliers, out.match_mp)
        fallen: set = set()
        with STATS.stage("commit"):
            for agent, img, slots in pend["items"]:
                tr = agent.system.tracking
                j = rows[id(agent)]
                if id(agent) in pend["invalid"]:
                    # speculative result built on a bad chained guess —
                    # track the stored frame through the staged path
                    agent.track(img, ts)
                    fallen.add(id(agent))
                    continue
                if int(ninl_b[j]) < tr.p.min_inliers_local:
                    fallen.add(id(agent))

                def provider(j=j, f=pend["fetch_feats"]):
                    return tuple(a[j] for a in f())

                frame = tr.commit_fused(img, ts, slots, Tcw_b[j], ninl_b[j],
                                        match_b[j], provider)
                pose = tr.finish_frame(frame, ts)
                if pose is not None:
                    agent.frames_tracked += 1
        return fallen

    def _update_overlap_hint(self, overlap: np.ndarray, rows: dict):
        """Feed the cross-agent descriptor-overlap matrix to the server's
        place-recognition budget (it ranks Sim3 attempts).  Only the agent
        mesh's step computes the matrix, so only a mesh Swarm calls this."""
        self.overlap_hint = overlap
        n = overlap.shape[1]
        for agent in self.agents:
            j = rows.get(id(agent))
            if j is None:
                continue
            med = self.mediators[agent.agent_id] if agent.agent_id < len(self.mediators) else None
            if med is not None:
                med.overlap_hint = {
                    o: float(overlap[j, o]) / self._overlap_norm
                    for o in range(n) if o != j
                }

    def sync(self):
        """Push all agents' deltas, run the scheduler, deliver replies.
        With async_server the worker thread drains the queue instead of
        this call (the reference's scheduler worker)."""
        for agent in self.agents:
            with agent.system.store.lock:
                payload = agent.push_payload()
            if payload is not None:
                self.scheduler.enqueue_request(agent.agent_id, payload)
        if not self.config.async_server:
            self.scheduler.process_pending()
        self._deliver_pending()

    def _deliver_pending(self):
        """Hand queued server distributes to their clients.  The worker
        thread appends concurrently; swap each list out under the lock,
        deliver outside it."""
        for agent in self.agents:
            with self._dist_lock:
                batch = self._pending_distribute[agent.agent_id]
                if not batch:
                    continue
                self._pending_distribute[agent.agent_id] = []
            for payload in batch:
                agent.receive_distribute(payload)

    def _drain_server(self, timeout: float = 300.0):
        """Drain the async server queue while PUMPING distributes to the
        clients — the live cadence.  Parking them until the end would
        leave every queued push in the pre-correction gauge after a
        server-side loop correction (the stale-gauge guard covers that,
        but prompt delivery retires it the way live operation does)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            self._deliver_pending()
            with self.scheduler._cv:
                idle = (not self.scheduler._heap
                        and not getattr(self.scheduler, "_in_flight", False))
            if idle:
                break
            _time.sleep(0.05)
        self._deliver_pending()

    def finish(self):
        """Final flush (reference stops after 6 empty pushes; one final
        sync is enough for the synchronous harness)."""
        self._flush_pending()
        self._prefetch_pool.shutdown(wait=True)
        if self.config.async_mapping:
            for a in self.agents:
                a.system.local_mapping.stop_async()
        if self.config.async_server:
            self._drain_server()
        # final inter-map gauge polish over the full live duplicate-pair
        # set (the merge-time refinement only saw its own fuse pairs);
        # the queue is drained, so the stores are quiescent
        self.map_manager.polish_group_transforms()
        # joint merged-group GBA: couples the member maps through their
        # cross-map duplicate observations (SURVEY.md §5); self-checking
        # — applies only when the group chi2 improves — and runs
        # observation-sharded when an agent mesh is up
        for gid, members in list(self.map_manager.groups.items()):
            if len(members) >= 2:
                self.map_manager.group_global_ba(
                    gid, mesh=self.gba_mesh,
                    scale_factor=self.settings.orb.scale_factor)
        self.map_manager.polish_group_transforms()
        self.sync()
        if self.config.async_server:
            self._drain_server()
            self.scheduler.stop()
            self._deliver_pending()

    # -- outputs ---------------------------------------------------------------
    def merged_groups(self) -> list[set[int]]:
        return [set(v) for v in self.map_manager.groups.values()]

    def save_outputs(self, out_dir):
        from pathlib import Path

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for agent in self.agents:
            agent.system.save_keyframe_trajectory_tum(
                out / f"KeyFrameTrajectory-client-{agent.agent_id}.txt"
            )
        for med in self.mediators:
            med.save_map(out / f"map-server-{med.map_id}.bin")
        self.map_manager.save_global_trajectories(out)
