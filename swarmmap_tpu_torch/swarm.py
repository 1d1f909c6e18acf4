"""The client side of the swarm: one agent's SLAM system with its change log
and sync endpoints.

Port of `SwarmAgent` from swarmmap_tpu/swarm.py (reference spec:
Examples/Monocular/swarm_map.cc — each client tracks frame by frame,
reports its state every 500 ms and pushes its map every 2 s).  The
in-process harness around it (`Swarm`, `SwarmConfig`, the fused cohort
dispatch) needs the server and is not ported yet (ROADMAP queue 1, item
12).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.system import System
from .core.tracking import TrackingParams
from .ops.vocab import Vocabulary
from .sync import codec
from .sync.oplog import Mapit
from .utils.config import Settings
from .utils.logging import get_logger

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
