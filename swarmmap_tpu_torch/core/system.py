"""System facade (reference: code/src/System.cc).

Port of swarmmap_tpu/core/system.py: wires vocabulary, map store,
keyframe database, tracking and local mapping for one agent, on one
device (by default the card).  Like the reference client, loop closing is
NOT run here — it lives server-side in the mediator (System.cc:96-97); the
AddLoopClosing map events flow to it through the sync layer.

Not ported yet, and raising NotImplementedError: `track_stereo` (ROADMAP
queue 1, item 16).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.vocab import Vocabulary, default_vocabulary
from ..utils.config import Settings
from ..utils.device import default_device
from ..utils.logging import get_logger
from ..utils.trajectory import save_tum
from .keyframe_db import KeyFrameDatabase
from .local_mapping import LocalMapping
from .map_store import MapStore
from .tracking import SystemState, Tracking, TrackingParams, TrackingState

_log = get_logger("system")


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


class System:
    def __init__(
        self,
        settings: Settings,
        vocab: Vocabulary | None = None,
        map_id: int = 0,
        tracking_params: TrackingParams | None = None,
        log_fn=None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        """`device` runs tracking's and mapping's device programs; by
        default the card (`utils.device.default_device`), which raises
        where there is none.  Tests pass device="cpu"."""
        device = torch.device(default_device() if device is None else device)
        self.settings = settings
        self.vocab = vocab or default_vocabulary()
        n_kp = _round_up(settings.orb.n_features)
        self.store = MapStore(map_id=map_id, n_kp=n_kp, log_fn=log_fn)
        self.kfdb = KeyFrameDatabase(self.vocab)
        self.local_mapping = LocalMapping(self.store, settings, kfdb=self.kfdb,
                                          device=device)
        self.tracking = Tracking(
            settings, self.store, self.kfdb, self.vocab,
            local_mapping=self.local_mapping,
            params=tracking_params, rng_seed=rng_seed, device=device,
        )

    # -- reference System public API ------------------------------------------
    def track_monocular(self, image: np.ndarray, timestamp: float) -> np.ndarray | None:
        """reference: System::TrackMonocular"""
        return self.tracking.grab(image, timestamp)

    def track_rgbd(self, image: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> np.ndarray | None:
        """reference: System::TrackRGBD"""
        return self.tracking.grab(image, timestamp, depth_image=depth)

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float, baseline: float = 0.12) -> np.ndarray | None:
        """reference: System::TrackStereo"""
        raise NotImplementedError(
            "stereo tracking (ops/stereo.py) is not ported yet (ROADMAP queue 1, item 16)")

    @property
    def state(self) -> TrackingState:
        return self.tracking.state

    def get_system_state(self) -> SystemState:
        return self.tracking.system_state()

    def shutdown(self):
        """Drain and stop the async mapping worker, if one runs."""
        self.local_mapping.stop_async()

    def n_keyframes(self) -> int:
        return int(self.store.kf_alive[: self.store.n_kf].sum())

    def n_map_points(self) -> int:
        return int(self.store.mp_alive[: self.store.n_mp].sum())

    def save_keyframe_trajectory_tum(self, path: str | Path):
        """reference: System::SaveKeyFrameTrajectoryTUM (System.cc:205+)"""
        st = self.store
        slots = st.alive_kf_slots()
        order = np.argsort(st.kf_ts[slots])
        poses, stamps = [], []
        for k in slots[order]:
            poses.append(np.linalg.inv(st.kf_global_pose(k)))
            stamps.append(st.kf_ts[k])
        if poses:
            save_tum(path, np.asarray(stamps), np.stack(poses))
        else:  # reference opens the ofstream unconditionally
            Path(path).write_text("")

    def save_frame_trajectory_tum(self, path: str | Path):
        tr = self.tracking.trajectory
        if tr:
            stamps = np.asarray([t for t, _ in tr])
            poses = np.stack([T for _, T in tr])
            save_tum(path, stamps, poses)
        else:
            Path(path).write_text("")

    # -- client-side map checkpoints (reference: System.cc:349,370) -----------
    def save_map(self, path: str | Path, fmt: str = "msgpack"):
        """Write the client map checkpoint — the reference's
        `map-client-<id>.bin` (System::SaveMap, System.cc:349 — the whole
        map + the keyframe database's inverted file).  fmt="boost-bin"
        exports the reference's binary-archive layout so its tooling can
        read maps built here; the default is the compact msgpack slice
        (decode auto-sniffs both).  The same bytes as the JAX package's
        save of the same map."""
        from ..sync import codec
        from ..sync.oplog import full_archive

        with self.store.lock:
            arc = full_archive(self.store)
            if fmt == "boost-bin":
                from ..sync import boost_bin

                inv = self.kfdb.inverted  # word id -> kf slots
                n_words = max(inv.keys(), default=-1) + 1
                inverted = [
                    sorted(int(self.store.kf_gid[k]) for k in inv.get(w, ())
                           if self.store.kf_alive[k])
                    for w in range(n_words)
                ]
                data = boost_bin.encode_map_bin(arc.kfs, arc.mps,
                                                inverted_file=inverted)
            else:
                data = codec.encode_slice(arc)
        Path(path).write_bytes(data)
        _log.info("map saved to %s (%d KFs, %d MPs)", path,
                  len(arc.kfs), len(arc.mps))

    def load_map(self, path: str | Path) -> bool:
        """Load a saved map checkpoint into this client (reference:
        System::LoadMap, System.cc:370 — deserialize, then rebuild the
        keyframe database via ComputeBoW).  Returns False when the file
        does not exist (the reference starts a fresh map then)."""
        path = Path(path)
        if not path.exists():
            _log.warning("cannot open map file %s — starting fresh", path)
            return False
        from ..sync import codec
        from ..sync.oplog import Mapit

        sl = codec.decode_slice(path.read_bytes())
        with self.store.lock:
            prev_log = self.store.log_fn
            Mapit(self.store).apply_slice(sl, vocab=self.vocab)
            self.store.log_fn = prev_log
            # reference: for kf in GetAllKeyFrames(): kf->ComputeBoW()
            for k in self.store.alive_kf_slots():
                self.kfdb.add(self.store, int(k))
        _log.info("map loaded from %s: %d keyframes, %d points", path,
                  self.n_keyframes(), self.n_map_points())
        return True
