"""The map as struct-of-arrays + host bookkeeping.

Copy of swarmmap_tpu/core/map_store.py (numpy + the native covisibility
and redundancy passes of swarmmap_tpu_torch/native.py), which the port
cannot import on a machine without JAX.

Replaces the reference's pointer-graph of KeyFrame*/MapPoint* objects
(code/src/{KeyFrame,MapPoint,Map}.cc of the C++ SwarmMap) with padded numpy
arrays (device-transferable slices) and python dict indices: alive-masks
replace SetBadFlag, compaction replaces deletion (SURVEY.md §7.1).

Global-id scheme mirrors the reference so multi-agent merging works the
same way: id = local_counter + map_id * MAP_BASE (KeyFrame.cc:65,
Map.h:45 MAP_BASE=1000000); the originating map of any element is
id // MAP_BASE (KeyFrame.cc:1008).

Every mutator that the reference instruments with bAddUpdate takes a
`log` flag and emits an update record through `self.log_fn` — the hook
where the Mapit change log (L4) attaches.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np

from .. import MAP_BASE
from ..utils.logging import get_logger
from ..utils.timer import global_clock

_log = get_logger("map")

NO_MP = -1


def _grow(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out


@dataclasses.dataclass
class SetTransformGuard:
    """Scale-jump rejection + interpolation for the map's local->world
    Sim3 (reference: Map::SetTransform, Map.cc:450-486)."""

    scale_lo: float = 0.8
    scale_hi: float = 1.2
    blend: float = 0.9  # weight of the NEW transform


class MapStore:
    """One agent's map (client) or its server-side replica."""

    def __init__(
        self,
        map_id: int = 0,
        kf_capacity: int = 64,
        mp_capacity: int = 4096,
        n_kp: int = 1024,
        log_fn: Callable | None = None,
        is_server: bool = False,
    ):
        self.map_id = map_id
        self.n_kp = n_kp
        self.log_fn = log_fn  # (kind, func, global_id, args) -> None
        self.is_server = is_server

        # -- keyframes ------------------------------------------------------
        self.n_kf = 0
        self.kf_pose_cw = np.zeros((kf_capacity, 4, 4), np.float32)
        self.kf_ts = np.zeros(kf_capacity, np.float64)
        self.kf_created = np.zeros(kf_capacity, np.float32)  # STS clock
        self.kf_alive = np.zeros(kf_capacity, bool)
        self.kf_genuine = np.ones(kf_capacity, bool)   # False => synthesized (MBP)
        self.kf_gid = np.full(kf_capacity, -1, np.int64)
        self.kf_frame_id = np.zeros(kf_capacity, np.int64)
        self.kf_kp_uv = np.zeros((kf_capacity, n_kp, 2), np.float32)
        self.kf_kp_octave = np.zeros((kf_capacity, n_kp), np.int32)
        self.kf_kp_angle = np.zeros((kf_capacity, n_kp), np.float32)
        self.kf_kp_response = np.zeros((kf_capacity, n_kp), np.float32)
        self.kf_kp_valid = np.zeros((kf_capacity, n_kp), bool)
        self.kf_desc = np.zeros((kf_capacity, n_kp, 8), np.uint32)
        self.kf_words = np.full((kf_capacity, n_kp), -1, np.int32)
        self.kf_nodes = np.full((kf_capacity, n_kp), -1, np.int32)
        self.kf_kp_mp = np.full((kf_capacity, n_kp), NO_MP, np.int32)
        self.kf_parent = np.full(kf_capacity, -1, np.int32)     # spanning tree
        self.kf_velocity = np.zeros(kf_capacity, np.float32)    # MBP feature
        self.kf_K = np.zeros((kf_capacity, 3, 3), np.float32)
        self.kf_hw = np.zeros((kf_capacity, 2), np.int32)       # image size
        self.kf_to_serialize = np.zeros(kf_capacity, bool)      # mbToBeSerialized
        self.kf_loop_edges: dict[int, set[int]] = {}
        # stale-gauge guard (server replicas): a loop/pose-graph
        # correction rebases every pose, but client pushes created BEFORE
        # the correction round-tripped still carry the old gauge —
        # applying them verbatim leaves the map half-corrected and the
        # next GBA blends the two gauges into a permanent warp.  The
        # correction records each slot's pre-correction pose (+ the
        # per-node Sim3 scale); the op-log apply path uses them to
        # re-express stale ops in the corrected frame (sync/oplog.py).
        self.kf_corrected = np.zeros(kf_capacity, bool)
        self.kf_pre_corr_pose = np.zeros((kf_capacity, 4, 4), np.float32)
        # fixed post-correction snapshot: stale ops conjugate onto THIS,
        # not the live pose — successive stale slices carry CUMULATIVE
        # client deltas, so composing onto the live (already-conjugated)
        # pose would double-apply them and blow the gauge up
        self.kf_post_corr_pose = np.zeros((kf_capacity, 4, 4), np.float32)
        self.kf_corr_scale = np.ones(kf_capacity, np.float32)
        # monotonically increasing gauge epoch: incremented by every
        # accepted server-side correction, echoed by clients in their
        # pushes (MapSlice.epoch) so staleness is decided by protocol
        # metadata, not a geometric vote over SetPose records — a
        # backlogged push carrying only NEW elements has no poses to
        # vote with, yet is exactly the stale case the guard exists for
        self.gauge_epoch = 0

        # -- map points -----------------------------------------------------
        self.n_mp = 0
        self.mp_pos = np.zeros((mp_capacity, 3), np.float32)
        self.mp_normal = np.zeros((mp_capacity, 3), np.float32)
        self.mp_min_dist = np.zeros(mp_capacity, np.float32)
        self.mp_max_dist = np.zeros(mp_capacity, np.float32)
        self.mp_desc = np.zeros((mp_capacity, 8), np.uint32)
        self.mp_alive = np.zeros(mp_capacity, bool)
        self.mp_gid = np.full(mp_capacity, -1, np.int64)
        self.mp_ref_kf = np.full(mp_capacity, -1, np.int32)
        self.mp_first_kf = np.full(mp_capacity, -1, np.int32)
        self.mp_visible = np.zeros(mp_capacity, np.int32)
        self.mp_found = np.zeros(mp_capacity, np.int32)
        self.mp_created = np.zeros(mp_capacity, np.float32)     # STS clock
        self.mp_last_tracked = np.zeros(mp_capacity, np.float32)
        self.mp_update_count = np.zeros(mp_capacity, np.int32)  # MBP feature
        self.mp_cam_velocity = np.zeros(mp_capacity, np.float32)
        self.mp_to_serialize = np.zeros(mp_capacity, bool)
        self.mp_corrected = np.zeros(mp_capacity, bool)
        self.mp_pre_corr_pos = np.zeros((mp_capacity, 3), np.float32)
        self.mp_post_corr_pos = np.zeros((mp_capacity, 3), np.float32)

        # observations: mp slot -> {kf slot: kp idx}
        self.obs: dict[int, dict[int, int]] = {}
        # array-resident mirror of the observation table: parallel
        # (mp, kf, kp, alive) rows + per-point observer counts, so BA /
        # scoring / local-map assembly are numpy gathers instead of dict
        # walks (reference pays this cost in native C++ setup loops,
        # Optimizer.cc:436-741; Python must use arrays)
        obs_cap = 4 * mp_capacity
        self.obs_n = 0
        self.obs_mp = np.full(obs_cap, -1, np.int32)
        self.obs_kf = np.full(obs_cap, -1, np.int32)
        self.obs_kp = np.zeros(obs_cap, np.int32)
        self.obs_alive = np.zeros(obs_cap, bool)
        self._obs_row: dict[tuple[int, int], int] = {}
        self._obs_dead = 0
        self._obs_version = 0          # bumped on every obs mutation
        self._obs_cache = None         # (version, (mp, kf, kp)) for obs_arrays
        self.mp_nobs = np.zeros(mp_capacity, np.int32)
        # covisibility: kf slot -> {kf slot: shared count}
        self.covis: dict[int, dict[int, int]] = {}

        # id registries (global id -> slot) — includes foreign elements
        # inserted by map sync (their gid // MAP_BASE != self.map_id)
        self.kf_by_gid: dict[int, int] = {}
        self.mp_by_gid: dict[int, int] = {}
        self._next_kf_local = 0
        self._next_mp_local = 0

        # local -> world Sim3 (R, t, s); identity until a merge
        self.Twl_R = np.eye(3, dtype=np.float32)
        self.Twl_t = np.zeros(3, np.float32)
        self.Twl_s = np.float32(1.0)
        self.transform_guard = SetTransformGuard()
        self.group_id = map_id  # map group (server-side merging)

        # restoration queues for out-of-order sync (Map.cc:401-423)
        self.pending_obs: list[tuple[int, int, int]] = []  # (mp_gid, kf_gid, kp)
        # serializes tracking-vs-mapping mutations in async-mapping mode
        # (reference: per-object mutexes in KeyFrame/MapPoint/Map);
        # reentrant so nested mutators compose. Uncontended cost ~100ns.
        self.lock = threading.RLock()
        # points whose observation sets changed since last refresh — the
        # descriptor/normal recompute loops only touch these
        self.dirty_mps: set[int] = set()
        # points whose visible/found counters changed since the last push
        # (drained by Mapit.archive into last-writer SetVisible/SetFound)
        self.dirty_vis: set[int] = set()
        self.dirty_found: set[int] = set()

    # -- observation-table rows ----------------------------------------------
    def _obs_add_row(self, m: int, k: int, kp: int):
        row = self._obs_row.get((m, k))
        if row is not None:
            self.obs_kp[row] = kp
            self._obs_version += 1
            return
        if self.obs_n >= len(self.obs_mp):
            if self._obs_dead * 2 > self.obs_n:
                self._obs_compact()
            else:
                for name in ("obs_mp", "obs_kf", "obs_kp", "obs_alive"):
                    setattr(self, name,
                            _grow(getattr(self, name), 2 * len(self.obs_mp)))
                self.obs_mp[self.obs_n:] = -1
                self.obs_kf[self.obs_n:] = -1
        row = self.obs_n
        self.obs_n += 1
        self._obs_version += 1
        self.obs_mp[row] = m
        self.obs_kf[row] = k
        self.obs_kp[row] = kp
        self.obs_alive[row] = True
        self._obs_row[(m, k)] = row
        self.mp_nobs[m] += 1

    def _obs_del_row(self, m: int, k: int):
        row = self._obs_row.pop((m, k), None)
        if row is not None:
            self.obs_alive[row] = False
            self.mp_nobs[m] -= 1
            self._obs_dead += 1
            self._obs_version += 1

    def _obs_compact(self):
        """Drop dead rows in place (amortized; keeps gathers dense)."""
        n = self.obs_n
        keep = np.where(self.obs_alive[:n])[0]
        m = len(keep)
        self.obs_mp[:m] = self.obs_mp[keep]
        self.obs_kf[:m] = self.obs_kf[keep]
        self.obs_kp[:m] = self.obs_kp[keep]
        self.obs_alive[:m] = True
        self.obs_alive[m:n] = False
        self.obs_n = m
        self._obs_dead = 0
        self._obs_row = {
            (int(self.obs_mp[r]), int(self.obs_kf[r])): r for r in range(m)
        }

    def clone(self) -> "MapStore":
        """Deep snapshot for A/B experiments and tests: arrays copied,
        index dicts/sets deep-copied, fresh lock; the log hook is kept
        by reference (pass log_fn=None stores for isolated clones)."""
        import copy as _copy

        new = object.__new__(MapStore)
        for key, v in self.__dict__.items():
            if key == "lock":
                new.lock = threading.RLock()
            elif key == "_obs_cache":
                new._obs_cache = None
            elif isinstance(v, np.ndarray):
                setattr(new, key, v.copy())
            elif isinstance(v, (dict, set, list)):
                setattr(new, key, _copy.deepcopy(v))
            else:
                setattr(new, key, v)
        return new

    def obs_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Live observation rows as (mp, kf, kp) arrays — the batch
        interface for BA assembly, scoring, and local-map collection.
        Cached per obs-version (it runs per frame per agent on the
        tracker's hot path); callers must treat the arrays as
        READ-ONLY — they are shared until the next obs mutation."""
        c = self._obs_cache
        if c is not None and c[0] == self._obs_version:
            return c[1]
        n = self.obs_n
        a = self.obs_alive[:n]
        out = (self.obs_mp[:n][a], self.obs_kf[:n][a], self.obs_kp[:n][a])
        self._obs_cache = (self._obs_version, out)
        return out

    # -- logging hook --------------------------------------------------------
    def _emit(self, kind: str, func: str, gid: int, args: tuple, log: bool):
        if log and self.log_fn is not None:
            self.log_fn(kind, func, gid, args)

    # -- capacity ------------------------------------------------------------
    def _ensure_kf_capacity(self):
        if self.n_kf < len(self.kf_alive):
            return
        cap = len(self.kf_alive) * 2
        for name in (
            "kf_pose_cw kf_ts kf_created kf_alive kf_genuine kf_gid kf_frame_id "
            "kf_kp_uv kf_kp_octave kf_kp_angle kf_kp_response kf_kp_valid "
            "kf_desc kf_words kf_nodes kf_kp_mp kf_parent kf_velocity kf_K "
            "kf_hw kf_to_serialize kf_corrected kf_pre_corr_pose "
            "kf_post_corr_pose kf_corr_scale"
        ).split():
            setattr(self, name, _grow(getattr(self, name), cap))
        self.kf_corr_scale[self.n_kf :] = 1.0
        self.kf_parent[self.n_kf :] = -1
        self.kf_gid[self.n_kf :] = -1
        self.kf_kp_mp[self.n_kf :] = NO_MP
        self.kf_words[self.n_kf :] = -1
        self.kf_nodes[self.n_kf :] = -1
        self.kf_genuine[self.n_kf:] = True

    def _ensure_mp_capacity(self):
        if self.n_mp < len(self.mp_alive):
            return
        cap = len(self.mp_alive) * 2
        for name in (
            "mp_pos mp_normal mp_min_dist mp_max_dist mp_desc mp_alive mp_gid "
            "mp_ref_kf mp_first_kf mp_visible mp_found mp_created "
            "mp_last_tracked mp_update_count mp_cam_velocity mp_to_serialize "
            "mp_nobs mp_corrected mp_pre_corr_pos mp_post_corr_pos"
        ).split():
            setattr(self, name, _grow(getattr(self, name), cap))
        self.mp_gid[self.n_mp :] = -1
        self.mp_ref_kf[self.n_mp :] = -1
        self.mp_first_kf[self.n_mp :] = -1

    # -- id allocation ---------------------------------------------------------
    def claim_kf_gid(self) -> int:
        gid = self._next_kf_local + self.map_id * MAP_BASE
        self._next_kf_local += 1
        return gid

    def claim_mp_gid(self) -> int:
        gid = self._next_mp_local + self.map_id * MAP_BASE
        self._next_mp_local += 1
        return gid

    def set_map_id(self, new_id: int):
        """Re-key the id space after server registration
        (reference: Map::SetId, Map.cc:513-525)."""
        old = self.map_id
        if new_id == old:
            return
        self.map_id = new_id
        self.group_id = new_id
        delta = (new_id - old) * MAP_BASE
        self.kf_by_gid = {g + delta: s for g, s in self.kf_by_gid.items()}
        self.mp_by_gid = {g + delta: s for g, s in self.mp_by_gid.items()}
        self.kf_gid[: self.n_kf] += delta
        self.mp_gid[: self.n_mp] += delta

    def origin_map_of(self, gid: int) -> int:
        return int(gid) // MAP_BASE

    # -- keyframes -------------------------------------------------------------
    def add_keyframe(
        self,
        pose_cw: np.ndarray,
        K: np.ndarray,
        kp_uv: np.ndarray,
        kp_octave: np.ndarray,
        kp_angle: np.ndarray,
        kp_response: np.ndarray,
        kp_valid: np.ndarray,
        desc: np.ndarray,
        ts: float = 0.0,
        frame_id: int = 0,
        gid: int | None = None,
        genuine: bool = True,
        velocity: float = 0.0,
        hw: tuple[int, int] = (480, 640),
        log: bool = True,
    ) -> int:
        self._ensure_kf_capacity()
        k = self.n_kf
        self.n_kf += 1
        self.kf_pose_cw[k] = pose_cw
        self.kf_K[k] = K
        self.kf_ts[k] = ts
        self.kf_created[k] = global_clock()
        self.kf_alive[k] = True
        self.kf_genuine[k] = genuine
        n = min(len(kp_uv), self.n_kp)
        self.kf_kp_uv[k, :n] = kp_uv[:n]
        self.kf_kp_octave[k, :n] = kp_octave[:n]
        self.kf_kp_angle[k, :n] = kp_angle[:n]
        self.kf_kp_response[k, :n] = kp_response[:n]
        self.kf_kp_valid[k, :n] = kp_valid[:n]
        self.kf_desc[k, :n] = desc[:n]
        self.kf_frame_id[k] = frame_id
        self.kf_velocity[k] = velocity
        self.kf_hw[k] = hw
        self.kf_gid[k] = self.claim_kf_gid() if gid is None else gid
        self.kf_by_gid[int(self.kf_gid[k])] = k
        self.kf_to_serialize[k] = True
        self.covis[k] = {}
        self.kf_loop_edges[k] = set()
        return k

    def set_kf_pose(self, k: int, pose_cw: np.ndarray, log: bool = True):
        self.kf_pose_cw[k] = pose_cw
        self._emit("kf", "SetPose", int(self.kf_gid[k]), (pose_cw.copy(),), log)

    def kf_center(self, k: int) -> np.ndarray:
        T = self.kf_pose_cw[k]
        return -T[:3, :3].T @ T[:3, 3]

    def set_kf_bad(self, k: int, log: bool = True):
        """SetBadFlag: detach observations, splice spanning tree
        (reference: KeyFrame::SetBadFlag)."""
        if not self.kf_alive[k] or k == 0:
            return
        for kp, mp in enumerate(self.kf_kp_mp[k]):
            if mp != NO_MP:
                self.erase_observation(int(mp), k, log=False)
        # reparent children
        parent = self.kf_parent[k]
        for child in np.where(self.kf_parent[: self.n_kf] == k)[0]:
            self.kf_parent[child] = parent
        # drop covisibility
        for other in list(self.covis.get(k, {})):
            self.covis[other].pop(k, None)
        self.covis[k] = {}
        self.kf_alive[k] = False
        self._emit("kf", "SetBadFlag", int(self.kf_gid[k]), (), log)

    def add_loop_edge(self, k1: int, k2: int, log: bool = True):
        self.kf_loop_edges.setdefault(k1, set()).add(k2)
        self.kf_loop_edges.setdefault(k2, set()).add(k1)
        self._emit("kf", "AddLoopEdge", int(self.kf_gid[k1]),
                   (int(self.kf_gid[k2]),), log)

    # -- map points --------------------------------------------------------------
    def add_map_point(
        self,
        pos: np.ndarray,
        desc: np.ndarray,
        ref_kf: int,
        gid: int | None = None,
        normal: np.ndarray | None = None,
        min_dist: float = 0.1,
        max_dist: float = 100.0,
        cam_velocity: float = 0.0,
        log: bool = True,
    ) -> int:
        self._ensure_mp_capacity()
        m = self.n_mp
        self.n_mp += 1
        self.mp_pos[m] = pos
        self.mp_desc[m] = desc
        self.mp_ref_kf[m] = ref_kf
        self.mp_first_kf[m] = ref_kf
        self.mp_alive[m] = True
        self.mp_visible[m] = 1
        self.mp_found[m] = 1
        self.mp_created[m] = global_clock()
        self.mp_last_tracked[m] = global_clock()
        self.mp_cam_velocity[m] = cam_velocity
        self.mp_normal[m] = normal if normal is not None else [0, 0, 1.0]
        self.mp_min_dist[m] = min_dist
        self.mp_max_dist[m] = max_dist
        self.mp_gid[m] = self.claim_mp_gid() if gid is None else gid
        self.mp_by_gid[int(self.mp_gid[m])] = m
        self.mp_to_serialize[m] = True
        self.obs[m] = {}
        return m

    def set_mp_pos(self, m: int, pos: np.ndarray, log: bool = True):
        self.mp_pos[m] = pos
        self.mp_update_count[m] += 1
        self._emit("mp", "SetWorldPos", int(self.mp_gid[m]), (pos.copy(),), log)

    def add_observation(self, m: int, k: int, kp_idx: int, log: bool = True):
        if m == NO_MP or not self.mp_alive[m]:
            return
        prev = self.obs[m].get(k)
        if prev == kp_idx:
            return
        # steal the target keypoint from whichever point held it,
        # keeping its covisibility contributions consistent
        old_mp = self.kf_kp_mp[k, kp_idx]
        if old_mp != NO_MP and old_mp != m and k in self.obs.get(old_mp, {}):
            self._update_covis_pair(int(old_mp), k, -1)
            self.obs[old_mp].pop(k, None)
            self._obs_del_row(int(old_mp), k)
            self.dirty_mps.add(int(old_mp))
        self.obs[m][k] = kp_idx
        self._obs_add_row(m, k, kp_idx)
        self.kf_kp_mp[k, kp_idx] = m
        if prev is None:
            self._update_covis_pair(m, k, +1)
        elif self.kf_kp_mp[k, prev] == m:
            # re-observation at a different keypoint (the reference's
            # Fuse skips pMP->IsInKeyFrame(pKF)): re-link without
            # double-counting the (m, k) covisibility pair
            self.kf_kp_mp[k, prev] = NO_MP
        self.dirty_mps.add(int(m))
        self._emit("mp", "AddObservation", int(self.mp_gid[m]),
                   (int(self.kf_gid[k]), kp_idx), log)

    def add_observations_new_kf(self, k: int, kps: np.ndarray,
                                ms: np.ndarray, log: bool = True):
        """Batch AddObservation for a FRESHLY INSERTED keyframe whose
        kp->mp row is still empty.

        Semantically equal to calling add_observation(m, k, kp) per
        matched keypoint (reference: the per-keypoint AddMapPoint /
        AddObservation loop in Tracking::CreateNewKeyFrame,
        Tracking.cc), but without the per-pair python covisibility
        walk: there is nothing to steal (the row is empty) and the
        whole covisibility row for k is rebuilt EXACTLY from the batch
        with one bincount over the live observation arrays.  Cuts the
        lock-held host time of keyframe insertion from O(sum observers)
        python to O(batch) + one numpy pass."""
        ms = np.asarray(ms)
        kps = np.asarray(kps)
        keep = (ms != NO_MP) & self.mp_alive[np.clip(ms, 0, None)]
        ms, kps = ms[keep], kps[keep]
        if len(ms) == 0:
            return
        # duplicate map points in one frame: the sequential loop's net
        # effect is last-kp-wins — replicate via reversed unique
        uniq, first_rev = np.unique(ms[::-1], return_index=True)
        if len(uniq) != len(ms):
            sel = len(ms) - 1 - first_rev
            ms, kps = ms[sel], kps[sel]
        self.kf_kp_mp[k, kps] = ms
        # obs rows: one capacity check, then slice-assign
        need = self.obs_n + len(ms)
        while need > len(self.obs_mp):
            if self._obs_dead * 2 > self.obs_n:
                self._obs_compact()
                need = self.obs_n + len(ms)
                continue
            for name in ("obs_mp", "obs_kf", "obs_kp", "obs_alive"):
                setattr(self, name,
                        _grow(getattr(self, name), 2 * len(self.obs_mp)))
            self.obs_mp[self.obs_n:] = -1
            self.obs_kf[self.obs_n:] = -1
        r0 = self.obs_n
        self.obs_n = need
        self._obs_version += 1
        self.obs_mp[r0:need] = ms
        self.obs_kf[r0:need] = k
        self.obs_kp[r0:need] = kps
        self.obs_alive[r0:need] = True
        self.mp_nobs[ms] += 1
        row_of = self._obs_row
        kf_gid = int(self.kf_gid[k])
        for i, (m, kp) in enumerate(zip(ms.tolist(), kps.tolist())):
            row_of[(m, k)] = r0 + i
            self.obs[m][k] = kp
            self.dirty_mps.add(m)
            self._emit("mp", "AddObservation", int(self.mp_gid[m]),
                       (kf_gid, kp), log)
        # exact covisibility row for k (the row was empty before, so
        # this batch IS k's observation set)
        in_set = np.zeros(len(self.mp_alive), bool)
        in_set[ms] = True
        om, okf, _ = self.obs_arrays()
        sel = in_set[om] & (okf != k) & self.kf_alive[okf]
        binc = np.bincount(okf[sel], minlength=self.n_kf)
        counts = {int(k2): int(binc[k2]) for k2 in np.nonzero(binc)[0]}
        for k2, w in counts.items():
            self.covis.setdefault(k2, {})[k] = w
        self.covis[k] = counts

    def erase_observation(self, m: int, k: int, log: bool = True):
        if m not in self.obs or k not in self.obs[m]:
            return
        kp_idx = self.obs[m].pop(k)
        self._obs_del_row(m, k)
        if self.kf_kp_mp[k, kp_idx] == m:
            self.kf_kp_mp[k, kp_idx] = NO_MP
        self._update_covis_pair(m, k, -1)
        self.dirty_mps.add(int(m))
        self._emit("mp", "EraseObservation", int(self.mp_gid[m]),
                   (int(self.kf_gid[k]),), log)
        if len(self.obs[m]) <= 1 and self.mp_alive[m]:
            self.set_mp_bad(m, log=log)

    def set_mp_bad(self, m: int, log: bool = True):
        if not self.mp_alive[m]:
            return
        for k, kp_idx in list(self.obs.get(m, {}).items()):
            if self.kf_kp_mp[k, kp_idx] == m:
                self.kf_kp_mp[k, kp_idx] = NO_MP
            self._update_covis_pair(m, k, -1)
            self._obs_del_row(m, k)
        self.obs[m] = {}
        self.mp_alive[m] = False
        self._emit("mp", "SetBadFlag", int(self.mp_gid[m]), (), log)

    def replace_mp(self, m_old: int, m_new: int, log: bool = True):
        """MapPoint::Replace — transplant observations, keep counters."""
        if m_old == m_new or not self.mp_alive[m_old]:
            return
        for k, kp_idx in list(self.obs.get(m_old, {}).items()):
            self._update_covis_pair(m_old, k, -1)
            self._obs_del_row(m_old, k)
            if k in self.obs.get(m_new, {}):
                # new point already seen by this KF: drop the old obs
                if self.kf_kp_mp[k, kp_idx] == m_old:
                    self.kf_kp_mp[k, kp_idx] = NO_MP
            else:
                self.obs.setdefault(m_new, {})[k] = kp_idx
                self._obs_add_row(m_new, k, kp_idx)
                self.kf_kp_mp[k, kp_idx] = m_new
                self._update_covis_pair(m_new, k, +1)
        self.mp_found[m_new] += self.mp_found[m_old]
        self.mp_visible[m_new] += self.mp_visible[m_old]
        self.dirty_mps.add(int(m_new))
        self.obs[m_old] = {}
        self.mp_alive[m_old] = False
        self._emit("mp", "Replace", int(self.mp_gid[m_old]),
                   (int(self.mp_gid[m_new]),), log)

    def increase_visible(self, ms: np.ndarray, log: bool = True):
        """SetVisible is last-writer-wins on the wire, so per-frame counter
        bumps only mark the point dirty; Mapit.archive synthesizes ONE
        record per dirty point at push time (no per-element host loop on
        the frame path)."""
        self.mp_visible[ms] += 1
        if log and self.log_fn is not None:
            self.dirty_vis.update(np.atleast_1d(ms).tolist())

    def increase_found(self, ms: np.ndarray, log: bool = True):
        self.mp_found[ms] += 1
        self.mp_last_tracked[ms] = global_clock()
        if log and self.log_fn is not None:
            self.dirty_found.update(np.atleast_1d(ms).tolist())

    # -- descriptors / geometry refresh -------------------------------------------
    def compute_distinctive_descriptor(self, m: int, log: bool = True):
        """Median-distance-minimizing descriptor among observations
        (reference: MapPoint::ComputeDistinctiveDescriptors)."""
        entries = [
            self.kf_desc[k, kp] for k, kp in self.obs.get(m, {}).items()
            if self.kf_alive[k]
        ]
        if not entries:
            return
        D = np.stack(entries).astype(np.uint32)
        x = self._pairwise_hamming(D)
        best = int(np.median(x, axis=1).argmin())
        self.mp_desc[m] = D[best]
        self._emit("mp", "ComputeDistinctiveDescriptors", int(self.mp_gid[m]),
                   (D[best].copy(),), log)

    _POPCOUNT8 = np.unpackbits(
        np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint16)

    if hasattr(np, "bitwise_count"):
        @staticmethod
        def _pairwise_hamming(D: np.ndarray) -> np.ndarray:
            return np.bitwise_count(
                np.bitwise_xor(D[:, None, :], D[None, :, :])).sum(-1)
    else:
        def _pairwise_hamming(self, D: np.ndarray) -> np.ndarray:
            return self._POPCOUNT8[np.bitwise_xor(
                D[:, None, :], D[None, :, :]).view(np.uint8)].sum(-1)

    def refresh_points(self, ms, scale_factor: float = 1.2,
                       n_levels: int = 8, log: bool = True,
                       descriptors: bool = True):
        """Batched ComputeDistinctiveDescriptors + UpdateNormalAndDepth
        over a dirty set (reference recomputes per mutation inline,
        MapPoint.cc; per-keyframe batching is behaviorally equivalent).

        Replaces the per-point python walks: normals come from one
        gather over the live observation arrays + a segment mean, and
        the descriptor medians use a uint8 popcount LUT with an exact
        nobs<=2 fast path (argmin of the row medians of a 2x2 distance
        matrix is always the first row)."""
        ms = [int(m) for m in ms
              if self.mp_alive[m] and self.obs.get(m)]
        if not ms:
            return
        n_kf = self.n_kf
        R = self.kf_pose_cw[:n_kf, :3, :3]
        t = self.kf_pose_cw[:n_kf, :3, 3]
        centers = -np.einsum("kji,kj->ki", R, t)  # -R^T t per keyframe
        idx_of = {m: i for i, m in enumerate(ms)}
        om, okf, _ = self.obs_arrays()
        sel = np.isin(om, np.asarray(ms))
        om_s, okf_s = om[sel], okf[sel]
        rows = np.fromiter((idx_of[int(m)] for m in om_s), np.int64,
                           count=len(om_s))
        v = self.mp_pos[om_s].astype(np.float64) - centers[okf_s]
        nv = np.linalg.norm(v, axis=1)
        good = nv > 1e-9
        u = np.zeros_like(v)
        u[good] = v[good] / nv[good, None]
        nsum = np.zeros((len(ms), 3))
        ncnt = np.zeros(len(ms))
        np.add.at(nsum, rows[good], u[good])
        np.add.at(ncnt, rows[good], 1.0)
        # ref keyframe (fallback: first observer) for depth/octave
        refs = np.empty(len(ms), np.int64)
        kp_ref = np.empty(len(ms), np.int64)
        for i, m in enumerate(ms):
            ob = self.obs[m]
            r = int(self.mp_ref_kf[m])
            if r not in ob or not self.kf_alive[r]:
                r = next(iter(ob))
            refs[i] = r
            kp_ref[i] = ob[r]
        dist = np.linalg.norm(
            self.mp_pos[ms].astype(np.float64) - centers[refs], axis=1)
        level = self.kf_kp_octave[refs, kp_ref]
        maxd = dist * np.power(float(scale_factor), level.astype(np.float64))
        mind = maxd / scale_factor ** (n_levels - 1)
        for i, m in enumerate(ms):
            # descriptor: median-distance minimizer among live observers
            entries = ([self.kf_desc[k, kp] for k, kp in self.obs[m].items()
                        if self.kf_alive[k]] if descriptors else None)
            if entries:
                if len(entries) <= 2:
                    best_desc = entries[0]
                else:
                    D = np.stack(entries).astype(np.uint32)
                    x = self._pairwise_hamming(D)
                    best_desc = D[int(np.median(x, axis=1).argmin())]
                self.mp_desc[m] = best_desc
                self._emit("mp", "ComputeDistinctiveDescriptors",
                           int(self.mp_gid[m]), (self.mp_desc[m].copy(),), log)
            if ncnt[i] > 0:
                n = nsum[i] / ncnt[i]
                self.mp_normal[m] = n / max(np.linalg.norm(n), 1e-9)
                self.mp_max_dist[m] = maxd[i]
                self.mp_min_dist[m] = mind[i]
                self._emit("mp", "UpdateNormalAndDepth", int(self.mp_gid[m]),
                           (self.mp_normal[m].copy(),
                            float(self.mp_min_dist[m]),
                            float(self.mp_max_dist[m])), log)

    def update_normal_and_depth(self, m: int, scale_factor: float = 1.2,
                                n_levels: int = 8, log: bool = True):
        ob = self.obs.get(m, {})
        if not ob:
            return
        pos = self.mp_pos[m]
        normals = []
        for k in ob:
            c = self.kf_center(k)
            v = pos - c
            nv = np.linalg.norm(v)
            if nv > 1e-9:
                normals.append(v / nv)
        if not normals:
            return
        n = np.mean(normals, axis=0)
        self.mp_normal[m] = n / max(np.linalg.norm(n), 1e-9)
        ref = int(self.mp_ref_kf[m])
        if ref not in ob or not self.kf_alive[ref]:
            # fall back to an actual observer so the center and octave
            # come from the same keyframe
            ref = next(iter(ob))
        dist = np.linalg.norm(pos - self.kf_center(ref))
        level = int(self.kf_kp_octave[ref, ob[ref]])
        self.mp_max_dist[m] = dist * scale_factor**level
        self.mp_min_dist[m] = self.mp_max_dist[m] / scale_factor ** (n_levels - 1)
        self._emit("mp", "UpdateNormalAndDepth", int(self.mp_gid[m]),
                   (self.mp_normal[m].copy(), float(self.mp_min_dist[m]),
                    float(self.mp_max_dist[m])), log)

    # -- covisibility ---------------------------------------------------------------
    def _update_covis_pair(self, m: int, k: int, delta: int):
        """Incrementally maintain shared-point counts between k and every
        other observer of m."""
        for k2 in self.obs.get(m, {}):
            if k2 == k:
                continue
            for a, b in ((k, k2), (k2, k)):
                d = self.covis.setdefault(a, {})
                d[b] = d.get(b, 0) + delta
                if d[b] <= 0:
                    del d[b]

    def update_connections(self, k: int, min_weight: int = 15,
                           log: bool = True) -> list[int]:
        """Rebuild keyframe k's covisibility row from its kp->mp table,
        re-pick the spanning-tree parent, and return the connected
        keyframes ordered by weight (reference:
        KeyFrame::UpdateConnections, src/KeyFrame.cc).

        `covis` always stores EXACT shared-observation counts (the
        incremental deltas in _update_covis_pair rely on that
        invariant); the reference's >=min_weight rule selects the
        *connected* set — every neighbor at or above the threshold, or
        the single best neighbor when none reaches it — which is what
        this returns.
        """
        row = self.kf_kp_mp[k]
        mm = np.unique(row[row != NO_MP])
        mm = mm[self.mp_alive[mm]]
        in_set = np.zeros(len(self.mp_alive), bool)
        in_set[mm] = True
        om, okf, _ = self.obs_arrays()
        sel = in_set[om] & (okf != k) & self.kf_alive[okf]
        binc = np.bincount(okf[sel], minlength=self.n_kf)
        nz = np.nonzero(binc)[0]
        counts: dict[int, int] = {int(k2): int(binc[k2]) for k2 in nz}
        # symmetric repair of the row (fixes any incremental drift)
        old = self.covis.get(k, {})
        for k2 in set(old) - set(counts):
            self.covis.get(k2, {}).pop(k, None)
        for k2, w in counts.items():
            self.covis.setdefault(k2, {})[k] = w
        self.covis[k] = dict(counts)
        if counts and self.kf_parent[k] < 0 and k != 0:
            best = max(counts, key=counts.get)
            if self.kf_gid[best] < self.kf_gid[k]:
                self.kf_parent[k] = best
        self._emit("kf", "UpdateConnections", int(self.kf_gid[k]), (), log)
        ordered = sorted(counts.items(), key=lambda kv: -kv[1])
        connected = [k2 for k2, w in ordered if w >= min_weight]
        if not connected and ordered:
            connected = [ordered[0][0]]
        return connected

    def redundancy_counts(self, cands: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Per-candidate (total, redundant) observation counts for
        keyframe culling: a point is redundant when >=3 OTHER alive
        keyframes see it at the same-or-finer octave (reference:
        LocalMapping::KeyFrameCulling / MapManager::KeyFrameCulling).

        Batch-computed in the native C++ kernel
        (csrc/mapops.cc:redundancy_counts, built by native.py; a failed
        build raises)."""
        if not cands:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        from .. import native

        n_kf = self.n_kf
        rows = self.kf_kp_mp[:n_kf].astype(np.int32, copy=True)
        # scrub dead points so native `row >= 0` equals mp_alive checks
        live = rows >= 0
        rows[live & ~self.mp_alive[np.clip(rows, 0, None)]] = NO_MP
        total, red = native.redundancy(
            rows, self.kf_kp_octave[:n_kf].astype(np.int32),
            self.kf_alive[:n_kf], np.asarray(cands, np.int32),
        )
        return total, red

    def rebuild_covisibility(self) -> None:
        """Recompute the whole covisibility table from the kp->mp rows
        in one native batch pass — the bulk-load fast path (used after
        applying a full map archive, where incremental per-observation
        updates are quadratic)."""
        from .. import native

        n_kf = self.n_kf
        rows = self.kf_kp_mp[:n_kf].astype(np.int32, copy=True)
        live = rows >= 0
        rows[live & ~self.mp_alive[np.clip(rows, 0, None)]] = NO_MP
        i, j, c = native.covisibility(rows, self.kf_alive[:n_kf])
        covis: dict[int, dict[int, int]] = {}
        for a, b, w in zip(i.tolist(), j.tolist(), c.tolist()):
            covis.setdefault(a, {})[b] = w
            covis.setdefault(b, {})[a] = w
        self.covis = covis

    def covisible_kfs(self, k: int, n: int = 0, min_weight: int = 1) -> list[int]:
        con = [
            (w, k2) for k2, w in self.covis.get(k, {}).items()
            if w >= min_weight and self.kf_alive[k2]
        ]
        con.sort(reverse=True)
        out = [k2 for _, k2 in con]
        return out[:n] if n else out

    # -- queries ----------------------------------------------------------------------
    def alive_kf_slots(self) -> np.ndarray:
        return np.where(self.kf_alive[: self.n_kf])[0]

    def alive_mp_slots(self) -> np.ndarray:
        return np.where(self.mp_alive[: self.n_mp])[0]

    def kf_tracked_points(self, k: int, min_obs: int = 1) -> int:
        mps = self.kf_kp_mp[k]
        mm = mps[mps != NO_MP]
        return int(np.count_nonzero(
            self.mp_alive[mm] & (self.mp_nobs[mm] >= min_obs)
        ))

    # -- global (world) coordinates ------------------------------------------------------
    def check_transform(self, s: float) -> bool:
        """Dry-run of the set_transform scale guard (no mutation) — lets
        group rebasing be applied atomically across member maps."""
        g = self.transform_guard
        ratio = s / max(float(self.Twl_s), 1e-12)
        return self.Twl_s == 1.0 or (g.scale_lo <= ratio <= g.scale_hi)

    def set_transform(self, R: np.ndarray, t: np.ndarray, s: float,
                      log: bool = True, exact: bool = False) -> bool:
        """Guarded Twl update (reference: Map::SetTransform).

        `exact=True` bypasses the blend and sets the transform verbatim.
        The blend is ONLY for repeated independent Sim3 ESTIMATES of the
        same alignment (reference interpolate(), Map.cc:450).  Group
        rebases (merge algebra) and replication of the authoritative
        server value to a client replica must be exact — blending those
        leaves each member a fraction of the rebase delta away from the
        group frame and corrupts inter-map alignment by tens of degrees."""
        if exact:
            # exact callers carry their own guarantees: merge() dry-runs
            # the scale guard across the whole group first, and replica
            # application must follow the authoritative value even
            # through a legitimate large jump the guard would reject
            self.Twl_R, self.Twl_t, self.Twl_s = (
                R.astype(np.float32), t.astype(np.float32), np.float32(s))
            return True
        if not self.check_transform(s):
            ratio = s / max(float(self.Twl_s), 1e-12)
            _log.warning("rejecting scale jump %.3f on map %d", ratio, self.map_id)
            return False
        if float(self.Twl_s) == 1.0 and np.allclose(self.Twl_R, np.eye(3)):
            self.Twl_R, self.Twl_t, self.Twl_s = (
                R.astype(np.float32), t.astype(np.float32), np.float32(s))
        else:
            # blend toward the new transform (reference slerp ratio 0.9)
            b = self.transform_guard.blend
            from ..utils.trajectory import rot_to_quat, quat_to_rot
            q0, q1 = rot_to_quat(self.Twl_R), rot_to_quat(R)
            if np.dot(q0, q1) < 0:
                q1 = -q1
            q = (1 - b) * q0 + b * q1
            self.Twl_R = quat_to_rot(q / np.linalg.norm(q)).astype(np.float32)
            self.Twl_t = ((1 - b) * self.Twl_t + b * t).astype(np.float32)
            self.Twl_s = np.float32(self.Twl_s ** (1 - b) * s**b)
        return True

    def mp_global_pos(self, slots: np.ndarray) -> np.ndarray:
        p = self.mp_pos[slots]
        return self.Twl_s * p @ self.Twl_R.T + self.Twl_t

    def kf_global_pose(self, k: int) -> np.ndarray:
        """World->camera in the group frame: Tcw_global = Tcw_local * Tlw."""
        Rlw = self.Twl_R.T / self.Twl_s
        tlw = -Rlw @ self.Twl_t
        Tlw = np.eye(4, dtype=np.float32)
        Tlw[:3, :3] = Rlw
        Tlw[:3, 3] = tlw
        return self.kf_pose_cw[k] @ Tlw
