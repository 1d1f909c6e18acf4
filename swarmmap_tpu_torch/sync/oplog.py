"""Change-log map synchronization ("Mapit" — the git-like push/pull).

Reference spec:
  - update records + funcName vocabulary: include/MapElementUpdate.h,
    src/MapUpdater.cc:17-190
  - per-map log with drop/aggregate policies: src/Mapit.cc
  - slice assembly (new elements + update log): Map::ArchiveMap
    (src/Map.cc:297-339)
  - slice application with id re-linking and out-of-order restoration
    queues: Map::UpdateMap (src/Map.cc:341-447)

Design notes:
  - Updates that target elements not yet shipped are dropped — those
    elements travel whole inside the same slice (Mapit.cc:17-48).
  - Aggregation compacts the log before shipping: last-writer-wins for
    SetPose/SetWorldPos and state-snapshot ops, counters collapse to
    final values, all ops on dead elements drop except the SetBadFlag
    itself (Mapit.cc:50-143).

Copy of swarmmap_tpu/sync/oplog.py over the port's map store and host
C++ (`native.aggregate_keep`), which the port cannot import on a machine
without JAX.  It runs on the host only, in numpy.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np

from ..core.map_store import NO_MP, MapStore
from ..utils.logging import get_logger

_log = get_logger("mapit")


def _pose_dist(Ta: np.ndarray, Tb: np.ndarray) -> float:
    """Translation + weighted rotation distance between SE3 cam poses."""
    dt = float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]))
    cos = np.clip((np.trace(Ta[:3, :3] @ Tb[:3, :3].T) - 1.0) / 2.0, -1.0, 1.0)
    return dt + 0.5 * float(np.arccos(cos))

# ops where only the last record per target matters
LAST_WRITER_OPS = {
    "SetPose", "SetWorldPos", "SetFound", "SetVisible", "SetLastTrackedTime",
    "ComputeDistinctiveDescriptors", "UpdateNormalAndDepth", "UpdateConnections",
}


@dataclasses.dataclass
class UpdateRecord:
    seq: int
    kind: str          # 'kf' | 'mp' | 'map'
    func: str
    target: int        # global id (or map id for kind='map')
    args: tuple


@dataclasses.dataclass
class MapSlice:
    """The sync unit (reference: include/MapSlice.h): new keyframes, new
    map points, and the aggregated update log."""
    map_id: int
    kfs: list[dict]
    mps: list[dict]
    updates: list[UpdateRecord]
    twl: tuple | None = None  # (R,t,s) local->world, shipped when non-identity
    # gauge epoch this slice was built under (MapStore.gauge_epoch at
    # archive time).  None = legacy/reference peer without epoch
    # metadata — the apply path falls back to the geometric pose vote.
    epoch: int | None = None

    def counts(self) -> tuple[int, int, int]:
        return len(self.kfs), len(self.mps), len(self.updates)


class Mapit:
    """Per-map change log + push/pull entry points."""

    def __init__(self, store: MapStore):
        self.store = store
        self.log: list[UpdateRecord] = []
        self.shipped_kf: set[int] = set()
        self.shipped_mp: set[int] = set()
        self._seq = itertools.count()
        self._slice_stale = False  # current slice predates a correction
        store.log_fn = self.add

    # ------------------------------------------------------------------ log
    def add(self, kind: str, func: str, target: int, args: tuple):
        if kind == "kf" and target not in self.shipped_kf:
            return  # ships whole with the next slice
        if kind == "mp" and target not in self.shipped_mp:
            return
        self.log.append(UpdateRecord(next(self._seq), kind, func, target, args))

    def aggregate(self, records: list[UpdateRecord]) -> list[UpdateRecord]:
        """Compact the log (reference: Mapit::Aggregate).

        The keep-mask is computed by the host C++ pass
        (csrc/mapops.cc:aggregate_oplog, bound by native.py; a failed
        build raises): drop every record on a SetBadFlag'd target except the
        flag itself, and keep only the LAST record per
        (kind, func, target) for last-writer funcs."""
        if not records:
            return []
        from .. import native

        kind_ids = {"kf": 0, "mp": 1, "map": 2}
        func_ids: dict[str, int] = {}
        kinds = np.empty(len(records), np.int32)
        funcs = np.empty(len(records), np.int32)
        targets = np.empty(len(records), np.int64)
        for i, r in enumerate(records):
            kinds[i] = kind_ids[r.kind]
            funcs[i] = func_ids.setdefault(r.func, len(func_ids))
            targets[i] = r.target
        lw = np.zeros(max(len(func_ids), 1), np.uint8)
        bf = np.zeros(max(len(func_ids), 1), np.uint8)
        for name, fid in func_ids.items():
            lw[fid] = name in LAST_WRITER_OPS
            bf[fid] = name == "SetBadFlag"
        keep = native.aggregate_keep(kinds, funcs, targets, lw, bf)
        return [r for r, k in zip(records, keep) if k]

    # ------------------------------------------------------------------ push
    def archive(self, include_twl: bool = False) -> MapSlice:
        """Collect new elements + drained, aggregated update log
        (reference: Map::ArchiveMap)."""
        with self.store.lock:
            return self._archive_locked(include_twl)

    def _archive_locked(self, include_twl: bool = False) -> MapSlice:
        st = self.store
        kfs, mps = [], []
        for k in np.where(st.kf_to_serialize[: st.n_kf] & st.kf_alive[: st.n_kf])[0]:
            kfs.append(self._kf_payload(int(k)))
            st.kf_to_serialize[k] = False
            self.shipped_kf.add(int(st.kf_gid[k]))
        for m in np.where(st.mp_to_serialize[: st.n_mp] & st.mp_alive[: st.n_mp])[0]:
            mps.append(self._mp_payload(int(m)))
            st.mp_to_serialize[m] = False
            self.shipped_mp.add(int(st.mp_gid[m]))
        # synthesize the deferred counter records (one last-writer record
        # per dirty point, instead of a host loop on every frame)
        for dirty, funcs in (
            (st.dirty_vis, (("SetVisible", st.mp_visible),)),
            (st.dirty_found, (("SetFound", st.mp_found),
                              ("SetLastTrackedTime", st.mp_last_tracked))),
        ):
            for m in dirty:
                if not st.mp_alive[m]:
                    continue
                gid = int(st.mp_gid[m])
                if gid not in self.shipped_mp:
                    continue
                for func, arr in funcs:
                    val = float(arr[m]) if arr.dtype.kind == "f" else int(arr[m])
                    self.log.append(UpdateRecord(
                        next(self._seq), "mp", func, gid, (val,)))
            dirty.clear()
        updates = self.aggregate(self.log)
        self.log = []
        twl = None
        # the global transform is SERVER-owned (reference: Map::SetTransform
        # has no client-side caller) — only server->client distributes ship
        # it; a client echoing its stale copy back would fight the server's
        if include_twl and (st.Twl_s != 1.0
                            or not np.allclose(st.Twl_R, np.eye(3))):
            twl = (st.Twl_R.copy(), st.Twl_t.copy(), float(st.Twl_s))
        return MapSlice(map_id=st.map_id, kfs=kfs, mps=mps, updates=updates,
                        twl=twl, epoch=st.gauge_epoch)

    def _kf_payload(self, k: int) -> dict:
        st = self.store
        mp_gids = np.full(st.n_kp, -1, np.int64)
        has = st.kf_kp_mp[k] != NO_MP
        mp_gids[has] = st.mp_gid[st.kf_kp_mp[k][has]]
        return dict(
            gid=int(st.kf_gid[k]),
            pose_cw=st.kf_pose_cw[k].copy(),
            K=st.kf_K[k].copy(),
            hw=tuple(int(x) for x in st.kf_hw[k]),
            ts=float(st.kf_ts[k]),
            frame_id=int(st.kf_frame_id[k]),
            genuine=bool(st.kf_genuine[k]),
            velocity=float(st.kf_velocity[k]),
            kp_uv=st.kf_kp_uv[k].copy(),
            kp_octave=st.kf_kp_octave[k].copy(),
            kp_angle=st.kf_kp_angle[k].copy(),
            kp_response=st.kf_kp_response[k].copy(),
            kp_valid=st.kf_kp_valid[k].copy(),
            desc=st.kf_desc[k].copy(),
            mp_gids=mp_gids,
            parent_gid=int(st.kf_gid[st.kf_parent[k]]) if st.kf_parent[k] >= 0 else -1,
        )

    def _mp_payload(self, m: int) -> dict:
        st = self.store
        ref = int(st.mp_ref_kf[m])
        # Ship the observation map {kf_gid: kp_idx} with the point (the
        # reference serializes MapPoint::mIdObservations).  Without it,
        # observations linking a NEW point to an ALREADY-shipped keyframe
        # are lost: Mapit.add drops AddObservation records targeting
        # unshipped points, and the old keyframe never re-ships its
        # kp->mp table.
        obs = {
            int(st.kf_gid[k]): int(kp)
            for k, kp in st.obs.get(m, {}).items()
            if st.kf_alive[k]
        }
        return dict(
            gid=int(st.mp_gid[m]),
            obs=obs,
            pos=st.mp_pos[m].copy(),
            desc=st.mp_desc[m].copy(),
            normal=st.mp_normal[m].copy(),
            min_dist=float(st.mp_min_dist[m]),
            max_dist=float(st.mp_max_dist[m]),
            ref_kf_gid=int(st.kf_gid[ref]) if ref >= 0 else -1,
            visible=int(st.mp_visible[m]),
            found=int(st.mp_found[m]),
            created=float(st.mp_created[m]),
            last_tracked=float(st.mp_last_tracked[m]),
            cam_velocity=float(st.mp_cam_velocity[m]),
        )

    # ------------------------------------------------------------------ pull/apply
    def reply_pull(self, n_last: int = 5) -> MapSlice:
        """Server side of the pull verb: the latest `n_last` live
        keyframes plus every live map point they observe (reference:
        Mapit::ReplyPull, src/Mapit.cc:164-196 — Pull itself is an empty
        stub there; the slice applies like a distribute).  Read-only: no
        serialize-flag or log mutation, so pulls are idempotent."""
        with self.store.lock:
            st = self.store
            alive = st.alive_kf_slots()
            last = alive[-n_last:][::-1]  # latest first (reference order)
            kfs = [self._kf_payload(int(k)) for k in last]
            seen: set[int] = set()
            mps = []
            for k in last:
                row = st.kf_kp_mp[int(k)]
                for m in row[row != NO_MP]:
                    m = int(m)
                    if m not in seen and st.mp_alive[m]:
                        seen.add(m)
                        mps.append(self._mp_payload(m))
            twl = None
            if st.Twl_s != 1.0 or not np.allclose(st.Twl_R, np.eye(3)):
                twl = (st.Twl_R.copy(), st.Twl_t.copy(), float(st.Twl_s))
            return MapSlice(map_id=st.map_id, kfs=kfs, mps=mps, updates=[],
                            twl=twl, epoch=st.gauge_epoch)

    def apply_slice(self, sl: MapSlice, vocab=None,
                    on_map_event=None) -> None:
        """Insert new elements + apply the update log
        (reference: Map::UpdateMap).  `on_map_event(func, target, args)`
        receives map-level events (AddLoopClosing, clear, ...)."""
        with self.store.lock:
            self._apply_slice_locked(sl, vocab, on_map_event)

    def _apply_slice_locked(self, sl: MapSlice, vocab=None,
                            on_map_event=None) -> None:
        st = self.store
        # 0. stale-gauge classification: after a server-side loop
        # correction rebased this replica, pushes the client created
        # BEFORE receiving the correction distribute still carry the old
        # gauge.  Primary signal is protocol metadata: every correction
        # bumps MapStore.gauge_epoch, distributes stamp it into the
        # slice, and clients echo the last epoch they saw — a push built
        # under an older epoch is stale by definition, with no geometry
        # involved.  Legacy slices (epoch=None, e.g. a reference peer on
        # the boost wire) fall back to a pose vote over SetPose records
        # against the recorded pre/post-correction snapshots; with the
        # guard armed, no votes or a tie means STALE — a backlogged push
        # carrying only new elements is exactly the deep-queue case the
        # guard exists for.  A stale slice's geometry is re-expressed in
        # the corrected frame below, a fresh one retires the guard.
        guard_armed = bool(st.kf_corrected[: st.n_kf].any())
        if not guard_armed:
            self._slice_stale = False
        elif sl.epoch is not None:
            self._slice_stale = sl.epoch < st.gauge_epoch
            if not self._slice_stale:
                st.kf_corrected[: st.n_kf] = False
                st.mp_corrected[: st.n_mp] = False
            else:
                _log.info("stale-gauge slice for map %d (epoch %d < %d) — "
                          "re-expressing in the corrected frame",
                          st.map_id, sl.epoch, st.gauge_epoch)
        else:
            stale_v = fresh_v = 0
            for r in sl.updates:
                if r.kind == "kf" and r.func == "SetPose":
                    k = st.kf_by_gid.get(r.target)
                    if k is not None and st.kf_corrected[k]:
                        T = np.asarray(r.args[0])
                        if (_pose_dist(T, st.kf_pre_corr_pose[k])
                                < _pose_dist(T, st.kf_post_corr_pose[k])):
                            stale_v += 1
                        else:
                            fresh_v += 1
            self._slice_stale = fresh_v <= stale_v  # no votes / tie => stale
            if fresh_v and not self._slice_stale:
                st.kf_corrected[: st.n_kf] = False
                st.mp_corrected[: st.n_mp] = False
            elif self._slice_stale:
                _log.info("stale-gauge slice for map %d (%d stale vs %d "
                          "fresh pose votes) — re-expressing in the "
                          "corrected frame", st.map_id, stale_v, fresh_v)
        # a slice never lowers the receiver's epoch; distributes raise the
        # client's so its next push echoes the corrected gauge
        if sl.epoch is not None and sl.epoch > st.gauge_epoch:
            st.gauge_epoch = sl.epoch
        # 1. keyframes
        new_kfs = []
        for p in sl.kfs:
            if p["gid"] in st.kf_by_gid:
                continue
            pose = np.asarray(p["pose_cw"], np.float32)
            par = (st.kf_by_gid.get(p["parent_gid"])
                   if p.get("parent_gid", -1) >= 0 else None)
            if (self._slice_stale and par is not None
                    and st.kf_corrected[par]):
                # anchor the new keyframe by its relative pose to the
                # parent's PRE-correction pose, composed onto the
                # parent's corrected pose (relative translation rescaled
                # by the parent's per-node correction scale)
                T_rel = pose @ np.linalg.inv(st.kf_pre_corr_pose[par])
                T_rel[:3, 3] /= st.kf_corr_scale[par]
                client_pose = pose
                pose = (T_rel @ st.kf_post_corr_pose[par]).astype(np.float32)
                p = dict(p, _client_pose=client_pose,
                         _corr_scale=float(st.kf_corr_scale[par]))
            p = dict(p, pose_cw=pose)
            k = st.add_keyframe(
                pose_cw=p["pose_cw"], K=p["K"], kp_uv=p["kp_uv"],
                kp_octave=p["kp_octave"], kp_angle=p["kp_angle"],
                kp_response=p["kp_response"], kp_valid=p["kp_valid"],
                desc=p["desc"], ts=p["ts"], frame_id=p["frame_id"],
                gid=p["gid"], genuine=p.get("genuine", True),
                velocity=p.get("velocity", 0.0), hw=p.get("hw", (480, 640)),
                log=False,
            )
            if vocab is not None:
                w, nd = vocab.transform_np(p["desc"])
                valid = p["kp_valid"]
                st.kf_words[k, : len(w)] = np.where(valid, w.astype(np.int32), -1)
                st.kf_nodes[k, : len(nd)] = np.where(valid, nd.astype(np.int32), -1)
            # came from the peer: don't echo it back whole, but DO log
            # future local mutations on it
            st.kf_to_serialize[k] = False
            if "_client_pose" in p:
                # the element itself now needs the guard: the client's
                # NEXT stale push may carry SetPose for it in the old
                # gauge
                st.kf_pre_corr_pose[k] = p["_client_pose"]
                st.kf_post_corr_pose[k] = st.kf_pose_cw[k]
                st.kf_corrected[k] = True
                st.kf_corr_scale[k] = p["_corr_scale"]
            self.shipped_kf.add(p["gid"])
            new_kfs.append((k, p))
        # 2. map points
        for p in sl.mps:
            if p["gid"] in st.mp_by_gid:
                continue
            ref = st.kf_by_gid.get(p["ref_kf_gid"], -1)
            pos = np.asarray(p["pos"], np.float32)
            if self._slice_stale and ref >= 0 and st.kf_corrected[ref]:
                # map the client-frame position through the reference
                # keyframe's pre->post correction Sim3 (same math as
                # correct_loop's point correction)
                Tp = st.kf_pre_corr_pose[ref]
                pc = Tp[:3, :3] @ pos + Tp[:3, 3]
                Tc = st.kf_post_corr_pose[ref]
                client_pos = pos
                pos = (Tc[:3, :3].T
                       @ (pc / st.kf_corr_scale[ref] - Tc[:3, 3])
                       ).astype(np.float32)
                p = dict(p, _client_pos=client_pos)
            m = st.add_map_point(
                pos=pos, desc=p["desc"], ref_kf=ref, gid=p["gid"],
                normal=p["normal"], min_dist=p["min_dist"], max_dist=p["max_dist"],
                cam_velocity=p.get("cam_velocity", 0.0), log=False,
            )
            st.mp_visible[m] = p["visible"]
            st.mp_found[m] = p["found"]
            st.mp_created[m] = p["created"]
            st.mp_last_tracked[m] = p["last_tracked"]
            st.mp_to_serialize[m] = False
            if "_client_pos" in p:
                st.mp_pre_corr_pos[m] = p["_client_pos"]
                st.mp_post_corr_pos[m] = st.mp_pos[m]
                st.mp_corrected[m] = True
            self.shipped_mp.add(p["gid"])
            # replay the shipped observation set (reference restores
            # mIdObservations on arrival); keyframes not present yet go
            # to the restoration queue
            for kf_gid, kp in p.get("obs", {}).items():
                k = st.kf_by_gid.get(int(kf_gid))
                if k is not None and st.kf_alive[k]:
                    st.add_observation(m, k, int(kp), log=False)
                else:
                    st.pending_obs.append((p["gid"], int(kf_gid), int(kp)))
        # 3. link keypoint -> map point from payloads
        for k, p in new_kfs:
            if p["parent_gid"] >= 0 and p["parent_gid"] in st.kf_by_gid:
                st.kf_parent[k] = st.kf_by_gid[p["parent_gid"]]
            gids = p["mp_gids"]
            for kp in np.where(gids >= 0)[0]:
                m = st.mp_by_gid.get(int(gids[kp]))
                if m is not None and st.mp_alive[m]:
                    st.add_observation(m, k, int(kp), log=False)
                else:
                    st.pending_obs.append((int(gids[kp]), p["gid"], int(kp)))
        # 4. retry restoration queue (out-of-order tolerance, Map.cc:401)
        still = []
        for mp_gid, kf_gid, kp in st.pending_obs:
            m = st.mp_by_gid.get(mp_gid)
            k = st.kf_by_gid.get(kf_gid)
            if m is not None and k is not None and st.mp_alive[m]:
                st.add_observation(m, k, kp, log=False)
            else:
                still.append((mp_gid, kf_gid, kp))
        st.pending_obs = still[-10000:]
        # 5. transform — exact replication: a slice's twl is the
        # AUTHORITATIVE server value (the server owns global alignment;
        # reference: SetTransform is only ever called server-side,
        # MapManager.cc).  Blending here let a stale echo drag the
        # transform away from the authoritative one.
        if sl.twl is not None:
            R, t, s = sl.twl
            st.set_transform(np.asarray(R), np.asarray(t), float(s),
                             log=False, exact=True)
        # 6. update log
        for r in sorted(sl.updates, key=lambda r: r.seq):
            self._apply_update(r, on_map_event)
        # refresh covisibility for the new keyframes; bulk loads (full
        # map archives) rebuild the whole table in one native batch pass
        # instead of N incremental per-keyframe walks
        if len(new_kfs) >= 32:
            st.rebuild_covisibility()
            for k, _ in new_kfs:
                if st.kf_parent[k] < 0 and k != 0:
                    row = st.covis.get(k, {})
                    live = {k2: w for k2, w in row.items()
                            if st.kf_alive[k2] and st.kf_gid[k2] < st.kf_gid[k]}
                    if live:
                        st.kf_parent[k] = max(live, key=live.get)
        else:
            for k, _ in new_kfs:
                st.update_connections(k, log=False)

    def _apply_update(self, r: UpdateRecord, on_map_event=None):
        """funcName dispatch (reference: MapUpdater::Apply,
        src/MapUpdater.cc:232-279)."""
        st = self.store
        if r.kind == "map":
            if on_map_event is not None:
                on_map_event(r.func, r.target, r.args)
            return
        if r.kind == "kf":
            k = st.kf_by_gid.get(r.target)
            if k is None:
                return
            if r.func == "SetPose":
                T = np.asarray(r.args[0])
                if self._slice_stale and st.kf_corrected[k]:
                    # stale gauge: carry the client's relative refinement
                    # (vs the pre-correction pose) onto the FIXED
                    # post-correction snapshot — successive stale slices
                    # carry cumulative deltas, so conjugating onto the
                    # live pose would compound them
                    delta = T @ np.linalg.inv(st.kf_pre_corr_pose[k])
                    delta[:3, 3] /= st.kf_corr_scale[k]
                    T = (delta @ st.kf_post_corr_pose[k]).astype(np.float32)
                st.set_kf_pose(k, T, log=False)
            elif r.func == "SetBadFlag":
                st.set_kf_bad(k, log=False)
            elif r.func == "AddLoopEdge":
                k2 = st.kf_by_gid.get(r.args[0])
                if k2 is not None:
                    st.add_loop_edge(k, k2, log=False)
            elif r.func == "UpdateConnections":
                st.update_connections(k, log=False)
            return
        m = st.mp_by_gid.get(r.target)
        if m is None:
            if r.func == "AddObservation":
                # park in the restoration queue: the point may arrive in a
                # later slice (out-of-order tolerance, Map.cc:401-423)
                st.pending_obs.append((r.target, r.args[0], int(r.args[1])))
            return
        if r.func == "SetWorldPos":
            x = np.asarray(r.args[0], np.float32)
            if self._slice_stale and st.mp_corrected[m]:
                # stale gauge: keep the (fixed) corrected position, fold
                # in the client's refinement delta mapped through the
                # reference keyframe's pre->post Sim3 (rotation AND
                # scale) — against the post-correction snapshot, not the
                # live position, to avoid compounding cumulative deltas
                # across successive stale slices.  With x = pre + d the
                # full-point mapping x' = Rc^T((Rp x + tp)/s - tc)
                # reduces to post + Rc^T Rp d / s.
                ref = int(st.mp_ref_kf[m])
                d = x - st.mp_pre_corr_pos[m]
                if ref >= 0 and st.kf_corrected[ref]:
                    Rp = st.kf_pre_corr_pose[ref][:3, :3]
                    Rc = st.kf_post_corr_pose[ref][:3, :3]
                    d = (Rc.T @ (Rp @ d)) / float(st.kf_corr_scale[ref])
                x = (st.mp_post_corr_pos[m] + d).astype(np.float32)
            st.set_mp_pos(m, x, log=False)
        elif r.func == "AddObservation":
            k = st.kf_by_gid.get(r.args[0])
            if k is not None:
                st.add_observation(m, k, int(r.args[1]), log=False)
            else:
                st.pending_obs.append((r.target, r.args[0], int(r.args[1])))
        elif r.func == "EraseObservation":
            k = st.kf_by_gid.get(r.args[0])
            if k is not None:
                st.erase_observation(m, k, log=False)
        elif r.func == "SetBadFlag":
            st.set_mp_bad(m, log=False)
        elif r.func == "Replace":
            m2 = st.mp_by_gid.get(r.args[0])
            if m2 is not None:
                st.replace_mp(m, m2, log=False)
        elif r.func == "ComputeDistinctiveDescriptors":
            st.mp_desc[m] = np.asarray(r.args[0], np.uint32)
        elif r.func == "UpdateNormalAndDepth":
            st.mp_normal[m] = np.asarray(r.args[0])
            st.mp_min_dist[m] = r.args[1]
            st.mp_max_dist[m] = r.args[2]
        elif r.func == "SetVisible":
            st.mp_visible[m] = int(r.args[0])
        elif r.func == "SetFound":
            st.mp_found[m] = int(r.args[0])
        elif r.func == "SetLastTrackedTime":
            st.mp_last_tracked[m] = float(r.args[0])
        else:
            _log.debug("unknown update func %s", r.func)


def full_archive(store: MapStore) -> MapSlice:
    """Whole-map snapshot (for SaveMap/LoadMap checkpoints — reference:
    System::SaveMap, System.cc:349; map-client-<id>.bin)."""
    mapit = Mapit.__new__(Mapit)
    mapit.store = store
    sl = MapSlice(map_id=store.map_id, kfs=[], mps=[], updates=[], twl=None,
                  epoch=store.gauge_epoch)
    for k in store.alive_kf_slots():
        sl.kfs.append(Mapit._kf_payload(mapit, int(k)))
    for m in store.alive_mp_slots():
        sl.mps.append(Mapit._mp_payload(mapit, int(m)))
    if store.Twl_s != 1.0 or not np.allclose(store.Twl_R, np.eye(3)):
        sl.twl = (store.Twl_R.copy(), store.Twl_t.copy(), float(store.Twl_s))
    return sl


