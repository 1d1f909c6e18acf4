"""Local mapping: map growth + refinement around each new keyframe.

Port of swarmmap_tpu/core/local_mapping.py.  Reference spec: LocalMapping
(code/src/LocalMapping.cc of the C++ SwarmMap) — ProcessNewKeyFrame ->
MapPointCulling -> CreateNewMapPoints (epipolar triangulation with
covisible neighbors) -> SearchInNeighbors (fuse) -> LocalBundleAdjustment
-> KeyFrameCulling.  The SwarmMap twist: instead of feeding a local loop
closer, it emits an AddLoopClosing map event so the SERVER's loop closer
picks the keyframe up (LocalMapping.cc:88-90).

Runs synchronously by default (one call per inserted keyframe), or in a
worker thread (`start_async`).  The device programs run on the mapper's
`device` (by default the card): the per-neighbour match / triangulate /
check and the per-target fuse are one program each over a leading
neighbour or target axis (where the JAX package has `jax.vmap`), or one
merged program for both (the default; SWARMMAP_MERGED_MAPPING=0 selects
the two-phase order of LocalMapping.cc:70-76, as in the JAX package).
Local BA is the dense Schur BA of `ops/ba.py`.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import matching, triangulate as tri
from ..utils.device import default_device, fetch, to_device
from ..utils.logging import get_logger
from ..utils.stats import STATS
from .map_store import NO_MP, MapStore

_log = get_logger("mapping")


# ---------------------------------------------------------------------------
# Device programs: all covisible neighbors (or fuse targets) in ONE call,
# the neighbor or target axis leading.
# ---------------------------------------------------------------------------

def _triangulate_body(
    nodes1, free1, uv1, desc1, angle1, sig2_1, P1, T1, c1,
    nodes2, free2, uv2, desc2, angle2, sig2_2, F12, P2, T2, c2, nb_ok,
):
    """Epipolar-gated BoW match + DLT triangulation + quality checks of
    keyframe k ([N] keypoints) against B neighbors (the *2 arguments and
    nb_ok have the neighbor axis leading).  Returns ([B,N] match index,
    [B,N] good, [B,N,3] points)."""
    B = nodes2.shape[0]
    mask = matching.node_mask(nodes1, nodes2, free1, free2 & nb_ok[:, None])
    mask &= matching.epipolar_mask(uv1, uv2, F12, sig2_2, free1, free2)
    m = matching.masked_match(
        desc1.expand(B, -1, -1), desc2, mask, max_dist=matching.TH_LOW, ratio=0.0,
        angle_q=angle1.expand(B, -1), angle_t=angle2, check_rotation=True,
    )
    idx = m.idx.long()
    uv2m = torch.gather(uv2, 1, idx[..., None].expand(-1, -1, 2))
    pts = tri.triangulate(P1.expand(B, 3, 4), P2, uv1, uv2m)
    finite = torch.isfinite(pts).all(-1)
    z1 = (pts @ T1[:3, :3].T + T1[:3, 3])[..., 2]
    z2 = (pts @ T2[:, :3, :3].transpose(-1, -2) + T2[:, None, :3, 3])[..., 2]
    e1 = tri.reprojection_error2(P1, pts, uv1)
    e2 = tri.reprojection_error2(P2, pts, uv2m)
    cosp = tri.parallax_cos(c1, c2, pts)
    good = (
        m.valid & finite & (z1 > 0) & (z2 > 0)
        & (e1 < 5.991 * sig2_1) & (e2 < 5.991 * torch.gather(sig2_2, 1, idx))
        & (cosp < 0.9998)
    )
    return m.idx, good, pts


def _fuse_body(
    mp_pos, mp_desc, mp_maxd, mp_ok,
    kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok,
    hw_h, hw_w, scale, n_levels, window_th,
):
    """Project one shared candidate point set ([M] rows) into each of B
    target keyframes (the kf_* arguments have the target axis leading) and
    window-match (the SearchInNeighbors fuse step).  Returns ([B,M] target
    keypoint, [B,M] valid)."""
    B = kf_Tcw.shape[0]
    pc = mp_pos @ kf_Tcw[:, :3, :3].transpose(-1, -2) + kf_Tcw[:, None, :3, 3]
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = kf_K[:, 0, 0, None] * pc[..., 0] / zc + kf_K[:, 0, 2, None]
    v = kf_K[:, 1, 1, None] * pc[..., 1] / zc + kf_K[:, 1, 2, None]
    visible = (
        mp_ok & kf_ok[:, None] & (z > 0.05)
        & (u >= 0) & (u < hw_w) & (v >= 0) & (v < hw_h)
    )
    pred_oct = matching.predicted_octave(z, mp_maxd, scale, n_levels)
    radius = window_th * torch.tensor(scale, dtype=torch.float32) ** pred_oct.to(torch.float32)
    mask = matching.window_mask(
        torch.stack([u, v], -1), kf_uv, radius, visible, kf_valid,
        t_octave=kf_oct, oct_lo=pred_oct - 1, oct_hi=pred_oct + 1,
    )
    m = matching.masked_match(
        mp_desc.expand(B, -1, -1), kf_desc, mask, max_dist=matching.TH_LOW, ratio=0.0)
    return m.idx, m.valid


def _batched_triangulate_then_fuse(
    nodes1, free1, uv1, desc1, angle1, sig2_1, P1, T1, c1,
    nodes2, free2, uv2, desc2, angle2, sig2_2, F12, P2, T2, c2, nb_ok,
    oct1,
    krow_pos, krow_desc, krow_maxd, krow_ok,
    ext_pos, ext_desc, ext_maxd, ext_ok,
    kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok,
    hw_h, hw_w, scale, n_levels, window_th,
):
    """CreateNewMapPoints + SearchInNeighbors as ONE device program:
    triangulate against every covisible neighbor, dedup the winners on
    device (the first neighbor claims a keypoint — the host commit order),
    and window-match the combined candidate set into every target
    keyframe.

    The candidate ORDER mirrors the two-phase path exactly: KF k's row in
    keypoint order (a new point where one triangulated, else the row's
    pre-existing point), then the neighbor-only extras, so index-order
    tie-breaking in the mutual-best resolve is the two-phase path's."""
    idx_b, good_b, pts_b = _triangulate_body(
        nodes1, free1, uv1, desc1, angle1, sig2_1, P1, T1, c1,
        nodes2, free2, uv2, desc2, angle2, sig2_2, F12, P2, T2, c2, nb_ok,
    )
    # for a keypoint i of KF k, the FIRST neighbor (lowest bi) with a good
    # triangulation wins; argmax of a bool is taken on uint8, first max
    any_good = good_b.any(dim=0)
    first_nb = torch.argmax(good_b.to(torch.uint8), dim=0)
    n_kp = good_b.shape[1]
    new_pos = pts_b[first_nb, torch.arange(n_kp, device=pts_b.device)]
    new_pos = torch.where(any_good[:, None], new_pos, 0.0)
    # max scale-invariance distance exactly as the host will set it
    # (map_store.update_normal_and_depth: ref KF = k, level = kp octave)
    dist = torch.linalg.norm(new_pos - c1, dim=1)
    new_maxd = torch.clamp(dist, min=1e-6) * torch.tensor(
        scale, dtype=torch.float32) ** oct1.to(torch.float32)
    # per-keypoint bank: new point where one triangulated (free keypoints
    # only), else the pre-existing point of k's row — disjoint sets
    bank_pos = torch.where(any_good[:, None], new_pos, krow_pos)
    bank_desc = torch.where(any_good[:, None], desc1, krow_desc)
    bank_maxd = torch.where(any_good, new_maxd, krow_maxd)
    bank_ok = any_good | krow_ok
    fidx_b, fvalid_b = _fuse_body(
        torch.cat([bank_pos, ext_pos], 0), torch.cat([bank_desc, ext_desc], 0),
        torch.cat([bank_maxd, ext_maxd], 0), torch.cat([bank_ok, ext_ok], 0),
        kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok,
        hw_h, hw_w, scale, n_levels, window_th,
    )
    return idx_b, good_b, pts_b, fidx_b, fvalid_b


class LocalMapping:
    def __init__(self, store: MapStore, settings, kfdb=None, on_loop_closing=None,
                 device: torch.device | str | None = None):
        """`device` runs the device programs; by default the card
        (`utils.device.default_device`), which raises where there is
        none.  Tests pass device="cpu"."""
        self.device = torch.device(default_device() if device is None else device)
        self.store = store
        self.settings = settings
        self.kfdb = kfdb
        self.on_loop_closing = on_loop_closing  # server-side loop-closer hook
        self.recent_mps: list[int] = []
        self.queue: list[int] = []
        # async mode (reference: LocalMapping::Run free thread). Off by
        # default: the synchronous path is deterministic.
        self._async = False
        # merged triangulate+fuse dispatch (default); SWARMMAP_MERGED_MAPPING=0
        # restores the reference's two-phase ordering (LocalMapping.cc:70-76)
        self._merged_mapping = (
            os.environ.get("SWARMMAP_MERGED_MAPPING", "1") != "0")
        self._cv = threading.Condition()
        self._busy = False
        self._stop = False
        self._thread: threading.Thread | None = None

    @property
    def scale_factor(self):
        return self.settings.orb.scale_factor

    @property
    def n_levels(self):
        return self.settings.orb.n_levels

    def _t(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def insert_keyframe(self, k: int):
        if self._async:
            with self._cv:
                self.queue.append(k)
                self._cv.notify()
        else:
            self.queue.append(k)
            self.process_queue()

    def process_queue(self):
        while self.queue:
            k = self.queue.pop(0)
            self.process_keyframe(k)

    # ------------------------------------------------------------ async mode
    def start_async(self):
        """Run the mapping pipeline in a worker thread, overlapping with
        tracking (reference runs LocalMapping::Run as a free thread).
        Mutations are serialized through store.lock; each stage takes it
        only around its store reads/writes, so the tracker's device calls
        overlap mapping's."""
        if self._async:
            return
        self._async = True
        self._stop = False

        def run():
            while True:
                with self._cv:
                    while not self.queue and not self._stop:
                        self._cv.wait(0.05)
                    if self._stop and not self.queue:
                        return
                    k = self.queue.pop(0)
                    self._busy = True
                try:
                    self.process_keyframe(k)
                except Exception:  # noqa: BLE001 — worker must survive
                    _log.exception("async local mapping failed for kf %d", k)
                finally:
                    with self._cv:
                        self._busy = False
                        self._cv.notify_all()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait_idle(self, timeout: float = 30.0):
        """Barrier: block until the queue is drained."""
        if not self._async:
            return
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.queue or self._busy:
                if not self._cv.wait(min(0.05, max(deadline - time.monotonic(), 0.001))):
                    if time.monotonic() >= deadline:
                        _log.warning("wait_idle timed out with %d queued",
                                     len(self.queue))
                        return

    def stop_async(self):
        if not self._async:
            return
        self.wait_idle()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._async = False

    @property
    def busy(self) -> bool:
        """True while the async worker has queued or in-flight keyframes
        (reference: LocalMapping::AcceptKeyFrames — the tracker's keyframe
        policy throttles on it)."""
        return self._async and (self._busy or bool(self.queue))

    def process_keyframe(self, k: int):
        st = self.store
        # reference backlog semantics (LocalMapping.cc:62-82): when new
        # keyframes are already queued behind this one, run only the
        # essential per-KF work (observations, culling, triangulation)
        # and DEFER fuse + local BA to the keyframe that empties the queue
        backlogged = bool(self.queue)
        with STATS.stage("lm_process_new"), st.lock:
            self._process_new_keyframe(k)
        if not backlogged:
            # culling must not run ahead of fuse: a just-triangulated point
            # has n_obs=2 until fuse adds the neighbor observations
            with STATS.stage("lm_cull_mps"), st.lock:
                self._cull_map_points(k)
        if self._merged_mapping and not backlogged:
            with STATS.stage("lm_tri_fuse"):
                self._create_and_fuse(k)
        else:
            with STATS.stage("lm_triangulate"):
                self._create_new_map_points(k)
            if not backlogged:
                with STATS.stage("lm_fuse"):
                    self._fuse_neighbors(k)
        if not backlogged:
            if st.kf_alive[: st.n_kf].sum() > 2:
                with STATS.stage("lm_local_ba"):
                    self._local_ba(k)
        with STATS.stage("lm_cull_kfs"), st.lock:
            self._cull_keyframes(k)
        # hand the KF to the (server-side) loop closer via the map event
        # log (reference: LocalMapping.cc:88-90)
        if st.log_fn is not None:
            st.log_fn("map", "AddLoopClosing", int(st.kf_gid[k]), ())
        if self.on_loop_closing is not None:
            self.on_loop_closing(k)

    # ------------------------------------------------------------------
    def _process_new_keyframe(self, k: int):
        self._refresh_dirty()
        self.store.update_connections(k)

    def _refresh_dirty(self):
        """Recompute descriptors/normals ONLY for points whose observation
        sets changed (equivalent at keyframe granularity to the reference's
        inline recomputation on every mutation)."""
        st = self.store
        st.refresh_points(st.dirty_mps, self.scale_factor, self.n_levels)
        st.dirty_mps.clear()

    def _cull_map_points(self, k: int):
        """Recent-point quality gate (reference: MapPointCulling)."""
        st = self.store
        kept = []
        for m in self.recent_mps:
            if not st.mp_alive[m]:
                continue
            found_ratio = st.mp_found[m] / max(st.mp_visible[m], 1)
            age = k - st.mp_first_kf[m]
            n_obs = len(st.obs.get(m, {}))
            if found_ratio < 0.25:
                st.set_mp_bad(m)
            elif age >= 2 and n_obs <= 2:
                st.set_mp_bad(m)
            elif age >= 3:
                continue  # graduated
            else:
                kept.append(m)
        self.recent_mps = kept

    def _create_new_map_points(self, k: int, n_neighbors: int = 8):
        st = self.store
        with st.lock:
            args = self._triangulate_assemble(k, n_neighbors)
        if args is None:
            return
        kept_nb, dev_args, _oct1 = args
        # dispatch + fetch run UNLOCKED (tracking interleaves in async mode)
        idx_b, good_b, pts_b = fetch(_triangulate_body(*dev_args))
        with st.lock:
            self._triangulate_commit(k, kept_nb, idx_b, good_b, pts_b)

    def _triangulate_assemble(self, k: int, n_neighbors: int):
        st = self.store
        neighbors = st.covisible_kfs(k, n_neighbors)
        if not neighbors:
            return None
        K1 = st.kf_K[k]
        T1 = st.kf_pose_cw[k].astype(np.float32)
        P1 = (K1 @ T1[:3]).astype(np.float32)
        c1 = st.kf_center(k).astype(np.float32)
        n_kp = st.n_kp
        B = n_neighbors  # fixed batch
        T2 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        P2 = np.zeros((B, 3, 4), np.float32)
        F12 = np.zeros((B, 3, 3), np.float32)
        c2 = np.zeros((B, 3), np.float32)
        nodes2 = np.full((B, n_kp), -1, np.int32)
        free2 = np.zeros((B, n_kp), bool)
        uv2 = np.zeros((B, n_kp, 2), np.float32)
        desc2 = np.zeros((B, n_kp, 8), np.uint32)
        angle2 = np.zeros((B, n_kp), np.float32)
        sig2_2 = np.ones((B, n_kp), np.float32)
        nb_ok = np.zeros(B, bool)
        kept_nb = []
        for bi, k2 in enumerate(neighbors[:B]):
            c2_i = st.kf_center(k2)
            baseline = np.linalg.norm(c2_i - c1)
            mps2 = st.kf_kp_mp[k2]
            live = mps2[mps2 != NO_MP]
            live = live[st.mp_alive[live]]
            if len(live):
                depths = (st.mp_pos[live] @ st.kf_pose_cw[k2][:3, :3].T
                          + st.kf_pose_cw[k2][:3, 3])[:, 2]
                med_depth = float(np.median(depths[depths > 0])) if (depths > 0).any() else 1.0
            else:
                med_depth = 1.0
            if baseline / max(med_depth, 1e-9) < 0.01:
                continue
            T2_i = st.kf_pose_cw[k2].astype(np.float32)
            T12 = T1 @ np.linalg.inv(T2_i)
            R12, t12 = T12[:3, :3], T12[:3, 3]
            tx = np.array(
                [[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]],
                np.float32,
            )
            K2 = st.kf_K[k2]
            T2[bi] = T2_i
            P2[bi] = (K2 @ T2_i[:3]).astype(np.float32)
            F12[bi] = np.linalg.inv(K1).T @ tx @ R12 @ np.linalg.inv(K2)
            c2[bi] = c2_i
            nodes2[bi] = st.kf_nodes[k2]
            free2[bi] = st.kf_kp_valid[k2] & (st.kf_kp_mp[k2] == NO_MP)
            uv2[bi] = st.kf_kp_uv[k2]
            desc2[bi] = st.kf_desc[k2]
            angle2[bi] = st.kf_kp_angle[k2]
            sig2_2[bi] = self.scale_factor ** (2.0 * st.kf_kp_octave[k2])
            nb_ok[bi] = True
            kept_nb.append((bi, k2))
        if not kept_nb:
            return None
        free1 = st.kf_kp_valid[k] & (st.kf_kp_mp[k] == NO_MP)
        sig2_1 = (self.scale_factor ** (2.0 * st.kf_kp_octave[k])).astype(np.float32)
        t = self._t
        dev_args = tuple(t(x) for x in (
            st.kf_nodes[k], free1, st.kf_kp_uv[k], st.kf_desc[k], st.kf_kp_angle[k],
            sig2_1, P1, T1, c1,
            nodes2, free2, uv2, desc2, angle2, sig2_2, F12, P2, T2, c2, nb_ok))
        return kept_nb, dev_args, t(st.kf_kp_octave[k])

    def _triangulate_commit(self, k, kept_nb, idx_b, good_b, pts_b):
        st = self.store
        created: dict[int, int] = {}  # kp index of k -> new mp id
        claimed = np.zeros(st.n_kp, bool)  # first neighbor wins a keypoint
        for bi, k2 in kept_nb:
            good = good_b[bi] & ~claimed
            for i in np.where(good)[0]:
                j = int(idx_b[bi, i])
                mp = st.add_map_point(
                    pts_b[bi, i], st.kf_desc[k, i], ref_kf=k,
                    cam_velocity=float(st.kf_velocity[k]),
                )
                st.add_observation(mp, k, int(i))
                st.add_observation(mp, k2, j)
                self.recent_mps.append(mp)
                claimed[i] = True
                created[int(i)] = mp
        if created:
            # one batched normal/depth pass over the new points (the fuse
            # assembly needs mp_max_dist; descriptors get their distinctive
            # refresh in _refresh_dirty after fuse)
            st.refresh_points(created.values(), self.scale_factor,
                              self.n_levels, descriptors=False)
            st.update_connections(k)
        return created

    def _fuse_assemble(self, k: int, max_targets: int, cand_bucket: int,
                       krow: bool = False):
        """Build the fuse program's inputs (call holding store.lock).

        The shared candidate set is the union of all targets' points (dedup
        keeps the FIRST occurrence so the strongest targets' points survive
        the bucket cut).  krow=True splits the candidates into KF k's
        keypoint-indexed row bank + neighbor-only extras for the merged
        program.  Near the cand_bucket cap the krow layout admits slightly
        more extras than the two-phase cut (ext_cap counts only
        pre-existing k-row points, not fresh triangulations), as in the
        JAX package."""
        st = self.store
        neighbors = st.covisible_kfs(k, max_targets - 1)
        targets = [k] + neighbors
        rows = st.kf_kp_mp[np.asarray(targets, np.int32)]
        if krow:
            krow_mp = rows[0].astype(np.int32, copy=True)
            krow_mp[(krow_mp != NO_MP)
                    & ~st.mp_alive[np.clip(krow_mp, 0, None)]] = NO_MP
            kv = krow_mp != NO_MP
            krow_pos = np.zeros((st.n_kp, 3), np.float32)
            krow_desc = np.zeros((st.n_kp, 8), np.uint32)
            krow_maxd = np.ones(st.n_kp, np.float32)
            krow_pos[kv] = st.mp_pos[krow_mp[kv]]
            krow_desc[kv] = st.mp_desc[krow_mp[kv]]
            krow_maxd[kv] = st.mp_max_dist[krow_mp[kv]]
            in_krow = np.zeros(len(st.mp_alive), bool)
            in_krow[krow_mp[kv]] = True
            flat = rows[1:][rows[1:] != NO_MP]
            uniq, first = np.unique(flat, return_index=True)
            cand = uniq[np.argsort(first)]
            cand = cand[st.mp_alive[cand] & ~in_krow[cand]]
            ext_cap = max(0, cand_bucket - int(kv.sum()))
            slots = cand[:ext_cap].astype(np.int32)
        else:
            krow_mp = None
            flat = rows[rows != NO_MP]
            uniq, first = np.unique(flat, return_index=True)
            cand = uniq[np.argsort(first)]
            cand = cand[st.mp_alive[cand]]
            slots = cand[:cand_bucket].astype(np.int32)
        n = len(slots)
        mp_pos = np.zeros((cand_bucket, 3), np.float32)
        mp_desc = np.zeros((cand_bucket, 8), np.uint32)
        mp_maxd = np.ones(cand_bucket, np.float32)
        mp_ok = np.zeros(cand_bucket, bool)
        mp_pos[:n] = st.mp_pos[slots]
        mp_desc[:n] = st.mp_desc[slots]
        mp_maxd[:n] = st.mp_max_dist[slots]
        mp_ok[:n] = True

        B = max_targets
        n_kp = st.n_kp
        kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        kf_K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        kf_uv = np.zeros((B, n_kp, 2), np.float32)
        kf_oct = np.zeros((B, n_kp), np.int32)
        kf_valid = np.zeros((B, n_kp), bool)
        kf_desc = np.zeros((B, n_kp, 8), np.uint32)
        kf_ok = np.zeros(B, bool)
        for bi, tk in enumerate(targets[:B]):
            kf_Tcw[bi] = st.kf_pose_cw[tk]
            kf_K[bi] = st.kf_K[tk]
            kf_uv[bi] = st.kf_kp_uv[tk]
            kf_oct[bi] = st.kf_kp_octave[tk]
            kf_valid[bi] = st.kf_kp_valid[tk]
            kf_desc[bi] = st.kf_desc[tk]
            kf_ok[bi] = True
        hw = st.kf_hw[k]
        t = self._t
        kf_args = (kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok)
        if krow:
            dev = tuple(t(x) for x in (krow_pos, krow_desc, krow_maxd, krow_mp != NO_MP,
                                       mp_pos, mp_desc, mp_maxd, mp_ok) + kf_args)
            return (targets[:B], slots, n, dev,
                    (float(hw[0]), float(hw[1])), krow_mp)
        dev = tuple(t(x) for x in (mp_pos, mp_desc, mp_maxd, mp_ok) + kf_args)
        return targets[:B], slots, n, dev, (float(hw[0]), float(hw[1]))

    def _fuse_commit(self, k, targets, cand_mp, idx_b, valid_b, rows=None):
        """Apply fuse matches (call holding store.lock).  cand_mp maps each
        candidate index of the program to its map-point slot (NO_MP entries
        are skipped — padding, or device-good triangulations the host
        commit rejected).  rows maps each target to its program row."""
        st = self.store
        if rows is None:
            rows = range(len(targets))
        for bi, tk in zip(rows, targets):
            if not st.kf_alive[tk]:
                continue
            for qi in np.where(valid_b[bi])[0]:
                mp_new = int(cand_mp[qi]) if qi < len(cand_mp) else NO_MP
                if mp_new == NO_MP or not st.mp_alive[mp_new]:
                    continue
                kp = int(idx_b[bi, qi])
                mp_old = int(st.kf_kp_mp[tk, kp])
                if mp_old != NO_MP and st.mp_alive[mp_old]:
                    if mp_old == mp_new:
                        continue
                    if st.mp_nobs[mp_old] >= st.mp_nobs[mp_new]:
                        st.replace_mp(mp_new, mp_old)
                    else:
                        st.replace_mp(mp_old, mp_new)
                else:
                    st.add_observation(mp_new, tk, kp)
        self._refresh_dirty()
        st.update_connections(k)

    def _fuse_neighbors(self, k: int, window_th: float = 3.0,
                        max_targets: int = 8, cand_bucket: int = 2048):
        """Project the neighborhood's shared candidate point set into every
        target keyframe and merge duplicates — one device program
        (reference: SearchInNeighbors + ORBmatcher::Fuse)."""
        st = self.store
        with st.lock:
            targets, slots, n, dev, hw = self._fuse_assemble(
                k, max_targets, cand_bucket)
        if n == 0:
            return
        # dispatch + fetch UNLOCKED
        idx_b, valid_b = fetch(_fuse_body(
            *dev, hw[0], hw[1], self.scale_factor, self.n_levels, window_th,
        ))
        cand_mp = np.full(valid_b.shape[1], NO_MP, np.int32)
        cand_mp[:n] = slots
        with st.lock:
            self._fuse_commit(k, targets, cand_mp, idx_b, valid_b)

    def _create_and_fuse(self, k: int, n_neighbors: int = 8,
                         window_th: float = 3.0, max_targets: int = 8,
                         cand_bucket: int = 2048):
        """Triangulate + fuse in ONE device round trip.

        Assembles both phases' inputs under one lock window, runs the
        merged program, then commits triangulation first (so the fuse
        commit can resolve the new points' freshly assigned ids).  The
        reference ranks fuse targets AFTER CreateNewMapPoints; the merged
        program must pick its rows before the new points exist, so the
        device fuse is kept only when the post-triangulation ranking equals
        the pre ranking as a SET.  On a mismatch the device fuse half is
        discarded and a fresh two-phase fuse runs
        (`lm_merged_fuse_fallback`)."""
        st = self.store
        with st.lock:
            tri_args = self._triangulate_assemble(k, n_neighbors)
            fuse = (self._fuse_assemble(k, max_targets, cand_bucket, krow=True)
                    if tri_args is not None else None)
        if tri_args is None:
            # no triangulation partners: plain fuse still applies
            self._fuse_neighbors(k, window_th, max_targets, cand_bucket)
            return
        kept_nb, dev_args, oct1 = tri_args
        targets, slots, n, fuse_dev, hw, krow_mp = fuse
        # dispatch + fetch UNLOCKED
        idx_b, good_b, pts_b, fidx_b, fvalid_b = fetch(_batched_triangulate_then_fuse(
            *dev_args, oct1, *fuse_dev,
            hw[0], hw[1], self.scale_factor, self.n_levels, window_th,
        ))
        with st.lock:
            new_mp_of_kp = self._triangulate_commit(k, kept_nb, idx_b, good_b, pts_b)
            post = [k] + st.covisible_kfs(k, max_targets - 1)
            exact = set(post) == set(targets)
            if exact:
                # candidate -> map point: KF k's keypoint bank first (new
                # points override their free slots), then the extras bucket
                cand_mp = np.full(fvalid_b.shape[1], NO_MP, np.int32)
                cand_mp[: st.n_kp] = krow_mp
                for kp_i, mp in new_mp_of_kp.items():
                    cand_mp[kp_i] = mp
                cand_mp[st.n_kp: st.n_kp + n] = slots
                row_of = {tk: bi for bi, tk in enumerate(targets)}
                self._fuse_commit(k, post, cand_mp, fidx_b, fvalid_b,
                                  rows=[row_of[tk] for tk in post])
        if not exact:
            # ranking moved during triangulation: the device fused the
            # stale candidate set — replay fuse two-phase style
            _log.debug("merged fuse discarded for kf %d: ranking moved", k)
            STATS.bump("lm_merged_fuse_fallback")
            self._fuse_neighbors(k, window_th, max_targets, cand_bucket)

    # ------------------------------------------------------------------
    def _local_ba(self, k: int, max_cams: int = 16, max_pts: int = 4096,
                  max_obs: int = 16384):
        """Covisibility-window bundle adjustment
        (reference: Optimizer::LocalBundleAdjustment)."""
        st = self.store
        with st.lock:
            n_kf0, n_mp0 = st.n_kf, st.n_mp
            local = [k] + st.covisible_kfs(k, max_cams - 1)
            # local points = union of local KFs' observations
            rows = st.kf_kp_mp[np.asarray(local, np.int32)]
            flat = rows[rows != NO_MP]
            uniq, first = np.unique(flat, return_index=True)
            pts_arr = uniq[np.argsort(first)]
            pts_arr = pts_arr[st.mp_alive[pts_arr]][:max_pts].astype(np.int64)
            if len(pts_arr) < 20:
                return
            pt_lut = np.full(st.n_mp, -1, np.int32)
            pt_lut[pts_arr] = np.arange(len(pts_arr), dtype=np.int32)
            om, okf, okp = st.obs_arrays()
            in_pts = pt_lut[om] >= 0
            # frontier: KFs observing local points but not in the window
            local_arr = np.asarray(local, np.int64)
            is_local = np.zeros(st.n_kf, bool)
            is_local[local_arr] = True
            obs_kfs = np.unique(okf[in_pts])
            obs_kfs = obs_kfs[st.kf_alive[obs_kfs]]
            frontier = obs_kfs[~is_local[obs_kfs]]
            cams = np.concatenate([local_arr, frontier])
            cam_lut = np.full(st.n_kf, -1, np.int32)
            cam_lut[cams] = np.arange(len(cams), dtype=np.int32)
            fixed = np.zeros(len(cams), bool)
            fixed[len(local):] = True
            if cam_lut[0] >= 0:
                fixed[cam_lut[0]] = True  # keep the origin KF as gauge
            elif not fixed.any():
                fixed[len(local) - 1] = True  # no frontier: anchor the oldest
            sel = np.where(
                in_pts & (cam_lut[okf] >= 0) & st.kf_alive[okf])[0][:max_obs]
            if len(sel) < 30:
                return
            sel_kf, sel_kp = okf[sel], okp[sel]
            obs_cam = cam_lut[sel_kf]
            obs_pt = pt_lut[om[sel]]
            obs_uv = st.kf_kp_uv[sel_kf, sel_kp]
            obs_is2 = (1.0 / self.scale_factor
                       ** (2.0 * st.kf_kp_octave[sel_kf, sel_kp]))
            prob = ba_ops.build_padded_problem(
                st.kf_pose_cw[cams], st.kf_K[cams], fixed,
                st.mp_pos[pts_arr], obs_cam, obs_pt, obs_uv, obs_is2,
                device=self.device,
            )
        # LM iterations + fetch run UNLOCKED
        res = ba_ops.bundle_adjust(prob, iters_a=5, iters_b=10, mode="dense")
        Tcw_new, pts_new, obs_inl = fetch(res.Tcw, res.pts, res.obs_inlier)
        with st.lock:
            if st.n_kf != n_kf0 or st.n_mp != n_mp0:
                # an urgent keyframe landed mid-BA: discard the stale window
                # (reference: mbAbortBA interrupts LocalBA)
                _log.debug("local BA discarded: map grew during the run")
                return
            for i, c in enumerate(cams):
                if not fixed[i]:
                    st.set_kf_pose(int(c), Tcw_new[i])
            for i, m in enumerate(pts_arr):
                st.set_mp_pos(int(m), pts_new[i])
            # prune outlier observations (ignore padded tail)
            inl = obs_inl[: len(sel)]
            for o in np.where(~inl)[0]:
                st.erase_observation(int(om[sel[o]]), int(okf[sel[o]]))

    def _cull_keyframes(self, k: int):
        """Redundancy culling: a local KF whose points are >=90% seen by at
        least 3 other KFs at the same/finer scale dies
        (reference: LocalMapping::KeyFrameCulling, ratio 0.9)."""
        st = self.store
        cands = [
            lk for lk in st.covisible_kfs(k)
            if lk != 0 and st.kf_alive[lk] and st.kf_genuine[lk]
        ]
        total, redundant = st.redundancy_counts(cands)
        for lk, t, r in zip(cands, total, redundant):
            if t > 10 and r > 0.9 * t:
                if self.kfdb is not None:
                    self.kfdb.erase(lk)
                st.set_kf_bad(lk)
                _log.debug("culled redundant keyframe %d", lk)
