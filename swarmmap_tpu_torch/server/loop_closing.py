"""Loop detection + correction (server-side).

Reference spec: LoopClosing (/root/reference/code/src/LoopClosing.cc) —
BoW candidate detection with covisibility-consistency (>=3 consecutive),
Sim3 computation (SearchByBoW >=20 matches -> Sim3 RANSAC -> OptimizeSim3
>=20 inliers), loop correction via essential-graph optimization +
SearchAndFuse, optional global BA.  On clients the thread never starts
(System.cc:96-97); each server mediator runs one per replica
(AgentMediator.cc:50-51).

Port of swarmmap_tpu/server/loop_closing.py: the host bookkeeping is
copied line for line; the Sim3 pipeline, the essential graph, the fuse
match and the CG global BA run on the loop closer's device, and the
RANSAC draws come from its `torch.Generator` (the JAX package's
PRNGKey).  A device mesh with more than one device raises (item 17).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.keyframe_db import KeyFrameDatabase
from ..core.local_mapping import _fuse_body
from ..core.map_store import NO_MP, MapStore
from ..ops import pose_graph
from ..ops import ba as ba_ops
from ..ops.vocab import Vocabulary
from ..utils.device import default_device, fetch, require_one_device, to_device
from ..utils.logging import get_logger
from . import sim3_match

_log = get_logger("loop")


def _project_scale_gauge(Tn: np.ndarray, pn: np.ndarray,
                         c_pre: np.ndarray, n_cams: int,
                         n_pts: int) -> tuple[np.ndarray, np.ndarray]:
    """Remove the scale-gauge component from a (mono) BA result.

    With one fixed camera, reprojection error is exactly invariant to
    scaling the whole solution about that camera's center — BA output
    can wander along that null direction.  Rescale poses+points about
    the anchor (row 0, the fixed camera) so the camera-center spread
    matches the pre-BA solution `c_pre`.  The anchor's pose is
    preserved bit-for-bit; reprojections are unchanged (projection is
    invariant to scaling camera-frame points).
    """
    Tn = np.asarray(Tn, np.float64)
    R = Tn[:n_cams, :3, :3]
    c_new = -np.einsum("kij,kj->ki", R.transpose(0, 2, 1), Tn[:n_cams, :3, 3])
    c0 = c_pre[0]
    d_pre = np.sum((c_pre - c0) ** 2)
    d_new = np.sum((c_new - c0) ** 2)
    if d_new < 1e-12 or d_pre < 1e-12:
        return Tn.astype(np.float32), np.asarray(pn)
    s = float(np.sqrt(d_pre / d_new))
    if abs(s - 1.0) < 1e-6:
        return Tn.astype(np.float32), np.asarray(pn)
    out_T = Tn.copy()
    # t' = s*t - (1-s) * R_cw @ c0  (pure scaling about c0; rotation
    # unchanged, anchor pose exactly preserved)
    out_T[:n_cams, :3, 3] = (s * Tn[:n_cams, :3, 3]
                             - (1.0 - s) * (R @ c0))
    out_p = np.asarray(pn, np.float64).copy()
    out_p[:n_pts] = s * out_p[:n_pts] + (1.0 - s) * c0
    return out_T.astype(np.float32), out_p.astype(np.float32)


class LoopClosing:
    def __init__(self, store: MapStore, kfdb: KeyFrameDatabase,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 consistency_th: int = 3, min_sim3_inliers: int = 20,
                 run_global_ba: bool = True, rng_seed: int = 17,
                 on_merge=None, device: torch.device | str | None = None):
        """`device` runs the device programs; by default the card
        (`utils.device.default_device`).  Tests pass device="cpu"."""
        self.device = torch.device(default_device() if device is None else device)
        self.store = store
        self.kfdb = kfdb
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.consistency_th = consistency_th
        self.min_sim3_inliers = min_sim3_inliers
        self.run_global_ba = run_global_ba
        self.on_merge = on_merge
        self.generator = torch.Generator(self.device).manual_seed(rng_seed)
        self.consistency: dict[int, int] = {}
        self.last_loop_kf = -1
        self.n_loops_closed = 0
        self.n_fused = 0  # total SearchAndFuse fusions across loops
        # device mesh for observation-sharded GBA (SURVEY.md §5); one
        # with more than one device raises in global_ba (item 17)
        self.mesh = None

    # ------------------------------------------------------------------
    def process_keyframe(self, k: int) -> bool:
        st = self.store
        if not st.kf_alive[k]:
            return False
        if self.last_loop_kf >= 0 and k - self.last_loop_kf < 10:
            return False  # cooldown (reference: mLastLoopKFid + 10)
        cands = self.detect_loop(k)
        for cand in cands:
            res = self.compute_sim3(k, cand)
            if res is None:
                continue
            s, R, t, mp_pairs = res
            if not self.correct_loop(k, cand, s, R, t, mp_pairs):
                continue
            self.last_loop_kf = k
            self.n_loops_closed += 1
            return True
        return False

    # ------------------------------------------------------------------
    def detect_loop(self, k: int) -> list[int]:
        """BoW candidates above the min covisible score, with the
        consecutive-consistency counter (reference: DetectLoop)."""
        st = self.store
        covis = st.covisible_kfs(k, 30)
        if len(covis) < 3:
            return []
        bow_k = self.kfdb.bow.get(k, {})
        min_score = min(
            (Vocabulary.score(bow_k, self.kfdb.bow.get(c, {})) for c in covis),
            default=0.0,
        )
        cands = self.kfdb.detect_loop_candidates(st, k, min_score)
        # temporal consistency: candidate groups must persist across
        # consecutive keyframes
        new_consistency: dict[int, int] = {}
        accepted = []
        for c in cands:
            group = set(st.covisible_kfs(c, 10)) | {c}
            prev = max((self.consistency.get(g, 0) for g in group), default=0)
            new_consistency[c] = prev + 1
            if prev + 1 >= self.consistency_th:
                accepted.append(c)
        self.consistency = new_consistency
        return accepted

    # ------------------------------------------------------------------
    def compute_sim3(self, k: int, cand: int):
        """Sim3 between current KF and candidate via the full shared
        pipeline — BoW match, RANSAC, SearchBySim3 guided enrichment,
        OptimizeSim3 (reference: ComputeSim3, LoopClosing.cc:210-370)."""
        res = sim3_match.compute_sim3_between(
            self.store, k, self.store, cand, self.generator,
            self.scale_factor, self.n_levels, self.min_sim3_inliers,
            own_origin_only=True,
        )
        if res is None:
            return None
        return res["s"], res["R"], res["t"], (res["mp1"], res["mp2"])

    # ------------------------------------------------------------------
    def map_reproj_cost(self, chi2_cap: float = 25.0) -> float:
        """Mean capped reprojection chi2 over all live observations —
        the self-consistency metric guarding loop corrections (host
        numpy; ~100 ms at 150k observations)."""
        st = self.store
        om, okf, okp = st.obs_arrays()
        sel = st.mp_alive[om] & st.kf_alive[okf]
        om, okf, okp = om[sel], okf[sel], okp[sel]
        if len(om) == 0:
            return 0.0
        T = st.kf_pose_cw[okf]
        pc = np.einsum("nij,nj->ni", T[:, :3, :3], st.mp_pos[om]) + T[:, :3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        K = st.kf_K[okf]
        u = K[:, 0, 0] * pc[:, 0] / z + K[:, 0, 2]
        v = K[:, 1, 1] * pc[:, 1] / z + K[:, 1, 2]
        uv = st.kf_kp_uv[okf, okp]
        inv_s2 = (1.0 / self.scale_factor
                  ** (2.0 * st.kf_kp_octave[okf, okp]))
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_s2
        chi2 = np.where(pc[:, 2] > 0, chi2, chi2_cap)
        return float(np.minimum(chi2, chi2_cap).mean())

    def correct_loop(self, k: int, loop_kf: int, s: float, R: np.ndarray,
                     t: np.ndarray, mp_pairs=None) -> bool:
        """Essential-graph correction (reference: CorrectLoop).

        (s,R,t) = S_{k<-loop}: maps loop-KF camera coords into current-KF
        camera coords.  The corrected pose of k is S_k_loop * T_loop_w.

        Unlike the reference, the correction is SELF-CHECKING: the mean
        reprojection chi2 over the (unchanged) observation set is
        measured before and after; a correction that blows it up is
        rolled back atomically — a wrong loop Sim3 or an ill-conditioned
        essential graph warps the entire replica otherwise."""
        st = self.store
        dump_dir = os.environ.get("SWARMMAP_DUMP_LOOP")
        if dump_dir:
            # forensics: snapshot the replica + the measured Sim3 so a
            # warping correction can be replayed in isolation
            import pickle

            from ..sync.oplog import full_archive
            from ..sync import codec as _codec

            path = os.path.join(
                dump_dir, f"loop_map{st.map_id}_k{k}_l{loop_kf}.pkl")
            with open(path, "wb") as f:
                pickle.dump({
                    "slice": _codec.encode_slice(full_archive(st)),
                    "map_id": st.map_id, "k": k, "loop_kf": loop_kf,
                    "s": s, "R": np.asarray(R), "t": np.asarray(t),
                    "parent": st.kf_parent[: st.n_kf].copy(),
                    "kf_ts": st.kf_ts[: st.n_kf].copy(),
                    "kf_alive": st.kf_alive[: st.n_kf].copy(),
                    "kf_genuine": st.kf_genuine[: st.n_kf].copy(),
                    "kf_gid": st.kf_gid[: st.n_kf].copy(),
                }, f)
            _log.info("loop case dumped to %s", path)
        cost_before = self.map_reproj_cost()
        mp_slots_snap = st.alive_mp_slots()
        mp_pos_snap = st.mp_pos[mp_slots_snap].copy()
        slots = st.alive_kf_slots()
        pose_snap = st.kf_pose_cw[slots].copy()
        n = len(slots)
        slot_of = {int(kk): i for i, kk in enumerate(slots)}
        Riw = st.kf_pose_cw[slots][:, :3, :3].astype(np.float32)
        tiw = st.kf_pose_cw[slots][:, :3, 3].astype(np.float32)
        siw = np.ones(n, np.float32)

        # corrected Sim3 for current KF:  S_kw_corr = S_k_loop * T_loop_w
        T_lw = st.kf_pose_cw[loop_kf]
        R_corr = (R @ T_lw[:3, :3]).astype(np.float32)
        t_corr = (s * (R @ T_lw[:3, 3]) + t).astype(np.float32)
        s_corr = np.float32(s)
        ik = slot_of[k]
        # propagate correction to current KF's covisible neighborhood:
        # S_iw_corr = S_i_k(old relative) * S_kw_corr
        neighborhood = [k] + st.covisible_kfs(k, 20)
        T_kw = st.kf_pose_cw[k]
        T_wk = np.linalg.inv(T_kw)
        for nk in neighborhood:
            i = slot_of.get(nk)
            if i is None:
                continue
            T_ik = st.kf_pose_cw[nk] @ T_wk
            # Sim3 composition: (R_ik, t_ik, 1) * (R_corr, t_corr, s_corr)
            Riw[i] = (T_ik[:3, :3] @ R_corr).astype(np.float32)
            tiw[i] = (T_ik[:3, :3] @ t_corr + T_ik[:3, 3]).astype(np.float32)
            siw[i] = s_corr

        # edges: spanning tree + strong covisibility + the new loop edge
        ei, ej, mR, mt, ms = [], [], [], [], []

        def add_edge(a, b, Sji=None):
            ia, ib = slot_of.get(a), slot_of.get(b)
            if ia is None or ib is None or ia == ib:
                return
            if Sji is None:
                # measurement from PRE-correction relative pose: S_ji = T_jw * T_iw^-1
                Tj = st.kf_pose_cw[b]
                Ti = st.kf_pose_cw[a]
                Tji = Tj @ np.linalg.inv(Ti)
                Sji = (Tji[:3, :3], Tji[:3, 3], 1.0)
            ei.append(ia)
            ej.append(ib)
            mR.append(np.asarray(Sji[0], np.float32))
            mt.append(np.asarray(Sji[1], np.float32))
            ms.append(float(Sji[2]))

        seen = set()
        for kk in slots:
            p = st.kf_parent[kk]
            if p >= 0 and st.kf_alive[p]:
                add_edge(int(kk), int(p))
            for k2, w in st.covis.get(int(kk), {}).items():
                if w >= 100 and st.kf_alive[k2] and (k2, int(kk)) not in seen:
                    seen.add((int(kk), k2))
                    add_edge(int(kk), k2)
            for k2 in st.kf_loop_edges.get(int(kk), ()):
                if st.kf_alive[k2] and (k2, int(kk)) not in seen:
                    seen.add((int(kk), k2))
                    add_edge(int(kk), k2)
        # the new loop edge with the measured Sim3 (S_k_loop)
        add_edge(loop_kf, k, (R, t, s))
        if len(ei) < n - 1:
            # ensure connectivity through temporal chain
            for i in range(n - 1):
                add_edge(int(slots[i]), int(slots[i + 1]))

        fixed = np.zeros(n, bool)
        fixed[slot_of[loop_kf]] = True
        def t_(x):
            return to_device(x, self.device)

        nodes = pose_graph.optimize_pose_graph(
            pose_graph.Sim3Nodes(t_(Riw), t_(tiw), t_(siw)),
            t_(np.asarray(ei, np.int32)), t_(np.asarray(ej, np.int32)),
            t_(np.stack(mR)), t_(np.stack(mt)), t_(np.asarray(ms, np.float32)),
            t_(np.ones(len(ei), bool)), t_(fixed), t_(np.ones(n, bool)),
            iters=15,
        )
        R_new, t_new, s_new = fetch(nodes.R, nodes.t, nodes.s)

        # correct map points using their reference keyframe's old/new Sim3
        old_R = st.kf_pose_cw[slots][:, :3, :3].copy()
        old_t = st.kf_pose_cw[slots][:, :3, 3].copy()
        # stale-gauge guard bookkeeping: remember each slot's
        # pre-correction pose (+ the per-node correction scale) so client
        # pushes created before this correction round-tripped can be
        # re-expressed in the corrected frame at apply time
        # (sync/oplog.py; see MapStore.kf_corrected).  Snapshot the guard
        # state of any still-active PREVIOUS correction first: a rollback
        # must restore it, not wipe it — clearing wholesale lets the next
        # stale push apply verbatim and half-revert the earlier one.
        guard_snap = (
            st.kf_corrected[slots].copy(),
            st.kf_pre_corr_pose[slots].copy(),
            st.kf_post_corr_pose[slots].copy(),
            st.kf_corr_scale[slots].copy(),
            st.mp_corrected[mp_slots_snap].copy(),
            st.mp_pre_corr_pos[mp_slots_snap].copy(),
            st.mp_post_corr_pos[mp_slots_snap].copy(),
            st.gauge_epoch,
        )
        st.kf_pre_corr_pose[slots] = st.kf_pose_cw[slots]
        st.kf_corrected[slots] = True
        st.kf_corr_scale[slots] = s_new
        st.gauge_epoch += 1
        for m in st.alive_mp_slots():
            ref = int(st.mp_ref_kf[m])
            i = slot_of.get(ref)
            if i is None:
                ob = st.obs.get(int(m), {})
                if not ob:
                    continue
                i = slot_of.get(next(iter(ob)))
                if i is None:
                    continue
            # p_cam = S_old_iw p ; p_new = S_new_iw^-1 p_cam
            st.mp_pre_corr_pos[m] = st.mp_pos[m]
            st.mp_corrected[m] = True
            pc = old_R[i] @ st.mp_pos[m] + old_t[i]
            p_new = (R_new[i].T @ (pc - t_new[i])) / s_new[i]
            st.set_mp_pos(m, p_new.astype(np.float32))
            st.mp_post_corr_pos[m] = st.mp_pos[m]
        # write back SE3 poses: T = [R | t/s]
        for i, kk in enumerate(slots):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_new[i]
            T[:3, 3] = t_new[i] / s_new[i]
            st.set_kf_pose(int(kk), T)
            st.kf_post_corr_pose[kk] = T
        # self-check over the UNCHANGED observation set: a sound
        # correction moves poses and points together, roughly preserving
        # reprojection; a wrong loop Sim3 / diverged essential graph
        # shears them apart.  Roll back atomically rather than let the
        # follow-up GBA converge the whole replica onto the warp.
        cost_after = self.map_reproj_cost()
        if cost_after > 2.0 * cost_before + 0.5:
            _log.warning(
                "loop correction REJECTED: map %d kf %d <-> kf %d would "
                "raise mean reprojection chi2 %.2f -> %.2f — rolling back",
                st.map_id, k, loop_kf, cost_before, cost_after)
            for i, kk in enumerate(slots):
                st.set_kf_pose(int(kk), pose_snap[i])
            for m, p in zip(mp_slots_snap, mp_pos_snap):
                st.set_mp_pos(int(m), p)
            (st.kf_corrected[slots], st.kf_pre_corr_pose[slots],
             st.kf_post_corr_pose[slots], st.kf_corr_scale[slots],
             st.mp_corrected[mp_slots_snap],
             st.mp_pre_corr_pos[mp_slots_snap],
             st.mp_post_corr_pos[mp_slots_snap],
             st.gauge_epoch) = guard_snap
            return False
        _log.info("loop correction accepted: mean reprojection chi2 "
                  "%.2f -> %.2f", cost_before, cost_after)
        st.add_loop_edge(k, loop_kf)
        # replace the current KF's matched points with the loop points
        # (reference: the mvpCurrentMatchedPoints loop in CorrectLoop)
        if mp_pairs is not None:
            mp_cur, mp_loop = mp_pairs
            for a, b2 in zip(mp_cur, mp_loop):
                a, b2 = int(a), int(b2)
                if a != b2 and st.mp_alive[a] and st.mp_alive[b2]:
                    st.replace_mp(a, b2)
        self.n_fused += self.search_and_fuse(k, loop_kf)
        _log.info("loop closed: map %d kf %d <-> kf %d (scale %.3f, "
                  "%d graph nodes)", self.store.map_id, k, loop_kf, s,
                  len(slots))

        if self.run_global_ba:
            self.global_ba()
        return True

    # ------------------------------------------------------------------
    def search_and_fuse(self, k: int, loop_kf: int, window_th: float = 4.0,
                        max_targets: int = 16, cand_bucket: int = 2048) -> int:
        """Project the loop side's map points into the current KF's
        corrected neighborhood and fuse duplicates — the corrected point
        is REPLACED by the loop point (reference: LoopClosing::SearchAndFuse,
        LoopClosing.cc:552-576; loop point set :330-340)."""
        st = self.store
        loop_side = [loop_kf] + st.covisible_kfs(loop_kf, 10)
        rows = st.kf_kp_mp[np.asarray(loop_side, np.int32)]
        flat = rows[rows != NO_MP]
        uniq = np.unique(flat)
        uniq = uniq[st.mp_alive[uniq]]
        # own-origin only: replacing own points with foreign-fused
        # duplicates injects the OTHER map's gauge into this replica
        # (see compute_sim3_between own_origin_only)
        from .. import MAP_BASE

        uniq = uniq[(st.mp_gid[uniq] // MAP_BASE) == st.map_id]
        targets = [k] + st.covisible_kfs(k, max_targets - 1)
        if not len(uniq) or not targets:
            return 0
        slots = uniq[:cand_bucket].astype(np.int32)
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
        nb = min(len(targets), B)
        for bi, tk in enumerate(targets[:B]):
            kf_Tcw[bi] = st.kf_pose_cw[tk]
            kf_K[bi] = st.kf_K[tk]
            kf_uv[bi] = st.kf_kp_uv[tk]
            kf_oct[bi] = st.kf_kp_octave[tk]
            kf_valid[bi] = st.kf_kp_valid[tk]
            kf_desc[bi] = st.kf_desc[tk]
            kf_ok[bi] = True
        hw = st.kf_hw[k]
        idx_b, valid_b = fetch(_fuse_body(
            *(to_device(x, self.device) for x in (
                mp_pos, mp_desc, mp_maxd, mp_ok,
                kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok)),
            float(hw[0]), float(hw[1]), self.scale_factor, self.n_levels,
            window_th,
        ))
        fused = 0
        for bi, tk in enumerate(targets[:nb]):
            for qi in np.where(valid_b[bi])[0]:
                if qi >= n:
                    continue
                mp_loop = int(slots[qi])
                if not st.mp_alive[mp_loop]:
                    continue
                kp = int(idx_b[bi, qi])
                mp_old = int(st.kf_kp_mp[tk, kp])
                if mp_old != NO_MP and st.mp_alive[mp_old]:
                    if mp_old == mp_loop:
                        continue
                    st.replace_mp(mp_old, mp_loop)  # pRep->Replace(loopMP)
                else:
                    st.add_observation(mp_loop, tk, kp)
                fused += 1
        if fused:
            _log.info("SearchAndFuse: %d loop-point fusions across %d keyframes",
                      fused, nb)
        return fused

    # ------------------------------------------------------------------
    def global_ba(self, iters: int = 10, should_abort=None, chunk: int = 4,
                  soft_abort: bool = False):
        """Full-map BA (reference: RunGlobalBundleAdjustment, 10 LM
        iterations per server pass, MediatorScheduler.cc:122).

        `should_abort()` is the mbStopGBA analogue (LoopClosing.cc
        RunGlobalBundleAdjustment): it is polled between LM chunks, and —
        like the reference, which only applies GBA results after an
        uninterrupted run — an aborted GBA discards all progress and
        leaves the map untouched.

        Safe to run on a background thread (the reference's detached
        std::thread, LoopClosing.cc:602): problem assembly and the final
        apply hold store.lock; the LM chunks in between run unlocked, and
        a map that grew mid-run (concurrent push) discards the stale
        result — the next pass redoes it on the fresher map.

        Returns the number of LM iterations applied to the map (0 when
        the pass was skipped, aborted or discarded).  The LM chunks run
        on the loop closer's device on the calling thread's current
        stream; a mesh of more than one device raises (item 17)."""
        require_one_device(self.mesh)
        st = self.store
        if iters <= 0:
            return 0
        with st.lock:
            kfs = st.alive_kf_slots()
            mps = st.alive_mp_slots()
            if len(kfs) < 3 or len(mps) < 50:
                return 0
            n_kf0, n_mp0 = st.n_kf, st.n_mp
            cam_lut = np.full(st.n_kf, -1, np.int32)
            cam_lut[kfs] = np.arange(len(kfs), dtype=np.int32)
            pt_lut = np.full(st.n_mp, -1, np.int32)
            pt_lut[mps] = np.arange(len(mps), dtype=np.int32)
            om, okf, okp = st.obs_arrays()
            sel = (pt_lut[om] >= 0) & (cam_lut[okf] >= 0)
            sel_kf, sel_kp = okf[sel], okp[sel]
            obs_cam = cam_lut[sel_kf]
            obs_pt = pt_lut[om[sel]]
            obs_uv = st.kf_kp_uv[sel_kf, sel_kp]
            obs_is2 = (1.0 / self.scale_factor
                       ** (2.0 * st.kf_kp_octave[sel_kf, sel_kp]))
            if len(obs_cam) < 100:
                return 0
            fixed = np.zeros(len(kfs), bool)
            fixed[0] = True
            prob = ba_ops.build_padded_problem(
                st.kf_pose_cw[kfs], st.kf_K[kfs], fixed,
                st.mp_pos[mps], obs_cam, obs_pt, obs_uv, obs_is2,
                device=self.device,
            )
            # gauge snapshot for the post-GBA scale projection (below)
            T_pre = st.kf_pose_cw[kfs].astype(np.float64)
            c_pre = -np.einsum("kij,kj->ki",
                               T_pre[:, :3, :3].transpose(0, 2, 1),
                               T_pre[:, :3, 3])
        res = None
        done = 0
        first = True
        while done < iters:
            if soft_abort and done == 0:
                pass  # the first chunk ALWAYS runs: soft-abort callers
                # (per-push scheduler GBA) need guaranteed forward
                # progress — at production push rates a newer push is
                # ALWAYS pending and a pre-chunk abort would starve GBA
                # to 0 iterations forever
            elif should_abort is not None and should_abort():
                # soft abort (per-push scheduler GBA): a newer pending
                # push caps the latency of THIS pass, but completed LM
                # chunks are a valid improved map state — apply them
                # instead of discarding, so GBA makes monotonic progress
                # even when pushes always outpace the full 10 iterations.
                # Hard abort (loop-closing mbStopGBA) still discards.
                if soft_abort and done > 0:
                    _log.info("GBA yielding after %d/%d iterations "
                              "(new request) — applying partial result",
                              done, iters)
                    break
                _log.info("GBA aborted after %d/%d iterations (new request)",
                          done, iters)
                return 0
            step = min(chunk, iters - done)
            a = (step + 1) // 2 if first else 0  # prune phase once, up front
            res = ba_ops.bundle_adjust(prob, iters_a=a, iters_b=step - a,
                                       mode="cg", cg_iters=32)
            prob = prob._replace(Tcw=res.Tcw, pts=res.pts)
            done += step
            first = False
        Tn, pn = fetch(res.Tcw, res.pts)
        # Monocular gauge projection.  With ONE fixed camera the
        # similarity gauge leaves exactly one null direction: scale
        # about the anchor's center (reprojection is invariant to it).
        # The reference runs GlobalBundleAdjustment once per loop event
        # (LoopClosing.cc:602) so a little wander along that direction
        # never matters; THIS architecture re-runs GBA on every push
        # (MediatorScheduler.cc:122) and distributes the result back to
        # the tracker, so per-pass wander compounds through the
        # push->GBA->distribute feedback into exponential scale drift
        # (observed: 13x contraction over 40 circuit frames, killing
        # loop closure).  Project the drift out: rescale the solution
        # about the anchor so the camera-center spread is preserved.
        Tn, pn = _project_scale_gauge(Tn, pn, c_pre, len(kfs), len(mps))
        with st.lock:
            if (not soft_abort and should_abort is not None
                    and should_abort()):
                _log.info("GBA aborted before apply (new request)")
                return 0
            if st.n_kf != n_kf0 or st.n_mp != n_mp0:
                _log.info("GBA discarded: map grew during the run "
                          "(%d->%d KFs)", n_kf0, st.n_kf)
                return 0
            for i, kk in enumerate(kfs):
                if not fixed[i]:
                    st.set_kf_pose(int(kk), Tn[i])
            for i, m in enumerate(mps):
                st.set_mp_pos(int(m), pn[i])
        return done
