"""Map groups + cross-map merging.

Reference spec: MapManager (/root/reference/code/src/MapManager.cc) —
static group registry, MergeMap Sim3 group algebra on each map's
local->world transform, cross-map point fusion (ORBmatcher::Fuse with
global poses + MapPoint::Replace), post-fusion keyframe culling, global
trajectory export.

Port of swarmmap_tpu/server/map_manager.py: the group algebra and the
store mutations are copied line for line; the fuse match, the group
transform refinement and the joint group BA (CG) run on the manager's
device.  A device mesh with more than one device raises (item 17).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import MAP_BASE
from ..core.local_mapping import _fuse_body
from ..core.map_store import NO_MP, MapStore
from ..utils.device import default_device, fetch, require_one_device, to_device
from ..utils.logging import get_logger
from ..utils.padding import pad_slots
from ..utils.trajectory import save_tum

_log = get_logger("mapmanager")


class MapManager:
    """Registry of all server-side map replicas + group algebra."""

    def __init__(self, device: torch.device | str | None = None):
        """`device` runs the device programs; by default the card
        (`utils.device.default_device`).  Tests pass device="cpu"."""
        self.device = torch.device(default_device() if device is None else device)
        self.stores: dict[int, MapStore] = {}   # map_id -> replica
        self.groups: dict[int, set[int]] = {}   # group_id -> {map_id}
        self.fuse_events: list[tuple[int, int, int]] = []  # (dst, src, n_fused)

    def register(self, store: MapStore):
        self.stores[store.map_id] = store
        self.groups.setdefault(store.group_id, set()).add(store.map_id)

    def group_of(self, map_id: int) -> set[int]:
        st = self.stores[map_id]
        return self.groups.get(st.group_id, {map_id})

    # ------------------------------------------------------------------
    def merge(self, map1: int, map2: int, s12: float, R12: np.ndarray,
              t12: np.ndarray, fuse: bool = True,
              scale_factor: float = 1.2, n_levels: int = 8) -> bool:
        """Merge map2's group into map1's using S12 = Sim3 taking map2
        LOCAL coords into map1 LOCAL coords (reference: MapManager::MergeMap).

        Twl2_new = Twl1 * S12 ; every map in map2's old group is rebased
        by the same right-composition so relative alignment is kept.
        After the group algebra, duplicate landmarks are fused and
        redundant keyframes culled (MapManager.cc:100, :118-209)."""
        st1, st2 = self.stores[map1], self.stores[map2]
        if st1.group_id == st2.group_id:
            return False
        # S(world<-2) = S(world<-1) composed with S(1<-2)
        R_new = st1.Twl_R @ R12
        t_new = st1.Twl_s * (st1.Twl_R @ t12) + st1.Twl_t
        s_new = float(st1.Twl_s) * s12
        # delta applied to all maps of group2:  Twl_m_new = D * Twl_m with
        # D = Twl2_new * Twl2_old^-1
        R2, t2, s2 = st2.Twl_R, st2.Twl_t, float(st2.Twl_s)
        Dr = R_new @ R2.T
        Ds = s_new / s2
        Dt = t_new - Ds * (Dr @ t2)
        g2 = sorted(self.groups.get(st2.group_id, {map2}))
        # dry-run the scale guard for every member FIRST so the group is
        # rebased atomically (a partial apply would leave it internally
        # misaligned and a later retry would compound the delta)
        for mid in g2:
            sm = self.stores[mid]
            if not sm.check_transform(Ds * float(sm.Twl_s)):
                _log.warning("merge rejected by scale guard on member map %d", mid)
                return False
        for mid in g2:
            sm = self.stores[mid]
            Rm = Dr @ sm.Twl_R
            tm = Ds * (Dr @ sm.Twl_t) + Dt
            ssm = Ds * float(sm.Twl_s)
            # exact: a rebase is group algebra, not a new estimate — a
            # blended apply would leave every member ~(1-blend) of the
            # delta away from the group frame
            sm.set_transform(Rm, tm, ssm, exact=True)
        # union groups: bigger group id wins membership (reference unions
        # by size; we union into group1)
        g1_id, g2_id = st1.group_id, st2.group_id
        members = self.groups.pop(g2_id, {map2})
        for mid in members:
            self.stores[mid].group_id = g1_id
        self.groups.setdefault(g1_id, set()).update(members)
        _log.info("merged map %d group into map %d group (scale %.3f)", map2, map1, s12)
        if fuse:
            n = self.fuse(map1, map2, scale_factor=scale_factor,
                          n_levels=n_levels)
            self.fuse_events.append((map1, map2, n))
            if n:
                self.keyframe_culling(map1)
        return True

    # ------------------------------------------------------------------
    def fuse(self, dst: int, src: int, window_th: float = 4.0,
             scale_factor: float = 1.2, n_levels: int = 8,
             kf_bucket: int = 32) -> int:
        """Cross-map duplicate fusion: project src's points into every dst
        keyframe through the shared group frame, REPLACE dst duplicates
        with the src point, and add observations where the keypoint was
        free (reference: MapManager::Fuse + ORBmatcher::Fuse +
        MapPoint::Replace, MapManager.cc:118-153).

        The src point is inserted into dst's store under its foreign gid
        (positions re-expressed in dst's LOCAL frame), so the dst replica
        — and, through the next distribute, the dst client — ends up
        sharing one landmark per physical feature.  Returns the number of
        fused matches (replacements + new cross-map observations)."""
        st_d, st_s = self.stores[dst], self.stores[src]
        if st_d.group_id != st_s.group_id:
            return 0
        src_slots = st_s.alive_mp_slots()
        dst_kfs = st_d.alive_kf_slots()
        if len(src_slots) == 0 or len(dst_kfs) == 0:
            return 0
        # src geometry re-expressed in dst's LOCAL frame:
        #   x_d = (1/s_d) R_d^T (x_w - t_d),  x_w = s_s R_s x_s + t_s
        pos_w = st_s.mp_global_pos(src_slots)
        Rl = st_d.Twl_R.T / st_d.Twl_s
        pos_d = (pos_w - st_d.Twl_t) @ Rl.T
        nrm_d = (st_s.mp_normal[src_slots] @ st_s.Twl_R.T) @ st_d.Twl_R
        s_rel = float(st_s.Twl_s) / float(st_d.Twl_s)
        maxd_d = st_s.mp_max_dist[src_slots] * s_rel
        mind_d = st_s.mp_min_dist[src_slots] * s_rel

        slots_p, slot_ok = pad_slots(np.asarray(src_slots, np.int32))
        nq = len(slots_p)
        pos_p = np.zeros((nq, 3), np.float32)
        pos_p[: len(pos_d)] = pos_d
        desc_p = np.zeros((nq, 8), np.uint32)
        desc_p[: len(src_slots)] = st_s.mp_desc[src_slots]
        maxd_p = np.ones(nq, np.float32)
        maxd_p[: len(src_slots)] = maxd_d

        # -- pass 1: MATCH ONLY (no mutation).  Collect duplicate pairs
        # first so the group transform can be POLISHED before any src
        # position is written into dst — inserting with the coarse merge
        # Sim3 and refining afterwards left every injected copy offset
        # by the refinement delta (observed ds up to 6%), which degraded
        # the dst client's tracking until the agent got lost.
        matches: list[tuple[int, int, int]] = []  # (qi, kf, kp)
        pair_p1: list[np.ndarray] = []  # dst duplicate position (dst-local)
        pair_p2: list[np.ndarray] = []  # src point position (dst-local)
        n_kp = st_d.n_kp
        hw = st_d.kf_hw[dst_kfs[0]]
        for lo in range(0, len(dst_kfs), kf_bucket):
            batch = dst_kfs[lo : lo + kf_bucket]
            B = kf_bucket
            kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
            kf_K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
            kf_uv = np.zeros((B, n_kp, 2), np.float32)
            kf_oct = np.zeros((B, n_kp), np.int32)
            kf_valid = np.zeros((B, n_kp), bool)
            kf_desc = np.zeros((B, n_kp, 8), np.uint32)
            kf_ok = np.zeros(B, bool)
            nb = len(batch)
            kf_Tcw[:nb] = st_d.kf_pose_cw[batch]
            kf_K[:nb] = st_d.kf_K[batch]
            kf_uv[:nb] = st_d.kf_kp_uv[batch]
            kf_oct[:nb] = st_d.kf_kp_octave[batch]
            kf_valid[:nb] = st_d.kf_kp_valid[batch]
            kf_desc[:nb] = st_d.kf_desc[batch]
            kf_ok[:nb] = True
            idx_b, valid_b = fetch(_fuse_body(
                *(to_device(x, self.device) for x in (
                    pos_p, desc_p, maxd_p, slot_ok,
                    kf_Tcw, kf_K, kf_uv, kf_oct, kf_valid, kf_desc, kf_ok)),
                float(hw[0]), float(hw[1]), scale_factor, n_levels, window_th,
            ))
            for bi, k in enumerate(batch):
                k = int(k)
                for qi in np.where(valid_b[bi])[0]:
                    if qi >= len(src_slots):
                        continue
                    kp = int(idx_b[bi, qi])
                    matches.append((int(qi), k, kp))
                    mp_old = int(st_d.kf_kp_mp[k, kp])
                    if mp_old != NO_MP and st_d.mp_alive[mp_old]:
                        pair_p1.append(st_d.mp_pos[mp_old].copy())
                        pair_p2.append(pos_d[qi])
        if not matches:
            return 0
        # -- polish src's Twl from the duplicate pairs, then recompute
        # the injected geometry under the refined transform
        self._refine_group_transform(st_d, st_s, pair_p1, pair_p2)
        pos_w = st_s.mp_global_pos(src_slots)
        Rl = st_d.Twl_R.T / st_d.Twl_s
        pos_d = (pos_w - st_d.Twl_t) @ Rl.T
        nrm_d = (st_s.mp_normal[src_slots] @ st_s.Twl_R.T) @ st_d.Twl_R
        s_rel = float(st_s.Twl_s) / float(st_d.Twl_s)
        maxd_d = st_s.mp_max_dist[src_slots] * s_rel
        mind_d = st_s.mp_min_dist[src_slots] * s_rel
        # -- pass 2: mutate with polished positions
        fused = 0
        for qi, k, kp in matches:
            m_new = self._ensure_foreign_point(
                st_d, st_s, int(src_slots[qi]), pos_d[qi], nrm_d[qi],
                float(mind_d[qi]), float(maxd_d[qi]),
            )
            if m_new is None:
                continue
            mp_old = int(st_d.kf_kp_mp[k, kp])
            if mp_old != NO_MP and st_d.mp_alive[mp_old]:
                if mp_old == m_new:
                    continue
                # dst's duplicate is replaced by the src point
                # (reference: pRep->Replace(otherMapPoints[i]))
                st_d.replace_mp(mp_old, m_new)
            else:
                st_d.add_observation(m_new, k, kp)
            if st_d.mp_ref_kf[m_new] < 0:
                st_d.mp_ref_kf[m_new] = k
            fused += 1
        if fused:
            for k in st_d.alive_kf_slots():
                st_d.update_connections(int(k), log=False)
            _log.info("fused %d cross-map matches: map %d <- map %d",
                      fused, dst, src)
        return fused

    def _refine_group_transform(self, st_d: MapStore, st_s: MapStore,
                                pair_p1: list, pair_p2: list,
                                min_pairs: int = 20) -> None:
        """Polish src's Twl from the duplicate pairs found by fuse — the
        EdgeSim3RelativeXYZ refinement (reference:
        Optimizer::OptimizeSim3ByMapPoint, Optimizer.cc:1660-1811)."""
        if len(pair_p1) < min_pairs:
            return
        from ..ops import sim3_opt

        p1 = np.stack(pair_p1).astype(np.float32)
        p2 = np.stack(pair_p2).astype(np.float32)
        # normalize by the median residual so the fixed chi2 gate means
        # "within ~3x the typical alignment error" at any scene scale
        sigma = float(np.median(np.linalg.norm(p1 - p2, axis=1))) or 1.0
        from ..utils.padding import bucket_size

        b = bucket_size(len(p1), 128)
        p1p = np.zeros((b, 3), np.float32)
        p2p = np.zeros((b, 3), np.float32)
        okp = np.zeros(b, bool)
        p1p[: len(p1)] = p1 / sigma
        p2p[: len(p2)] = p2 / sigma
        okp[: len(p1)] = True
        dev = self.device
        opt = sim3_opt.optimize_sim3_points(
            torch.tensor(1.0, dtype=torch.float32, device=dev),
            torch.eye(3, dtype=torch.float32, device=dev),
            torch.zeros(3, dtype=torch.float32, device=dev),
            to_device(p1p, dev), to_device(p2p, dev), to_device(okp, dev),
            chi2_th=9.0,
        )
        n_in, sc, Rc, tc = fetch(opt.n_inliers, opt.s, opt.R, opt.t)
        if int(n_in) < min_pairs:
            return
        sc = float(sc)
        Rc, tc = np.asarray(Rc), np.asarray(tc) * sigma  # un-normalize
        if not (0.8 <= sc <= 1.2):
            return
        # Twl_s_new = Twl_d o C o Twl_d^-1 o Twl_s  (C lives in dst-local)
        def compose(a, bb):
            Ra, ta, sa = a
            Rb, tb, sb = bb
            return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb

        Twl_d = (st_d.Twl_R, st_d.Twl_t, float(st_d.Twl_s))
        inv_d = (st_d.Twl_R.T, -(st_d.Twl_R.T @ st_d.Twl_t) / float(st_d.Twl_s),
                 1.0 / float(st_d.Twl_s))
        D = compose(compose(Twl_d, (Rc, tc, sc)), inv_d)
        Rn, tn, sn = compose(D, (st_s.Twl_R, st_s.Twl_t, float(st_s.Twl_s)))
        st_s.set_transform(Rn.astype(np.float32), tn.astype(np.float32), sn)
        ang = np.degrees(np.arccos(np.clip((np.trace(Rc) - 1) / 2, -1, 1)))
        _log.info("refined group transform of map %d: ds=%.4f |dt|=%.4f "
                  "dR=%.2fdeg (%d pairs)",
                  st_s.map_id, sc, float(np.linalg.norm(tc)), float(ang),
                  int(n_in))

    @staticmethod
    def _ensure_foreign_point(st_d: MapStore, st_s: MapStore, src_slot: int,
                              pos_d, normal_d, min_d: float, max_d: float):
        """Insert (or look up) st_s's point in st_d under its foreign gid."""
        gid = int(st_s.mp_gid[src_slot])
        m = st_d.mp_by_gid.get(gid)
        if m is not None:
            return m if st_d.mp_alive[m] else None
        m = st_d.add_map_point(
            pos=pos_d, desc=st_s.mp_desc[src_slot], ref_kf=-1, gid=gid,
            normal=normal_d, min_dist=min_d, max_dist=max_d,
            cam_velocity=float(st_s.mp_cam_velocity[src_slot]), log=False,
        )
        st_d.mp_visible[m] = st_s.mp_visible[src_slot]
        st_d.mp_found[m] = st_s.mp_found[src_slot]
        st_d.mp_created[m] = st_s.mp_created[src_slot]
        st_d.mp_last_tracked[m] = st_s.mp_last_tracked[src_slot]
        return m

    # ------------------------------------------------------------------
    def group_global_ba(self, gid: int, iters: int = 10,
                        mesh=None, chi2_cap: float = 25.0,
                        scale_factor: float = 1.2) -> bool:
        """JOINT bundle adjustment over every map in a merged group, in
        the shared world gauge (SURVEY.md §5: the server's joint BA over
        the device mesh; reference analogue: per-map GBA after MergeMap,
        MediatorScheduler.cc:122 — the rebuild goes further and couples
        the maps through their cross-map duplicate observations).

        Formulation: each keyframe becomes an effective world-frame SE3.
        With Twl = (s, R_wl, t_wl) local->world, the world->camera map is
        the Sim3 p_cam = (1/s)(R_g p_w + t_g), R_g = R_cw R_wl^T,
        t_g = s t_cw - R_g t_wl; projection is invariant to the uniform
        1/s, so BA optimizes (R_g, t_g) as plain SE3 + world points.
        Points enter once, under their OWNER map; observations of
        foreign duplicate copies retarget to the owner instance — that
        cross-map coupling is what the per-map GBA cannot express.

        Self-checking like correct_loop: the result applies only when the
        mean capped chi2 improved.  With a multi-device mesh the pass
        runs observation-sharded, which is not ported yet: it raises
        (item 17)."""
        from ..ops import ba as ba_ops

        require_one_device(mesh)

        members = sorted(self.groups.get(gid, ()))
        if len(members) < 2:
            return False
        stores = [self.stores[m] for m in members]
        import contextlib

        with contextlib.ExitStack() as stack:
            for st in stores:  # consistent order: members sorted
                stack.enter_context(st.lock)
            # -- world point table: own-origin live points per member
            pt_rows: dict[int, int] = {}   # point gid -> row
            pt_owner: list[tuple[MapStore, int]] = []
            pts_w = []
            for st in stores:
                own = np.where(
                    st.mp_alive[: st.n_mp]
                    & (st.mp_gid[: st.n_mp] // MAP_BASE == st.map_id))[0]
                gp = st.mp_global_pos(own)
                for i, m in enumerate(own):
                    pt_rows[int(st.mp_gid[m])] = len(pts_w)
                    pt_owner.append((st, int(m)))
                    pts_w.append(gp[i])
            if len(pts_w) < 100:
                return False
            # -- cameras: effective world-frame SE3 per live keyframe
            cam_rows: dict[tuple[int, int], int] = {}  # (map_id, slot) -> row
            cams = []
            Ks = []
            for st in stores:
                s = float(st.Twl_s)
                for k in st.alive_kf_slots():
                    G = st.kf_global_pose(int(k))
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :3] = G[:3, :3] * s
                    T[:3, 3] = G[:3, 3] * s
                    cam_rows[(st.map_id, int(k))] = len(cams)
                    cams.append(T)
                    Ks.append(st.kf_K[k])
            # -- observations: retarget foreign copies to the owner row
            obs_cam, obs_pt, obs_uv, obs_is2 = [], [], [], []
            for st in stores:
                om, okf, okp = st.obs_arrays()
                sel = st.mp_alive[om] & st.kf_alive[okf]
                om, okf, okp = om[sel], okf[sel], okp[sel]
                rows = np.array([pt_rows.get(int(g), -1)
                                 for g in st.mp_gid[om]], np.int64)
                keep = rows >= 0
                om, okf, okp, rows = om[keep], okf[keep], okp[keep], rows[keep]
                crow = np.array([cam_rows[(st.map_id, int(k))] for k in okf],
                                np.int64)
                obs_cam.append(crow)
                obs_pt.append(rows)
                obs_uv.append(st.kf_kp_uv[okf, okp])
                obs_is2.append(
                    1.0 / scale_factor ** (2.0 * st.kf_kp_octave[okf, okp]))
            obs_cam = np.concatenate(obs_cam)
            obs_pt = np.concatenate(obs_pt)
            obs_uv = np.concatenate(obs_uv).astype(np.float32)
            obs_is2 = np.concatenate(obs_is2).astype(np.float32)
            if len(obs_cam) < 500:
                return False
            # gauge: fix the reference map's first two keyframes (two
            # anchors pin the monocular scale, unlike a single one)
            fixed = np.zeros(len(cams), bool)
            ref = stores[0]
            ref_kfs = ref.alive_kf_slots()
            for k in ref_kfs[:2]:
                fixed[cam_rows[(ref.map_id, int(k))]] = True
            cams = np.stack(cams)
            pts_w = np.stack(pts_w).astype(np.float32)
            # before-cost (host): mean capped chi2 on the assembled obs
            pc = np.einsum("oij,oj->oi", cams[obs_cam][:, :3, :3],
                           pts_w[obs_pt]) + cams[obs_cam][:, :3, 3]
            Kn = np.stack(Ks).astype(np.float32)
            Ko = Kn[obs_cam]
            z = np.maximum(pc[:, 2], 1e-6)
            du = Ko[:, 0, 0] * pc[:, 0] / z + Ko[:, 0, 2] - obs_uv[:, 0]
            dv = Ko[:, 1, 1] * pc[:, 1] / z + Ko[:, 1, 2] - obs_uv[:, 1]
            chi2_0 = (du * du + dv * dv) * obs_is2
            chi2_0 = np.where(pc[:, 2] > 0, chi2_0, chi2_cap)
            cost_before = float(np.minimum(chi2_0, chi2_cap).mean())

            prob = ba_ops.build_padded_problem(
                cams, Kn, fixed, pts_w, obs_cam, obs_pt, obs_uv, obs_is2,
                device=self.device)
            a = (iters + 1) // 2
            res = ba_ops.bundle_adjust(
                prob, iters_a=a, iters_b=iters - a, mode="cg", cg_iters=32)
            Tn, pn, chi2_n = fetch(res.Tcw, res.pts, res.obs_chi2)
            nO = len(obs_cam)
            cost_after = float(np.minimum(chi2_n[:nO], chi2_cap).mean())
            if cost_after >= cost_before:
                _log.info("group %d joint GBA discarded: chi2 %.2f -> %.2f",
                          gid, cost_before, cost_after)
                return False
            # -- write back: world SE3 -> local poses through each Twl
            for (map_id, k), row in cam_rows.items():
                if fixed[row]:
                    continue
                st = self.stores[map_id]
                s = float(st.Twl_s)
                R_g, t_g = Tn[row, :3, :3], Tn[row, :3, 3]
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = R_g @ st.Twl_R
                T[:3, 3] = (t_g + R_g @ st.Twl_t) / s
                st.set_kf_pose(int(k), T)
            # owner points: world -> owner-local
            for row, (st, m) in enumerate(pt_owner):
                s = float(st.Twl_s)
                p_l = (st.Twl_R.T @ (pn[row] - st.Twl_t)) / s
                st.set_mp_pos(int(m), p_l.astype(np.float32))
            # foreign duplicate copies follow their owner's new position
            for st in stores:
                foreign = np.where(
                    st.mp_alive[: st.n_mp]
                    & (st.mp_gid[: st.n_mp] // MAP_BASE != st.map_id))[0]
                s = float(st.Twl_s)
                for m in foreign:
                    row = pt_rows.get(int(st.mp_gid[m]))
                    if row is None:
                        continue
                    p_l = (st.Twl_R.T @ (pn[row] - st.Twl_t)) / s
                    st.set_mp_pos(int(m), p_l.astype(np.float32))
            _log.info("group %d joint GBA over %d maps: %d cams, %d pts, "
                      "%d obs — chi2 %.2f -> %.2f",
                      gid, len(members), len(cams), len(pts_w), nO,
                      cost_before, cost_after)
            return True

    # ------------------------------------------------------------------
    def polish_group_transforms(self, sweeps: int = 2,
                                min_pairs: int = 30) -> None:
        """Tighten every group's inter-map gauge from LIVE duplicate
        pairs: each foreign copy (gid // MAP_BASE != host map) and its
        owner's instance are the same physical landmark, so their GLOBAL
        positions should coincide; any residual is Twl misalignment.
        One Umeyama Sim3 fit per non-reference map per sweep
        (Gauss-Seidel over the group, reference = lowest map id).

        The merge-time refinement only sees the pairs found during that
        fuse; this polish runs over the full current pair set after BA
        has settled, so it is the natural finish/periodic pass
        (EdgeSim3RelativeXYZ over live pairs, Optimizer.cc:1660)."""
        from ..utils.trajectory import umeyama_align

        for gid, members in self.groups.items():
            if len(members) < 2:
                continue
            order = sorted(members)
            ref = order[0]
            for _ in range(sweeps):
                for mid in order:
                    if mid == ref:
                        continue
                    st_m = self.stores[mid]
                    own_g, other_g = [], []
                    # pairs: m's OWN points that exist as foreign copies
                    # in any other member store
                    for did in order:
                        if did == mid:
                            continue
                        st_d = self.stores[did]
                        fm = np.where(
                            st_d.mp_alive[: st_d.n_mp]
                            & (st_d.mp_gid[: st_d.n_mp] // MAP_BASE == mid)
                        )[0]
                        if len(fm) == 0:
                            continue
                        gids = st_d.mp_gid[fm]
                        own = np.array(
                            [st_m.mp_by_gid.get(int(g), -1) for g in gids],
                            np.int64)
                        ok = own >= 0
                        ok[ok] &= st_m.mp_alive[own[ok]]
                        if not ok.any():
                            continue
                        own_g.append(st_m.mp_global_pos(own[ok]))
                        other_g.append(st_d.mp_global_pos(fm[ok]))
                    if not own_g:
                        continue
                    a = np.concatenate(own_g)
                    b = np.concatenate(other_g)
                    if len(a) < min_pairs:
                        continue
                    # robust trim: drop the worst 20% pairs (mismatched
                    # fusions) before the final fit
                    s, R, t = umeyama_align(a, b)
                    res = np.linalg.norm(a @ (s * R).T + t - b, axis=1)
                    keep = res <= np.quantile(res, 0.8)
                    if keep.sum() < min_pairs:
                        continue
                    s, R, t = umeyama_align(a[keep], b[keep])
                    if not (0.9 <= s <= 1.1):
                        continue  # a gross fit means bad pairs, not gauge
                    # G maps m's current global frame closer to the
                    # consensus: Twl_m_new = G o Twl_m
                    Rn = (R @ st_m.Twl_R).astype(np.float32)
                    tn = (s * (R @ st_m.Twl_t) + t).astype(np.float32)
                    sn = float(s * st_m.Twl_s)
                    st_m.set_transform(Rn, tn, sn, exact=True)
            _log.info("polished group %d transforms over %d maps",
                      gid, len(order))

    # ------------------------------------------------------------------
    def keyframe_culling(self, map_id: int, redundancy: float = 0.85):
        """Post-fusion culling (reference: MapManager::KeyFrameCulling,
        >=85% redundant observations)."""
        st = self.stores[map_id]
        cands = [k for k in st.alive_kf_slots() if k != 0 and st.kf_genuine[k]]
        total, red = st.redundancy_counts(cands)
        for k, t, r in zip(cands, total, red):
            if t > 10 and r > redundancy * t:
                st.set_kf_bad(k)

    # ------------------------------------------------------------------
    def save_global_trajectories(self, out_dir, prefix: str = "map-group"):
        """Per-group TUM trajectories in global coordinates
        (reference: MapManager::SaveGlobalMap, MapManager.cc:253-295)."""
        from pathlib import Path

        for gid, members in self.groups.items():
            stamps, poses = [], []
            for mid in sorted(members):
                st = self.stores[mid]
                for k in st.alive_kf_slots():
                    # only genuine, owned keyframes: synthesized (MBP
                    # virtual) cameras are map-enhancement artifacts, and
                    # foreign fused replicas would duplicate their owner's
                    # entry at a stale pose
                    if not st.kf_genuine[k]:
                        continue
                    if int(st.kf_gid[k]) // MAP_BASE != mid:
                        continue
                    stamps.append(st.kf_ts[k])
                    poses.append(np.linalg.inv(st.kf_global_pose(k)))
            if poses:
                order = np.argsort(stamps)
                save_tum(
                    Path(out_dir) / f"{prefix}-{gid}.txt",
                    np.asarray(stamps)[order], np.stack(poses)[order],
                )
