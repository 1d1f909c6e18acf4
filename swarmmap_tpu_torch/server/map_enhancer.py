"""MBP map backbone: virtual keyframe synthesis + score-based compression.

Reference spec: MapEnhancer (/root/reference/code/src/MapEnhancer.cc) —
GetVirtualKeyFrame picks the adjacent keyframe pair with minimum
(score / distance), synthesizes a keyframe at the midpoint pose by
projecting the reference pair's map points into the virtual camera
(frustum / distance / viewing-angle tests) and cloning descriptors from
existing observations (GenerateKeyFrame, :20-150); Compress flags the
bottom-20%-scored keyframes and points bad (:236-272 — note the reference
ships with compression disabled by an early return at :249, mirrored here
with enabled=False by default).

Copy of swarmmap_tpu/server/map_enhancer.py over the port's map store and
trajectory helpers, which the port cannot import on a machine without JAX.
It runs on the host only, in numpy.
"""
from __future__ import annotations

import numpy as np

from ..core.map_store import NO_MP, MapStore
from ..utils.logging import get_logger
from ..utils.trajectory import rot_to_quat, quat_to_rot
from .landmark_scoring import LandmarkScoring

_log = get_logger("enhancer")

VIRTUAL_GID_BASE = 500_000  # virtual KFs claim ids above this offset


class MapEnhancer:
    def __init__(self, store: MapStore, scoring: LandmarkScoring,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 compression_enabled: bool = False):
        self.store = store
        self.scoring = scoring
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.compression_enabled = compression_enabled
        self._next_virtual = 0

    # ------------------------------------------------------------------
    def get_virtual_keyframe(self, new_kf_slots: list[int],
                             merged_only: bool = True) -> int | None:
        """Pick the weakest adjacent pair among the new keyframes and
        synthesize a midpoint keyframe (MediatorScheduler.cc:110-114)."""
        st = self.store
        if merged_only and st.group_id == st.map_id and float(st.Twl_s) == 1.0:
            # only enrich maps that joined a group (reference behavior)
            if np.allclose(st.Twl_R, np.eye(3)):
                return None
        kfs = [k for k in new_kf_slots if st.kf_alive[k] and st.kf_genuine[k]]
        if len(kfs) < 2:
            return None
        if not self.scoring.kf_scores:
            self.scoring.rank()
        best_pair, best_val = None, np.inf
        for a, b in zip(kfs[:-1], kfs[1:]):
            d = float(np.linalg.norm(st.kf_center(a) - st.kf_center(b)))
            if d < 1e-6:
                continue
            sc = (self.scoring.kf_scores.get(a, 0.0)
                  + self.scoring.kf_scores.get(b, 0.0)) / 2.0
            val = sc / d
            if val < best_val:
                best_val, best_pair = val, (a, b)
        if best_pair is None:
            return None
        a, b = best_pair
        Tmid = self._midpoint_pose(st.kf_pose_cw[a], st.kf_pose_cw[b])
        return self.generate_keyframe(Tmid, ref_kf=a, identical=False)

    @staticmethod
    def _midpoint_pose(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
        qa, qb = rot_to_quat(Ta[:3, :3]), rot_to_quat(Tb[:3, :3])
        if np.dot(qa, qb) < 0:
            qb = -qb
        q = qa + qb
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = quat_to_rot(q / np.linalg.norm(q))
        T[:3, 3] = 0.5 * (Ta[:3, 3] + Tb[:3, 3])
        return T

    # ------------------------------------------------------------------
    def generate_keyframe(self, Tcw: np.ndarray, ref_kf: int,
                          identical: bool = False) -> int | None:
        """Synthesize a keyframe at pose Tcw from the points visible to
        ref_kf and its neighbors (reference: MapEnhancer::GenerateKeyFrame;
        `identical=True` regenerates at the ref pose — the reference's
        self-test mode, MapEnhancer.cc:19-20)."""
        st = self.store
        if identical:
            Tcw = st.kf_pose_cw[ref_kf].copy()
        K = st.kf_K[ref_kf]
        hw = st.kf_hw[ref_kf]
        h, w = int(hw[0]), int(hw[1])
        # candidate points: ref + neighbors
        cand: set[int] = set()
        for k in [ref_kf] + st.covisible_kfs(ref_kf, 10):
            for m in st.kf_kp_mp[k]:
                if m != NO_MP and st.mp_alive[m]:
                    cand.add(int(m))
        if len(cand) < 20:
            return None
        slots = np.asarray(sorted(cand), np.int32)
        pc = st.mp_pos[slots] @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        uv = np.stack(
            [K[0, 0] * pc[:, 0] / np.maximum(z, 1e-9) + K[0, 2],
             K[1, 1] * pc[:, 1] / np.maximum(z, 1e-9) + K[1, 2]], 1,
        )
        center = -Tcw[:3, :3].T @ Tcw[:3, 3]
        dist = np.linalg.norm(st.mp_pos[slots] - center, axis=1)
        rays = (st.mp_pos[slots] - center) / np.maximum(dist[:, None], 1e-9)
        view_cos = np.einsum("mi,mi->m", rays, st.mp_normal[slots])
        ok = (
            (z > 0.05)
            & (uv[:, 0] >= 16) & (uv[:, 0] < w - 16)
            & (uv[:, 1] >= 16) & (uv[:, 1] < h - 16)
            & (dist >= 0.8 * st.mp_min_dist[slots])
            & (dist <= 1.2 * st.mp_max_dist[slots])
            & (view_cos > 0.5)
        )
        sel = np.where(ok)[0][: st.n_kp]
        if len(sel) < 20:
            return None
        # clone keypoint attributes from each point's best observation
        n = st.n_kp
        kp_uv = np.zeros((n, 2), np.float32)
        kp_oct = np.zeros(n, np.int32)
        kp_ang = np.zeros(n, np.float32)
        kp_resp = np.zeros(n, np.float32)
        kp_valid = np.zeros(n, bool)
        desc = np.zeros((n, 8), np.uint32)
        for out_i, ci in enumerate(sel):
            m = int(slots[ci])
            ob = st.obs.get(m, {})
            if not ob:
                continue
            k0, kp0 = next(iter(ob.items()))
            kp_uv[out_i] = uv[ci]
            ratio = dist[ci] / max(float(st.mp_min_dist[m]), 1e-9)
            lvl = int(np.clip(np.ceil(np.log(max(ratio, 1e-9)) / np.log(self.scale_factor)),
                              0, self.n_levels - 1))
            kp_oct[out_i] = lvl
            kp_ang[out_i] = st.kf_kp_angle[k0, kp0]
            kp_resp[out_i] = st.kf_kp_response[k0, kp0]
            kp_valid[out_i] = True
            desc[out_i] = st.mp_desc[m]
        gid = (st.map_id * 1_000_000 + VIRTUAL_GID_BASE + self._next_virtual)
        self._next_virtual += 1
        k_new = st.add_keyframe(
            pose_cw=Tcw.astype(np.float32), K=K, kp_uv=kp_uv, kp_octave=kp_oct,
            kp_angle=kp_ang, kp_response=kp_resp, kp_valid=kp_valid, desc=desc,
            ts=float(st.kf_ts[ref_kf]), frame_id=-1, gid=gid, genuine=False,
            hw=(h, w),
        )
        for out_i, ci in enumerate(sel):
            st.add_observation(int(slots[ci]), k_new, out_i)
        st.update_connections(k_new)
        _log.info("synthesized virtual keyframe %d with %d points", k_new, len(sel))
        return k_new

    # ------------------------------------------------------------------
    def compress(self, fraction: float = 0.2) -> int:
        """Flag the bottom-`fraction` scored KFs and MPs bad
        (reference: MapEnhancer::Compress — shipped disabled, :249)."""
        if not self.compression_enabled:
            return 0  # parity with the reference's early return
        st = self.store
        scores = self.scoring.rank()
        slots = st.alive_mp_slots()
        removed = 0
        if len(slots) > 50:
            th = np.quantile(scores, fraction)
            for m in slots[scores < th]:
                st.set_mp_bad(int(m))
                removed += 1
        kf_items = sorted(self.scoring.kf_scores.items(), key=lambda kv: kv[1])
        n_cut = int(fraction * len(kf_items))
        for k, _ in kf_items[:n_cut]:
            if k != 0 and st.kf_alive[k]:
                st.set_kf_bad(k)
                removed += 1
        return removed
