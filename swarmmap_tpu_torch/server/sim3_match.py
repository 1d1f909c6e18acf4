"""Shared Sim3 computation between two keyframes (same or different maps).

Reference spec: the ComputeSim3 pipeline used by both the loop closer
(/root/reference/code/src/LoopClosing.cc:210-370) and the cross-agent
mediator (src/AgentMediator.cc:204-382):

  SearchByBoW >= 20 map-point matches
    -> Sim3Solver RANSAC (per-octave chi2 gates)
    -> SearchBySim3 guided-match enrichment (ORBmatcher.cc:1011)
    -> OptimizeSim3 over the ENRICHED correspondence set
    -> accept at >= min_inliers (20 for loops, 40 for merges).

The reference grows ~20 BoW matches into 40+ guided matches before
judging, which is what makes the 40-inlier merge gate reachable.

Port of swarmmap_tpu/server/sim3_match.py: the host bookkeeping is copied
line for line, the device programs (BoW match, RANSAC, guided match,
OptimizeSim3) run on the device of the caller's generator, and the RANSAC
draws come from that generator (`sim3.ransac_sim3_draws`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.map_store import NO_MP, MapStore
from ..ops import matching, sim3 as sim3_ops, sim3_opt
from ..utils.device import fetch, to_device
from ..utils.logging import get_logger
from ..utils.padding import bucket_size, pad_rows

_log = get_logger("sim3_match")


def _project_into_neighbors(
    st: MapStore, k: int, mps: np.ndarray, pts_cam: np.ndarray,
    scale_factor: float, max_neighbors: int = 10,
) -> tuple[int, int]:
    """Project candidate 3-D points (given in keyframe k's camera frame)
    into k's covisible neighbor keyframes and score them against the
    neighbors' OWN observations of the matched map points `mps`.

    Returns (n_inliers, n_checked) pooled over all neighbors; an
    observation counts as checked when the neighbor actually observes
    the matched point and the candidate lands in front of its camera.
    """
    # candidate points in the map's local/world frame
    T = st.kf_pose_cw[k]
    pw = (pts_cam - T[:3, 3]) @ T[:3, :3]  # R^T (p - t)
    n_in = n_ck = 0
    for kn in st.covisible_kfs(k, n=max_neighbors):
        if kn == k or not st.kf_alive[kn]:
            continue
        row = st.kf_kp_mp[kn]
        vk = st.kf_kp_valid[kn] & (row != NO_MP)
        if not vk.any():
            continue
        # inverse index: mp slot -> kp index in this neighbor
        idx_of = np.full(st.n_mp, -1, np.int64)
        kp_idx = np.where(vk)[0]
        idx_of[row[kp_idx]] = kp_idx
        safe = np.clip(mps, 0, st.n_mp - 1)
        j = np.where(mps < st.n_mp, idx_of[safe], -1)
        seen = j >= 0
        if not seen.any():
            continue
        Tn = st.kf_pose_cw[kn]
        pc = pw[seen] @ Tn[:3, :3].T + Tn[:3, 3]
        front = pc[:, 2] > 1e-3
        if not front.any():
            continue
        K = st.kf_K[kn]
        u = K[0, 0] * pc[front, 0] / pc[front, 2] + K[0, 2]
        v = K[1, 1] * pc[front, 1] / pc[front, 2] + K[1, 2]
        kp = j[seen][front]
        uv_obs = st.kf_kp_uv[kn][kp]
        err2 = (u - uv_obs[:, 0]) ** 2 + (v - uv_obs[:, 1]) ** 2
        sig2 = scale_factor ** (2.0 * st.kf_kp_octave[kn][kp])
        n_ck += int(front.sum())
        n_in += int((err2 <= 5.99 * sig2).sum())
    return n_in, n_ck


def _neighbor_verify(
    st1: MapStore, k1: int, st2: MapStore, k2: int,
    s: float, R: np.ndarray, t: np.ndarray,
    mp1: np.ndarray, mp2: np.ndarray, scale_factor: float,
    min_checked: int = 10, min_ratio: float = 0.35,
) -> tuple[bool, float, int]:
    """Multi-view acceptance check for a candidate Sim3 S12.

    The matched points of map 2 are carried through S12 into keyframe
    k1's camera frame and re-projected into k1's covisible neighbors
    (and symmetrically map-1 points through S12^-1 into k2's
    neighbors).  The neighbors' genuinely different viewpoints break
    the scale/translation degeneracy of the single-pair symmetric
    reprojection test: a wrong scale that slides points radially past
    k1/k2 lands tens of pixels off everywhere else.

    Passes when too few neighbor observations exist to judge
    (n_checked < min_checked) — the single-pair gates remain the only
    evidence then, as in the reference.
    """
    # map-2 points -> k2 camera frame -> S12 -> k1 camera frame
    T2 = st2.kf_pose_cw[k2]
    pc2 = st2.mp_pos[mp2] @ T2[:3, :3].T + T2[:3, 3]
    p_in_1 = s * (pc2 @ R.T) + t
    n_in1, n_ck1 = _project_into_neighbors(
        st1, k1, mp1, p_in_1, scale_factor)
    # map-1 points -> k1 camera frame -> S12^-1 -> k2 camera frame
    T1 = st1.kf_pose_cw[k1]
    pc1 = st1.mp_pos[mp1] @ T1[:3, :3].T + T1[:3, 3]
    p_in_2 = ((pc1 - t) / s) @ R
    n_in2, n_ck2 = _project_into_neighbors(
        st2, k2, mp2, p_in_2, scale_factor)
    n_in, n_ck = n_in1 + n_in2, n_ck1 + n_ck2
    if n_ck < min_checked:
        return True, 1.0, n_ck
    ratio = n_in / n_ck
    return ratio >= min_ratio, ratio, n_ck


def _cam_frame_points(st: MapStore, k: int, mps: np.ndarray) -> np.ndarray:
    T = st.kf_pose_cw[k]
    return st.mp_pos[mps] @ T[:3, :3].T + T[:3, 3]


def _guided_inputs(st: MapStore, k: int, exclude_kps: np.ndarray):
    """Per-keypoint arrays for sim3_guided_match: each keypoint's map
    point position in its own camera frame + gates."""
    mps = st.kf_kp_mp[k]
    safe = np.clip(mps, 0, max(st.n_mp - 1, 0))
    ok = st.kf_kp_valid[k] & (mps != NO_MP) & st.mp_alive[safe]
    ok[exclude_kps] = False
    T = st.kf_pose_cw[k]
    pc = st.mp_pos[safe] @ T[:3, :3].T + T[:3, 3]
    return (
        pc.astype(np.float32), ok, st.mp_desc[safe],
        st.mp_min_dist[safe].astype(np.float32),
        st.mp_max_dist[safe].astype(np.float32),
    )


def compute_sim3_between(
    st1: MapStore, k1: int, st2: MapStore, k2: int, generator: torch.Generator,
    scale_factor: float, n_levels: int, min_inliers: int,
    min_bow_matches: int = 20, guided_th: float = 7.5,
    own_origin_only: bool = False, trace: list | None = None,
):
    """Full ComputeSim3 pipeline between (st1, k1) and (st2, k2), on the
    device of `generator`, whose stream gives the RANSAC draws.

    Returns None on rejection, else a dict with the accepted Sim3
    S12 (camera-2 -> camera-1 coords), the matched map-point pairs
    (slot arrays in each store), and the inlier count.

    own_origin_only: restrict the correspondence set to points
    ORIGINATING in each store's own map (gid // MAP_BASE == map_id).
    Required for INTRA-map loop closing after cross-map fusion: fused
    foreign duplicates sit at positions governed by the other map's
    gauge, so a loop Sim3 measured through them reports the inter-map
    alignment error as phantom drift.

    trace: optional list; each pipeline stage appends a
    (stage_name, value) tuple so diagnostics can see WHICH gate
    rejected a candidate.
    """
    from .. import MAP_BASE

    dev = generator.device

    def t(x):
        return to_device(x, dev)

    def _tr(stage, value):
        if trace is not None:
            trace.append((stage, value))

    def _own_mask(st, mps):
        if not own_origin_only:
            return np.ones(len(mps), bool)
        return (st.mp_gid[mps] // MAP_BASE) == st.map_id
    # 1. BoW-node match over keypoints that hold alive map points
    node_m = matching.node_mask(
        t(st1.kf_nodes[k1]), t(st2.kf_nodes[k2]),
        t(st1.kf_kp_valid[k1] & (st1.kf_kp_mp[k1] != NO_MP)),
        t(st2.kf_kp_valid[k2] & (st2.kf_kp_mp[k2] != NO_MP)),
    )
    m = matching.masked_match(
        t(st1.kf_desc[k1]), t(st2.kf_desc[k2]), node_m,
        max_dist=matching.TH_LOW, ratio=0.75,
    )
    idx, valid = fetch(m.idx, m.valid)
    _tr('bow_raw', int(valid.sum()))
    if valid.sum() < min_bow_matches:
        return None
    kq = np.where(valid)[0]
    mp1 = st1.kf_kp_mp[k1, kq]
    mp2 = st2.kf_kp_mp[k2, idx[kq]]
    ok = (mp1 != NO_MP) & (mp2 != NO_MP) & st1.mp_alive[mp1] & st2.mp_alive[mp2]
    ok &= _own_mask(st1, mp1) & _own_mask(st2, mp2)
    mp1, mp2, kq = mp1[ok], mp2[ok], kq[ok]
    kt = idx[kq]
    _tr('bow_mp', int(len(mp1)))
    if len(mp1) < min_bow_matches:
        return None

    # 2. RANSAC Sim3 on the camera-frame point pairs, per-octave chi2
    pc1 = _cam_frame_points(st1, k1, mp1)
    pc2 = _cam_frame_points(st2, k2, mp2)
    b = bucket_size(len(pc1), 128)
    okp = np.zeros(b, bool)
    okp[: len(pc1)] = True
    sig2_1 = scale_factor ** (2.0 * st1.kf_kp_octave[k1][kq])
    sig2_2 = scale_factor ** (2.0 * st2.kf_kp_octave[k2][kt])
    chi2_1 = pad_rows((9.21 * sig2_1).astype(np.float32), b)
    chi2_2 = pad_rows((9.21 * sig2_2).astype(np.float32), b)
    chi2_1[len(pc1):] = 9.21
    chi2_2[len(pc1):] = 9.21
    okp_t = t(okp)
    res = sim3_ops.ransac_sim3(
        t(pad_rows(pc1.astype(np.float32), b)), t(pad_rows(pc2.astype(np.float32), b)),
        okp_t, t(st1.kf_K[k1]), t(st2.kf_K[k2]),
        sim3_ops.ransac_sim3_draws(okp_t, generator),
        chi2_1=t(chi2_1), chi2_2=t(chi2_2), min_inliers=min(min_inliers, 20),
    )
    r_ok, r_s, r_R, r_t = fetch(res.success, res.s, res.R, res.t)
    _tr('ransac', (bool(r_ok), round(float(r_s), 4)))
    if not bool(r_ok):
        return None
    r_s, r_R, r_t = float(r_s), np.asarray(r_R), np.asarray(r_t)

    # 3. SearchBySim3: grow the correspondence set by mutual guided
    #    projection under the coarse Sim3 (reference: ORBmatcher.cc:1011)
    g1 = _guided_inputs(st1, k1, kq)
    g2 = _guided_inputs(st2, k2, kt)
    f32 = torch.float32
    gi, gv = fetch(*matching.sim3_guided_match(
        *(t(x) for x in g1),
        t(st1.kf_kp_uv[k1]), t(st1.kf_kp_octave[k1]),
        t(st1.kf_kp_valid[k1]), t(st1.kf_desc[k1]),
        t(st1.kf_K[k1]), t(st1.kf_hw[k1].astype(np.float32)),
        *(t(x) for x in g2),
        t(st2.kf_kp_uv[k2]), t(st2.kf_kp_octave[k2]),
        t(st2.kf_kp_valid[k2]), t(st2.kf_desc[k2]),
        t(st2.kf_K[k2]), t(st2.kf_hw[k2].astype(np.float32)),
        torch.tensor(r_s, dtype=f32, device=dev), t(r_R), t(r_t),
        guided_th, scale_factor, n_levels,
    ))
    gq = np.where(gv)[0]
    if len(gq):
        gmp1 = st1.kf_kp_mp[k1, gq]
        gmp2 = st2.kf_kp_mp[k2, gi[gq]]
        gok = (gmp1 != NO_MP) & (gmp2 != NO_MP)
        gok &= _own_mask(st1, np.clip(gmp1, 0, st1.n_mp - 1))
        gok &= _own_mask(st2, np.clip(gmp2, 0, st2.n_mp - 1))
        gq, gmp1, gmp2 = gq[gok], gmp1[gok], gmp2[gok]
        kq = np.concatenate([kq, gq])
        kt = np.concatenate([kt, gi[gq]])
        mp1 = np.concatenate([mp1, gmp1])
        mp2 = np.concatenate([mp2, gmp2])

    # 4. OptimizeSim3 over the enriched set
    pc1 = _cam_frame_points(st1, k1, mp1)
    pc2 = _cam_frame_points(st2, k2, mp2)
    b = bucket_size(len(pc1), 128)
    okp = np.zeros(b, bool)
    okp[: len(pc1)] = True
    uv1 = st1.kf_kp_uv[k1][kq]
    uv2 = st2.kf_kp_uv[k2][kt]
    is2_1 = 1.0 / scale_factor ** (2.0 * st1.kf_kp_octave[k1][kq])
    is2_2 = 1.0 / scale_factor ** (2.0 * st2.kf_kp_octave[k2][kt])
    opt = sim3_opt.optimize_sim3(
        torch.tensor(r_s, dtype=f32, device=dev), t(r_R), t(r_t),
        t(pad_rows(pc1.astype(np.float32), b)),
        t(pad_rows(pc2.astype(np.float32), b)),
        t(pad_rows(uv1.astype(np.float32), b)),
        t(pad_rows(uv2.astype(np.float32), b)),
        t(pad_rows(is2_1.astype(np.float32), b)),
        t(pad_rows(is2_2.astype(np.float32), b)),
        t(okp), t(st1.kf_K[k1]), t(st2.kf_K[k2]),
    )
    o_n, o_s, o_R, o_t = fetch(opt.n_inliers, opt.s, opt.R, opt.t)
    _tr('opt', (int(o_n), round(float(o_s), 4)))
    if int(o_n) < min_inliers:
        return None
    o_s, o_R, o_t = float(o_s), np.asarray(o_R), np.asarray(o_t)
    # 5. multi-view verification.  A single-pair symmetric reprojection
    # cannot pin the SCALE when the matched points have little depth
    # spread (scale trades against translation along the view axis).
    # Projecting the transformed points into k1's COVISIBLE keyframes
    # breaks the degeneracy: a wrong scale lands tens of pixels off from
    # any other viewpoint.
    ok_nb, ratio, n_checked = _neighbor_verify(
        st1, k1, st2, k2, o_s, o_R, o_t, mp1, mp2, scale_factor)
    _tr('nbver', (bool(ok_nb), round(ratio, 3), int(n_checked)))
    if not ok_nb:
        _log.info(
            "sim3 rejected by neighbor verification: s=%.3f ratio=%.2f "
            "over %d neighbor observations", o_s, ratio, n_checked)
        return None
    return dict(
        s=o_s, R=o_R, t=o_t,
        mp1=mp1, mp2=mp2, n_inliers=int(o_n),
        n_bow=int(len(mp1) - len(gq)), n_guided=int(len(gq)),
    )
