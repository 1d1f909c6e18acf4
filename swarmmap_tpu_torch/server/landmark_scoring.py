"""MBP landmark / keyframe scoring.

Reference spec: LandmarkScoring (/root/reference/code/src/LandmarkScoring.cc)
— per-MapPoint features (observation count, update frequency, creation and
last-tracked times, creating-camera velocity, observer spread, viewing-
angle spread; MapPointScoreItem, LandmarkScoring.h:17-49), normalized by
per-map running maxima and summed (CalcFinalScore, :224-244); keyframe
score = mean of its points' scores (:311-334); request priority =
normalized generation rate minus normalized recent mean score
(GetRequestPriority, :31-75); CSV dump (Save, :337-377).

Vectorized numpy over the whole store per call (observer sets padded to
MAX_OBSERVERS).

Copy of swarmmap_tpu/server/landmark_scoring.py over the port's map store
and clock, which the port cannot import on a machine without JAX.  It runs
on the host only, in numpy.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.map_store import MapStore
from ..utils.timer import global_clock

MAX_OBSERVERS = 8
FEATURES = (
    "observed", "update_freq", "age", "recency", "cam_velocity",
    "observer_spread", "view_angle",
)


class LandmarkScoring:
    def __init__(self, store: MapStore):
        self.store = store
        self.maxima = {f: 1e-9 for f in FEATURES}
        self.mp_scores: np.ndarray = np.zeros(0, np.float32)
        self.kf_scores: dict[int, float] = {}
        # request-priority running maxima (GetRequestPriority)
        self.max_generation = 1e-9
        self.max_mean_score = 1e-9

    # ------------------------------------------------------------------
    def features(self, slots: np.ndarray) -> np.ndarray:
        """[M, n_features] raw feature matrix for the given mp slots."""
        st = self.store
        now = global_clock()
        n = len(slots)
        # observer centers via the array obs table (the dict walk was a
        # wall at 50k observations): group rows by point, take the first
        # MAX_OBSERVERS observers of each
        lut = np.full(st.n_mp, -1, np.int32)
        lut[slots] = np.arange(n, dtype=np.int32)
        om, okf, _ = st.obs_arrays()
        sel = np.where(lut[om] >= 0)[0]
        g = lut[om[sel]]
        order = np.argsort(g, kind="stable")
        gs, kf_sorted = g[order], okf[sel][order]
        counts = np.bincount(gs, minlength=n).astype(np.int32)
        starts = np.searchsorted(gs, np.arange(n))
        R = st.kf_pose_cw[: st.n_kf, :3, :3]
        t = st.kf_pose_cw[: st.n_kf, :3, 3]
        kf_centers = -np.einsum("kji,kj->ki", R, t)
        centers = np.zeros((n, MAX_OBSERVERS, 3), np.float32)
        for j in range(MAX_OBSERVERS):
            idx = starts + j
            ok = idx < starts + counts
            idx = np.minimum(idx, len(gs) - 1) if len(gs) else idx
            if not len(gs):
                break
            centers[ok, j] = kf_centers[kf_sorted[idx[ok]]]
        pos = st.mp_pos[slots]
        age = np.maximum(now - st.mp_created[slots], 1e-3)
        upd_freq = st.mp_update_count[slots] / age
        recency = np.maximum(now - st.mp_last_tracked[slots], 0.0)
        # observer spread: max pairwise distance among observer centers
        nb = np.minimum(counts, MAX_OBSERVERS)
        mask = np.arange(MAX_OBSERVERS)[None] < nb[:, None]
        d = np.linalg.norm(centers[:, :, None] - centers[:, None, :], axis=-1)
        pair_ok = mask[:, :, None] & mask[:, None, :]
        spread = np.where(pair_ok, d, 0.0).reshape(n, -1).max(1)
        # viewing-angle spread
        rays = pos[:, None, :] - centers
        rays = rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
        cos = np.einsum("mik,mjk->mij", rays, rays)
        ang = np.where(pair_ok, np.arccos(np.clip(cos, -1, 1)), 0.0)
        view_angle = ang.reshape(n, -1).max(1)
        return np.stack(
            [
                counts.astype(np.float32),
                upd_freq.astype(np.float32),
                age.astype(np.float32),
                recency.astype(np.float32),
                st.mp_cam_velocity[slots],
                spread.astype(np.float32),
                view_angle.astype(np.float32),
            ],
            axis=1,
        )

    def rank(self) -> np.ndarray:
        """Score every live map point; returns scores aligned with
        alive_mp_slots() (reference: LandmarkScoring::Rank)."""
        st = self.store
        slots = st.alive_mp_slots()
        if len(slots) == 0:
            self.mp_scores = np.zeros(0, np.float32)
            return self.mp_scores
        F = self.features(slots)
        for i, f in enumerate(FEATURES):
            self.maxima[f] = max(self.maxima[f], float(np.abs(F[:, i]).max()))
        norm = np.array([self.maxima[f] for f in FEATURES], np.float32)
        Fn = F / norm[None]
        # recency counts against the score (stale points decay)
        weights = np.array([1, 1, 0.5, -1, 0.5, 1, 1], np.float32)
        self.mp_scores = Fn @ weights
        # keyframe scores = mean of observed points' scores (vectorized
        # over all keyframe rows)
        lut = np.full(st.n_mp, -1, np.int32)
        lut[slots] = np.arange(len(slots), dtype=np.int32)
        kfs = st.alive_kf_slots()
        rows = st.kf_kp_mp[kfs]
        val = lut[np.clip(rows, 0, max(st.n_mp - 1, 0))]
        ok = (rows >= 0) & (val >= 0)
        scores_pad = np.concatenate([self.mp_scores, [0.0]]).astype(np.float32)
        sums = np.where(ok, scores_pad[np.where(ok, val, -1)], 0.0).sum(1)
        cnt = ok.sum(1)
        self.kf_scores = {
            int(k): float(s / c) if c else 0.0
            for k, s, c in zip(kfs, sums, cnt)
        }
        return self.mp_scores

    def request_priority(self, n_new_elements: int, dt: float = 2.0) -> float:
        """Contribution score of a pending push: generation rate minus
        recent mean score (GetRequestPriority)."""
        gen = n_new_elements / max(dt, 1e-3)
        mean_score = float(self.mp_scores.mean()) if len(self.mp_scores) else 0.0
        self.max_generation = max(self.max_generation, gen)
        self.max_mean_score = max(self.max_mean_score, abs(mean_score))
        return gen / self.max_generation - mean_score / self.max_mean_score

    def save_csv(self, path: str | Path):
        st = self.store
        slots = st.alive_mp_slots()
        lines = ["slot,gid," + ",".join(FEATURES) + ",score"]
        if len(slots):
            F = self.features(slots)
            for i, m in enumerate(slots):
                sc = self.mp_scores[i] if i < len(self.mp_scores) else 0.0
                lines.append(
                    f"{m},{st.mp_gid[m]}," +
                    ",".join(f"{x:.5f}" for x in F[i]) + f",{sc:.5f}"
                )
        Path(path).write_text("\n".join(lines) + "\n")
