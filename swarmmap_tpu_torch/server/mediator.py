"""Per-client server-side agent replica.

Reference spec: AgentMediator (/root/reference/code/src/AgentMediator.cc) —
owns the replica map + keyframe database + a loop closer (no tracking);
static registry of all mediators' databases for incremental cross-agent
place recognition (CheckOverlapCandidates, :140-202): every new keyframe
of one map is queried against all OTHER agents' databases, consistency-
checked, then GetSim3 (:204-382): SearchByBoW >=20 matches -> Sim3Solver
RANSAC -> umeyama alignment -> OptimizeSim3 >=40 inliers ->
Mapit::Merge + map segmentation.

Port of swarmmap_tpu/server/mediator.py: the replica's loop closer and
its Sim3 attempts run on the mediator's device, and the cross-map RANSAC
draws come from a `torch.Generator` seeded 1000 + map_id (the JAX
package's PRNGKey).
"""
from __future__ import annotations

import torch

from ..core.keyframe_db import KeyFrameDatabase
from ..core.map_store import MapStore
from ..ops.vocab import Vocabulary
from ..sync import codec
from ..sync.oplog import Mapit, MapSlice, full_archive
from ..utils.device import default_device
from ..utils.logging import get_logger
from . import sim3_match
from .landmark_scoring import LandmarkScoring
from .loop_closing import LoopClosing
from .map_enhancer import MapEnhancer
from .map_manager import MapManager

_log = get_logger("mediator")

MIN_SEG_LENGTH = 8  # reference: AgentMediator.cc:574


class AgentMediator:
    """Server-side replica of one client's map."""

    registry: dict[int, "AgentMediator"] = {}  # reference: databaseMap (:31)

    def __init__(self, map_id: int, vocab: Vocabulary, map_manager: MapManager,
                 n_kp: int = 1024, scale_factor: float = 1.2, n_levels: int = 8,
                 run_global_ba: bool = False, min_merge_inliers: int = 40,
                 device: torch.device | str | None = None):
        """`device` runs the device programs; by default the card
        (`utils.device.default_device`).  Tests pass device="cpu"."""
        self.device = torch.device(default_device() if device is None else device)
        self.map_id = map_id
        self.vocab = vocab
        self.store = MapStore(map_id=map_id, n_kp=n_kp, is_server=True)
        self.mapit = Mapit(self.store)
        self.kfdb = KeyFrameDatabase(vocab)
        self.scoring = LandmarkScoring(self.store)
        self.enhancer = MapEnhancer(self.store, self.scoring,
                                    scale_factor, n_levels)
        self.loop_closing = LoopClosing(
            self.store, self.kfdb, scale_factor, n_levels,
            run_global_ba=run_global_ba, device=self.device,
        )
        self.map_manager = map_manager
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.min_merge_inliers = min_merge_inliers
        self.state = None  # last reported SystemState
        self.generator = torch.Generator(self.device).manual_seed(1000 + map_id)
        # cross-map candidate consistency, counted per covisibility GROUP
        # (reference: AgentMediator::DetectLoop's mvConsistentGroups,
        # AgentMediator.cc:384-460) — exact-candidate counting never
        # converges because consecutive queries return different members
        # of the same revisited area
        self.overlap_groups: list[tuple[int, set[int], int]] = []
        # ICI cross-agent descriptor-overlap hint ({other map_id ->
        # fraction of fresh descriptors with a match there}), fed by the
        # mesh-sharded swarm step; ranks the Sim3 attempt budget
        self.overlap_hint: dict[int, float] | None = None
        map_manager.register(self.store)
        AgentMediator.registry[map_id] = self

    # ------------------------------------------------------------------
    def set_state(self, state):
        self.state = state

    def on_push(self, sl: MapSlice) -> list[int]:
        """Apply a client push; returns new keyframe slots; loop-closer
        keyframes are collected through the AddLoopClosing map events."""
        st = self.store
        n_before = st.n_kf
        loop_kfs: list[int] = []

        def on_map_event(func, target, args):
            if func == "AddLoopClosing":
                k = st.kf_by_gid.get(target)
                if k is not None:
                    loop_kfs.append(k)
            elif func == "clear":
                _log.warning("client %d cleared its map", self.map_id)

        from ..utils.stats import STATS

        with STATS.stage("srv_apply_slice"):
            self.mapit.apply_slice(sl, vocab=self.vocab,
                                   on_map_event=on_map_event)
        new_slots = list(range(n_before, st.n_kf))
        for k in new_slots:
            self.kfdb.add(st, k)
        with STATS.stage("srv_loop_detect"):
            for k in loop_kfs:
                self.loop_closing.process_keyframe(k)
        return new_slots

    # ------------------------------------------------------------------ overlap
    def check_overlap_candidates(self, new_kf_slots: list[int],
                                 consistency_th: int = 2,
                                 max_sim3_attempts: int = 4) -> bool:
        """Cross-agent place recognition: query every OTHER mediator's
        database with our new keyframes (reference:
        AgentMediator::CheckOverlapCandidates).  Sim3 attempts are
        budgeted per push — each costs several device round trips, and a
        failing candidate pair will be retried on the next push anyway."""
        st = self.store
        merged = False
        # phase 1: gather consistency-approved (score, k, other, cand)
        # pairs over the WHOLE push, so the sim3 budget goes to the
        # BEST-scoring pairs instead of the first keyframes' weak ones
        approved: list[tuple[float, int, int, int]] = []
        for k in new_kf_slots:
            if not st.kf_alive[k]:
                continue
            bow = self.kfdb.bow.get(k, {})
            words = st.kf_words[k]
            # relative gate (reference: kf->GetMinCovisibilityScore(),
            # AgentMediator.cc:177): the weakest self-similarity among the
            # keyframe's own covisible neighbors — invariant to the
            # vocabulary's word count, unlike an absolute threshold
            covis = st.covisible_kfs(k, 30)
            min_score = min(
                (Vocabulary.score(bow, self.kfdb.bow.get(c, {}))
                 for c in covis),
                default=0.0,
            )
            for other_id, other in AgentMediator.registry.items():
                if other_id == self.map_id:
                    continue
                if other.store.group_id == st.group_id:
                    continue  # already merged
                cands = other.kfdb.detect_candidates(
                    bow, words, other.store, min_score=min_score,
                )
                for cand in cands[:3]:
                    group = set(other.store.covisible_kfs(cand, 10)) | {cand}
                    count = 1
                    kept = []
                    for oid, g, c in self.overlap_groups:
                        if oid == other_id and (g & group):
                            count = max(count, c + 1)
                        else:
                            kept.append((oid, g, c))
                    self.overlap_groups = kept + [(other_id, group, count)]
                    if count < consistency_th:
                        continue
                    score = Vocabulary.score(
                        bow, other.kfdb.bow.get(cand, {}))
                    approved.append((score, k, other_id, cand))
        # phase 2: spend the budget best-first; the device-computed
        # overlap hint (all_gathered descriptor matches over the agent
        # mesh) boosts pairs the ICI prefilter already saw agreeing
        if self.overlap_hint:
            approved = [
                (score * (1.0 + self.overlap_hint.get(other_id, 0.0)),
                 k, other_id, cand)
                for score, k, other_id, cand in approved
            ]
        approved.sort(reverse=True)
        for _score, k, other_id, cand in approved[:max_sim3_attempts]:
            other = AgentMediator.registry[other_id]
            if other.store.group_id == st.group_id:
                continue
            res = self.get_sim3(k, other, cand)
            if res is not None:
                s, R, t = res
                # S12 takes other's LOCAL coords into our LOCAL coords
                # (both via camera frames): S_1l2l = T_1w^-1 S_c1c2 T_2w
                T1 = st.kf_pose_cw[k]
                T2 = other.store.kf_pose_cw[cand]
                R1i, t1i = T1[:3, :3].T, -T1[:3, :3].T @ T1[:3, 3]
                R_a = R1i @ R @ T2[:3, :3]
                t_a = R1i @ (s * (R @ T2[:3, 3]) + t) + t1i
                merged |= self.map_manager.merge(
                    self.map_id, other_id, s, R_a, t_a
                )
                if merged:
                    self.overlap_groups.clear()
                    return True
        return merged

    def get_sim3(self, k: int, other: "AgentMediator", cand: int):
        """Sim3 between our kf k and other's kf cand via the full shared
        pipeline — BoW match, RANSAC (per-octave chi2), SearchBySim3
        guided enrichment, OptimizeSim3 (reference: AgentMediator::GetSim3,
        AgentMediator.cc:204-382).  The reference accepts >=40 inliers
        for cross-map merges (:342)."""
        res = sim3_match.compute_sim3_between(
            self.store, k, other.store, cand, self.generator,
            self.scale_factor, self.n_levels, self.min_merge_inliers,
        )
        if res is None:
            return None
        _log.info(
            "cross-map sim3: map %d kf %d <-> map %d kf %d "
            "(%d inliers = %d bow + %d guided, s=%.3f)",
            self.map_id, k, other.map_id, cand, res["n_inliers"],
            res["n_bow"], res["n_guided"], res["s"],
        )
        return res["s"], res["R"], res["t"]

    # ------------------------------------------------------------------
    def segment_map(self) -> list[list[int]]:
        """Split the map into >=MIN_SEG_LENGTH keyframe slices at loop-
        closure boundaries (reference: SegmentMapByKeyFrame, :544-588)."""
        st = self.store
        kfs = sorted(st.alive_kf_slots())
        segments: list[list[int]] = []
        cur: list[int] = []
        for k in kfs:
            cur.append(int(k))
            if st.kf_loop_edges.get(int(k)) and len(cur) >= MIN_SEG_LENGTH:
                segments.append(cur)
                cur = []
        if cur:
            if segments and len(cur) < MIN_SEG_LENGTH:
                segments[-1].extend(cur)
            else:
                segments.append(cur)
        return segments

    def save_map(self, path, fmt: str = "msgpack") -> None:
        """Write the replica map checkpoint; fmt="boost-bin" exports the
        reference's `map-*.bin` binary-archive layout (System::SaveMap)
        so reference tooling can load maps built here."""
        from pathlib import Path

        if fmt == "boost-bin":
            from ..sync import boost_bin

            arc = full_archive(self.store)
            inverted = None
            if self.kfdb is not None:
                inv = self.kfdb.inverted  # word id -> kf slots
                n_words = max(inv.keys(), default=-1) + 1
                inverted = [
                    sorted(int(self.store.kf_gid[k]) for k in inv.get(w, ())
                           if self.store.kf_alive[k])
                    for w in range(n_words)
                ]
            Path(path).write_bytes(
                boost_bin.encode_map_bin(arc.kfs, arc.mps,
                                         inverted_file=inverted))
            return
        Path(path).write_bytes(codec.encode_slice(full_archive(self.store)))
