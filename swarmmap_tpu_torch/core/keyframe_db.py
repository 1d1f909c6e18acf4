"""BoW inverted-file place recognition database.

Copy of swarmmap_tpu/core/keyframe_db.py (numpy only).

Reference spec: KeyFrameDatabase (code/src/KeyFrameDatabase.cc)
— word -> keyframe lists; candidate detection by shared-word counting,
score accumulation over covisibility groups, expansion thresholds.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..ops.vocab import Vocabulary
from .map_store import MapStore


class KeyFrameDatabase:
    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.inverted: dict[int, set[int]] = defaultdict(set)
        self.bow: dict[int, dict[int, float]] = {}  # kf slot -> sparse bow

    def add(self, store: MapStore, k: int) -> None:
        words = store.kf_words[k]
        valid = store.kf_kp_valid[k] & (words >= 0)
        self.bow[k] = self.vocab.bow_vector(words, valid)
        for w in set(words[valid].tolist()):
            self.inverted[w].add(k)

    def erase(self, k: int) -> None:
        b = self.bow.pop(k, None)
        if b:
            for w in b:
                self.inverted[w].discard(k)

    def _shared_word_counts(self, words: np.ndarray, exclude: set[int]) -> dict[int, int]:
        counts: dict[int, int] = defaultdict(int)
        for w in set(int(x) for x in words[words >= 0]):
            for k in self.inverted.get(w, ()):
                if k not in exclude:
                    counts[k] += 1
        return counts

    def detect_candidates(
        self,
        query_bow: dict[int, float],
        query_words: np.ndarray,
        store: MapStore,
        exclude: set[int] | None = None,
        min_score: float = 0.0,
        use_covis_accumulation: bool = True,
    ) -> list[int]:
        """Shared algorithm behind DetectLoopCandidates and
        DetectRelocalizationCandidates (KeyFrameDatabase.cc)."""
        exclude = exclude or set()
        counts = self._shared_word_counts(query_words, exclude)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = max(0.8 * max_common, 1.0)
        scored = []
        for k, c in counts.items():
            if c >= min_common and store.kf_alive[k]:
                s = Vocabulary.score(query_bow, self.bow.get(k, {}))
                if s >= min_score:
                    scored.append((s, k))
        if not scored:
            return []
        if not use_covis_accumulation:
            scored.sort(reverse=True)
            return [k for _, k in scored]
        # accumulate over covisibility groups; return best of each group
        best_acc = 0.0
        groups = []
        direct = dict((k, s) for s, k in scored)
        for s, k in scored:
            group = [k] + store.covisible_kfs(k, 10)
            acc = 0.0
            best_k, best_s = k, s
            for k2 in group:
                s2 = direct.get(k2)
                if s2 is not None:
                    acc += s2
                    if s2 > best_s:
                        best_k, best_s = k2, s2
            groups.append((acc, best_k))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, k in sorted(groups, reverse=True):
            if acc >= th and k not in seen:
                seen.add(k)
                out.append(k)
        return out

    def detect_loop_candidates(self, store: MapStore, k: int, min_score: float) -> list[int]:
        connected = set(store.covisible_kfs(k)) | {k}
        words = store.kf_words[k]
        return self.detect_candidates(
            self.bow.get(k, {}), words, store, exclude=connected, min_score=min_score
        )

    def detect_reloc_candidates(self, frame, store: MapStore) -> list[int]:
        bow = self.vocab.bow_vector(frame.words, frame.valid & (frame.words >= 0))
        return self.detect_candidates(bow, frame.words, store)
