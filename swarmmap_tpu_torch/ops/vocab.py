"""Bag-of-binary-words vocabulary (DBoW2-equivalent).

Port of swarmmap_tpu/ops/vocab.py (reference spec: DBoW2
TemplatedVocabulary — a k-ary tree over 256-bit descriptors; transform()
maps a descriptor to a leaf word plus a grouping node at (L - levelsup);
frames are scored with normalised L1).  The tree is flattened into
per-level dense center arrays.

The host part is a copy: `transform_np`, `bow_vector`, `score`, `load`.
`transform` is the device form in PyTorch (L batched gathers and
popcount-argmin steps; ties go to the first child, as numpy's argmin), with
the tree's tables uploaded once per device.  No caller needs it yet:
`Frame.compute_bow` runs on the host, as in the JAX package.
Training and the DBoW2 file formats are not carried over: the port reads
the JAX package's shipped vocabulary by path (`default_vocabulary`).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .hamming import popcount_u32

if hasattr(np, "bitwise_count"):  # numpy >= 2.0: hardware popcnt ufunc

    def _np_popcount_rows(x: np.ndarray) -> np.ndarray:
        """[..,8] u32 -> [..] bit count."""
        return np.bitwise_count(x).sum(-1, dtype=np.int32)

else:
    _POPCOUNT_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)

    def _np_popcount_rows(x: np.ndarray) -> np.ndarray:
        """[..,8] u32 -> [..] bit count (byte LUT)."""
        return _POPCOUNT_LUT[x.view(np.uint8)].sum(-1, dtype=np.int32)


@dataclasses.dataclass
class Vocabulary:
    k: int
    L: int
    centers: list[np.ndarray]          # level l: [k^l, k, 8] u32 child centers
    valid: list[np.ndarray]            # level l: [k^l, k] bool
    word_weights: np.ndarray           # [k^L] f32 (idf)
    node_level: int = 2                # FeatureVector grouping level
    # device -> per-level (centers as int32 words, valid) on that device
    _tables: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return self.k**self.L

    # -- transform ---------------------------------------------------------
    def transform_np(self, desc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host transform: [N,8]u32 -> (word_id [N], node_id [N])."""
        node = np.zeros(len(desc), np.int64)
        node_at = np.zeros(len(desc), np.int64)
        for l in range(self.L):
            cents = self.centers[l][node]          # [N,k,8]
            ok = self.valid[l][node]               # [N,k]
            d = _np_popcount_rows(np.bitwise_xor(cents, desc[:, None, :]))
            d = np.where(ok, d, 1 << 20)
            child = d.argmin(1)
            node = node * self.k + child
            if l + 1 == self.node_level:
                node_at = node.copy()
        return node, node_at

    def transform(self, desc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Device transform (same math, batched gathers): [N,8] int32 words
        on any device -> (word_id [N], node_id [N]) int32 there."""
        dev = desc.device
        if dev not in self._tables:
            self._tables[dev] = [(torch.from_numpy(c.view(np.int32)).to(dev),
                                  torch.from_numpy(v).to(dev))
                                 for c, v in zip(self.centers, self.valid)]
        n = desc.shape[0]
        node = torch.zeros(n, dtype=torch.long, device=dev)
        node_at = torch.zeros(n, dtype=torch.long, device=dev)
        for l, (cents, oks) in enumerate(self._tables[dev]):
            c = cents[node]                        # [N,k,8]
            ok = oks[node]
            d = popcount_u32(torch.bitwise_xor(c, desc[:, None, :])).sum(-1)
            d = torch.where(ok, d, 1 << 20)
            child = torch.argmin(d, dim=1)         # first minimal index on ties
            node = node * self.k + child
            if l + 1 == self.node_level:
                node_at = node
        return node.to(torch.int32), node_at.to(torch.int32)

    # -- scoring -----------------------------------------------------------
    def bow_vector(self, words: np.ndarray, valid: np.ndarray | None = None) -> dict[int, float]:
        """Sparse normalized BoW vector {word: weight} (DBoW2 L1 norm)."""
        if valid is not None:
            words = words[valid]
        bow: dict[int, float] = {}
        for w in words:
            bow[int(w)] = bow.get(int(w), 0.0) + float(self.word_weights[int(w)])
        norm = sum(abs(v) for v in bow.values()) or 1.0
        return {w: v / norm for w, v in bow.items()}

    @staticmethod
    def score(a: dict[int, float], b: dict[int, float]) -> float:
        """DBoW2 L1 score in [0,1]: 1 - 0.5*|va/|va| - vb/|vb||_1,
        accumulated over shared words only."""
        s = 0.0
        if len(a) > len(b):
            a, b = b, a
        for w, va in a.items():
            vb = b.get(w)
            if vb is not None:
                s += abs(va) + abs(vb) - abs(va - vb)
        return 0.5 * s

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, path: str | Path) -> "Vocabulary":
        z = np.load(path)
        k, L = int(z["k"]), int(z["L"])
        return cls(
            k=k, L=L,
            centers=[z[f"centers_{l}"] for l in range(L)],
            valid=[z[f"valid_{l}"] for l in range(L)],
            word_weights=z["word_weights"],
            node_level=int(z["node_level"]),
        )


# the JAX package's shipped vocabulary (10^4 words, k=10, L=4, trained on
# ORB descriptors of rendered synthetic worlds), read by path: a data file,
# not an import
SHIPPED_VOCAB = (Path(__file__).resolve().parents[2] / "swarmmap_tpu" / "data"
                 / "vocab-synth-k10L5.npz")

_default_vocab: Vocabulary | None = None


def default_vocabulary() -> Vocabulary:
    """The shipped vocabulary (SHIPPED_VOCAB), loaded once per process.
    Raises FileNotFoundError where the file is missing: the JAX package's
    random-descriptor fallback is not carried over."""
    global _default_vocab
    if _default_vocab is None:
        _default_vocab = Vocabulary.load(SHIPPED_VOCAB)
    return _default_vocab
