"""Bag-of-binary-words vocabulary (DBoW2-equivalent).

Port of swarmmap_tpu/ops/vocab.py (reference spec: DBoW2
TemplatedVocabulary — a k-ary tree over 256-bit descriptors; transform()
maps a descriptor to a leaf word plus a grouping node at (L - levelsup);
frames are scored with normalised L1).  The tree is flattened into
per-level dense center arrays.

The host part is a copy: training (hierarchical k-medians with
majority-bit centers, an offline step like the reference's pre-trained
ORBvoc.bin), `transform_np`, `bow_vector`, `score`, the native .npz files
and the reference's DBoW2 text and binary formats.  `transform` is the
device form in PyTorch (L batched gathers and popcount-argmin steps; ties
go to the first child, as numpy's argmin), with the tree's tables uploaded
once per device.  No caller needs it yet: `Frame.compute_bow` runs on the
host, as in the JAX package.  The port reads the JAX package's shipped
vocabulary by path (`default_vocabulary`).
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


def _np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[Na,8] x [Nb,8] -> [Na,Nb]."""
    return _np_popcount_rows(np.bitwise_xor(a[:, None, :], b[None, :, :]))


def _majority_center(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority 'mean' of binary descriptors (k-medians center)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [N,256]
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


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

    # -- training ----------------------------------------------------------
    @classmethod
    def train(
        cls,
        descriptors: np.ndarray,
        k: int = 10,
        L: int = 3,
        seed: int = 0,
        iters: int = 6,
        node_level: int | None = None,
    ) -> "Vocabulary":
        rng = np.random.RandomState(seed)
        descriptors = np.unique(descriptors, axis=0)
        centers = [np.zeros((k**l, k, 8), np.uint32) for l in range(L)]
        valid = [np.zeros((k**l, k), bool) for l in range(L)]

        def cluster(node: int, level: int, members: np.ndarray) -> None:
            if level == L:
                return
            n = len(members)
            if n == 0:
                return
            kk = min(k, n)
            sel = rng.choice(n, size=kk, replace=False)
            cents = members[sel].copy()
            for _ in range(iters):
                d = _np_hamming(members, cents)
                assign = d.argmin(1)
                for c in range(kk):
                    grp = members[assign == c]
                    if len(grp):
                        cents[c] = _majority_center(grp)
            d = _np_hamming(members, cents)
            assign = d.argmin(1)
            centers[level][node, :kk] = cents
            valid[level][node, :kk] = True
            for c in range(kk):
                cluster(node * k + c, level + 1, members[assign == c])

        cluster(0, 0, descriptors.astype(np.uint32))

        voc = cls(
            k=k, L=L, centers=centers, valid=valid,
            word_weights=np.ones(k**L, np.float32),
            node_level=node_level if node_level is not None else max(L - 2, 1),
        )
        # idf weights from the training set
        words, _ = voc.transform_np(descriptors)
        df = np.bincount(words, minlength=k**L).astype(np.float32)
        voc.word_weights = np.log(len(descriptors) / (1.0 + df)).astype(np.float32)
        voc.word_weights = np.maximum(voc.word_weights, 1e-3)
        return voc

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

    # -- DBoW2 text-format interop -------------------------------------------
    # Standard ORB vocabulary text layout (DBoW2 TemplatedVocabulary::
    # saveToTextFile): header "k L scoring weighting", then one line per
    # non-root node in BFS-compatible order:
    #   parent_id is_leaf b0 b1 ... b31 weight
    def save_dbow2_txt(self, path: str | Path) -> None:
        lines = [f"{self.k} {self.L} 0 0"]
        # assign node ids in level order: root=0, then each level's nodes
        next_id = 1
        id_of: dict[tuple[int, int], int] = {}  # (level, dense_pos) -> file id
        id_of[(0, 0)] = 0
        for l in range(self.L):
            for parent_pos in range(self.k**l):
                for c in range(self.k):
                    if not self.valid[l][parent_pos, c]:
                        continue
                    child_pos = parent_pos * self.k + c
                    id_of[(l + 1, child_pos)] = next_id
                    next_id += 1
        for l in range(self.L):
            for parent_pos in range(self.k**l):
                for c in range(self.k):
                    if not self.valid[l][parent_pos, c]:
                        continue
                    child_pos = parent_pos * self.k + c
                    desc_bytes = self.centers[l][parent_pos, c].view(np.uint8)
                    is_leaf = 1 if l == self.L - 1 else 0
                    w = float(self.word_weights[child_pos]) if is_leaf else 0.0
                    lines.append(
                        f"{id_of[(l, parent_pos)]} {is_leaf} "
                        + " ".join(str(int(b)) for b in desc_bytes)
                        + f" {w}"
                    )
        Path(path).write_text("\n".join(lines) + "\n")

    @classmethod
    def load_dbow2_txt(cls, path: str | Path, node_level: int | None = None) -> "Vocabulary":
        """Load a DBoW2-text vocabulary (e.g. a converted ORBvoc.txt)."""
        lines = Path(path).read_text().split("\n")
        header = lines[0].split()
        k, L = int(header[0]), int(header[1])
        children: dict[int, list[tuple[int, np.ndarray, float, bool]]] = {}
        node_id = 0
        for ln in lines[1:]:
            ln = ln.strip()
            if not ln:
                continue
            parts = ln.split()
            node_id += 1
            parent = int(parts[0])
            is_leaf = bool(int(parts[1]))
            desc = np.array([int(x) for x in parts[2:34]], np.uint8).view(np.uint32)
            weight = float(parts[34])
            children.setdefault(parent, []).append((node_id, desc, weight, is_leaf))
        centers = [np.zeros((k**l, k, 8), np.uint32) for l in range(L)]
        valid = [np.zeros((k**l, k), bool) for l in range(L)]
        weights = np.ones(k**L, np.float32)
        # BFS: map file node id -> (level, dense position)
        stack = [(0, 0, 0)]  # (file id, level, dense pos)
        while stack:
            fid, l, pos = stack.pop()
            if l >= L:
                continue
            for c, (cid, desc, w, is_leaf) in enumerate(children.get(fid, [])[:k]):
                centers[l][pos, c] = desc
                valid[l][pos, c] = True
                child_pos = pos * k + c
                if is_leaf or l == L - 1:
                    weights[min(child_pos, k**L - 1)] = max(w, 1e-3)
                else:
                    stack.append((cid, l + 1, child_pos))
        return cls(
            k=k, L=L, centers=centers, valid=valid, word_weights=weights,
            node_level=node_level if node_level is not None else max(L - 2, 1),
        )

    # -- DBoW2 binary-format interop (ORBvoc.bin) ------------------------------
    # Layout (spec: TemplatedVocabulary::loadFromBinaryFile,
    # Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1478): header =
    # u32 nb_nodes, u32 size_node, i32 k, i32 L, i32 scoring, i32 weighting;
    # then per non-root node: i32 parent, 32-byte descriptor, f32 weight,
    # u8 is_leaf  (size_node = 41 for ORB).
    def save_dbow2_bin(self, path: str | Path) -> None:
        import struct

        records = []
        # file node ids in level order (parents precede children)
        id_of: dict[tuple[int, int], int] = {(0, 0): 0}
        next_id = 1
        order: list[tuple[int, int, int]] = []  # (level, parent_pos, child)
        for l in range(self.L):
            for pp in range(self.k**l):
                for c in range(self.k):
                    if self.valid[l][pp, c]:
                        id_of[(l + 1, pp * self.k + c)] = next_id
                        next_id += 1
                        order.append((l, pp, c))
        for l, pp, c in order:
            child_pos = pp * self.k + c
            is_leaf = l == self.L - 1
            w = float(self.word_weights[child_pos]) if is_leaf else 0.0
            records.append(
                struct.pack("<i", id_of[(l, pp)])
                + self.centers[l][pp, c].view(np.uint8).tobytes()
                + struct.pack("<f?", w, is_leaf)
            )
        header = struct.pack("<IIiiii", len(records) + 1, 41, self.k, self.L, 0, 0)
        Path(path).write_bytes(header + b"".join(records))

    @classmethod
    def load_dbow2_bin(cls, path: str | Path,
                       node_level: int | None = None) -> "Vocabulary":
        """Load a reference-format binary vocabulary (ORBvoc.bin)."""
        import struct

        data = Path(path).read_bytes()
        nb_nodes, size_node, k, L, _scoring, _weighting = struct.unpack(
            "<IIiiii", data[:24]
        )
        assert size_node == 41, f"unsupported node size {size_node}"
        body = data[24:]
        n_rec = len(body) // size_node
        children: dict[int, list[tuple[int, bytes, float, bool]]] = {}
        for i in range(n_rec):
            rec = body[i * size_node : (i + 1) * size_node]
            parent = struct.unpack("<i", rec[:4])[0]
            desc = rec[4:36]
            weight, is_leaf = struct.unpack("<f?", rec[36:41])
            children.setdefault(parent, []).append((i + 1, desc, weight, is_leaf))
        centers = [np.zeros((k**l, k, 8), np.uint32) for l in range(L)]
        valid = [np.zeros((k**l, k), bool) for l in range(L)]
        weights = np.ones(k**L, np.float32)
        stack = [(0, 0, 0)]
        while stack:
            fid, l, pos = stack.pop()
            if l >= L:
                continue
            for c, (cid, desc, w, is_leaf) in enumerate(children.get(fid, [])[:k]):
                centers[l][pos, c] = np.frombuffer(desc, np.uint32)
                valid[l][pos, c] = True
                child_pos = pos * k + c
                if is_leaf or l == L - 1:
                    weights[min(child_pos, k**L - 1)] = max(w, 1e-3)
                else:
                    stack.append((cid, l + 1, child_pos))
        return cls(
            k=k, L=L, centers=centers, valid=valid, word_weights=weights,
            node_level=node_level if node_level is not None else max(L - 2, 1),
        )

    # -- persistence -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        arrs = {"k": self.k, "L": self.L, "node_level": self.node_level,
                "word_weights": self.word_weights}
        for l in range(self.L):
            arrs[f"centers_{l}"] = self.centers[l]
            arrs[f"valid_{l}"] = self.valid[l]
        np.savez_compressed(path, **arrs)

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
