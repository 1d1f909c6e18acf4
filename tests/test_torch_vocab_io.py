"""The port's vocabulary training and files (`ops/vocab.py`) against the
JAX package's: tests/test_matching.py's round trips (DBoW2 text, DBoW2
binary, the native .npz, the real ORBvoc.bin shape) on both packages.

Exact: training on the same descriptors with the same seed gives the same
tree; both packages write the same bytes; each loads the other's file into
the same tables, and the loaded trees transform descriptors to the same
words and nodes.
"""
import struct

import numpy as np
import pytest

from swarmmap_tpu.ops import vocab as jvocab
from swarmmap_tpu_torch.ops import vocab as pvocab
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _same_tree(a, b):
    assert (a.k, a.L, a.node_level) == (b.k, b.L, b.node_level)
    for l in range(a.L):
        np.testing.assert_array_equal(a.centers[l], b.centers[l])
        np.testing.assert_array_equal(a.valid[l], b.valid[l])
    np.testing.assert_array_equal(a.word_weights, b.word_weights)


def _same_words(a, b, descs):
    for x, y in zip(a.transform_np(descs), b.transform_np(descs)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,L,seed,n", [(5, 3, 1, 1500), (4, 3, 9, 1200), (4, 2, 3, 500)])
def test_training_matches_jax(rng, k, L, seed, n):
    descs = rng.randint(0, 2**32, (n, 8), dtype=np.uint32)
    _same_tree(pvocab.Vocabulary.train(descs, k=k, L=L, seed=seed),
               jvocab.Vocabulary.train(descs, k=k, L=L, seed=seed))


@pytest.mark.parametrize("fmt", ["dbow2_txt", "dbow2_bin", "npz"])
def test_files_match_jax(tmp_path, rng, fmt):
    """Both packages write the same bytes; each reads the other's file."""
    descs = rng.randint(0, 2**32, (1500, 8), dtype=np.uint32)
    pv = pvocab.Vocabulary.train(descs, k=5, L=3, seed=1)
    jv = jvocab.Vocabulary.train(descs, k=5, L=3, seed=1)
    ext = {"dbow2_txt": "txt", "dbow2_bin": "bin", "npz": "npz"}[fmt]
    save, load = ("save", "load") if fmt == "npz" else (f"save_{fmt}", f"load_{fmt}")
    pp, jp = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
    getattr(pv, save)(pp)
    getattr(jv, save)(jp)
    if fmt == "npz":  # compressed archives carry times: compare the arrays
        pz, jz = np.load(pp), np.load(jp)
        assert sorted(pz.files) == sorted(jz.files)
        for name in pz.files:
            np.testing.assert_array_equal(pz[name], jz[name])
    else:
        assert pp.read_bytes() == jp.read_bytes()
    p_of_j = getattr(pvocab.Vocabulary, load)(jp)
    j_of_p = getattr(jvocab.Vocabulary, load)(pp)
    _same_tree(p_of_j, j_of_p)
    _same_words(p_of_j, pv, descs[:128])
    _same_words(p_of_j, j_of_p, descs[:128])


def test_dbow2_text_roundtrip(tmp_path, rng):
    """tests/test_matching.py::test_vocab_dbow2_text_roundtrip on the port."""
    descs = rng.randint(0, 2**32, (1500, 8), dtype=np.uint32)
    voc = pvocab.Vocabulary.train(descs, k=5, L=3, seed=1)
    p = tmp_path / "voc.txt"
    voc.save_dbow2_txt(p)
    _same_words(voc, pvocab.Vocabulary.load_dbow2_txt(p), descs[:128])
    head = p.read_text().split("\n")[0].split()
    assert head[0] == "5" and head[1] == "3"


def test_dbow2_binary_roundtrip(tmp_path, rng):
    """tests/test_matching.py::test_vocab_dbow2_binary_roundtrip on the port."""
    descs = rng.randint(0, 2**32, (1200, 8), dtype=np.uint32)
    voc = pvocab.Vocabulary.train(descs, k=4, L=3, seed=9)
    p = tmp_path / "voc.bin"
    voc.save_dbow2_bin(p)
    raw = p.read_bytes()
    nb_nodes, size_node, k, L, sc, wt = struct.unpack("<IIiiii", raw[:24])
    assert size_node == 41 and k == 4 and L == 3
    assert len(raw) == 24 + (nb_nodes - 1) * 41
    _same_words(voc, pvocab.Vocabulary.load_dbow2_bin(p), descs[:128])


def test_dbow2_binary_k10_L6_real_shape(tmp_path, rng):
    """The real ORBvoc.bin shape (k=10, L=6, ~1.1M nodes, ~45 MB): the
    JAX package's file read by the port, and the port's own round trip."""
    k, L = 10, 6
    centers = [rng.randint(0, 2**32, (k**l, k, 8), dtype=np.uint32) for l in range(L)]
    valid = [np.ones((k**l, k), bool) for l in range(L)]
    weights = rng.rand(k**L).astype(np.float32) + 1e-3
    jv = jvocab.Vocabulary(k=k, L=L, centers=centers, valid=valid,
                           word_weights=weights, node_level=4)
    jp = tmp_path / "ORBvoc.bin"
    jv.save_dbow2_bin(jp)
    nb_nodes, size_node, kk, LL, _, _ = struct.unpack("<IIiiii", jp.read_bytes()[:24])
    assert (nb_nodes, size_node, kk, LL) == (sum(k ** (l + 1) for l in range(L)) + 1, 41, 10, 6)
    pv = pvocab.Vocabulary.load_dbow2_bin(jp, node_level=4)
    assert pv.k == 10 and pv.L == 6
    for l in range(L):
        np.testing.assert_array_equal(pv.centers[l], centers[l])
    np.testing.assert_allclose(pv.word_weights, weights, rtol=1e-6)
    _same_words(pv, jv, rng.randint(0, 2**32, (256, 8), dtype=np.uint32))
