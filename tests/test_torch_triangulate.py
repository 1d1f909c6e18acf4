"""Parity of the port's triangulation (swarmmap_tpu_torch.ops.triangulate)
and epipolar gate (ops/matching.py:epipolar_mask) with the JAX package's on
the CPU.

Bars: triangulated points within 1e-4 relative where the DLT null vector is
well conditioned (|w| >= 1e-2 of the unit null vector, taken in float64:
points up to ~100 times the scene's depth); farther out float32 loses
digits as 1/|w|, so points with 1e-6 < |w| < 1e-2 are held within
1e-6 / |w| relative (the scene's real points agree to 1e-5);
the depth and parallax helpers within float32 rounding, the squared
reprojection error within 2e-4 px^2 (projections near 320 px round at
4e-5 px; the error is gated at 5.991 sigma^2 >= 5.991 px^2); the
epipolar gate exact except for pairs within 1e-5 relative of its
3.84 sigma^2 bar, which are counted and held to a small share.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmmap_tpu.ops import matching as jmatching, triangulate as jtri
from swarmmap_tpu_torch.ops import matching, triangulate as tri
from test_geometry import make_scene, project, small_rotation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _views(seed, n=400):
    """Two views of a random scene with pixel noise; the last 20 point
    pairs are rays at (near) infinity, where w of the DLT vanishes; the
    second view's projections come in [B=3] copies with growing baselines
    (the neighbour axis of local mapping)."""
    rng = np.random.RandomState(seed)
    pts, K = make_scene(rng, n)
    pts[-20:] *= 1e6
    P1 = K @ np.eye(4)[:3]
    uv1, _ = project(K, np.eye(3), np.zeros(3), pts)
    P2, uv2, T2 = [], [], []
    for b in range(3):
        R = small_rotation(rng, 0.05)
        t = np.array([0.3 * (b + 1), 0.05, 0.02])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        T2.append(T)
        P2.append(K @ T[:3])
        uv2.append(project(K, R, t, pts)[0] + rng.normal(0, 0.5, (n, 2)))
    f = np.float32
    return (P1.astype(f), np.stack(P2).astype(f), (uv1 + rng.normal(0, 0.5, (n, 2))).astype(f),
            np.stack(uv2).astype(f), np.stack(T2).astype(f), K.astype(f))


def _null_w(P1, P2, uv1, uv2):
    """|w| of the unit null vector of each DLT system, in float64."""
    P1, P2, uv1, uv2 = (np.asarray(x, np.float64) for x in (P1, P2, uv1, uv2))
    A = np.stack([uv1[:, 0:1] * P1[2] - P1[0], uv1[:, 1:2] * P1[2] - P1[1],
                  uv2[:, 0:1] * P2[2] - P2[0], uv2[:, 1:2] * P2[2] - P2[1]], 1)
    return np.abs(np.linalg.svd(A)[2][:, 3, 3])


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_matches_jax(seed):
    P1, P2, uv1, uv2, T2, K = _views(seed)
    got = tri.triangulate(torch.from_numpy(P1).expand(3, 3, 4), torch.from_numpy(P2),
                          torch.from_numpy(uv1), torch.from_numpy(uv2)).numpy()
    n_cond = 0
    for b in range(3):
        ref = np.asarray(jtri.triangulate(*(jnp.asarray(x) for x in (P1, P2[b], uv1, uv2[b]))))
        w = _null_w(P1, P2[b], uv1, uv2[b])
        cond = w > 1e-6
        n_cond += cond.sum()
        rel = np.abs(got[b] - ref).max(1) / np.maximum(np.abs(ref).max(1), 1e-6)
        bar = 1e-4 * np.maximum(1.0, 1e-2 / w)
        assert (rel < bar)[cond].all(), (b, rel[cond].max())
        assert rel[w >= 1e-2].max() < 1e-4 and (w >= 1e-2).sum() >= 370
        # the helpers, on the JAX package's points
        Tb = np.eye(4, dtype=np.float32)
        c2 = -T2[b, :3, :3].T @ T2[b, :3, 3]
        for name, atol, a, bb in (
            ("depths", 1e-5, jtri.depths(jnp.asarray(T2[b]), jnp.asarray(ref)),
             tri.depths(torch.from_numpy(T2[b]), torch.from_numpy(ref))),
            ("reprojection_error2", 2e-4, jtri.reprojection_error2(jnp.asarray(P2[b]), jnp.asarray(ref),
                                                            jnp.asarray(uv2[b])),
             tri.reprojection_error2(torch.from_numpy(P2[b]), torch.from_numpy(ref),
                                     torch.from_numpy(uv2[b]))),
            ("parallax_cos", 1e-6, jtri.parallax_cos(jnp.zeros(3), jnp.asarray(c2), jnp.asarray(ref)),
             tri.parallax_cos(torch.zeros(3), torch.from_numpy(c2), torch.from_numpy(ref))),
        ):
            a, bb = np.asarray(a)[cond], bb.numpy()[cond]
            np.testing.assert_allclose(bb, a, rtol=2e-5, atol=atol, err_msg=name)
        np.testing.assert_allclose(
            tri.projection_matrix(torch.from_numpy(K), torch.from_numpy(Tb)).numpy(),
            np.asarray(jtri.projection_matrix(jnp.asarray(K), jnp.asarray(Tb))))
    assert n_cond >= 3 * 370   # the rays at infinity are the ones left out


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_mask_matches_jax(seed):
    """[B=3] neighbours at once against the JAX package's per neighbour
    gate, on random keypoints (a dense mix of pairs far, near and on the
    lines)."""
    P1, P2, uv1, uv2, T2, K = _views(seed)
    rng = np.random.RandomState(seed + 10)
    n1, n2 = 300, 256
    q = uv1[:n1]
    tgt = np.concatenate([uv2[:, :128], rng.uniform(0, 640, (3, 128, 2)).astype(np.float32)], 1)
    sig2 = (1.2 ** (2 * rng.randint(0, 8, (3, n2)))).astype(np.float32)
    v1, v2 = rng.rand(n1) > 0.1, rng.rand(3, n2) > 0.1
    Kinv = np.linalg.inv(K.astype(np.float64))
    F12 = []
    for b in range(3):
        R, t = T2[b, :3, :3].T, -T2[b, :3, :3].T @ T2[b, :3, 3]    # T12 = T1 T2^-1
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        F12.append(Kinv.T @ tx @ R @ Kinv)
    F12 = np.stack(F12).astype(np.float32)
    got = matching.epipolar_mask(*(torch.from_numpy(x) for x in (q, tgt, F12, sig2, v1, v2))).numpy()
    near = flips = total = 0
    for b in range(3):
        ref = np.asarray(jmatching.epipolar_mask(*(jnp.asarray(x) for x in (
            q, tgt[b], F12[b], sig2[b], v1, v2[b]))))
        # squared distance to the bar, in float64, for the pairs that differ
        l = np.concatenate([q, np.ones((n1, 1), np.float32)], 1).astype(np.float64) @ F12[b]
        num = l[:, None, 0] * tgt[b][None, :, 0] + l[:, None, 1] * tgt[b][None, :, 1] + l[:, None, 2]
        dsq = num ** 2 / np.maximum(l[:, 0:1] ** 2 + l[:, 1:2] ** 2, 1e-12)
        bar = 3.84 * sig2[b][None, :]
        at_bar = np.abs(dsq - bar) <= 1e-5 * bar
        diff = got[b] != ref
        assert not (diff & ~at_bar).any()
        near += int(at_bar.sum())
        flips += int(diff.sum())
        total += int(ref.sum())
    assert total > 1000          # the gate passes a real share of pairs
    assert flips <= near and flips <= 3, (flips, near)
