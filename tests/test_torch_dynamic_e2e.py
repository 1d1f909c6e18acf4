"""Dynamic-object filtering end to end: the port's System(device="cpu") with
the shipped segmenter against the JAX package's System on the CPU, on
test_dynamic_e2e.py's flock sequence (synthesize_sequence(seed=5,
motion="arc", n_dynamic=60), 240x320, 350 landmarks, 600 features,
4 levels, 40 frames, dynamic_filter=True, dynamic_segment="conv": every
keyframe segmented).

Two-view initialisation draws from each package's own generator, so
JAX's draws are recorded and replayed in the port (`cells.replayed_draws`).
Map points are matched across the packages by position, as mutual
nearest neighbours within 0.5% of their distance from the origin: the two
front ends can order keypoints differently, and with them the slots of
the points made from them (in this run slots 100-102 hold the same three
points in another order), and local BA leaves positions up to 0.16%
apart inside the reach.

Reach: both runs take the same states on all 40 frames.  They insert the
same keyframes, hold the same map-point counts, poses within 1e-3 and flag
the same points dynamic on frames 0-10; at frame 11 local mapping keeps
480 points in JAX and 481 in the port (float32 drift in the local BA
moves a culling or fusion gate), at frame 12 625 and 614, at frame 13
JAX inserts a keyframe that the port does not, and from there the maps
part.  So the exact bars hold until the first frame whose keyframe or
point count differs, at least through frame 9; after it, both runs must
track and flag as test_dynamic_e2e.py asks (>= 35 frames tracked, >= 10
points flagged).
Both ATEs are printed; the reference's red assertion (ATE with the
segmenter below 0.7 x without) is not asserted here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarmmap_tpu.core.system import System as JSystem
from swarmmap_tpu.core.tracking import TrackingParams as JTrackingParams
from swarmmap_tpu.ops import twoview as jtwoview
from swarmmap_tpu.utils import config as jconfig, datasets as jdata
from swarmmap_tpu_torch.cells import (ate_share, frame_record, replayed_draws, settings_for,
                                      state_disagreements)
from swarmmap_tpu_torch.core.system import System
from swarmmap_tpu_torch.core.tracking import TrackingParams
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HW = (240, 320)
N_FRAMES = 40
TCW_TOL = 1e-3
MIN_REACH = 10      # frames 0..MIN_REACH-1 at least agree exactly
POS_TOL = 5e-3      # a map point's position in the two runs, relative to its norm


@pytest.fixture(scope="module")
def seq():
    return jdata.synthesize_sequence(n_frames=N_FRAMES, hw=HW, seed=5, n_points=350,
                                     motion="arc", n_dynamic=60)


def _jax_settings(world):
    K = world.K
    return jconfig.Settings(
        camera=jconfig.CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                    cy=float(K[1, 2]), fps=20.0, width=HW[1], height=HW[0]),
        orb=jconfig.OrbConfig(n_features=600, n_levels=4),
    )


def _matched_flags(sa, sb, flags_a, flags_b) -> tuple[int, int, int]:
    """(points matched, points unmatched, matched points flagged in one run
    only): the alive map points of two stores paired as mutual nearest
    neighbours by position, within POS_TOL of their distance from the
    origin."""
    ia, ib = np.flatnonzero(sa.mp_alive[: sa.n_mp]), np.flatnonzero(sb.mp_alive[: sb.n_mp])
    if not len(ia) or not len(ib):
        return 0, len(ia) + len(ib), 0
    d = np.linalg.norm(sa.mp_pos[ia][:, None] - sb.mp_pos[ib][None], axis=-1)
    ab, ba = d.argmin(1), d.argmin(0)
    near = d[np.arange(len(ia)), ab] < POS_TOL * np.linalg.norm(sa.mp_pos[ia], axis=-1)
    mutual = (ba[ab] == np.arange(len(ia))) & near
    pa, pb = ia[mutual], ib[ab[mutual]]
    unmatched = len(ia) - len(pa) + len(ib) - len(pb)
    return len(pa), unmatched, int((flags_a[pa] != flags_b[pb]).sum())


@pytest.fixture(scope="module")
def runs(seq):
    draws, orig = [], jtwoview.reconstruct

    def record(uv1, uv2, valid, K, key, *args, **kw):
        count = jnp.asarray(max(int(np.sum(valid)), 8), jnp.int32)
        draws.append(np.array(jax.random.randint(key, (jtwoview.N_HYPOTHESES, 8), 0, count)))
        return orig(uv1, uv2, valid, K, key, *args, **kw)

    params = dict(dynamic_filter=True, dynamic_segment="conv")
    a = JSystem(_jax_settings(seq.world), tracking_params=JTrackingParams(**params))
    b = System(settings_for(seq.world, 600, 4), tracking_params=TrackingParams(**params),
               device="cpu")
    recs, poses, flags = [], ({}, {}), []
    jtwoview.reconstruct = record
    try:
        with replayed_draws(draws):
            for i in range(N_FRAMES):
                img, ts = seq.read(i), seq.timestamps[i]
                for s, p in zip((a, b), poses):
                    T = s.track_monocular(img, ts)
                    if T is not None:
                        p[i] = T
                recs.append((frame_record(a.tracking), frame_record(b.tracking)))
                fa, fb = (s.tracking.dynamic.votes.is_dynamic(np.arange(s.store.n_mp))
                          for s in (a, b))
                flags.append((int(fa.sum()), int(fb.sum()),
                              _matched_flags(a.store, b.store, fa, fb)))
    finally:
        jtwoview.reconstruct = orig
    assert not draws   # every recorded draw was replayed
    return a, b, recs, poses, flags


def _reach(recs) -> int:
    """The first frame whose keyframe or map-point count differs."""
    return next((i for i, (x, y) in enumerate(recs) if (x.n_kf, x.n_mp) != (y.n_kf, y.n_mp)),
                len(recs))


def test_same_states_every_frame(runs):
    _, _, recs, _, _ = runs
    assert [x.state for x, _ in recs] == [y.state for _, y in recs]


def test_exact_until_the_maps_part(runs):
    """Until the reach: the same keyframe frames, counts, poses within
    TCW_TOL, and the same points flagged dynamic (matched by position)."""
    _, _, recs, _, flags = runs
    reach = _reach(recs)
    print(f"flock run: JAX and the port agree exactly on frames 0-{reach - 1}")
    assert reach >= MIN_REACH, reach
    assert state_disagreements(*zip(*recs[:reach]), TCW_TOL) == []
    # frames since the last keyframe, once there is one (frame ids come from
    # a process-wide counter in each package)
    assert ([x.since_kf for x, _ in recs[:reach] if x.state == "OK"]
            == [y.since_kf for _, y in recs[:reach] if y.state == "OK"])
    for i, (na, nb, (matched, unmatched, apart)) in enumerate(flags[:reach]):
        assert na == nb and unmatched == 0 and apart == 0, (i, na, nb, matched, unmatched, apart)
    assert flags[reach - 1][0] > 0   # the segmenter flagged points inside the reach


def test_tracks_and_flags_the_flock(runs, seq):
    """test_dynamic_e2e.py's tracking and flagging bars on the port; both
    ATEs reported."""
    a, b, _, poses, flags = runs
    assert len(poses[1]) >= N_FRAMES - 5
    assert flags[-1][1] >= 10, flags[-1]
    (ate_a, span), (ate_b, _) = (ate_share(p, seq.world) for p in poses)
    print(f"flock run, segmenter on: ATE JAX {ate_a:.4f}, port {ate_b:.4f} "
          f"(span {span:.3f}); points flagged JAX {flags[-1][0]}, port {flags[-1][1]}")
    assert np.isfinite(ate_b)
