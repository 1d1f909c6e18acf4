"""ATE of the monocular client over RANSAC seeds, in either package.

    JAX_PLATFORMS=cpu python tests/ate_spread_mono.py {jax,port} [--first 0] [--last 12]
        [--hw 480 752] [--features 1000] [--levels 8] [--landmarks 1500]
        [--draws mono_draws.npz] [--record jax_draws.npz]

Runs System.track_monocular (`jax`: the JAX package's System; `port`: the
PyTorch port's, on the CPU) over the `mono` cell's sequence,
`cells.mono_sequence()` (synthesize_sequence(seed=0, motion="arc"), 40
frames), with the cell's camera and ORB settings (`cells.settings_for`),
once per rng_seed in [first, last).  The defaults are the cell's own size:
480x752, 1000 features, 8 levels, 1500 landmarks.  The two-view RANSAC
draws are the only input that changes with the seed.  With --draws (the
port only), run rng_seed k replays the two-view draws that
`chip_smoke.py --out DIR` saved for its card run k (DIR/mono_draws.npz),
so the CPU runs on the card's draws; with --record (JAX only), the JAX
runs' draws are saved in the same form, for `port --draws` to replay them.
Prints per seed: the
frame that initialised, frames tracked, keyframes, map points, the ATE as a
share of that run's own span and the median tracking inliers; then the
count of seeds at or above 5% (`tests/test_slam_e2e.py`'s bar).  Not a
test: a measurement script.
"""
import argparse
import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BAR = 0.05


def _jax_system(settings, rng_seed: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from swarmmap_tpu.core.system import System as JSystem
    from swarmmap_tpu.utils import config as jconfig

    c, o = settings.camera, settings.orb
    return JSystem(jconfig.Settings(
        camera=jconfig.CameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=c.fps,
                                    width=c.width, height=c.height),
        orb=jconfig.OrbConfig(n_features=o.n_features, n_levels=o.n_levels)),
        rng_seed=rng_seed)


@contextlib.contextmanager
def _recorded_jax_draws(saved: dict, seed: int):
    """Within the block, each two-view RANSAC draw of the JAX package
    (`jax.random.randint(key, (256, 8), 0, count)` in `twoview.reconstruct`)
    goes into saved["{seed}_{call}"]."""
    import jax
    import jax.numpy as jnp
    from swarmmap_tpu.ops import twoview as jtwoview

    orig = jtwoview.reconstruct

    def record(uv1, uv2, valid, K, key, *args, **kw):
        count = jnp.asarray(max(int(np.sum(valid)), 8), jnp.int32)
        saved[f"{seed}_{sum(k.startswith(f'{seed}_') for k in saved)}"] = np.array(
            jax.random.randint(key, (jtwoview.N_HYPOTHESES, 8), 0, count))
        return orig(uv1, uv2, valid, K, key, *args, **kw)

    jtwoview.reconstruct = record
    try:
        yield
    finally:
        jtwoview.reconstruct = orig


def main() -> None:
    from swarmmap_tpu_torch import cells

    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=("jax", "port"))
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--last", type=int, default=12)
    ap.add_argument("--hw", type=int, nargs=2, default=cells.HW)
    ap.add_argument("--features", type=int, default=cells.N_FEATURES)
    ap.add_argument("--levels", type=int, default=cells.N_LEVELS)
    ap.add_argument("--landmarks", type=int, default=cells.MONO_LANDMARKS)
    ap.add_argument("--draws", help="draws to replay: chip_smoke.py --out's, or --record's")
    ap.add_argument("--record", help="save the JAX runs' draws here (.npz)")
    a = ap.parse_args()
    saved = {}
    recorded = np.load(a.draws) if a.draws else None

    seq = cells.mono_sequence(hw=tuple(a.hw), n_points=a.landmarks)
    settings = cells.settings_for(seq.world, a.features, a.levels)
    print(f"{a.which}: {seq.world.hw}, {a.features} features, {a.levels} levels, "
          f"{a.landmarks} landmarks, {len(seq)} frames", flush=True)
    shares = []
    for seed in range(a.first, a.last):
        s = (_jax_system(settings, seed) if a.which == "jax"
             else cells.new_system(seq, "cpu", a.features, a.levels, rng_seed=seed))
        replay = contextlib.nullcontext() if recorded is None else cells.replayed_draws(
            [recorded[k] for k in sorted((k for k in recorded.files if k.split("_")[0] == str(seed)),
                                         key=lambda k: int(k.split("_")[1]))])
        if a.record:
            replay = _recorded_jax_draws(saved, seed)
        poses, inliers, init = {}, [], None
        with replay:
            for i in range(len(seq)):
                T = s.track_monocular(seq.read(i), seq.timestamps[i])
                if T is not None:
                    poses[i] = T
                    init = i if init is None else init
                inliers.append(s.tracking.matches_inliers)
        if poses:
            rmse, span = cells.ate_share(poses, seq.world)
            shares.append(rmse / span)
            share = f"{rmse / span:.4f}"
        else:
            shares.append(float("inf"))
            share = "none (never initialised)"
        print(f"{a.which} rng_seed {seed}: initialised at {init}, tracked {len(poses)}, "
              f"keyframes {s.n_keyframes()}, map points {s.n_map_points()}, ATE share {share}, "
              f"median inliers {np.median(inliers[5:]):.1f}", flush=True)
    if a.record:
        np.savez(a.record, **saved)
    print(f"{a.which} rng_seed {a.first}-{a.last - 1}: median ATE share "
          f"{np.median(shares):.4f}, at or above {BAR}: {sum(x >= BAR for x in shares)} "
          f"of {len(shares)}", flush=True)


if __name__ == "__main__":
    main()
