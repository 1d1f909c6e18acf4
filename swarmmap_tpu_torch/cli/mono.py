"""Single-agent dataset runners (reference: mono_tum / mono_euroc /
mono_kitti.cc, plus the rgbd_tum / stereo_* sensor variants).

Port of swarmmap_tpu/cli/mono.py, on the card by default:

    python -m swarmmap_tpu_torch.cli.mono --synthetic --frames 80
    python -m swarmmap_tpu_torch.cli.mono --synthetic --sensor rgbd
    python -m swarmmap_tpu_torch.cli.mono -d config/fr2-desk.yaml
"""
from __future__ import annotations

import time
from pathlib import Path

from ..core.system import System
from ..utils.logging import get_logger
from .common import base_parser, device_of, load_vocab, load_world

_log = get_logger("mono")


def main(argv=None):
    p = base_parser("swarmmap single-agent SLAM (PyTorch)")
    p.add_argument("--sensor", choices=["mono", "rgbd", "stereo"], default="mono")
    p.add_argument("--baseline", type=float, default=0.12)
    args = p.parse_args(argv)
    device = device_of(args)
    settings, seqs = load_world(args, 1)
    vocab = load_vocab(args.voc)
    sys_ = System(settings, vocab, device=device)
    if args.load_map:
        sys_.load_map(args.load_map)
    seq = seqs[0]
    synthetic = getattr(seq, "world", None) is not None
    if args.sensor == "rgbd" and not synthetic and seq.depth_paths is None:
        p.error("rgbd mode needs a TUM dataset with depth.txt")
    if args.sensor == "stereo" and not synthetic and seq.right_paths is None:
        p.error("stereo mode needs a KITTI sequence with image_1/")
    if args.sensor == "stereo" and settings.bf > 0:
        args.baseline = settings.bf / settings.camera.fx
    from ..utils import datasets as ds

    t0 = time.time()
    tracked = 0
    for i in range(len(seq)):
        ts = float(seq.timestamps[i])
        if args.sensor == "rgbd":
            if synthetic:
                img, depth = ds.render_frame(seq.world, i, return_depth=True)
            else:
                img, depth = seq.read(i), seq.read_depth(i)
            pose = sys_.track_rgbd(img, depth, ts)
        elif args.sensor == "stereo":
            if synthetic:
                left, right = ds.render_stereo_pair(seq.world, i, args.baseline)
            else:
                left, right = seq.read(i), seq.read_right(i)
            pose = sys_.track_stereo(left, right, ts, baseline=args.baseline)
        else:
            pose = sys_.track_monocular(seq.read(i), ts)
        tracked += pose is not None
    wall = time.time() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sys_.save_keyframe_trajectory_tum(out / "KeyFrameTrajectory.txt")
    sys_.save_frame_trajectory_tum(out / "FrameTrajectory.txt")
    if args.save_map:
        sys_.save_map(args.save_map)
    _log.info("tracked %d/%d frames in %.1fs (%.1f fps) — kf=%d mp=%d",
              tracked, len(seq), wall, len(seq) / wall,
              sys_.n_keyframes(), sys_.n_map_points())
    return sys_


if __name__ == "__main__":
    main()
