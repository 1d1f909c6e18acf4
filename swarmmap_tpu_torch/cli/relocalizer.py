"""Offline relocalization evaluation harness.

Port of swarmmap_tpu/cli/relocalizer.py, on the card by default.
Reference spec: code/Examples/Monocular/relocalizer.cc — load a saved map,
optionally replace the genuine keyframes with a synthesized "keyframe
bone" along the trajectory (GenerateKeyFrameBone, :44-86 — the MBP
virtual-keyframe quality eval), then relocalize a fresh image stream
against the map and report the success rate.

    python -m swarmmap_tpu_torch.cli.relocalizer --map outputs/map-server-0.bin --synthetic
    python -m swarmmap_tpu_torch.cli.relocalizer --map m.bin --bone  # virtual-KF map
"""
from __future__ import annotations

from pathlib import Path

from ..core.frame import build_frame
from ..core.keyframe_db import KeyFrameDatabase
from ..core.map_store import MapStore
from ..core.system import _round_up
from ..core.tracking import Tracking, TrackingParams
from ..server.landmark_scoring import LandmarkScoring
from ..server.map_enhancer import MapEnhancer
from ..sync import codec
from ..sync.oplog import Mapit
from ..utils.logging import get_logger
from .common import base_parser, device_of, load_vocab, load_world

_log = get_logger("relocalizer")


def generate_keyframe_bone(store: MapStore, enhancer: MapEnhancer,
                           spacing: int = 2) -> int:
    """Replace genuine keyframes with virtual ones synthesized along the
    trajectory (reference: GenerateKeyFrameBone)."""
    genuine = [int(k) for k in store.alive_kf_slots() if store.kf_genuine[k]]
    n_virtual = 0
    for k in genuine[::spacing]:
        vk = enhancer.generate_keyframe(store.kf_pose_cw[k], ref_kf=k,
                                        identical=True)
        if vk is not None:
            n_virtual += 1
    # discard the genuine keyframes (keep kf 0 as the gauge anchor)
    for k in genuine[1:]:
        store.set_kf_bad(k, log=False)
    return n_virtual


def main(argv=None):
    p = base_parser("swarmmap relocalization evaluator (PyTorch)")
    p.add_argument("--map", required=True, help="saved map .bin")
    p.add_argument("--bone", action="store_true",
                   help="evaluate against a synthesized keyframe bone")
    p.add_argument("--spacing", type=int, default=2)
    args = p.parse_args(argv)

    device = device_of(args)
    settings, seqs = load_world(args, 1)
    vocab = load_vocab(args.voc)
    n_kp = _round_up(settings.orb.n_features)
    store = MapStore(map_id=0, n_kp=n_kp)
    mapit = Mapit(store)
    mapit.apply_slice(codec.decode_slice(Path(args.map).read_bytes()), vocab=vocab)
    _log.info("loaded map: %d keyframes, %d points",
              store.kf_alive.sum(), store.mp_alive.sum())

    if args.bone:
        scoring = LandmarkScoring(store)
        enhancer = MapEnhancer(store, scoring, settings.orb.scale_factor,
                               settings.orb.n_levels)
        nv = generate_keyframe_bone(store, enhancer, args.spacing)
        _log.info("keyframe bone: %d virtual keyframes", nv)

    kfdb = KeyFrameDatabase(vocab)
    for k in store.alive_kf_slots():
        kfdb.add(store, int(k))

    tracker = Tracking(settings, store, kfdb, vocab,
                       params=TrackingParams(), device=device)
    seq = seqs[0]
    n_ok = 0
    for i in range(len(seq)):
        frame = build_frame(seq.read(i), float(seq.timestamps[i]),
                            settings.camera, settings.orb, device=device)
        if tracker._relocalize(frame):
            n_ok += 1
    rate = n_ok / max(len(seq), 1)
    _log.info("relocalization: %d/%d frames (%.1f%%)", n_ok, len(seq), 100 * rate)
    print(f'{{"reloc_success_rate": {rate:.4f}, "frames": {len(seq)}}}')
    return rate


if __name__ == "__main__":
    main()
