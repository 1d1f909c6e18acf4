"""Shared CLI plumbing (reference counterpart: the popl option blocks in
code/Examples/Monocular/*.cc and the dataset-config parsing at
swarm_map.cc:198-219).

Copy of swarmmap_tpu/cli/common.py, plus `--device`: the CLIs run on the
card (`utils.device.default_device`, which raises where there is none)
unless the caller names another device, `--device cpu` for tests.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..ops.vocab import Vocabulary, default_vocabulary
from ..utils import datasets
from ..utils.config import DatasetConfig, Settings
from ..utils.device import default_device
from ..utils.logging import get_logger, set_log_level

_log = get_logger("cli")


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-v", "--voc", default="", help="vocabulary file (.npz)")
    p.add_argument("-d", "--dataset", default="", help="dataset config yaml")
    p.add_argument("-l", "--log", default="info", help="log level")
    p.add_argument("-u", "--viewer", action="store_true", help="(ignored: headless)")
    p.add_argument("-m", "--mapviewer", action="store_true", help="(ignored: headless)")
    p.add_argument("-o", "--out", default="outputs", help="output directory")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic world (no dataset files)")
    p.add_argument("--frames", type=int, default=120, help="synthetic frame count")
    p.add_argument("--features", type=int, default=0,
                   help="override ORBextractor.nFeatures")
    p.add_argument("--wire", default=None, choices=["msgpack", "boost-text"],
                   help="outbound wire format (boost-text = reference-"
                        "compatible archives; decode auto-sniffs both)")
    p.add_argument("--save-map", default="",
                   help="write the client map checkpoint here on exit "
                        "(reference: System::SaveMap, map-client-<id>.bin)")
    p.add_argument("--load-map", default="",
                   help="load a map checkpoint before tracking "
                        "(reference: System::LoadMap)")
    p.add_argument("--device", default="",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")
    return p


def device_of(args) -> torch.device:
    """The device the CLI runs on: --device, else the card."""
    return torch.device(args.device) if args.device else default_device()


def apply_wire(args):
    if getattr(args, "wire", None):
        from ..sync import codec

        codec.set_wire_mode(args.wire)


def load_vocab(path: str) -> Vocabulary:
    """Load a vocabulary by extension: .npz (native), .bin (reference
    DBoW2 binary, e.g. ORBvoc.bin — README.md:139), .txt (DBoW2 text)."""
    if path and Path(path).exists():
        _log.info("loading vocabulary %s", path)
        suffix = Path(path).suffix.lower()
        if suffix == ".bin":
            return Vocabulary.load_dbow2_bin(path)
        if suffix == ".txt":
            return Vocabulary.load_dbow2_txt(path)
        return Vocabulary.load(path)
    _log.info("using built-in default vocabulary")
    return default_vocabulary()


def load_world(args, n_agents: int):
    """Returns (settings, [ImageSequence])."""
    if args.synthetic or not args.dataset:
        seqs = [
            datasets.synthesize_sequence(
                n_frames=args.frames, hw=(480, 640), agent=a, n_points=800
            )
            for a in range(n_agents)
        ]
        world = seqs[0].world
        from ..utils.config import CameraConfig, OrbConfig

        settings = Settings(
            camera=CameraConfig(
                fx=float(world.K[0, 0]), fy=float(world.K[1, 1]),
                cx=float(world.K[0, 2]), cy=float(world.K[1, 2]),
                fps=20.0, width=640, height=480,
            ),
            orb=OrbConfig(),
        )
    else:
        cfg = DatasetConfig.load(args.dataset)
        settings = Settings.load(cfg.setting)
        seqs = []
        sensor = getattr(args, "sensor", "mono")
        for a in range(min(n_agents, cfg.n_agents)):
            times = cfg.times[a] if a < len(cfg.times) else None
            seqs.append(datasets.load_sequence(
                cfg.type, cfg.images[a], times, sensor=sensor,
                depth_factor=settings.depth_map_factor,
            ))
    if args.features:
        settings.orb.n_features = args.features
    set_log_level(args.log)
    return settings, seqs
