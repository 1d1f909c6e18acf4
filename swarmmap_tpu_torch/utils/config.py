"""Config loading: OpenCV-style YAML settings + dataset configs.

Copy of swarmmap_tpu/utils/config.py.  PyYAML is imported only inside
the YAML loaders, so `Settings(...)` works on a machine without it.

The reference uses cv::FileStorage YAML in two tiers (SURVEY.md §5):
  1. dataset config: TYPE / SETTING / IMAGES / TIMES / HOST / PORT
     (reference: config/mh123.yaml, parsed at swarm_map.cc:198-219)
  2. camera/ORB settings: Camera.*, ORBextractor.*, Viewer.*
     (reference: code/Examples/Monocular/EuRoC.yaml, parsed Tracking.cc:50-128)

We parse the same files byte-for-byte, including cv::FileStorage quirks
('%YAML:1.0' directive, missing space after ':').
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

import numpy as np


def load_opencv_yaml(path: str | Path) -> dict[str, Any]:
    """Load a cv::FileStorage-flavoured YAML file into a flat dict."""
    import yaml  # only the YAML loaders need PyYAML

    text = Path(path).read_text()
    lines = []
    for line in text.splitlines():
        if line.startswith("%YAML"):
            continue
        # cv::FileStorage allows "Key:value" without the space
        m = re.match(r"^(\s*[A-Za-z0-9_.\-]+):(\S.*)$", line)
        if m and not line.lstrip().startswith("#"):
            line = f"{m.group(1)}: {m.group(2)}"
        lines.append(line)
    data = yaml.safe_load("\n".join(lines)) or {}
    if not isinstance(data, dict):
        raise ValueError(f"expected a mapping in {path}")
    return data


@dataclasses.dataclass
class CameraConfig:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: int = 1
    width: int = 0   # optional; inferred from first image if 0
    height: int = 0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def dist(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float32)


@dataclasses.dataclass
class OrbConfig:
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    max_keypoints: int = 10000  # pre-distribution cap (reference: cuda/Fast.hpp:30)


@dataclasses.dataclass
class Settings:
    """Camera + ORB settings (tier 2)."""

    camera: CameraConfig
    orb: OrbConfig
    viewer: dict[str, float] = dataclasses.field(default_factory=dict)
    depth_map_factor: float = 5000.0   # TUM RGB-D depth png scaling
    bf: float = 0.0                    # stereo baseline * fx (KITTI)

    @classmethod
    def load(cls, path: str | Path) -> "Settings":
        d = load_opencv_yaml(path)
        cam = CameraConfig(
            fx=float(d["Camera.fx"]), fy=float(d["Camera.fy"]),
            cx=float(d["Camera.cx"]), cy=float(d["Camera.cy"]),
            k1=float(d.get("Camera.k1", 0.0)), k2=float(d.get("Camera.k2", 0.0)),
            p1=float(d.get("Camera.p1", 0.0)), p2=float(d.get("Camera.p2", 0.0)),
            k3=float(d.get("Camera.k3", 0.0)), fps=float(d.get("Camera.fps", 30.0)),
            rgb=int(d.get("Camera.RGB", 1)),
            width=int(d.get("Camera.width", 0)), height=int(d.get("Camera.height", 0)),
        )
        orb = OrbConfig(
            n_features=int(d.get("ORBextractor.nFeatures", 1000)),
            scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(d.get("ORBextractor.nLevels", 8)),
            ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        )
        viewer = {k.split(".", 1)[1]: float(v) for k, v in d.items()
                  if k.startswith("Viewer.")}
        return cls(camera=cam, orb=orb, viewer=viewer,
                   depth_map_factor=float(d.get("DepthMapFactor", 5000.0)),
                   bf=float(d.get("Camera.bf", 0.0)))

    @classmethod
    def default(cls) -> "Settings":
        """EuRoC-like defaults, used by tests and synthetic runs."""
        return cls(
            camera=CameraConfig(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                                fps=20.0, width=752, height=480),
            orb=OrbConfig(),
        )


@dataclasses.dataclass
class DatasetConfig:
    """Dataset config (tier 1; reference: config/*.yaml)."""

    type: str                    # 'euroc' | 'tum' | 'kitti' | 'synthetic'
    setting: str                 # path to the Settings YAML
    images: list[str]            # one image dir per agent
    times: list[str] = dataclasses.field(default_factory=list)
    host: str = "127.0.0.1"
    port: int = 2327

    @classmethod
    def load(cls, path: str | Path, root: str | Path | None = None) -> "DatasetConfig":
        """Resolve dataset paths against, in order: the literal path, the
        SWARMMAP_DATA env var (where datasets are mounted/downloaded),
        and the repo root (for SETTING files shipped under config/)."""
        import os

        d = load_opencv_yaml(path)
        root = Path(root) if root is not None else Path(path).parent.parent
        data_root = os.environ.get("SWARMMAP_DATA", "")

        def _abs(p: str) -> str:
            p = str(p)
            if Path(p).exists():
                return p
            if data_root and (Path(data_root) / p.lstrip("/")).exists():
                return str(Path(data_root) / p.lstrip("/"))
            return str(root / p.lstrip("/"))
        images = d.get("IMAGES", [])
        if isinstance(images, str):
            images = [images]
        times = d.get("TIMES", []) or []
        if isinstance(times, str):
            times = [times]
        return cls(
            type=str(d["TYPE"]).lower(),
            setting=_abs(d["SETTING"]),
            images=[_abs(p) for p in images],
            times=[_abs(p) for p in times],
            host=str(d.get("HOST", "127.0.0.1")),
            port=int(d.get("PORT", 2327)),
        )

    @property
    def n_agents(self) -> int:
        return len(self.images)
