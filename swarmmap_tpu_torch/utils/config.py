"""Config loading: OpenCV-style YAML settings + dataset configs.

Copy of swarmmap_tpu/utils/config.py, except that the files are read
without PyYAML: `load_opencv_yaml` parses the flat cv::FileStorage subset
the config files use (one `key: value` per line, comments, plain and
quoted scalars, flow lists) and resolves plain scalars by PyYAML's YAML
1.1 rules, so it returns what `yaml.safe_load` gives after the JAX
loader's pre-pass.  Anything outside the subset raises ValueError.

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
    try:
        return _parse_flat_mapping(lines)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# -- the flat YAML subset ------------------------------------------------------
# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1), tried in this
# order on a plain scalar whose first character is in the resolver's set.
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)(?::(?P<tz_minute>[0-9][0-9]))?))?)?$""",
    re.X)
_TIMESTAMP_IMPLICIT = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# characters that cannot start a plain scalar (PyYAML's scanner)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_MISSING = object()  # no node before a flow list's ',' or ']'


def _sexagesimal(value: str, cast):
    out = cast(0)
    for part in value.split(":"):
        out = out * 60 + cast(part)
    return out


def _resolve(s: str):
    """A plain scalar as PyYAML's SafeLoader resolves and constructs it."""
    first = s[:1]
    if first in set("yYnNtTfFoO") and _BOOL.match(s):
        return _BOOL_VALUES[s.lower()]
    if first in set("-+0123456789.") and _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if first in set("-+0123456789") and _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if first in set("~nN") and _NULL.match(s) or s == "":
        return None
    if first.isdigit() and _TIMESTAMP_IMPLICIT.match(s):
        return _timestamp(s)
    if s in ("<<", "="):
        raise ValueError(f"unsupported scalar {s!r}")
    return s


def _timestamp(s: str):
    import datetime

    v = _TIMESTAMP.match(s).groupdict()
    date = datetime.date(int(v["year"]), int(v["month"]), int(v["day"]))
    if not v["hour"]:
        return date
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(date.year, date.month, date.day, int(v["hour"]),
                             int(v["minute"]), int(v["second"]), fraction, tzinfo=tz)


class _Cursor:
    """A position in one logical line (a flow list may span lines)."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def peek(self) -> str:
        return self.text[self.i:self.i + 1]

    def skip_space(self):
        while self.peek() in (" ", "\t", "\n"):
            self.i += 1

    def at_comment(self) -> bool:
        """At a '#' that starts a comment (first, or after whitespace)."""
        return self.peek() == "#" and (self.i == 0 or self.text[self.i - 1] in " \t\n")


def _quoted(cur: _Cursor) -> str:
    q = cur.peek()
    cur.i += 1
    out = []
    while True:
        ch = cur.peek()
        if not ch:
            raise ValueError("unterminated quoted scalar")
        cur.i += 1
        if ch == q:
            if q == "'" and cur.peek() == "'":
                out.append("'")
                cur.i += 1
                continue
            break
        if ch == "\n":
            raise ValueError("multi-line quoted scalars are not supported")
        if q == '"' and ch == "\\":
            e = cur.peek()
            cur.i += 1
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = cur.text[cur.i:cur.i + n]
                if len(code) != n or any(c not in "0123456789abcdefABCDEF" for c in code):
                    raise ValueError(f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                cur.i += n
            else:
                raise ValueError(f"unknown escape \\{e}")
        else:
            out.append(ch)
    return "".join(out)


def _plain(cur: _Cursor, flow: bool) -> str:
    """A plain scalar: up to ': ', ' #', the line's end and, in a flow
    list, ',' ']' '[' '{' '}'."""
    start = cur.i
    stops = ",[]{}" if flow else ""
    while True:
        ch = cur.peek()
        if not ch or ch == "\n" and not flow or ch in stops:
            break
        if ch == ":" and cur.text[cur.i + 1:cur.i + 2] in ("", " ", "\t", "\n") + (
                tuple(",[]{}") if flow else ()):
            raise ValueError("mappings inside a value are not supported")
        if ch in " \t\n" and cur.text[cur.i + 1:cur.i + 2] == "#":
            break
        cur.i += 1
    # line breaks inside a flow scalar fold to one space
    return " ".join(cur.text[start:cur.i].split("\n")).strip(" \t")


def _node(cur: _Cursor, flow: bool):
    if flow:
        cur.skip_space()
    ch = cur.peek()
    if ch in ("'", '"'):
        return _quoted(cur)
    if ch == "[":
        return _flow_list(cur)
    nxt = cur.text[cur.i + 1:cur.i + 2]
    if ch in _INDICATORS and not (ch in "-?:" and nxt not in ("", " ", "\t", "\n")):
        if flow and ch in ",]":
            return _MISSING
        if cur.at_comment():
            return None
        raise ValueError(f"unsupported value starting with {ch!r}")
    return _resolve(_plain(cur, flow))


def _flow_list(cur: _Cursor) -> list:
    cur.i += 1  # '['
    out = []
    while True:
        cur.skip_space()
        if cur.peek() == "]":
            cur.i += 1
            return out
        if not cur.peek():
            raise ValueError("unterminated flow list")
        item = _node(cur, flow=True)
        cur.skip_space()
        ch = cur.peek()
        if ch == ",":
            cur.i += 1
        elif ch != "]":
            raise ValueError(f"expected ',' or ']' in a flow list, got {ch!r}")
        if item is _MISSING:
            if ch == ",":
                raise ValueError("empty item in a flow list")
            continue
        out.append(item)


def _end_of_line(cur: _Cursor):
    while cur.peek() in (" ", "\t"):
        cur.i += 1
    if cur.peek() and not cur.at_comment():
        raise ValueError(f"unexpected {cur.text[cur.i:]!r} after a value")


def _parse_flat_mapping(lines: list[str]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        body = line.strip()
        if not body or body.startswith("#") or body == "---" and not out:
            continue
        if line[0] in " \t":
            raise ValueError(f"indented line {line!r}: only a flat mapping is supported")
        cur = _Cursor(line)
        key = _node_key(cur)
        cur.i += 1  # ':'
        rest = line[cur.i:].lstrip(" \t")
        if rest.startswith("["):
            # a flow list may continue on the next lines
            text = line
            while text.count("[") > text.count("]") and i < len(lines):
                text += "\n" + lines[i]
                i += 1
            cur = _Cursor(text)
            cur.i = len(line) - len(rest)
        else:
            while cur.peek() in (" ", "\t"):
                cur.i += 1
        value = _node(cur, flow=False)
        _end_of_line(cur)
        out[key] = value
    return out


def _node_key(cur: _Cursor):
    """The key of a `key: value` line, resolved as PyYAML resolves keys;
    leaves the cursor on the ':'."""
    text = cur.text
    if text[0] in ("'", '"'):
        key = _quoted(cur)
    else:
        if text[0] in _INDICATORS and not (text[0] in "-?:" and text[1:2] not in ("", " ", "\t")):
            raise ValueError(f"unsupported line {text!r}")
        m = re.match(r"(.*?)[ \t]*:(?:[ \t]|$)", text)
        if m is None or " #" in m.group(1) or "\t#" in m.group(1):
            raise ValueError(f"not a 'key: value' line: {text!r}")
        cur.i = len(m.group(1))
        key = _resolve(m.group(1))
    while cur.peek() in (" ", "\t"):
        cur.i += 1
    if cur.peek() != ":" or cur.text[cur.i + 1:cur.i + 2] not in ("", " ", "\t"):
        raise ValueError(f"not a 'key: value' line: {text!r}")
    return key


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
