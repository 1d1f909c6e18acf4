"""Build and load the package's native code (nvcc or g++, then ctypes).

Each kernel is one `csrc/<name>.cu` file with a plain C entry point.  It is
compiled at first use for Hopper (`sm_90a`) into
`swarmmap_tpu_torch/_build/<name>-<hash>.so`, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
from the cache.  No PyTorch headers are included: a build takes seconds.
Host C++ (`csrc/*.cc`) is built the same way with g++ (`load_host`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (CDLL, build record); one load per process
_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _load(name: str, compiler: list[str], sources: list[Path]) -> ctypes.CDLL:
    """Build `sources` with `compiler` into _build/<name>-<hash>.so unless
    the cache holds that build, then load it.  A failed build raises."""
    if name in _LOADED:
        return _LOADED[name][0]
    digest = hashlib.sha256(" ".join(compiler[1:]).encode())
    for src in sources:
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.txt")  # kept beside the build for cached loads
    record = {"name": name, "so": str(so), "cached": so.exists(), "seconds": 0.0,
              "ptxas": report.read_text() if report.exists() else ""}
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [*compiler, "-o", str(tmp), *(str(s) for s in sources)],
            capture_output=True, text=True,
        )
        record["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed for {name}:\n{proc.stderr}")
        record["ptxas"] = proc.stderr.strip()
        report.write_text(record["ptxas"])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = (lib, record)
    return lib


def load(name: str, src: str | Path | None = None) -> ctypes.CDLL:
    """Return the loaded library for csrc/<name>.cu (or for the source file
    `src`, loaded under `name`), building it first if the cache holds no
    build of that source."""
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    return _load(name, [_nvcc(), *NVCC_FLAGS], [src])


def load_host(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Return the loaded host library `name` built with g++ from the
    csrc/ files `sources` (no CUDA), building it first if needed."""
    return _load(name, ["g++", *GXX_FLAGS], [CSRC / s for s in sources])


def build_record(name: str) -> dict:
    """How csrc/<name>.cu was obtained in this process: build seconds,
    whether it came from the cache, and ptxas's register/spill report."""
    return dict(_LOADED[name][1])
