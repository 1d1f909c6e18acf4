"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each kernel is one `csrc/<name>.cu` file with a plain C entry point.  It is
compiled at first use for Hopper (`sm_90a`) into
`swarmmap_tpu_torch/_build/<name>-<hash>.so`, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
from the cache.  No PyTorch headers are included: a build takes seconds.
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


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for csrc/<name>.cu, building it first if
    the cache holds no build of the current source."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    record = {"name": name, "so": str(so), "cached": so.exists(),
              "seconds": 0.0, "ptxas": ""}
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        record["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        record["ptxas"] = proc.stderr.strip()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = (lib, record)
    return lib


def build_record(name: str) -> dict:
    """How csrc/<name>.cu was obtained in this process: build seconds,
    whether it came from the cache, and ptxas's register/spill report."""
    return dict(_LOADED[name][1])
