"""Logging (reference counterpart: code/include/CLogger.h — spdlog singleton).

Copy of swarmmap_tpu/utils/logging.py; both packages log under the
"swarmmap" logger.

Pattern mirrors the reference's ``[HH:MM:SS][tid][level][func:line]`` format
(CLogger.h:65) so logs stay diff-able against reference runs.
"""
from __future__ import annotations

import logging
import sys
import threading

_FMT = "[%(asctime)s][%(thread)d][%(levelname).1s][%(funcName)s:%(lineno)d] %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False
_lock = threading.Lock()

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def _configure() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        root = logging.getLogger("swarmmap")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True


def get_logger(name: str = "") -> logging.Logger:
    _configure()
    return logging.getLogger("swarmmap" + ("." + name if name else ""))


def set_log_level(level: str | int) -> None:
    """Set global level from a CLI string ('debug', 'info', ...) or int."""
    _configure()
    if isinstance(level, str):
        level = _LEVELS[level.lower()]
    logging.getLogger("swarmmap").setLevel(level)
