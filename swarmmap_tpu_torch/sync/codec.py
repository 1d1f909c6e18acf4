"""Wire codec for map slices, requests, and system state.

Reference counterpart: BoostArchiver.h + MapUpdater::Serialize — the
reference ships boost TEXT archives over websockets (MapUpdater.cc:196).
This rebuild defaults to a compact msgpack binary layout (numpy arrays
as dtype/shape/bytes triples), which is both the wire format and the map
file format.  For mixed swarms (rebuild client <-> reference server or
vice versa) the OUTBOUND wire can be switched to the reference's boost
text-archive grammar with ``SWARMMAP_WIRE=boost-text`` (or
``set_wire_mode``); decoders auto-sniff both formats either way, so a
mixed deployment only needs the flag on the rebuild side.

Copy of swarmmap_tpu/sync/codec.py that packs through `msgpack_wire`
instead of the `msgpack` package, to the same bytes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from . import msgpack_wire
from .oplog import MapSlice, UpdateRecord

WIRE_VERSION = 1

_WIRE_MODES = ("msgpack", "boost-text")
_wire_mode = os.environ.get("SWARMMAP_WIRE", "msgpack")
if _wire_mode not in _WIRE_MODES:  # pragma: no cover - config error
    raise ValueError(f"SWARMMAP_WIRE must be one of {_WIRE_MODES}")


def set_wire_mode(mode: str):
    """Select the outbound wire format ('msgpack' | 'boost-text').
    Reference interop: ClientService.cc:113-172 + MapUpdater.cc:192-230
    always speak boost text; decode auto-sniffs, so only encode switches."""
    global _wire_mode
    if mode not in _WIRE_MODES:
        raise ValueError(f"wire mode must be one of {_WIRE_MODES}")
    _wire_mode = mode


def wire_mode() -> str:
    return _wire_mode


# --------------------------------------------------------------------------
# numpy-aware msgpack
# --------------------------------------------------------------------------

def _default(obj):
    if isinstance(obj, np.ndarray):
        return {
            b"__nd__": True,
            b"d": obj.dtype.str,
            b"s": list(obj.shape),
            b"b": obj.tobytes(),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"unserializable: {type(obj)}")


def _object_hook(obj):
    if b"__nd__" in obj or "__nd__" in obj:
        d = obj.get(b"d", obj.get("d"))
        s = obj.get(b"s", obj.get("s"))
        b = obj.get(b"b", obj.get("b"))
        return np.frombuffer(b, dtype=np.dtype(d)).reshape(s).copy()
    return obj


def _looks_like_msgpack_slice(data: bytes) -> bool:
    """Our slices pack as a msgpack map (first byte 0x80-0x8f / 0xde/df);
    reference .bin map files (boost binary, no_header) start with the
    Map* class-id int16 = 00 00."""
    return bool(data) and (0x80 <= data[0] <= 0x8F or data[0] in (0xDE, 0xDF))


def pack(obj: Any) -> bytes:
    return msgpack_wire.packb(obj, default=_default)


def unpack(data: bytes) -> Any:
    return msgpack_wire.unpackb(data, object_hook=_object_hook)


# --------------------------------------------------------------------------
# MapSlice
# --------------------------------------------------------------------------

def _update_to_wire(r: UpdateRecord) -> list:
    return [r.seq, r.kind, r.func, r.target, list(r.args)]


def _update_from_wire(x: list) -> UpdateRecord:
    return UpdateRecord(seq=x[0], kind=x[1], func=x[2], target=x[3],
                        args=tuple(x[4]))


def encode_slice(sl: MapSlice) -> bytes:
    if _wire_mode == "boost-text":
        from . import boost_text

        return boost_text.encode_slice(sl)
    return pack({
        "v": WIRE_VERSION,
        "map_id": sl.map_id,
        "kfs": sl.kfs,
        "mps": sl.mps,
        "updates": [_update_to_wire(u) for u in sl.updates],
        "twl": list(sl.twl) if sl.twl is not None else None,
        "epoch": sl.epoch,
    })


def decode_slice(data: bytes) -> MapSlice:
    if data.startswith(b"22 serialization::archive"):
        # slice pushed by a reference client (MapUpdater::Serialize)
        from . import boost_text

        return boost_text.decode_slice(data)
    if not _looks_like_msgpack_slice(data):
        # reference map-*.bin checkpoint (boost binary archive with
        # no_header; System::SaveMap) — import as a full slice
        from . import boost_bin

        kfs, mps, _inv, _maxid = boost_bin.decode_map_bin(data)
        mid = kfs[0]["gid"] // 10**6 if kfs else 0
        return MapSlice(map_id=mid, kfs=kfs, mps=mps, updates=[], twl=None)
    d = unpack(data)
    assert d["v"] == WIRE_VERSION, f"wire version mismatch: {d['v']}"
    kfs = [{k: _fix_tuple(k, v) for k, v in p.items()} for p in d["kfs"]]
    return MapSlice(
        map_id=d["map_id"],
        kfs=kfs,
        mps=d["mps"],
        updates=[_update_from_wire(u) for u in d["updates"]],
        twl=tuple(d["twl"]) if d["twl"] is not None else None,
        epoch=d.get("epoch"),
    )


def _fix_tuple(key, v):
    return tuple(v) if key == "hw" else v


# --------------------------------------------------------------------------
# Request / SystemState (reference: WebSocket.h:22-29, BoostArchiver.h:269-286)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    src: int
    dst: int
    path: str        # ReportState | PushMap | DistributeMap | Register ...
    body: bytes

    def encode(self) -> bytes:
        if _wire_mode == "boost-text":
            from . import boost_text

            return boost_text.encode_request(self)
        return pack([self.src, self.dst, self.path, self.body])

    @classmethod
    def decode(cls, data: bytes) -> "Request":
        if data.startswith(b"22 serialization::archive"):
            # reference peer: boost text-archive wire (BoostArchiver.h)
            from . import boost_text

            return boost_text.decode_request(data)
        src, dst, path, body = unpack(data)
        return cls(src=src, dst=dst, path=path, body=body)


def encode_register_reply(agent_id: int, port: int) -> bytes:
    """Dispatch reply body.  Reference grammar is the literal text
    "id port" (server.cc DispatchId; parsed at ClientService.cc:113-172)
    — used verbatim in boost-text mode."""
    if _wire_mode == "boost-text":
        return f"{agent_id} {port}".encode()
    return pack([agent_id, port])


def decode_register_reply(body: bytes) -> tuple[int, int]:
    try:
        a, p = body.split()
        return int(a), int(p)
    except ValueError:
        a, p = unpack(body)
        return int(a), int(p)


def encode_state(state) -> bytes:
    """SystemState (core.tracking.SystemState) -> bytes."""
    if _wire_mode == "boost-text":
        from . import boost_text

        return boost_text.encode_state(state)
    return pack([
        np.asarray(state.location, np.float32),
        bool(state.velocity_burst),
        bool(state.stable),
        int(state.n_tracked),
        int(state.lost_count),
    ])


def decode_state(data: bytes):
    from ..core.tracking import SystemState

    if data.startswith(b"22 serialization::archive"):
        from . import boost_text

        return boost_text.decode_state(data)
    loc, burst, stable, n_tracked, lost = unpack(data)
    return SystemState(location=loc, velocity_burst=burst, stable=stable,
                       n_tracked=n_tracked, lost_count=lost)
