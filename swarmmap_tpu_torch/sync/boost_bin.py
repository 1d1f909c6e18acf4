"""Boost *binary*-archive codec — the reference's `.bin` map files.

`System::SaveMap` / `AgentMediator::SaveMap` write boost binary archives
with `no_header` (System.cc:349-368, AgentMediator.cc:88-138): a `Map*`
pointer (Map body per BoostArchiver.h:232-243 — point/keyframe pointer
sets, origins, reference points, mnMaxKFid, mnBigChangeIdx, the
allMPs/allKFs id maps) followed by a `KeyFrameDatabase*` (inverted file,
BoostArchiver.h:221-229).  `System::LoadMap` and `relocalizer.cc`
round-trip them.

The binary grammar shares the text archives' class-metadata state
machine (docs/boost_wire.md) with raw little-endian primitive tokens:

| token | bytes | boost source |
|---|---|---|
| bool / tracking / (u)char | 1 | `basic_binary_oprimitive::save` |
| int / unsigned int | 4 | same |
| long / size_t | 8 (LP64) | same |
| float / double | 4 / 8 raw | same |
| std::string | size_t len + raw bytes | `save_override(std::string)` |
| class_id(_reference) | int_least16_t (2) | `basic_binary_oarchive.hpp` |
| object_id(_reference) | uint_least32_t (4) | same |
| class version | uint_least8_t (1) | same (library_version ≥ 7) |
| collection count | size_t (8) | collection_size_type (≥ 6) |
| cv::Mat data | raw bytes (`save_binary`) | array optimization |

`class_id_optional` is a no-op (by-value classes print no id), identical
to text archives.  Objects serialized through pointers are tracked, and
the reference's Map aliases every element (the same MapPoint* appears in
mspMapPoints AND allMPs), so repeat pointers emit only an
object_reference — the codec resolves those through its object table.

Certification status: widths follow the boost serialization sources for
1.58+ on LP64 Linux (the reference's tested platforms); no boost exists
in this container, so fixtures are self-consistent round-trips —
capture-replay against a reference build remains (PARITY.md).

Copy of swarmmap_tpu/sync/boost_bin.py (plain Python and numpy).
"""
from __future__ import annotations

import struct

import numpy as np

from .boost_text import (
    CV_8U, CV_32F, CV_64F, ULONG_MAX,
    _decode_keyframe, _decode_mappoint, _encode_keyframe, _encode_mappoint,
)

NULL_POINTER_CLASS_ID = -1


class BinWriter:
    """Same schema interface as boost_text._Writer, binary tokens."""

    def __init__(self):
        self.parts: list[bytes] = []
        self._class_ids: dict = {}
        self._class_info_done: set = set()
        self._next_object_id = 0

    # -- primitives -------------------------------------------------------
    def _raw(self, b: bytes):
        self.parts.append(b)

    def bool_(self, v):
        self._raw(b"\x01" if v else b"\x00")

    def int_(self, v):
        self._raw(struct.pack("<i", int(v)))

    def uint(self, v):
        v = int(v)
        if v < 0:
            v += 1 << 64
        self._raw(struct.pack("<Q", v))

    def f32(self, v):
        self._raw(struct.pack("<f", float(v)))

    def f64(self, v):
        self._raw(struct.pack("<d", float(v)))

    def string(self, s):
        b = s.encode() if isinstance(s, str) else bytes(s)
        self._raw(struct.pack("<Q", len(b)) + b)

    # metadata-width tokens
    def _class_id_tok(self, cid: int):
        self._raw(struct.pack("<h", cid))

    def _object_id_tok(self, oid: int):
        self._raw(struct.pack("<I", oid))

    def _version_tok(self, v: int):
        self._raw(struct.pack("<B", v))

    # -- class machinery ---------------------------------------------------
    def _class_id(self, key) -> int:
        if key not in self._class_ids:
            self._class_ids[key] = len(self._class_ids)
        return self._class_ids[key]

    def begin_value(self, key, tracked: bool = False, version: int = 0):
        self._class_id(key)
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_(tracked)
            self._version_tok(version)
        if tracked:
            self._object_id_tok(self._next_object_id)
            self._next_object_id += 1

    def begin_pointer(self, key, version: int = 0, obj=None) -> bool:
        """Returns True when the body must follow (first occurrence);
        False when `obj` was already serialized (reference emitted)."""
        cid = self._class_id(key)
        self._class_id_tok(cid)
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_(True)
            self._version_tok(version)
        if obj is not None:
            seen = getattr(self, "_objects", None)
            if seen is None:
                seen = self._objects = {}
            oid = seen.get(id(obj))
            if oid is not None:
                self._object_id_tok(oid)
                return False
            seen[id(obj)] = self._next_object_id
        self._object_id_tok(self._next_object_id)
        self._next_object_id += 1
        return True

    def null_pointer(self):
        self._class_id_tok(NULL_POINTER_CLASS_ID)

    def begin_collection(self, key, count: int, item_version: int = 0):
        self._class_id(key)
        self.uint(count)
        self._version_tok(item_version)

    # -- composite types ---------------------------------------------------
    def mat(self, arr: np.ndarray | None, cvtype: int = CV_32F):
        self.begin_value("cv::Mat")
        if arr is None or arr.size == 0:
            self.int_(0)
            self.int_(0)
            self.int_(0)
            self.bool_(True)
            return
        arr = np.atleast_2d(np.asarray(arr))
        rows, cols = arr.shape
        self.int_(cols)
        self.int_(rows)
        self.int_(cvtype)
        self.bool_(True)
        dt = {CV_8U: "<u1", CV_32F: "<f4", CV_64F: "<f8"}[cvtype]
        self._raw(np.ascontiguousarray(arr.astype(dt)).tobytes())

    def keypoint(self, x, y, size, angle, response, octave, class_id=-1):
        self.begin_value("cv::KeyPoint")
        self.f32(x); self.f32(y); self.f32(size)
        self.f32(angle); self.f32(response)
        self.int_(octave); self.int_(class_id)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class BinReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._class_info_done: set = set()
        self._classes_by_id: dict[int, object] = {}
        self._next_class_id = 0
        self._objects: dict[int, object] = {}
        self._next_object_id = 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated boost binary archive")
        self.pos += n
        return out

    def bool_(self) -> bool:
        return self._take(1) != b"\x00"

    def int_(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def uint(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self._take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def string(self) -> bytes:
        return self._take(self.uint())

    def _class_id_tok(self) -> int:
        return struct.unpack("<h", self._take(2))[0]

    def _object_id_tok(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def _version_tok(self) -> int:
        return self._take(1)[0]

    def begin_value(self, key, tracked: bool = False):
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            tracked = self.bool_()
            self._version_tok()
        if tracked:
            self._object_id_tok()

    def begin_pointer(self):
        """Returns (class_key, object_id, is_reference)."""
        cid = self._class_id_tok()
        if cid == NULL_POINTER_CLASS_ID:
            return None, None, False
        key = self._classes_by_id.get(cid)
        if key is None:
            key = ("anon", cid)
            self._classes_by_id[cid] = key
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_()
            self._version_tok()
        oid = self._object_id_tok()
        is_ref = oid < self._next_object_id
        if not is_ref:
            self._next_object_id = oid + 1
        return key, oid, is_ref

    def begin_collection(self) -> int:
        count = self.uint()
        self._version_tok()
        return count

    def mat(self):
        self.begin_value("cv::Mat")
        cols = self.int_()
        rows = self.int_()
        cvtype = self.int_()
        self.bool_()
        n = rows * cols
        if n == 0:
            return None, cvtype
        dt = {CV_8U: ("<u1", 1), CV_32F: ("<f4", 4), CV_64F: ("<f8", 8)}[cvtype]
        raw = self._take(n * dt[1])
        return np.frombuffer(raw, dt[0]).reshape(rows, cols).copy(), cvtype

    def keypoint(self):
        self.begin_value("cv::KeyPoint")
        x = self.f32(); y = self.f32(); size = self.f32()
        angle = self.f32(); response = self.f32()
        octave = self.int_(); self.int_()
        return x, y, size, angle, response, octave


# ===========================================================================
# Map + KeyFrameDatabase  (.bin map files)
# ===========================================================================

def encode_map_bin(kfs: list[dict], mps: list[dict],
                   inverted_file: list[list[int]] | None = None,
                   max_kf_id: int | None = None) -> bytes:
    """Our keyframe/map-point payload dicts (oplog._kf_payload /
    _mp_payload) -> a reference-loadable `map-*.bin` byte stream."""
    w = BinWriter()
    # oa << mpMap  (pointer to non-polymorphic Map)
    w.begin_pointer("Map")
    mp_handles = [object() for _ in mps]
    kf_handles = [object() for _ in kfs]

    def save_mp_ptr(i):
        if w.begin_pointer("MapPoint", obj=mp_handles[i]):
            _encode_mappoint(w, mps[i])

    def save_kf_ptr(i):
        if w.begin_pointer("KeyFrame", obj=kf_handles[i]):
            _encode_keyframe(w, kfs[i])

    # mspMapPoints : std::set<MapPoint*>
    w.begin_collection(("set", "MapPoint*"), len(mps))
    for i in range(len(mps)):
        save_mp_ptr(i)
    # mvpKeyFrameOrigins : vector<KeyFrame*> (the first keyframe)
    origins = [0] if kfs else []
    w.begin_collection(("vec", "KeyFrame*"), len(origins))
    for i in origins:
        save_kf_ptr(i)
    # mspKeyFrames : std::set<KeyFrame*>
    w.begin_collection(("set", "KeyFrame*"), len(kfs))
    for i in range(len(kfs)):
        save_kf_ptr(i)
    # mvpReferenceMapPoints : vector<MapPoint*> (ship empty; rebuilt live)
    w.begin_collection(("vec", "MapPoint*"), 0)
    w.uint(max_kf_id if max_kf_id is not None
           else (max((p["gid"] for p in kfs), default=0)))  # mnMaxKFid
    w.int_(0)                                               # mnBigChangeIdx
    # allMPs / allKFs : map<unsigned long, T*> — aliases of the sets above
    w.begin_collection(("map", "u64_MapPoint*"), len(mps))
    for i, p in enumerate(mps):
        w.begin_value(("pair", "u64_MapPoint*"))
        w.uint(p["gid"])
        save_mp_ptr(i)
    w.begin_collection(("map", "u64_KeyFrame*"), len(kfs))
    for i, p in enumerate(kfs):
        w.begin_value(("pair", "u64_KeyFrame*"))
        w.uint(p["gid"])
        save_kf_ptr(i)
    # oa << mpKeyFrameDatabase
    w.begin_pointer("KeyFrameDatabase")
    inv = inverted_file or []
    w.begin_collection(("vec", "list_u64"), len(inv))
    for row in inv:
        w.begin_collection(("list", "u64"), len(row))
        for gid in row:
            w.uint(gid)
    return w.getvalue()


def decode_map_bin(data: bytes):
    """Reference `map-*.bin` -> (kf payload dicts, mp payload dicts,
    inverted_file, max_kf_id)."""
    r = BinReader(data)
    key, _oid, _ = r.begin_pointer()          # Map*
    if key is None:
        raise ValueError("null Map pointer in archive")
    mps_by_oid: dict[int, dict] = {}
    kfs_by_oid: dict[int, dict] = {}

    def load_mp_ptr():
        k, oid, is_ref = r.begin_pointer()
        if k is None:
            return None
        if is_ref:
            return mps_by_oid.get(oid)
        p = _decode_mappoint(r)
        mps_by_oid[oid] = p
        return p

    def load_kf_ptr():
        k, oid, is_ref = r.begin_pointer()
        if k is None:
            return None
        if is_ref:
            return kfs_by_oid.get(oid)
        p = _decode_keyframe(r)
        kfs_by_oid[oid] = p
        return p

    mps = []
    for _ in range(r.begin_collection()):      # mspMapPoints
        p = load_mp_ptr()
        if p is not None:
            mps.append(p)
    for _ in range(r.begin_collection()):      # mvpKeyFrameOrigins
        load_kf_ptr()
    kfs = []
    for _ in range(r.begin_collection()):      # mspKeyFrames
        p = load_kf_ptr()
        if p is not None:
            kfs.append(p)
    for _ in range(r.begin_collection()):      # mvpReferenceMapPoints
        load_mp_ptr()
    max_kf_id = r.uint()
    r.int_()                                   # mnBigChangeIdx
    for _ in range(r.begin_collection()):      # allMPs
        r.begin_value(("pair", "u64_MapPoint*"))
        r.uint()
        load_mp_ptr()
    for _ in range(r.begin_collection()):      # allKFs
        r.begin_value(("pair", "u64_KeyFrame*"))
        r.uint()
        load_kf_ptr()
    key, _oid, _ = r.begin_pointer()          # KeyFrameDatabase*
    inverted = []
    if key is not None:
        for _ in range(r.begin_collection()):
            row = [r.uint() for _i in range(r.begin_collection())]
            inverted.append(row)
    return kfs, mps, inverted, max_kf_id
