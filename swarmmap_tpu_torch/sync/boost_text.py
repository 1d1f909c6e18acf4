"""Boost text-archive wire codec — reference binary interop.

The reference serializes every network payload and map file with
boost::serialization *text* archives (BoostArchiver.h:297-315 toString /
toObject, src/MapUpdater.cc:191-230 Serialize/Deserialize).  This module
implements that grammar so byte streams produced by a reference client or
server can be decoded here, and streams we produce can be consumed by a
reference peer:

* ``Request``      — WebSocket.h:22 {src, dst, path, body}
* ``SystemState``  — SystemState.h:16 {location(cv::Mat), bVelocityBurst,
                     bStable, nTracked(u8), lostCount(size_t)}
* ``MapSlice``     — MapSlice.h:17 {vector<KeyFrame*>, vector<MapPoint*>,
                     vector<MapElementUpdateBase*>} with the full KeyFrame
                     (KeyFrame.h:309-404) and MapPoint (MapPoint.h:204-247)
                     member layouts and the 15 registered update types
                     (MapUpdater.cc:283-301).

Wire grammar (boost_1_65+ text archives; see docs/boost_wire.md for the
token-level layout and boost-source citations):

* header: ``22 serialization::archive <V>`` — a string (length-prefixed)
  plus the archive library version; all later tokens are single-space
  separated.
* primitives: integers/bools in decimal; float as ``%.9g``; double as
  ``%.17g``; (unsigned) char as decimal; std::string as
  ``<len> <raw bytes>``.
* by-value class object, first occurrence of its class: ``<tracking 0|1>
  <class version>`` (the class-id token is *optional* in text archives
  and omitted); tracked objects then carry an object id.
* pointer: ``<class id>`` (ids are allocated in boost registration /
  first-encounter order — the reference registers the 15 update types up
  front), then class info on first class use, then ``<object id>``, then
  the body; repeat pointers to the same object emit only the object id.
* STL collections: ``<count> <item version>`` then items; no class info
  (collections are object_serializable).  std::pair and cv types are
  classes (class info once).

Certification status: the grammar is implemented from the boost
serialization sources' documented behavior and validated by
self-roundtrips plus hand-constructed fixtures; the container has no
boost installation, so capture-replay against a real reference build is
recorded as the remaining step in PARITY.md.

Copy of swarmmap_tpu/sync/boost_text.py (plain Python and numpy).
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_LIBRARY_VERSION = 17
ULONG_MAX = (1 << 64) - 1
NULL_POINTER_CLASS_ID = -1

CV_8U, CV_32F, CV_64F = 0, 5, 6

# MapUpdater::RegisterType order (MapUpdater.cc:283-301): class ids 0..14.
# Each entry: (kind, arg schema)
REGISTERED_UPDATE_TYPES = [
    ("kf", "mat"),            # 0  KeyFrameUpdate<cv::Mat>
    ("kf", "pair_u64_i32"),   # 1  KeyFrameUpdate<pair<ulong,int>>
    ("kf", "pair_u64_u64"),   # 2  KeyFrameUpdate<pair<ulong,size_t>>
    ("kf", "u64"),            # 3  KeyFrameUpdate<size_t>
    ("kf", "pair_u64_u64b"),  # 4  KeyFrameUpdate<pair<size_t,ulong>>
    ("kf", "u64c"),           # 5  KeyFrameUpdate<unsigned long>
    ("kf", "i32"),            # 6  KeyFrameUpdate<int>
    ("mp", "mat"),            # 7  MapPointUpdate<cv::Mat>
    ("mp", "pair_u64_u64"),   # 8  MapPointUpdate<pair<ulong,size_t>>
    ("mp", "u64"),            # 9  MapPointUpdate<unsigned long>
    ("mp", "i32"),            # 10 MapPointUpdate<int>
    ("mp", "f64"),            # 11 MapPointUpdate<double>
    ("map", "u64"),           # 12 MapEventUpdate<unsigned long>
    ("map", "vec_u64"),       # 13 MapEventUpdate<vector<ulong>>
    ("map", "i32"),           # 14 MapEventUpdate<int>
]
N_REGISTERED = len(REGISTERED_UPDATE_TYPES)

_ARG_SCHEMA = {  # schema -> (base arg kind)
    "mat": "mat", "pair_u64_i32": "pair", "pair_u64_u64": "pair",
    "pair_u64_u64b": "pair", "u64": "u64", "u64c": "u64", "i32": "i32",
    "f64": "f64", "vec_u64": "vec_u64",
}


def _fmt_f32(v: float) -> str:
    # round through binary32 first: C++ streams the float value
    return "%.9g" % float(np.float32(v))


def _fmt_f64(v: float) -> str:
    return "%.17g" % float(v)


class _Writer:
    def __init__(self, library_version: int = DEFAULT_LIBRARY_VERSION):
        self.version = library_version
        self.parts: list[bytes] = []
        sig = b"serialization::archive"
        self.parts.append(b"%d %s %d" % (len(sig), sig, library_version))
        # class bookkeeping
        self._class_ids: dict = {}
        self._class_info_done: set = set()
        self._next_object_id = 0
        for i in range(N_REGISTERED):
            self._class_ids[("update", i)] = i

    # -- primitives -------------------------------------------------------
    def _tok(self, s: str | bytes):
        self.parts.append(s.encode() if isinstance(s, str) else s)

    def int_(self, v):
        self._tok(str(int(v)))

    def uint(self, v):
        v = int(v)
        if v < 0:
            v += 1 << 64
        self._tok(str(v))

    def bool_(self, v):
        self._tok("1" if v else "0")

    def f32(self, v):
        self._tok(_fmt_f32(v))

    def f64(self, v):
        self._tok(_fmt_f64(v))

    def string(self, s: bytes | str):
        b = s.encode() if isinstance(s, str) else bytes(s)
        self._tok(b"%d %s" % (len(b), b))

    # -- class machinery ---------------------------------------------------
    def _class_id(self, key) -> int:
        if key not in self._class_ids:
            self._class_ids[key] = len(self._class_ids)
        return self._class_ids[key]

    def begin_value(self, key, tracked: bool = False, version: int = 0):
        """By-value class entry (class-id token is optional => omitted)."""
        self._class_id(key)
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_(tracked)
            self.uint(version)
        if tracked:
            self.uint(self._next_object_id)
            self._next_object_id += 1

    def begin_pointer(self, key, version: int = 0):
        """Pointer entry: class id + first-time class info + object id."""
        cid = self._class_id(key)
        self.int_(cid)
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_(True)   # pointer-serialized classes are tracked
            self.uint(version)
        self.uint(self._next_object_id)
        self._next_object_id += 1

    def begin_collection(self, key, count: int, item_version: int = 0):
        self._class_id(key)
        self.uint(count)
        self.uint(item_version)

    # -- composite value types --------------------------------------------
    def pair(self, key, emit_first, emit_second):
        self.begin_value(("pair", key))
        emit_first()
        emit_second()

    def mat(self, arr: np.ndarray | None, cvtype: int = CV_32F):
        """cv::Mat per BoostArchiver.h:88-115."""
        self.begin_value("cv::Mat")
        if arr is None or arr.size == 0:
            self.int_(0)  # cols
            self.int_(0)  # rows
            self.int_(0)  # type
            self.bool_(True)
            return
        arr = np.atleast_2d(np.asarray(arr))
        rows, cols = arr.shape
        self.int_(cols)
        self.int_(rows)
        self.int_(cvtype)
        self.bool_(True)
        flat = arr.reshape(-1)
        if cvtype == CV_8U:
            for v in flat.astype(np.uint8).tolist():
                self.int_(v)
        elif cvtype == CV_64F:
            for v in flat.tolist():
                self.f64(v)
        else:
            for v in flat.tolist():
                self.f32(v)

    def keypoint(self, x, y, size, angle, response, octave, class_id=-1):
        self.begin_value("cv::KeyPoint")
        self.f32(x)
        self.f32(y)
        self.f32(size)
        self.f32(angle)
        self.f32(response)
        self.int_(octave)
        self.int_(class_id)

    def getvalue(self) -> bytes:
        return b" ".join(self.parts)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._class_info_done: set = set()
        self._classes_by_id: dict[int, object] = {
            i: ("update", i) for i in range(N_REGISTERED)
        }
        self._next_class_id = N_REGISTERED
        sig_len = self.uint()
        sig = self.raw(sig_len)
        if sig != b"serialization::archive":
            raise ValueError(f"not a boost text archive: {sig[:40]!r}")
        self.version = self.uint()
        if self.version < 6:
            raise ValueError(f"unsupported archive library version {self.version}")

    # -- primitives -------------------------------------------------------
    def _token(self) -> bytes:
        d, n = self.data, len(self.data)
        while self.pos < n and d[self.pos] in b" \n\t":
            self.pos += 1
        start = self.pos
        while self.pos < n and d[self.pos] not in b" \n\t":
            self.pos += 1
        if start == self.pos:
            raise ValueError("unexpected end of archive")
        return d[start:self.pos]

    def raw(self, n: int) -> bytes:
        # exactly one separator, then n raw bytes
        self.pos += 1
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated string in archive")
        self.pos += n
        return out

    def int_(self) -> int:
        return int(self._token())

    def uint(self) -> int:
        return int(self._token())

    def bool_(self) -> bool:
        return self._token() != b"0"

    def f32(self) -> float:
        return float(self._token())

    def f64(self) -> float:
        return float(self._token())

    def string(self) -> bytes:
        return self.raw(self.uint())

    # -- class machinery ---------------------------------------------------
    def begin_value(self, key, tracked: bool = False) -> int | None:
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            tracked = self.bool_()
            self.uint()  # class version
        oid = None
        if tracked:
            oid = self.uint()
        return oid

    def begin_pointer(self):
        """Returns (class_key, object_id) — class resolved from the id."""
        cid = self.int_()
        if cid == NULL_POINTER_CLASS_ID:
            return None, None
        key = self._classes_by_id.get(cid)
        if key is None:
            key = ("anon", cid)
            self._classes_by_id[cid] = key
        if key not in self._class_info_done:
            self._class_info_done.add(key)
            self.bool_()  # tracking (true for pointers)
            self.uint()   # class version
        oid = self.uint()
        return key, oid

    def register_encounter(self, key):
        """Mirror of the writer's id allocation for by-value classes that
        may later be pointed to (KeyFrame/MapPoint through their vectors)."""
        if key not in [v for v in self._classes_by_id.values()]:
            self._classes_by_id[self._next_class_id] = key
            self._next_class_id += 1

    def begin_collection(self) -> int:
        count = self.uint()
        self.uint()  # item version
        return count

    def mat(self) -> tuple[np.ndarray | None, int]:
        self.begin_value("cv::Mat")
        cols = self.int_()
        rows = self.int_()
        cvtype = self.int_()
        self.bool_()  # continuous
        n = rows * cols
        if n == 0:
            return None, cvtype
        if cvtype == CV_8U:
            vals = np.array([self.int_() for _ in range(n)], np.uint8)
        elif cvtype == CV_64F:
            vals = np.array([self.f64() for _ in range(n)], np.float64)
        elif cvtype == CV_32F:
            vals = np.array([self.f32() for _ in range(n)], np.float32)
        else:
            raise ValueError(f"unsupported cv type {cvtype}")
        return vals.reshape(rows, cols), cvtype

    def keypoint(self):
        self.begin_value("cv::KeyPoint")
        x = self.f32(); y = self.f32(); size = self.f32()
        angle = self.f32(); response = self.f32()
        octave = self.int_(); self.int_()  # class_id
        return x, y, size, angle, response, octave


# ===========================================================================
# Request  (WebSocket.h:22, BoostArchiver.h:269-276)
# ===========================================================================

def encode_request(req, library_version: int = DEFAULT_LIBRARY_VERSION) -> bytes:
    w = _Writer(library_version)
    w.begin_value("Request")
    w.uint(req.src)
    w.uint(req.dst)
    w.string(req.path)
    body = req.body if isinstance(req.body, (bytes, bytearray)) else str(req.body).encode()
    w.string(body)
    return w.getvalue()


def decode_request(data: bytes):
    from .codec import Request

    r = _Reader(data)
    r.begin_value("Request")
    src = r.uint()
    dst = r.uint()
    path = r.string().decode()
    body = r.string()
    return Request(src=src, dst=dst, path=path, body=body)


# ===========================================================================
# SystemState  (SystemState.h:16, BoostArchiver.h:278-286)
# ===========================================================================

def encode_state(state, library_version: int = DEFAULT_LIBRARY_VERSION) -> bytes:
    w = _Writer(library_version)
    w.begin_value("SystemState")
    loc = np.asarray(state.location, np.float32).reshape(-1, 1)
    w.mat(loc, CV_32F)
    w.bool_(state.velocity_burst)
    w.bool_(state.stable)
    w.int_(int(state.n_tracked) & 0xFF)   # uint8_t as decimal
    w.uint(state.lost_count)              # size_t
    return w.getvalue()


def decode_state(data: bytes):
    from ..core.tracking import SystemState

    r = _Reader(data)
    r.begin_value("SystemState")
    loc, _ = r.mat()
    loc = np.zeros(3, np.float32) if loc is None else loc.reshape(-1)
    burst = r.bool_()
    stable = r.bool_()
    n_tracked = r.int_()
    lost = r.uint()
    return SystemState(location=loc, velocity_burst=burst, stable=stable,
                       n_tracked=n_tracked, lost_count=lost)


# ===========================================================================
# Update records  (MapElementUpdate.h, MapUpdater.cc handler arg types)
# ===========================================================================

# our funcName -> registered class index (see reference construction sites)
_KF_FUNC_CLASS = {
    "SetPose": 0,               # KeyFrame.cc:139  <cv::Mat>
    "AddConnection": 1,         # KeyFrame.cc:261  <pair<ulong,int>>
    "AddMapPoint": 2,           # KeyFrame.cc:354  <pair<ulong,size_t>>
    "EraseMapPointMatch": 3,    # KeyFrame.cc:375  <size_t>
    "ReplaceMapPointMatch": 2,  # KeyFrame.cc:410  <pair<ulong,size_t>>
    "AddLoopEdge": 5,           # KeyFrame.cc:617  <unsigned long>
    "UpdateConnections": 6,     # KeyFrame.cc:471  <int>
    "SetBadFlag": 6,            # KeyFrame.cc:655  <int>
}
_MP_FUNC_CLASS = {
    "SetWorldPos": 7,           # MapPoint.cc:88   <cv::Mat>
    "AddObservation": 8,        # MapPoint.cc:154  <pair<ulong,size_t>>
    "EraseObservation": 9,      # MapPoint.cc:176  <unsigned long>
    "Replace": 9,               # MapPoint.cc:252  <unsigned long>
    "SetBadFlag": 10,           # MapPoint.cc:224  <int>
    "IncreaseVisible": 10,      # MapPoint.cc:296  <int>
    "IncreaseFound": 10,        # MapPoint.cc:311  <int>
    "SetVisible": 10,
    "SetFound": 10,
    "ComputeDistinctiveDescriptors": 10,  # MapPoint.cc:325 <int> trigger
    "UpdateNormalAndDepth": 10,           # MapPoint.cc:417 <int> trigger
    "SetLastTrackedTime": 11,   # MapPoint.cc:565  <double>
}
_MAP_FUNC_CLASS = {
    "AddLoopClosing": 12,       # LocalMapping.cc:89 <unsigned long>
    "AddOriginKeyFrame": 12,    # Map.cc:136 <unsigned long>
    "clear": 14,                # Map.cc:121 <int>
}
# triggers whose reference arg is a recompute token, not the payload we log
_TRIGGER_FUNCS = {"ComputeDistinctiveDescriptors", "UpdateNormalAndDepth"}


def _encode_update(w: _Writer, rec) -> bool:
    """One UpdateRecord as a registered polymorphic pointer; returns False
    when the record has no reference analogue."""
    table = {"kf": _KF_FUNC_CLASS, "mp": _MP_FUNC_CLASS, "map": _MAP_FUNC_CLASS}[rec.kind]
    cls = table.get(rec.func)
    if cls is None:
        return False
    kind, schema = REGISTERED_UPDATE_TYPES[cls]
    w.begin_pointer(("update", cls))
    # base: MapElementUpdateBase {id, mnId, funcName}
    w.begin_value("MapElementUpdateBase")
    w.uint(rec.seq)
    w.uint(rec.target)
    w.string(rec.func)
    # arg
    a = rec.args
    base = _ARG_SCHEMA[schema]
    if rec.func in _TRIGGER_FUNCS:
        w.int_(0)
    elif base == "mat":
        m = np.asarray(a[0], np.float32)
        if m.ndim == 1:
            m = m.reshape(-1, 1)  # position vectors ship as 3x1 cv::Mat
        w.mat(m, CV_32F)
    elif base == "pair":
        first_u64 = schema != "pair_u64_u64b"
        w.begin_value(("pair", schema))
        (w.uint if first_u64 else w.uint)(a[0])
        if schema == "pair_u64_i32":
            w.int_(a[1])
        else:
            w.uint(a[1])
    elif base == "u64":
        w.uint(a[0] if a else 0)
    elif base == "i32":
        w.int_(a[0] if a else 0)
    elif base == "f64":
        w.f64(a[0] if a else 0.0)
    elif base == "vec_u64":
        vals = list(a[0]) if a else []
        w.begin_collection(("vec", "u64"), len(vals))
        for v in vals:
            w.uint(v)
    return True


def _decode_update(r: _Reader):
    """Returns an UpdateRecord or None (trigger funcs we refresh locally)."""
    from .oplog import UpdateRecord

    key, _oid = r.begin_pointer()
    if key is None:
        return None
    if key[0] != "update":
        raise ValueError(f"unexpected pointer class {key} in updates vector")
    kind, schema = REGISTERED_UPDATE_TYPES[key[1]]
    r.begin_value("MapElementUpdateBase")
    seq = r.uint()
    target = r.uint()
    func = r.string().decode()
    base = _ARG_SCHEMA[schema]
    if base == "mat":
        m, _ = r.mat()
        m = np.asarray(m, np.float32)
        if m.ndim == 2 and m.shape[1] == 1:
            m = m.reshape(-1)  # column vectors (SetWorldPos) -> 1-D
        args = (m,)
    elif base == "pair":
        r.begin_value(("pair", schema))
        a = r.uint()
        b = r.int_() if schema == "pair_u64_i32" else r.uint()
        args = (a, b)
    elif base == "u64":
        args = (r.uint(),)
    elif base == "i32":
        args = (r.int_(),)
    elif base == "f64":
        args = (r.f64(),)
    elif base == "vec_u64":
        n = r.begin_collection()
        args = ([r.uint() for _ in range(n)],)
    if func in _TRIGGER_FUNCS:
        return None
    return UpdateRecord(seq=seq, kind=kind, func=func, target=target, args=args)


# ===========================================================================
# KeyFrame / MapPoint bodies  (KeyFrame.h:309-404, MapPoint.h:204-247)
# ===========================================================================

GRID_COLS, GRID_ROWS = 64, 48


def _desc_to_bytes(desc_u32: np.ndarray) -> np.ndarray:
    """[N,8] u32 -> [N,32] u8 rows (reference mDescriptors layout)."""
    return np.ascontiguousarray(desc_u32.astype("<u4")).view(np.uint8).reshape(-1, 32)


def _desc_from_bytes(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows.astype(np.uint8)).view("<u4").reshape(-1, 8)


def _encode_keyframe(w: _Writer, p: dict, scale: float = 1.2, n_levels: int = 8):
    """One KeyFrame body from our slice payload dict (oplog._kf_payload)."""
    K = np.asarray(p["K"], np.float32)
    h, wd = p.get("hw", (480, 640))
    n = len(p["kp_uv"])
    w.uint(p["gid"])                       # mnId
    w.uint(p.get("frame_id", 0))           # mnFrameId
    w.f64(p.get("ts", 0.0))                # mTimeStamp
    w.f64(p.get("ts", 0.0))                # mCreatedTime
    w.int_(GRID_COLS)
    w.int_(GRID_ROWS)
    w.f32(GRID_COLS / float(wd))
    w.f32(GRID_ROWS / float(h))
    w.uint(0); w.uint(0)                   # mnTrackReferenceForFrame, mnFuseTargetForKF
    w.uint(0); w.int_(0); w.f32(0.0)       # mnLoopQuery, mnLoopWords, mLoopScore
    w.uint(0); w.int_(0); w.f32(0.0)       # mnRelocQuery, mnRelocWords, mRelocScore
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    w.f32(fx); w.f32(fy); w.f32(cx); w.f32(cy)
    w.f32(1.0 / fx); w.f32(1.0 / fy); w.f32(0.0)   # invfx, invfy, mbf
    w.f32(0.0); w.f32(0.0)                 # mb, mThDepth
    w.int_(n)                              # N
    uv = np.asarray(p["kp_uv"], np.float32)
    oct_ = np.asarray(p["kp_octave"], np.int64)
    ang = np.asarray(p["kp_angle"], np.float32)
    resp = np.asarray(p["kp_response"], np.float32)
    sizes = 31.0 * scale ** oct_.astype(np.float64)
    for vec in ("mvKeys", "mvKeysUn"):
        w.begin_collection(("vec", "KeyPoint"), n)
        for i in range(n):
            w.keypoint(uv[i, 0], uv[i, 1], sizes[i], ang[i], resp[i], int(oct_[i]))
    for _ in range(2):                     # mvuRight, mvDepth (mono: -1)
        w.begin_collection(("vec", "f32"), n)
        for _i in range(n):
            w.f32(-1.0)
    w.mat(_desc_to_bytes(np.asarray(p["desc"], np.uint32)), CV_8U)
    w.mat(None)                            # mTcp (restored downstream)
    w.int_(n_levels)
    w.f32(scale)
    w.f32(np.log(scale))
    sf = scale ** np.arange(n_levels, dtype=np.float64)
    for arr in (sf, sf**2, 1.0 / sf**2):   # mvScaleFactors, mvLevelSigma2, mvInvLevelSigma2
        w.begin_collection(("vec", "f32"), n_levels)
        for v in arr:
            w.f32(v)
    w.int_(0); w.int_(0); w.int_(wd); w.int_(h)   # bounds
    w.mat(K, CV_32F)
    Tcw = np.asarray(p["pose_cw"], np.float32)
    Twc = np.linalg.inv(Tcw).astype(np.float32)
    Ow = Twc[:3, 3:4]
    w.mat(Tcw, CV_32F); w.mat(Twc, CV_32F); w.mat(Ow, CV_32F); w.mat(Ow, CV_32F)
    w.mat(None); w.mat(None); w.mat(None)  # mGlobalTcw/Twc/Ow (server-side)
    # mvnMapPointIds
    gids = np.asarray(p["mp_gids"], np.int64)
    w.begin_collection(("vec", "u64"), n)
    for g in gids.tolist():
        w.uint(g if g >= 0 else ULONG_MAX)
    # mGrid: 64x48 cell lists of keypoint indices (Frame.cc grid rule)
    gx = np.clip(np.round(uv[:, 0] * (GRID_COLS / float(wd))).astype(int), 0, GRID_COLS - 1)
    gy = np.clip(np.round(uv[:, 1] * (GRID_ROWS / float(h))).astype(int), 0, GRID_ROWS - 1)
    valid = np.asarray(p.get("kp_valid", np.ones(n, bool)), bool)
    cells: list[list[list[int]]] = [[[] for _ in range(GRID_ROWS)] for _ in range(GRID_COLS)]
    for i in np.where(valid)[0]:
        cells[gx[i]][gy[i]].append(int(i))
    w.begin_collection(("vec", "vvu64"), GRID_COLS)
    for col in cells:
        w.begin_collection(("vec", "vu64"), GRID_ROWS)
        for cell in col:
            w.begin_collection(("vec", "u64"), len(cell))
            for i in cell:
                w.uint(i)
    # covisibility (receiver rebuilds; ship empty like a fresh keyframe)
    w.begin_collection(("map", "u64_i32"), 0)   # mConnectedKeyFrameIdWeights
    w.begin_collection(("vec", "u64"), 0)       # mvnOrderedConnectedKeyFrameIds
    w.begin_collection(("vec", "i32"), 0)       # mvOrderedWeights
    w.bool_(True)                               # mbFirstConnection
    pg = p.get("parent_gid", -1)
    w.uint(pg if pg >= 0 else ULONG_MAX)        # mnParentId
    w.begin_collection(("set", "u64"), 0)       # msnChildrenIds
    w.begin_collection(("set", "u64"), 0)       # msnLoopEdgeIds
    w.bool_(False); w.bool_(False); w.bool_(False)  # mbNotErase/mbToBeErased/mbBad
    w.f32(0.0)                                  # mHalfBaseline
    w.bool_(bool(p.get("genuine", True)) and p["gid"] % 10**6 == 0)  # mbFirst


def _decode_keyframe(r: _Reader) -> dict:
    gid = r.uint()
    frame_id = r.uint()
    if frame_id > (1 << 63) - 1:
        # signed sentinel wrapped through the unsigned wire (virtual
        # keyframes carry frame_id=-1, map_enhancer.py); unwrap so the
        # int64 store does not overflow on apply
        frame_id -= 1 << 64
    ts = r.f64()
    r.f64()  # mCreatedTime
    r.int_(); r.int_(); r.f32(); r.f32()   # grid dims + inverses
    r.uint(); r.uint()
    r.uint(); r.int_(); r.f32()
    r.uint(); r.int_(); r.f32()
    fx = r.f32(); fy = r.f32(); cx = r.f32(); cy = r.f32()
    r.f32(); r.f32(); r.f32()
    r.f32(); r.f32()
    n = r.int_()
    kps = []
    r.begin_collection()
    for _ in range(n):
        kps.append(r.keypoint())  # mvKeys (raw)
    kps_un = []
    r.begin_collection()
    for _ in range(n):
        kps_un.append(r.keypoint())
    r.begin_collection()
    right = [r.f32() for _ in range(n)]
    r.begin_collection()
    depth = [r.f32() for _ in range(n)]
    desc_rows, _ = r.mat()
    r.mat()  # mTcp
    n_levels = r.int_()
    scale = r.f32()
    r.f32()
    for _ in range(3):
        r.begin_collection()
        for _i in range(n_levels):
            r.f32()
    min_x = r.int_(); min_y = r.int_(); max_x = r.int_(); max_y = r.int_()
    K, _ = r.mat()
    Tcw, _ = r.mat()
    r.mat(); r.mat(); r.mat()              # Twc, Ow, Cw
    r.mat(); r.mat(); r.mat()              # globals
    r.begin_collection()
    mp_gids = np.array([r.uint() for _ in range(n)], np.uint64).astype(np.int64)
    mp_gids[mp_gids < 0] = -1              # ULONG_MAX wrapped negative
    n_cols = r.begin_collection()
    for _ in range(n_cols):
        n_rows = r.begin_collection()
        for _r in range(n_rows):
            cnt = r.begin_collection()
            for _c in range(cnt):
                r.uint()
    n_conn = r.begin_collection()
    for _ in range(n_conn):
        r.begin_value(("pair", "u64_i32"))
        r.uint(); r.int_()
    n_ord = r.begin_collection()
    for _ in range(n_ord):
        r.uint()
    n_w = r.begin_collection()
    for _ in range(n_w):
        r.int_()
    r.bool_()
    parent = r.uint()
    for _ in range(2):
        cnt = r.begin_collection()
        for _i in range(cnt):
            r.uint()
    r.bool_(); r.bool_(); r.bool_()
    r.f32()
    genuine_first = r.bool_()
    uvun = np.array([[k[0], k[1]] for k in kps_un], np.float32).reshape(n, 2)
    return dict(
        gid=gid,
        pose_cw=np.asarray(Tcw, np.float32).reshape(4, 4),
        K=np.asarray(K, np.float32).reshape(3, 3),
        hw=(int(max_y - min_y), int(max_x - min_x)),
        ts=ts, frame_id=frame_id, genuine=True, velocity=0.0,
        kp_uv=uvun,
        kp_octave=np.array([k[5] for k in kps_un], np.int32),
        kp_angle=np.array([k[3] for k in kps_un], np.float32),
        kp_response=np.array([k[4] for k in kps_un], np.float32),
        kp_valid=np.ones(n, bool),
        desc=_desc_from_bytes(desc_rows) if desc_rows is not None
        else np.zeros((n, 8), np.uint32),
        mp_gids=mp_gids,
        parent_gid=int(parent) if parent != ULONG_MAX else -1,
        first=genuine_first,
    )


def _encode_mappoint(w: _Writer, p: dict):
    w.uint(p["gid"])                       # mnId
    w.int_(int(p.get("ref_kf_gid", -1)) % (1 << 31))  # mnFirstKFid (long int)
    w.int_(0)                              # mnFirstFrame
    obs = p.get("obs", {})
    w.int_(len(obs))                       # nObs
    w.f32(0.0); w.f32(0.0); w.f32(0.0)     # mTrackProjX/Y/XR
    w.bool_(False)                         # mbTrackInView
    w.int_(0)                              # mnTrackScaleLevel
    w.f32(0.0)                             # mTrackViewCos
    w.uint(0); w.uint(0)                   # mnTrackReferenceForFrame, mnLastFrameSeen
    w.f64(p.get("created", 0.0))           # mTimeStamp
    w.f64(p.get("last_tracked", 0.0))      # mLastTrackedTime
    w.uint(0)                              # mnFuseCandidateForKF
    pos = np.asarray(p["pos"], np.float32).reshape(3, 1)
    w.mat(pos, CV_32F)                     # mWorldPos
    w.mat(None)                            # mGlobalPos
    w.mat(np.asarray(p["normal"], np.float32).reshape(3, 1), CV_32F)
    w.f32(p.get("min_dist", 0.0)); w.f32(p.get("max_dist", 0.0))
    w.begin_collection(("map", "u64_u64"), len(obs))   # mIdObservations
    for kf_gid, kp in sorted(obs.items()):
        w.begin_value(("pair", "u64_u64"))
        w.uint(kf_gid)
        w.uint(kp)
    w.mat(_desc_to_bytes(np.asarray(p["desc"], np.uint32).reshape(1, 8)), CV_8U)
    ref = int(p.get("ref_kf_gid", -1))
    w.uint(ref if ref >= 0 else ULONG_MAX)  # mnRefKFId
    w.int_(p.get("visible", 1)); w.int_(p.get("found", 1))
    w.int_(len(obs))                       # nObs (again, per layout)
    w.bool_(False)                         # mbBad
    w.uint(ULONG_MAX)                      # mnReplacedId


def _decode_mappoint(r: _Reader) -> dict:
    gid = r.uint()
    r.int_(); r.int_(); r.int_()
    r.f32(); r.f32(); r.f32()
    r.bool_(); r.int_(); r.f32()
    r.uint(); r.uint()
    created = r.f64()
    last_tracked = r.f64()
    r.uint()
    pos, _ = r.mat()
    r.mat()
    normal, _ = r.mat()
    min_d = r.f32(); max_d = r.f32()
    n_obs = r.begin_collection()
    obs = {}
    for _ in range(n_obs):
        r.begin_value(("pair", "u64_u64"))
        kf_gid = r.uint()
        kp = r.uint()
        obs[kf_gid] = kp
    desc_rows, _ = r.mat()
    ref = r.uint()
    visible = r.int_(); found = r.int_()
    r.int_()
    r.bool_()
    r.uint()
    return dict(
        gid=gid, obs=obs,
        pos=np.zeros(3, np.float32) if pos is None else np.asarray(pos, np.float32).reshape(-1)[:3],
        desc=(_desc_from_bytes(desc_rows)[0] if desc_rows is not None
              else np.zeros(8, np.uint32)),
        normal=(np.array([0, 0, 1], np.float32) if normal is None
                else np.asarray(normal, np.float32).reshape(-1)[:3]),
        min_dist=min_d, max_dist=max_d,
        ref_kf_gid=int(ref) if ref != ULONG_MAX else -1,
        visible=visible, found=found,
        created=created, last_tracked=last_tracked, cam_velocity=0.0,
    )


# ===========================================================================
# MapSlice  (MapSlice.h:17, MapUpdater::Serialize)
# ===========================================================================

def encode_slice(sl, library_version: int = DEFAULT_LIBRARY_VERSION) -> bytes:
    """Our sync.oplog.MapSlice -> reference text-archive bytes.

    Caveats recorded in PARITY.md: covisibility/grid bookkeeping is
    shipped empty (the reference rebuilds it in RestoreSerialization) and
    the slice's Twl has no reference analogue (their slices are already
    in map-local coordinates)."""
    w = _Writer(library_version)
    w.begin_value("MapSlice")
    w.begin_collection(("vec", "KeyFrame*"), len(sl.kfs))
    for p in sl.kfs:
        w.begin_pointer("KeyFrame")
        _encode_keyframe(w, p)
    w.begin_collection(("vec", "MapPoint*"), len(sl.mps))
    for p in sl.mps:
        w.begin_pointer("MapPoint")
        _encode_mappoint(w, p)
    encodable = [u for u in sl.updates if _update_encodable(u)]
    w.begin_collection(("vec", "Update*"), len(encodable))
    for u in encodable:
        _encode_update(w, u)
    return w.getvalue()


def _update_encodable(rec) -> bool:
    table = {"kf": _KF_FUNC_CLASS, "mp": _MP_FUNC_CLASS, "map": _MAP_FUNC_CLASS}[rec.kind]
    return rec.func in table


def decode_slice(data: bytes, map_id: int = 0):
    from .oplog import MapSlice

    r = _Reader(data)
    r.begin_value("MapSlice")
    kfs = []
    n = r.begin_collection()
    for _ in range(n):
        key, _oid = r.begin_pointer()
        kfs.append(_decode_keyframe(r))
    mps = []
    n = r.begin_collection()
    for _ in range(n):
        key, _oid = r.begin_pointer()
        mps.append(_decode_mappoint(r))
    updates = []
    n = r.begin_collection()
    for _ in range(n):
        u = _decode_update(r)
        if u is not None:
            updates.append(u)
    mid = map_id
    if kfs:
        mid = kfs[0]["gid"] // 10**6
    return MapSlice(map_id=mid, kfs=kfs, mps=mps, updates=updates, twl=None)
