"""Parity of the port's wire codecs with the JAX package's: the cases of
tests/test_boost_codec.py (the reference's boost text wire and binary map
files, on the fixtures of docs/boost_wire.md) run on both packages, with
every encoded stream the same bytes and every decoded object and applied
store equal, exactly (the map stores' clocks made one counter, as in
tests/test_torch_sync.py), the server mediator's map export included.
Then the port's msgpack packer (sync/msgpack_wire.py) is held to the
`msgpack` package on random nested objects with ndarrays: the same bytes,
and the same objects back.
"""
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.core.tracking as jax_tracking
import swarmmap_tpu.ops.vocab as jax_vocab
import swarmmap_tpu.server.map_manager as jax_mm
import swarmmap_tpu.server.mediator as jax_med
import swarmmap_tpu.sync.boost_bin as jax_bb
import swarmmap_tpu.sync.boost_text as jax_bt
import swarmmap_tpu.sync.codec as jax_codec
import swarmmap_tpu.sync.oplog as jax_oplog
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.core.tracking as port_tracking
import swarmmap_tpu_torch.ops.vocab as port_vocab
import swarmmap_tpu_torch.server.map_manager as port_mm
import swarmmap_tpu_torch.server.mediator as port_med
import swarmmap_tpu_torch.sync.boost_bin as port_bb
import swarmmap_tpu_torch.sync.boost_text as port_bt
import swarmmap_tpu_torch.sync.codec as port_codec
import swarmmap_tpu_torch.sync.oplog as port_oplog
from swarmmap_tpu_torch.sync import msgpack_wire
from test_torch_sync import counter_clock, snap  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PKGS = {
    name: SimpleNamespace(bt=bt, bb=bb, codec=cd, MapStore=ms.MapStore, Mapit=ol.Mapit,
                          MapSlice=ol.MapSlice, UpdateRecord=ol.UpdateRecord,
                          SystemState=tr.SystemState, AgentMediator=med.AgentMediator,
                          MapManager=lambda mm=mm, kw=kw: mm.MapManager(**kw),
                          vocab=voc.default_vocabulary, kw=kw)
    for name, bt, bb, cd, ms, ol, tr, med, mm, voc, kw in (
        ("jax", jax_bt, jax_bb, jax_codec, jax_map_store, jax_oplog, jax_tracking,
         jax_med, jax_mm, jax_vocab, {}),
        ("port", port_bt, port_bb, port_codec, port_map_store, port_oplog, port_tracking,
         port_med, port_mm, port_vocab, {"device": "cpu"}))
}


def _toy_slice(P):
    n_kp = 16
    rng = np.random.RandomState(7)
    kf = dict(
        gid=1000000, frame_id=3, ts=11.25, genuine=True, velocity=0.0,
        pose_cw=np.eye(4, dtype=np.float32),
        K=np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]], np.float32),
        hw=(480, 752),
        kp_uv=rng.uniform(0, 400, (n_kp, 2)).astype(np.float32),
        kp_octave=rng.randint(0, 8, n_kp).astype(np.int32),
        kp_angle=rng.uniform(0, 360, n_kp).astype(np.float32),
        kp_response=rng.rand(n_kp).astype(np.float32),
        kp_valid=np.ones(n_kp, bool),
        desc=rng.randint(0, 2**32, (n_kp, 8), dtype=np.uint32),
        mp_gids=np.array([2000000, -1] * (n_kp // 2), np.int64),
        parent_gid=-1,
    )
    mp = dict(
        gid=2000000, obs={1000000: 0},
        pos=np.array([1.0, -2.0, 5.0], np.float32),
        desc=rng.randint(0, 2**32, 8, dtype=np.uint32),
        normal=np.array([0.0, 0.0, 1.0], np.float32),
        min_dist=0.5, max_dist=4.0, ref_kf_gid=1000000,
        visible=3, found=2, created=10.0, last_tracked=11.0,
        cam_velocity=0.0,
    )
    ups = [P.UpdateRecord(9, "mp", "SetWorldPos", 2000000,
                          (np.array([1, 2, 3], np.float32),))]
    return P.MapSlice(map_id=1, kfs=[kf], mps=[mp], updates=ups, twl=None)


# --- the cases of tests/test_boost_codec.py: each returns (streams, results) --

def request_fixture_decode(P):
    raw = b"22 serialization::archive 17 0 0 3 1 7 PushMap 11 hello world"
    req = P.bt.decode_request(raw)
    assert (req.src, req.dst, req.path, req.body) == (3, 1, "PushMap", b"hello world")
    return [], req


def request_roundtrip_exact_bytes(P):
    req = P.codec.Request(src=2, dst=0, path="ReportState", body=b"\x00\x01 binary \xff")
    enc = P.bt.encode_request(req)
    assert enc.startswith(b"22 serialization::archive 17 0 0 2 0 11 ReportState 11 ")
    return [enc], P.bt.decode_request(enc)


def system_state_fixture_decode(P):
    raw = (b"22 serialization::archive 17 0 0 0 0 1 3 5 1 "
           b"1.5 -2 0.25 1 0 57 4")
    st = P.bt.decode_state(raw)
    assert st.n_tracked == 57 and st.lost_count == 4
    return [], st


def system_state_roundtrip(P):
    st = P.SystemState(location=np.array([0.1, -3.25, 7.0], np.float32),
                       velocity_burst=False, stable=True, n_tracked=200, lost_count=0)
    enc = P.bt.encode_state(st)
    return [enc], P.bt.decode_state(enc)


def float_formats_match_cxx_ostream(P):
    w = P.bt._Writer()
    w.f32(1.0 / 3.0)
    w.f64(1.0 / 3.0)
    w.f32(1e10)
    out = w.getvalue()
    assert out.split(b" ")[3:] == [b"0.333333343", b"0.33333333333333331", b"1e+10"]
    return [out], None


def update_records_roundtrip(P):
    recs = [
        P.UpdateRecord(1, "kf", "SetPose", 1000001, (np.eye(4, dtype=np.float32),)),
        P.UpdateRecord(2, "mp", "AddObservation", 2000005, (1000001, 37)),
        P.UpdateRecord(3, "mp", "EraseObservation", 2000005, (1000001,)),
        P.UpdateRecord(4, "mp", "Replace", 2000006, (2000005,)),
        P.UpdateRecord(5, "kf", "SetBadFlag", 1000002, (0,)),
        P.UpdateRecord(6, "mp", "SetLastTrackedTime", 2000005, (12.5,)),
        P.UpdateRecord(7, "map", "AddLoopClosing", 1, (1000003,)),
        P.UpdateRecord(8, "mp", "SetVisible", 2000005, (9,)),
    ]
    enc = P.bt.encode_slice(P.MapSlice(map_id=1, kfs=[], mps=[], updates=recs, twl=None))
    back = P.bt.decode_slice(enc, map_id=1)
    assert len(back.updates) == len(recs)
    return [enc], back


def trigger_funcs_encode_as_int_and_drop_on_decode(P):
    recs = [
        P.UpdateRecord(1, "mp", "ComputeDistinctiveDescriptors", 5,
                       (np.arange(8, dtype=np.uint32),)),
        P.UpdateRecord(2, "mp", "UpdateNormalAndDepth", 5,
                       (np.ones(3, np.float32), 0.5, 2.0)),
        P.UpdateRecord(3, "mp", "SetWorldPos", 5, (np.zeros((3, 1), np.float32),)),
    ]
    enc = P.bt.encode_slice(P.MapSlice(map_id=0, kfs=[], mps=[], updates=recs, twl=None))
    back = P.bt.decode_slice(enc)
    assert [u.func for u in back.updates] == ["SetWorldPos"]
    return [enc], back


def map_slice_roundtrip(P):
    enc = P.bt.encode_slice(_toy_slice(P))
    assert enc.startswith(b"22 serialization::archive 17 ")
    back = P.bt.decode_slice(enc)
    assert back.kfs[0]["gid"] == 1000000 and back.mps[0]["obs"] == {1000000: 0}
    return [enc], back


def map_slice_applies_to_store(P):
    enc = P.bt.encode_slice(_toy_slice(P))
    st = P.MapStore(map_id=1, n_kp=16, is_server=True)
    P.Mapit(st).apply_slice(P.bt.decode_slice(enc))
    np.testing.assert_allclose(st.mp_pos[st.mp_by_gid[2000000]], [1.0, 2.0, 3.0])
    return [enc], st


def virtual_kf_sentinel_frame_id_roundtrips(P):
    sl = _toy_slice(P)
    sl.kfs[0]["frame_id"] = -1
    sl.kfs[0]["genuine"] = False
    enc = P.bt.encode_slice(sl)
    back = P.bt.decode_slice(enc)
    assert back.kfs[0]["frame_id"] == -1
    st = P.MapStore(map_id=1, n_kp=16, is_server=True)
    P.Mapit(st).apply_slice(back)
    assert int(st.kf_frame_id[st.kf_by_gid[1000000]]) == -1
    return [enc], st


def binary_map_file_roundtrip(P):
    sl = _toy_slice(P)
    inv = [[1000000], [], [1000000]]
    data = P.bb.encode_map_bin(sl.kfs, sl.mps, inverted_file=inv)
    back = P.bb.decode_map_bin(data)
    assert back[2] == inv and back[3] == 1000000
    single = P.bb.encode_map_bin(sl.kfs, sl.mps)
    kfs_only = P.bb.encode_map_bin(sl.kfs, [])
    assert len(single) < 1.5 * len(kfs_only)
    return [data, single, kfs_only], back


def reference_bin_map_loads_through_codec(P):
    sl = _toy_slice(P)
    data = P.bb.encode_map_bin(sl.kfs, sl.mps)
    back = P.codec.decode_slice(data)
    assert back.map_id == 1 and len(back.kfs) == 1 and len(back.mps) == 1
    st = P.MapStore(map_id=1, n_kp=16, is_server=True)
    P.Mapit(st).apply_slice(back)
    own = P.codec.encode_slice(sl)
    return [data, own], (back, st, P.codec.decode_slice(own))


def mediator_boost_bin_export(P):
    """AgentMediator.save_map(fmt="boost-bin") writes a reference-layout
    map file that decode_map_bin reads back."""
    import tempfile
    from pathlib import Path

    P.AgentMediator.registry.clear()
    med = P.AgentMediator(1, P.vocab(), P.MapManager(), n_kp=16, **P.kw)
    P.Mapit(med.store).apply_slice(_toy_slice(P))
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "map-server-1.bin"
        med.save_map(out, fmt="boost-bin")
        data = out.read_bytes()
    kfs, mps, inverted, max_id = back = P.bb.decode_map_bin(data)
    assert len(kfs) == 1 and len(mps) == 1
    assert kfs[0]["gid"] == 1000000
    return [data], back


CASES = [
    request_fixture_decode, request_roundtrip_exact_bytes, system_state_fixture_decode,
    system_state_roundtrip, float_formats_match_cxx_ostream, update_records_roundtrip,
    trigger_funcs_encode_as_int_and_drop_on_decode, map_slice_roundtrip,
    map_slice_applies_to_store, virtual_kf_sentinel_frame_id_roundtrips,
    binary_map_file_roundtrip, reference_bin_map_loads_through_codec,
    mediator_boost_bin_export,
]


def test_codec_cases_cover_test_boost_codec():
    """Every case of tests/test_boost_codec.py has its case here (the
    mediator's export since the port has its server)."""
    import test_boost_codec as ref

    names = {n[len("test_"):] for n in dir(ref) if n.startswith("test_")}
    assert names - {f.__name__ for f in CASES} == set()


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_codec_case_same_bytes_and_results(case, counter_clock):
    counter_clock()
    jax_streams, jax_out = case(PKGS["jax"])
    counter_clock()
    port_streams, port_out = case(PKGS["port"])
    assert port_streams == jax_streams
    assert snap(port_out) == snap(jax_out)


# --- the msgpack packer against the msgpack package -------------------------

_scalars = (hs.none() | hs.booleans()
            | hs.integers(min_value=-(2**63), max_value=2**64 - 1)
            | hs.floats(allow_nan=False) | hs.text(max_size=40) | hs.binary(max_size=300))
_dtypes = hs.sampled_from([np.float32, np.float64, np.int32, np.int64, np.uint8,
                           np.uint32, np.bool_])
_arrays = hs.builds(
    lambda dt, shape, seed: np.random.RandomState(seed).randint(0, 200, shape).astype(dt),
    _dtypes, hs.lists(hs.integers(0, 4), max_size=3).map(tuple), hs.integers(0, 2**31 - 1))
_np_scalars = hs.builds(lambda dt, v: dt(v), hs.sampled_from([np.float32, np.int64, np.uint8]),
                        hs.integers(0, 255))
_values = hs.recursive(
    _scalars | _arrays | _np_scalars,
    lambda inner: (hs.lists(inner, max_size=20) | hs.tuples(inner, inner)
                   | hs.dictionaries(hs.text(max_size=20) | hs.integers(-10**6, 10**6),
                                     inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_packer_matches_msgpack(obj):
    ref = msgpack.packb(obj, default=port_codec._default, use_bin_type=True)
    assert msgpack_wire.packb(obj, default=port_codec._default) == ref
    back = msgpack_wire.unpackb(ref, object_hook=port_codec._object_hook)
    want = msgpack.unpackb(ref, object_hook=port_codec._object_hook, raw=False,
                           strict_map_key=False)
    assert snap(back) == snap(want)


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_packer_length_headers_match_msgpack(n):
    """str, bin, array and map at the lengths where the header widens."""
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {i: None for i in range(n)}):
        assert msgpack_wire.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    with pytest.raises(OverflowError):
        msgpack_wire.packb(2**64)
