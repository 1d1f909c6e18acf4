"""Parity of the port's sync layer (swarmmap_tpu_torch/sync/) with the JAX
package's: each scenario of tests/test_sync.py is replayed on JAX map
stores and on port map stores fed the same numpy calls.

A scenario runs a client side (a store, its change log, the encoder) and a
server side (the decoder, a replica store) from either package, in all
four pairings, on the msgpack and the boost-text wires.  Held exactly:
- every payload the client side encodes is the same bytes in all four;
- the final state of every store (all arrays, indices, queues and the
  change log) and every decoded object are equal in all four: a slice
  encoded by one package decodes and applies in the other to the same
  store.
The map store's clock (STS timestamps, which travel on the wire) is made a
counter in both packages, so two runs make the same values.
"""
import dataclasses
import struct
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import swarmmap_tpu.core.map_store as jax_map_store
import swarmmap_tpu.core.tracking as jax_tracking
import swarmmap_tpu.sync.codec as jax_codec
import swarmmap_tpu.sync.oplog as jax_oplog
import swarmmap_tpu_torch.core.map_store as port_map_store
import swarmmap_tpu_torch.core.tracking as port_tracking
import swarmmap_tpu_torch.sync.codec as port_codec
import swarmmap_tpu_torch.sync.oplog as port_oplog
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PKGS = {
    name: SimpleNamespace(name=name, map_store=ms, MapStore=ms.MapStore, codec=cd,
                          Mapit=ol.Mapit, MapSlice=ol.MapSlice, UpdateRecord=ol.UpdateRecord,
                          full_archive=ol.full_archive, SystemState=tr.SystemState)
    for name, ms, cd, ol, tr in (
        ("jax", jax_map_store, jax_codec, jax_oplog, jax_tracking),
        ("port", port_map_store, port_codec, port_oplog, port_tracking))
}
PAIRS = [("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")]
WIRES = ("msgpack", "boost-text")


def snap(x):
    """A structure of plain values that is equal for two objects exactly
    when their contents are: arrays by dtype, shape and bytes, floats by
    their bits, objects by their fields (a store's lock and log hook
    left out)."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (np.generic,)):
        return snap(np.asarray(x))
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    if isinstance(x, (bool, int, str, bytes, type(None))):
        return x
    if isinstance(x, dict):
        return ("dict", sorted(((repr(k), snap(k), snap(v)) for k, v in x.items()),
                               key=lambda t: t[0]))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [snap(v) for v in x])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(v) for v in x))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: snap(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if hasattr(x, "__dict__"):
        return (type(x).__name__, {k: snap(v) for k, v in vars(x).items()
                                   if k not in ("lock", "log_fn", "store")
                                   and not isinstance(v, type(threading.RLock()))})
    raise TypeError(f"no snapshot of {type(x)}")


class Wire:
    """Encodes with the client package's codec, keeps the bytes, decodes
    with the server package's."""

    def __init__(self, c, s):
        self.c, self.s, self.sent = c, s, []

    def __call__(self, sl):
        data = self.c.codec.encode_slice(sl)
        self.sent.append(data)
        return self.s.codec.decode_slice(data)


def make_store(P, map_id=0, n_kp=64):
    return P.MapStore(map_id=map_id, n_kp=n_kp, kf_capacity=8, mp_capacity=64)


def add_kf(st, pose_seed=0):
    rng = np.random.RandomState(pose_seed)
    n = st.n_kp
    return st.add_keyframe(
        pose_cw=np.eye(4, dtype=np.float32),
        K=np.array([[450, 0, 320], [0, 450, 240], [0, 0, 1]], np.float32),
        kp_uv=rng.rand(n, 2).astype(np.float32) * 200,
        kp_octave=rng.randint(0, 4, n),
        kp_angle=rng.rand(n).astype(np.float32) * 360,
        kp_response=rng.rand(n).astype(np.float32),
        kp_valid=np.ones(n, bool),
        desc=rng.randint(0, 2**32, (n, 8), dtype=np.uint32),
        ts=1.5, frame_id=7, hw=(480, 640),
    )


def _pose(R=None, t=(0, 0, 0)):
    T = np.eye(4, dtype=np.float32)
    if R is not None:
        T[:3, :3] = R
    T[:3, 3] = t
    return T


def _rot_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _pair(C, S, wire, map_id=0):
    """A client store with its log, and a replica holding its first push."""
    client = make_store(C, map_id=map_id)
    cm = C.Mapit(client)
    k0 = add_kf(client, 0)
    server = make_store(S, map_id=map_id)
    sm = S.Mapit(server)
    return client, cm, k0, server, sm


def _correct_shift(server, slots, shift):
    """A server-side rigid correction by +shift in z, with correct_loop's
    bookkeeping, bumping the gauge epoch."""
    for k in slots:
        server.kf_pre_corr_pose[k] = server.kf_pose_cw[k]
        server.kf_corrected[k] = True
        server.kf_corr_scale[k] = 1.0
        T = server.kf_pose_cw[k].copy()
        T[:3, 3] += shift
        server.set_kf_pose(k, T, log=False)
        server.kf_post_corr_pose[k] = T
    server.gauge_epoch = 1


# --- the scenarios of tests/test_sync.py, each returning what it left -------

def push_applies_to_replica(C, S, wire):
    client = make_store(C, map_id=3)
    mapit = C.Mapit(client)
    k = add_kf(client)
    m = client.add_map_point(np.array([1, 2, 3.0]), client.kf_desc[k, 0], ref_kf=k)
    client.add_observation(m, k, 0)
    server = make_store(S, map_id=3)
    S.Mapit(server).apply_slice(wire(mapit.archive()))
    assert server.n_kf == 1 and server.n_mp == 1 and server.kf_kp_mp[0, 0] == 0
    return client, server


def incremental_updates_flow(C, S, wire):
    client = make_store(C, map_id=1)
    mapit = C.Mapit(client)
    k = add_kf(client)
    m = client.add_map_point(np.array([1, 2, 3.0]), client.kf_desc[k, 0], ref_kf=k)
    client.add_observation(m, k, 0)
    server = make_store(S, map_id=1)
    sm = S.Mapit(server)
    sm.apply_slice(wire(mapit.archive()))
    new_pose = np.eye(4, dtype=np.float32)
    new_pose[0, 3] = 5.0
    client.set_kf_pose(k, new_pose)
    client.set_mp_pos(m, np.array([9.0, 9, 9]))
    sl = mapit.archive()
    assert len(sl.updates) == 2
    sm.apply_slice(wire(sl))
    assert server.kf_pose_cw[0][0, 3] == 5.0
    return client, server, sl


def updates_on_unshipped_elements_dropped(C, S, wire):
    client = make_store(C)
    mapit = C.Mapit(client)
    k = add_kf(client)
    client.set_kf_pose(k, np.eye(4, dtype=np.float32))
    assert len(mapit.log) == 0
    return client, list(mapit.log), wire(mapit.archive())


def aggregation_last_writer_wins(C, S, wire):
    client = make_store(C)
    mapit = C.Mapit(client)
    k = add_kf(client)
    first = wire(mapit.archive())
    for i in range(5):
        p = np.eye(4, dtype=np.float32)
        p[1, 3] = float(i)
        client.set_kf_pose(k, p)
    sl = mapit.archive()
    assert [u.func for u in sl.updates] == ["SetPose"]
    return client, first, sl, wire(sl)


def aggregation_drops_ops_on_dead_elements(C, S, wire):
    client = make_store(C)
    mapit = C.Mapit(client)
    k1, k2 = add_kf(client, 0), add_kf(client, 1)
    m = client.add_map_point(np.array([0, 0, 1.0]), client.kf_desc[k1, 0], ref_kf=k1)
    client.add_observation(m, k1, 0)
    client.add_observation(m, k2, 0)
    server = make_store(S)
    sm = S.Mapit(server)
    sm.apply_slice(wire(mapit.archive()))
    client.set_mp_pos(m, np.array([1.0, 1, 1]))
    client.set_mp_bad(m)
    sl = mapit.archive()
    funcs = [u.func for u in sl.updates if u.target == int(client.mp_gid[m])]
    assert "SetBadFlag" in funcs and "SetWorldPos" not in funcs
    sm.apply_slice(wire(sl))
    return client, sl, server


def out_of_order_restoration_queue(C, S, wire):
    server = make_store(S, map_id=2)
    sm = S.Mapit(server)
    client = make_store(C, map_id=2)
    cm = C.Mapit(client)
    k = add_kf(client)
    m = client.add_map_point(np.array([1.0, 1, 1]), client.kf_desc[k, 0], ref_kf=k)
    sl_full = cm.archive()
    sl1 = C.MapSlice(map_id=2, kfs=sl_full.kfs, mps=[], updates=[
        C.UpdateRecord(0, "mp", "AddObservation", int(client.mp_gid[m]),
                       (int(client.kf_gid[k]), 5)),
    ])
    sm.apply_slice(wire(sl1))
    assert server.n_mp == 0 and len(server.pending_obs) == 1
    queued = list(server.pending_obs)
    sm.apply_slice(wire(C.MapSlice(map_id=2, kfs=[], mps=sl_full.mps, updates=[])))
    assert server.n_mp == 1 and server.kf_kp_mp[0, 5] == 0 and not server.pending_obs
    return client, queued, server


def map_event_callback(C, S, wire):
    client = make_store(C)
    mapit = C.Mapit(client)
    k = add_kf(client)
    client.log_fn("map", "AddLoopClosing", int(client.kf_gid[k]), ())
    events = []
    server = make_store(S)
    S.Mapit(server).apply_slice(wire(mapit.archive()),
                                on_map_event=lambda f, t, a: events.append((f, t, a)))
    return client, events, server


def full_archive_checkpoint_roundtrip(C, S, wire):
    client = make_store(C, map_id=4)
    C.Mapit(client)
    k1, k2 = add_kf(client, 0), add_kf(client, 1)
    for i in range(10):
        m = client.add_map_point(np.array([i, 0, 2.0]), client.kf_desc[k1, i], ref_kf=k1)
        client.add_observation(m, k1, i)
        client.add_observation(m, k2, i)
    restored = make_store(S, map_id=4)
    S.Mapit(restored).apply_slice(wire(C.full_archive(client)))
    assert restored.n_kf == 2 and restored.n_mp == 10 and restored.covis[0][1] == 10
    return client, restored


def request_roundtrip(C, S, wire):
    r = C.codec.Request(src=1, dst=0, path="PushMap", body=b"\x00\x01payload")
    data = r.encode()
    wire.sent.append(data)
    r2 = S.codec.Request.decode(data)
    assert (r2.src, r2.dst, r2.path, r2.body) == (1, 0, "PushMap", b"\x00\x01payload")
    reply = C.codec.encode_register_reply(3, 9001)
    wire.sent.append(reply)
    return r2, S.codec.decode_register_reply(reply)


def system_state_roundtrip(C, S, wire):
    s = C.SystemState(location=np.array([1, 2, 3.0], np.float32),
                      velocity_burst=True, stable=False, n_tracked=42, lost_count=3)
    data = C.codec.encode_state(s)
    wire.sent.append(data)
    s2 = S.codec.decode_state(data)
    assert s2.velocity_burst and not s2.stable and s2.n_tracked == 42
    return (s2.location, s2.velocity_burst, s2.stable, s2.n_tracked, s2.lost_count)


def stale_gauge_slice_reexpressed(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    k1 = add_kf(client, 1)
    client.set_kf_pose(k1, _pose(t=(1.0, 0, 0)), log=False)
    m = client.add_map_point(np.array([0.5, 0, 3.0]), client.kf_desc[k0, 0], ref_kf=k0)
    client.add_observation(m, k0, 0)
    sm.apply_slice(wire(cm.archive()))
    shift = np.array([0, 0, 1.0], np.float32)
    _correct_shift(server, (0, 1), shift)
    server.mp_pre_corr_pos[0] = server.mp_pos[0]
    server.mp_corrected[0] = True
    server.set_mp_pos(0, server.mp_pos[0] - shift, log=False)
    server.mp_post_corr_pos[0] = server.mp_pos[0]
    client.set_kf_pose(k0, _pose(t=(0.01, 0, 0)))
    client.set_kf_pose(k1, _pose(t=(1.02, 0, 0)))
    client.set_mp_pos(m, np.array([0.52, 0, 3.0], np.float32))
    k2 = add_kf(client, 2)
    client.set_kf_pose(k2, _pose(t=(2.0, 0, 0)), log=False)
    client.kf_parent[k2] = k1
    m2 = client.add_map_point(np.array([1.5, 0, 3.0]), client.kf_desc[k2, 0], ref_kf=k1)
    client.add_observation(m2, k2, 1)
    sm.apply_slice(wire(cm.archive()))
    return client, server


def fresh_slice_retires_stale_gauge_guard(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    sm.apply_slice(wire(cm.archive()))
    _correct_shift(server, (0,), np.array([0, 0, 1.0], np.float32))
    T = server.kf_pose_cw[0].copy()
    client.set_kf_pose(k0, T, log=False)
    client.gauge_epoch = 1
    T2 = T.copy()
    T2[:3, 3] += [0.01, 0, 0]
    client.set_kf_pose(k0, T2)
    sm.apply_slice(wire(cm.archive()))
    return client, server


def stale_gauge_cumulative_slices_do_not_compound(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    sm.apply_slice(wire(cm.archive()))
    _correct_shift(server, (0,), np.array([0, 0, 1.0], np.float32))
    poses = []
    for dx in (0.05, 0.10, 0.15):
        client.set_kf_pose(k0, _pose(t=(dx, 0, 0)))
        sm.apply_slice(wire(cm.archive()))
        poses.append(server.kf_pose_cw[0].copy())
    return client, server, poses


def stale_gauge_rotational_correction(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    p0 = np.array([0.5, 0.2, 3.0], np.float32)
    m = client.add_map_point(p0.copy(), client.kf_desc[k0, 0], ref_kf=k0)
    client.add_observation(m, k0, 0)
    sm.apply_slice(wire(cm.archive()))
    Rc, tc, scl = _rot_z(90.0), np.array([0.3, -0.1, 0.4], np.float32), 2.0
    T_post = _pose(R=Rc, t=tc)
    server.kf_pre_corr_pose[0] = server.kf_pose_cw[0]
    server.kf_corrected[0] = True
    server.kf_corr_scale[0] = scl
    server.set_kf_pose(0, T_post, log=False)
    server.kf_post_corr_pose[0] = T_post
    server.mp_pre_corr_pos[0] = server.mp_pos[0]
    server.mp_corrected[0] = True
    server.set_mp_pos(0, (Rc.T @ (p0 / scl - tc)).astype(np.float32), log=False)
    server.mp_post_corr_pos[0] = server.mp_pos[0]
    server.gauge_epoch = 1
    client.set_mp_pos(m, p0 + np.array([0.06, -0.02, 0.03], np.float32))
    client.set_kf_pose(k0, _pose(t=(0.01, 0.02, 0)))
    sm.apply_slice(wire(cm.archive()))
    return client, server


def new_elements_only_push_classified_stale_by_epoch(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    sm.apply_slice(wire(cm.archive()))
    _correct_shift(server, (0,), np.array([0, 0, 1.0], np.float32))
    cm.log = []
    k1 = add_kf(client, 1)
    client.set_kf_pose(k1, _pose(t=(1.0, 0, 0)), log=False)
    client.kf_parent[k1] = k0
    m = client.add_map_point(np.array([0.5, 0, 3.0]), client.kf_desc[k1, 0], ref_kf=k0)
    client.add_observation(m, k1, 0)
    sm.apply_slice(wire(cm.archive()))
    return client, server


def legacy_no_vote_slice_assumed_stale(C, S, wire):
    client, cm, k0, server, sm = _pair(C, S, wire)
    sm.apply_slice(wire(cm.archive()))
    _correct_shift(server, (0,), np.array([0, 0, 1.0], np.float32))
    k1 = add_kf(client, 1)
    client.set_kf_pose(k1, _pose(t=(1.0, 0, 0)), log=False)
    client.kf_parent[k1] = k0
    sl = wire(cm.archive())
    sl.epoch = None
    sm.apply_slice(sl)
    return client, server


SCENARIOS = [
    push_applies_to_replica, incremental_updates_flow, updates_on_unshipped_elements_dropped,
    aggregation_last_writer_wins, aggregation_drops_ops_on_dead_elements,
    out_of_order_restoration_queue, map_event_callback, full_archive_checkpoint_roundtrip,
    request_roundtrip, system_state_roundtrip, stale_gauge_slice_reexpressed,
    fresh_slice_retires_stale_gauge_guard, stale_gauge_cumulative_slices_do_not_compound,
    stale_gauge_rotational_correction, new_elements_only_push_classified_stale_by_epoch,
    legacy_no_vote_slice_assumed_stale,
]


@pytest.fixture
def counter_clock(monkeypatch):
    """Both packages' map-store clocks as one counter, restarted by the
    returned function."""
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.25
        return state["t"]

    for ms in (jax_map_store, port_map_store):
        monkeypatch.setattr(ms, "global_clock", clock)
    return lambda: state.update(t=0.0)


@pytest.fixture
def wire_mode(request):
    """Both packages' outbound wire set to the parameter, restored after."""
    for cd in (jax_codec, port_codec):
        cd.set_wire_mode(request.param)
    yield request.param
    for cd in (jax_codec, port_codec):
        cd.set_wire_mode("msgpack")


def test_sync_scenarios_cover_test_sync():
    import test_sync as ref

    names = {n[len("test_"):] for n in dir(ref) if n.startswith("test_")}
    assert names == {f.__name__ for f in SCENARIOS}


@pytest.mark.parametrize("wire_mode", WIRES, indirect=True)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_sync_scenario_same_bytes_and_stores(scenario, wire_mode, counter_clock):
    runs = {}
    for c, s in PAIRS:
        counter_clock()
        wire = Wire(PKGS[c], PKGS[s])
        out = scenario(PKGS[c], PKGS[s], wire)
        runs[(c, s)] = (wire.sent, snap(out))
    sent, state = runs[("jax", "jax")]
    assert sent, "the scenario sent nothing"
    for pair, (sent2, state2) in runs.items():
        assert sent2 == sent, f"{pair}: encoded bytes differ"
        assert state2 == state, f"{pair}: stores or decoded objects differ"
