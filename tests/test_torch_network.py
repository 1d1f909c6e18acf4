"""The port's websocket transport (`net/ws_wire.py`, `net/wsrpc.py`) and
network services: tests/test_network.py's three tests on the port, and
the two packages' ends talking to each other.

The JAX package's transport is the `websockets` library; the port's is
its own RFC 6455 code.  Held exactly: JAX's `WsServer` with the port's
`WsClient` and `ws_round_trip`, and the port's `WsServer` with JAX's
`WsClient` and `ws_round_trip`, receive the bytes of `Request.encode()` of
what the other sent (the two packages' `Request` encodings are the same
bytes), including a message above 64 KiB (a 64-bit frame length).  Against
the `websockets` library directly: a message it sends in fragments, with a
ping between them, and its pings answered; its `permessage-deflate` offer
declined; frames of every length class both ways.
"""
import asyncio
import base64
import time

import numpy as np
import pytest

from swarmmap_tpu.net import wsrpc as jwsrpc
from swarmmap_tpu.sync.codec import Request as JRequest
from swarmmap_tpu_torch.net import ws_wire, wsrpc
from swarmmap_tpu_torch.net.client_service import ClientService
from swarmmap_tpu_torch.net.server_service import DispatchService, ServerService
from swarmmap_tpu_torch.sync.codec import Request
from test_network import free_port
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

websockets = pytest.importorskip("websockets")


def _wait(cond, timeout: float = 10.0) -> bool:
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


# -- tests/test_network.py on the port ---------------------------------------

def test_ws_round_trip_and_broadcast():
    port = free_port()
    got = []

    def on_request(req, reply):
        got.append(req.path)
        reply(Request(src=0, dst=req.src, path="Ack", body=req.body))

    server = wsrpc.WsServer("127.0.0.1", port, on_request)
    server.start()
    reply = wsrpc.ws_round_trip("127.0.0.1", port, Request(1, 0, "Hello", b"xyz"))
    assert reply.path == "Ack" and reply.body == b"xyz"
    assert got == ["Hello"]

    received = []
    client = wsrpc.WsClient("127.0.0.1", port, on_request=lambda r: received.append(r.path))
    client.connect()
    # the broadcast races the server registering the new connection;
    # retry until the subscription is live
    for _ in range(100):
        server.broadcast(Request(0, -1, "News", b""))
        time.sleep(0.1)
        if received:
            break
    assert received and received[0] == "News"
    client.close()
    server.stop()
    assert not client._thread.is_alive() and not server._thread.is_alive()


@pytest.fixture(params=["msgpack", "boost-text"])
def wire_mode(request):
    from swarmmap_tpu_torch.sync import codec as codec_mod

    codec_mod.set_wire_mode(request.param)
    yield request.param
    codec_mod.set_wire_mode("msgpack")


def test_dispatch_and_push_flow(wire_mode):
    """tests/test_network.py's full standalone flow on loopback with the
    port's services: register -> connect -> push -> server applies ->
    distribute -> client applies -> pull, in both wire modes."""
    from swarmmap_tpu_torch import MAP_BASE
    from swarmmap_tpu_torch.ops.vocab import default_vocabulary
    from swarmmap_tpu_torch.server.map_manager import MapManager
    from swarmmap_tpu_torch.server.mediator import AgentMediator
    from swarmmap_tpu_torch.server.scheduler import MediatorScheduler
    from swarmmap_tpu_torch.swarm import SwarmAgent
    from swarmmap_tpu_torch.utils.config import CameraConfig, OrbConfig, Settings

    vocab = default_vocabulary()
    AgentMediator.registry.clear()
    mm = MapManager(device="cpu")
    services = {}
    sched = MediatorScheduler(
        mm, distribute_fn=lambda aid, data: services[aid].distribute_map(data), device="cpu")

    def make_mediator(agent_id):
        med = AgentMediator(agent_id, vocab, mm, n_kp=128, device="cpu")
        sched.register_mediator(med)
        svc = ServerService(agent_id, sched, host="127.0.0.1", port=free_port())
        svc.start()
        services[agent_id] = svc
        return svc

    dport = free_port()
    dispatch = DispatchService("127.0.0.1", dport, make_mediator, next_id=5)
    dispatch.start()
    settings = Settings(
        camera=CameraConfig(fx=230, fy=230, cx=160, cy=120, fps=20, width=320, height=240),
        orb=OrbConfig(n_features=128, n_levels=3),
    )
    agent = SwarmAgent(0, settings, vocab, device="cpu")
    svc = ClientService(agent, "127.0.0.1")
    new_id, data_port = svc.register(dport)
    assert new_id == 5 and agent.system.store.map_id == 5
    svc.connect(data_port)

    st = agent.system.store
    rng = np.random.RandomState(0)

    def add_keyframe(store, pose, **kw):
        return store.add_keyframe(
            pose_cw=pose, K=settings.camera.K,
            kp_uv=rng.rand(store.n_kp, 2).astype(np.float32) * 100,
            kp_octave=np.zeros(store.n_kp, np.int32), kp_angle=np.zeros(store.n_kp, np.float32),
            kp_response=np.ones(store.n_kp, np.float32), kp_valid=np.ones(store.n_kp, bool),
            desc=rng.randint(0, 2**32, (store.n_kp, 8), dtype=np.uint32), **kw)

    k = add_keyframe(st, np.eye(4, dtype=np.float32))
    m = st.add_map_point(np.array([0, 0, 2.0]), st.kf_desc[k, 0], ref_kf=k)
    st.add_observation(m, k, 0)
    assert svc.push_map() > 0
    med = AgentMediator.registry[5]
    assert _wait(lambda: sched.process_pending() or med.store.n_kf == 1)
    assert med.store.n_kf == 1 and med.store.n_mp == 1

    new_pose = np.eye(4, dtype=np.float32)
    new_pose[2, 3] = 9.0
    med.store.set_kf_pose(0, new_pose)
    sched.map_distribute(5)
    assert _wait(lambda: agent.system.store.kf_pose_cw[0][2, 3] == 9.0)

    sst = med.store
    k2 = add_keyframe(sst, new_pose, gid=5 * MAP_BASE + 777)
    m2 = sst.add_map_point(np.array([1, 0, 3.0]), sst.kf_desc[k2, 0], ref_kf=k2,
                           gid=5 * MAP_BASE + 778)
    sst.add_observation(m2, k2, 1)
    pulled_gid = int(sst.kf_gid[k2])
    assert pulled_gid not in agent.system.store.kf_by_gid
    assert svc.pull_map(timeout=10.0), "ReplyPull never arrived"
    cst = agent.system.store
    kc = cst.kf_by_gid[pulled_gid]
    np.testing.assert_allclose(cst.kf_pose_cw[kc], new_pose, atol=1e-6)
    mc = cst.mp_by_gid[int(sst.mp_gid[m2])]
    np.testing.assert_allclose(cst.mp_pos[mc], [1, 0, 3.0], atol=1e-6)
    n_kf, n_mp = cst.n_kf, cst.n_mp
    assert svc.pull_map(timeout=10.0)
    assert (cst.n_kf, cst.n_mp) == (n_kf, n_mp)

    svc.close()
    dispatch.stop()
    for s in services.values():
        s.stop()


def test_wire_mode_grammar(wire_mode):
    from swarmmap_tpu_torch.core.tracking import SystemState
    from swarmmap_tpu_torch.sync import codec

    data = Request(1, 0, "PushMap", b"xx").encode()
    r = Request.decode(data)
    assert (r.src, r.dst, r.path, r.body) == (1, 0, "PushMap", b"xx")
    st = SystemState(location=np.zeros(3, np.float32), velocity_burst=False,
                     stable=True, n_tracked=42, lost_count=0)
    sdata = codec.encode_state(st)
    if wire_mode == "boost-text":
        assert data.startswith(b"22 serialization::archive")
        assert sdata.startswith(b"22 serialization::archive")
    back = codec.decode_state(sdata)
    assert back.n_tracked == 42 and back.stable


# -- the two packages' ends together -----------------------------------------

BIG = bytes(range(256)) * 400  # 102,400 bytes: a 64-bit frame length


@pytest.fixture()
def raw_decodes(monkeypatch):
    """The bytes each package's Request.decode is given, by package."""
    seen = {"jax": [], "port": []}
    for name, cls in (("jax", JRequest), ("port", Request)):
        inner = cls.decode

        def decode(data, _inner=inner, _seen=seen[name]):
            _seen.append(bytes(data))
            return _inner(data)

        monkeypatch.setattr(cls, "decode", staticmethod(decode))
    return seen


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_packages_interoperate(raw_decodes, server_side):
    """One package's WsServer, the other's ws_round_trip and WsClient: a
    round trip, a push above 64 KiB, a reply and a broadcast, each
    received as the bytes the sender encoded."""
    S, C = (jwsrpc, wsrpc) if server_side == "jax" else (wsrpc, jwsrpc)
    SReq, CReq = (JRequest, Request) if server_side == "jax" else (Request, JRequest)
    client_side = "port" if server_side == "jax" else "jax"
    port = free_port()

    def on_request(req, reply):
        reply(SReq(src=0, dst=req.src, path="Ack", body=req.body[:100]))

    server = S.WsServer("127.0.0.1", port, on_request)
    server.start()
    hello = CReq(1, 0, "Hello", b"xyz")
    assert C.ws_round_trip("127.0.0.1", port, hello).body == b"xyz"
    received = []
    client = C.WsClient("127.0.0.1", port, on_request=received.append)
    client.connect()
    push = CReq(2, 0, "PushMap", BIG)
    client.send(push)
    assert _wait(lambda: any(r.path == "Ack" for r in received))
    news = SReq(0, 2, "DistributeMap", BIG[::-1])
    for _ in range(100):
        server.broadcast(news)
        if _wait(lambda: any(r.path == "DistributeMap" for r in received), 0.1):
            break
    client.close()
    server.stop()
    assert raw_decodes[server_side][:2] == [hello.encode(), push.encode()]
    assert hello.encode() == SReq(1, 0, "Hello", b"xyz").encode()
    replies = raw_decodes[client_side]
    ack = SReq(src=0, dst=2, path="Ack", body=BIG[:100]).encode()
    assert SReq(0, 1, "Ack", b"xyz").encode() in replies and ack in replies
    assert news.encode() in replies


async def _echo_server():
    async def echo(reader, writer):
        ws = await ws_wire.accept(reader, writer, 1 << 30)
        async for m in ws:
            await ws.send(m)

    srv = await asyncio.start_server(echo, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


def test_websockets_client_fragments_and_pings():
    """A `websockets` client against the port's server end: its
    permessage-deflate offer declined, a message it sends in fragments
    with a ping between them, its pings answered, and every frame-length
    class echoed back intact."""
    from websockets.asyncio.client import connect

    async def run():
        srv, port = await _echo_server()
        async with connect(f"ws://127.0.0.1:{port}", max_size=1 << 30) as ws:
            assert ws.protocol.extensions == []
            pongs = []

            async def parts():
                yield b"a" * 1000
                pongs.append(await ws.ping(b"mid"))
                yield b"b" * 70000

            await ws.send(parts())
            assert await ws.recv() == b"a" * 1000 + b"b" * 70000
            await asyncio.wait_for(pongs[0], 5)
            await asyncio.wait_for(await ws.ping(b"again"), 5)
            for n in (0, 1, 125, 126, 65535, 65536, 1 << 20):
                msg = np.random.RandomState(n).bytes(n)
                await ws.send(msg)
                assert await ws.recv() == msg, n
            await ws.send("text")
            assert await ws.recv() == "text"
        srv.close()

    asyncio.run(run())


def test_websockets_server_fragments_and_pings():
    """The port's client end against a `websockets` server that sends a
    message in fragments and pings it (the reply must come before its
    next message)."""
    from websockets.asyncio.server import serve

    async def handler(ws):
        await ws.send([b"p" * 10, b"q" * 200000])
        await asyncio.wait_for(await ws.ping(b"hi"), 5)
        await ws.send(b"after-pong")
        async for m in ws:
            await ws.send(m)

    async def run():
        async with serve(handler, "127.0.0.1", 0, max_size=1 << 30) as s:
            port = next(iter(s.sockets)).getsockname()[1]
            c = await ws_wire.connect("127.0.0.1", port, 1 << 30)
            assert await c.recv() == b"p" * 10 + b"q" * 200000
            assert await c.recv() == b"after-pong"
            await c.send(b"z" * 66000)
            assert await c.recv() == b"z" * 66000
            await c.close()
            assert c.close_code == 1000

    asyncio.run(run())


def test_frame_lengths_and_handshake_key():
    """RFC 6455's own handshake example, and the 7-, 16- and 64-bit length
    encodings (1.3, 5.2)."""
    assert ws_wire.accept_key(b"dGhlIHNhbXBsZSBub25jZQ==") == b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    long_head = b"\x82\x7f" + (65536).to_bytes(8, "big")
    for n, head in ((125, b"\x82\x7d"), (126, b"\x82\x7e\x00\x7e"),
                    (65535, b"\x82\x7e\xff\xff"), (65536, long_head)):
        frame = ws_wire.encode_frame(ws_wire.OP_BINARY, b"\0" * n, masked=False)
        assert frame.startswith(head) and len(frame) == len(head) + n
    masked = ws_wire.encode_frame(ws_wire.OP_BINARY, b"hello", masked=True)
    assert masked[1] == 0x80 | 5 and ws_wire.mask(masked[6:], masked[2:6]) == b"hello"


def test_server_refuses_a_plain_http_request():
    async def run():
        srv = await asyncio.start_server(
            lambda r, w: _refused(ws_wire.accept(r, w, 1024)), "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        status = await asyncio.wait_for(reader.readline(), 5)
        writer.close()
        srv.close()
        return status

    assert asyncio.run(run()).startswith(b"HTTP/1.1 400")
    key = base64.b64encode(b"0123456789abcdef")
    assert len(ws_wire.accept_key(key)) == 28


async def _refused(accepting):
    with pytest.raises(ws_wire.HandshakeError):
        await accepting
