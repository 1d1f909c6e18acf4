"""Websocket transport for Request messages.

Port of swarmmap_tpu/net/wsrpc.py (reference spec: include/WebSocket.h —
Boost.Beast async websocket client `session` (strand-serialized write
queue) and server `listener` + `shared_state` broadcast).  The same
structure: each endpoint runs an asyncio loop in a daemon thread, so the
synchronous SLAM stack can call send() directly; the protocol is
`net/ws_wire.py` (RFC 6455 on asyncio streams) in place of the `websockets`
library, and the two packages' ends talk to each other.  Payloads are
binary `Request`s (`sync/codec.py`), up to 1 GiB.
"""
from __future__ import annotations

import asyncio
import threading
from typing import Callable

from ..sync.codec import Request
from ..utils.logging import get_logger
from . import ws_wire

_log = get_logger("ws")

MAX_SIZE = 1 << 30  # the JAX package's max_size (wsrpc.py:60-62, :104)


class WsServer:
    """Accepts sessions; on_request(Request, reply_fn) handles messages;
    broadcast() reaches every connected session (shared_state::send)."""

    def __init__(self, host: str, port: int,
                 on_request: Callable[[Request, Callable[[Request], None]], None]):
        self.host = host
        self.port = port
        self.on_request = on_request
        self._sessions: set = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stop: asyncio.Event | None = None
        self._tasks: set = set()  # the sessions' handler tasks

    async def _handler(self, reader, writer):
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            await self._session(reader, writer)
        finally:
            self._tasks.discard(task)

    async def _session(self, reader, writer):
        try:
            ws = await ws_wire.accept(reader, writer, MAX_SIZE)
        except (ws_wire.HandshakeError, ConnectionError) as e:
            _log.warning("refused a connection: %s", e)
            return
        self._sessions.add(ws)
        try:
            async for msg in ws:
                req = Request.decode(msg)

                def reply(r: Request, _ws=ws):
                    asyncio.run_coroutine_threadsafe(_ws.send(r.encode()), self._loop)

                self.on_request(req, reply)
        except ws_wire.ConnectionClosed:
            pass
        finally:
            self._sessions.discard(ws)
            ws.abort()

    def start(self):
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def main():
                self._stop = asyncio.Event()
                server = await asyncio.start_server(self._handler, self.host, self.port)
                self._started.set()
                await self._stop.wait()
                server.close()
                for task in list(self._tasks):
                    task.cancel()
                await asyncio.gather(*self._tasks, return_exceptions=True)

            try:
                self._loop.run_until_complete(main())
            except OSError as e:
                _log.error("ws server on %s:%d: %s", self.host, self.port, e)
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError(f"ws server failed to bind {self.host}:{self.port}")

    def broadcast(self, req: Request):
        data = req.encode()
        for ws in list(self._sessions):
            asyncio.run_coroutine_threadsafe(ws.send(data), self._loop)

    def stop(self):
        """Close the listening socket and every session, and end the
        loop's thread."""
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(10)


class WsClient:
    """Persistent client session with a background receive loop."""

    def __init__(self, host: str, port: int,
                 on_request: Callable[[Request], None] | None = None):
        self.host, self.port = host, port
        self.uri = f"ws://{host}:{port}"
        self.on_request = on_request
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ws: ws_wire.WebSocket | None = None
        self._thread: threading.Thread | None = None
        self._connected = threading.Event()
        self._close_requested: asyncio.Event | None = None

    def connect(self, timeout: float = 10.0):
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def main():
                self._ws = await ws_wire.connect(self.host, self.port, MAX_SIZE)
                self._close_requested = asyncio.Event()
                self._connected.set()

                async def closer():
                    await self._close_requested.wait()
                    await self._ws.close()

                closing = asyncio.ensure_future(closer())
                try:
                    async for msg in self._ws:
                        if self.on_request is not None:
                            self.on_request(Request.decode(msg))
                finally:
                    if not self._close_requested.is_set():  # the server closed first
                        closing.cancel()
                    await asyncio.gather(closing, return_exceptions=True)
                    await self._ws.close()

            try:
                self._loop.run_until_complete(main())
            except (OSError, ws_wire.HandshakeError) as e:
                _log.error("ws client to %s: %s", self.uri, e)
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._connected.wait(timeout):
            raise ConnectionError(f"could not connect to {self.uri}")

    def send(self, req: Request):
        asyncio.run_coroutine_threadsafe(self._ws.send(req.encode()), self._loop)

    def close(self, timeout: float = 10.0):
        """The closing handshake; returns once the receive loop ended."""
        if self._close_requested is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._close_requested.set)
            self._thread.join(timeout)


def ws_round_trip(host: str, port: int, req: Request, timeout: float = 10.0) -> Request:
    """One-shot synchronous request/reply on a fresh connection — the
    Register handshake (reference: ClientService::Register,
    ClientService.cc:113-172)."""

    async def go():
        ws = await ws_wire.connect(host, port, MAX_SIZE)
        try:
            await ws.send(req.encode())
            msg = await asyncio.wait_for(ws.recv(), timeout)
            return Request.decode(msg)
        finally:
            await ws.close()

    return asyncio.run(go())
