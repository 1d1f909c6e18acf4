"""WebSocket protocol (RFC 6455) on asyncio streams, for `net/wsrpc.py`.

The JAX package's transport runs on the `websockets` library; the port
speaks the same protocol over `asyncio.start_server` /
`asyncio.open_connection`, so either side can talk to the other:

- the HTTP/1.1 upgrade handshake, `Sec-WebSocket-Accept` being
  base64(SHA-1(key + the RFC's GUID));
- frames with 7-, 16- and 64-bit payload lengths, masked from the client
  (RFC 6455 5.3) and unmasked from the server;
- messages in one frame or in fragments (continuation frames), with
  control frames between the fragments;
- pings answered with pongs (a `websockets` peer pings every 20 s and
  closes the connection when no pong comes back);
- the closing handshake from either side.

No extension is negotiated: the client offers none, and the server
leaves a `websockets` client's `permessage-deflate` offer out of its reply,
which declines it.  A connection is used from the event loop that opened
it.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct

import numpy as np

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_HEADER_BYTES = 16 << 10

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL_ERROR, CLOSE_TOO_BIG = 1000, 1002, 1009


class ConnectionClosed(Exception):
    """The connection ended: a close frame, or the stream's end."""


class HandshakeError(Exception):
    """The HTTP upgrade was refused or malformed."""


def accept_key(key: bytes) -> bytes:
    return base64.b64encode(hashlib.sha1(key + GUID).digest())


def mask(data: bytes, key: bytes) -> bytes:
    """XOR `data` with the 4-byte masking `key` repeated (RFC 6455 5.3)."""
    n = len(data)
    if n == 0:
        return b""
    keys = np.frombuffer(key * ((n + 3) // 4), np.uint8)[:n]
    return (np.frombuffer(data, np.uint8) ^ keys).tobytes()


def encode_frame(opcode: int, payload: bytes, masked: bool, fin: bool = True) -> bytes:
    """One frame: FIN + opcode, the length in 7, 16 or 64 bits, the mask
    key and masked payload from a client, the payload as it is from a
    server."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if masked else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 1 << 16:
        head += bytes([bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([bit | 127]) + struct.pack(">Q", n)
    if masked:
        key = os.urandom(4)
        return head + key + mask(payload, key)
    return head + payload


async def _read_http_head(reader: asyncio.StreamReader) -> list[str]:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError) as e:
        raise HandshakeError(f"no complete HTTP head: {e}") from None
    if len(head) > MAX_HEADER_BYTES:
        raise HandshakeError("HTTP head too long")
    return head.decode("latin-1").split("\r\n")[:-2]


def _headers(lines: list[str]) -> dict[str, str]:
    out = {}
    for ln in lines:
        name, sep, value = ln.partition(":")
        if not sep:
            raise HandshakeError(f"bad header line {ln!r}")
        key = name.strip().lower()
        out[key] = f"{out[key]}, {value.strip()}" if key in out else value.strip()
    return out


class WebSocket:
    """One open connection.  `recv()` returns the next whole message
    (bytes for binary, str for text), answering pings and closes on the
    way; `send()` writes one message as one frame."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, max_size: int):
        self.reader, self.writer = reader, writer
        self.client = client
        self.max_size = max_size
        self.close_code: int | None = None
        self._close_sent = False
        self._closed = asyncio.Event()   # the peer's close frame came, or the stream ended
        self._reading = False
        self._write_lock = asyncio.Lock()

    # -- writing ---------------------------------------------------------
    async def _write(self, opcode: int, payload: bytes, fin: bool = True):
        async with self._write_lock:
            self.writer.write(encode_frame(opcode, payload, masked=self.client, fin=fin))
            await self.writer.drain()

    async def send(self, message: bytes | str):
        if self._close_sent or self._closed.is_set():
            raise ConnectionClosed("send on a closing connection")
        if isinstance(message, str):
            await self._write(OP_TEXT, message.encode())
        else:
            await self._write(OP_BINARY, bytes(message))

    async def ping(self, payload: bytes = b""):
        await self._write(OP_PING, payload)

    # -- reading ---------------------------------------------------------
    async def _read_frame(self) -> tuple[bool, int, bytes]:
        try:
            b0, b1 = await self.reader.readexactly(2)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", await self.reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", await self.reader.readexactly(8))
            if b0 & 0x70:
                await self._fail(CLOSE_PROTOCOL_ERROR, "reserved bits set: no extension was agreed")
            if bool(b1 & 0x80) == self.client:
                await self._fail(CLOSE_PROTOCOL_ERROR, "frame masked the wrong way for its side")
            if n > self.max_size:
                await self._fail(CLOSE_TOO_BIG, f"frame of {n} bytes over {self.max_size}")
            key = await self.reader.readexactly(4) if b1 & 0x80 else None
            payload = await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            self._closed.set()
            raise ConnectionClosed("stream ended") from None
        if key is not None:
            payload = mask(payload, key)
        return bool(b0 & 0x80), b0 & 0x0F, payload

    async def _fail(self, code: int, reason: str):
        if not self._close_sent:
            self._close_sent = True
            try:
                await self._write(OP_CLOSE, struct.pack(">H", code) + reason.encode()[:120])
            except ConnectionError:
                pass
        self.writer.close()
        self._closed.set()
        raise ConnectionClosed(reason)

    async def recv(self) -> bytes | str:
        """The next message.  Raises ConnectionClosed once the closing
        handshake is done or the stream ended."""
        self._reading = True
        try:
            parts, opcode, size = [], None, 0
            while True:
                if self._closed.is_set():
                    raise ConnectionClosed(f"closed with code {self.close_code}")
                fin, op, payload = await self._read_frame()
                if op >= 0x8:  # control frames: whole, and may come between fragments
                    if not fin or len(payload) > 125:
                        await self._fail(CLOSE_PROTOCOL_ERROR, "bad control frame")
                    if op == OP_PING:
                        if not self._close_sent:
                            await self._write(OP_PONG, payload)
                    elif op == OP_CLOSE:
                        self.close_code = (struct.unpack(">H", payload[:2])[0]
                                           if len(payload) >= 2 else 1005)
                        if not self._close_sent:  # echo the peer's close
                            self._close_sent = True
                            try:
                                await self._write(OP_CLOSE, payload[:2])
                            except ConnectionError:
                                pass
                        self._closed.set()
                        if not self.client:  # the server ends the TCP connection
                            self.writer.close()
                        raise ConnectionClosed(f"closed with code {self.close_code}")
                    elif op != OP_PONG:
                        await self._fail(CLOSE_PROTOCOL_ERROR, f"unknown opcode {op}")
                    continue
                if op == OP_CONT and opcode is None or op != OP_CONT and opcode is not None:
                    await self._fail(CLOSE_PROTOCOL_ERROR, "continuation out of place")
                if op not in (OP_CONT, OP_TEXT, OP_BINARY):
                    await self._fail(CLOSE_PROTOCOL_ERROR, f"unknown opcode {op}")
                opcode = op if opcode is None else opcode
                size += len(payload)
                if size > self.max_size:
                    await self._fail(CLOSE_TOO_BIG, f"message over {self.max_size} bytes")
                parts.append(payload)
                if fin:
                    data = b"".join(parts)
                    return data.decode() if opcode == OP_TEXT else data
        finally:
            self._reading = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    # -- closing ---------------------------------------------------------
    async def close(self, code: int = CLOSE_NORMAL, timeout: float = 10.0):
        """Send a close frame and wait (at most `timeout`) for the peer's;
        then end the TCP connection."""
        if not self._close_sent and not self._closed.is_set():
            self._close_sent = True
            try:
                await self._write(OP_CLOSE, struct.pack(">H", code))
            except ConnectionError:
                self._closed.set()
        try:
            if self._reading:  # another task reads: it sees the reply
                await asyncio.wait_for(self._closed.wait(), timeout)
            else:
                async def drain():
                    while True:
                        await self.recv()
                await asyncio.wait_for(drain(), timeout)
        except (ConnectionClosed, asyncio.TimeoutError):
            pass
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except ConnectionError:
            pass

    def abort(self):
        """End the TCP connection at once (on the connection's loop)."""
        self._closed.set()
        self.writer.close()


async def accept(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_size: int) -> WebSocket:
    """The server's side of the handshake, on a fresh TCP connection.
    Answers a bad upgrade with 400 and raises HandshakeError."""
    try:
        lines = await _read_http_head(reader)
        if not lines or not lines[0].startswith("GET "):
            raise HandshakeError(f"not a GET request: {lines[:1]}")
        h = _headers(lines[1:])
        key = h.get("sec-websocket-key", "")
        try:
            nonce = base64.b64decode(key, validate=True)
        except ValueError:
            nonce = b""
        if ("websocket" not in h.get("upgrade", "").lower()
                or "upgrade" not in h.get("connection", "").lower()
                or h.get("sec-websocket-version") != "13" or len(nonce) != 16):
            raise HandshakeError("not a WebSocket version 13 upgrade")
    except HandshakeError:
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
        writer.close()
        raise
    writer.write(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                 b"Connection: Upgrade\r\nSec-WebSocket-Accept: " + accept_key(key.encode())
                 + b"\r\n\r\n")
    await writer.drain()
    return WebSocket(reader, writer, client=False, max_size=max_size)


async def connect(host: str, port: int, max_size: int, path: str = "/") -> WebSocket:
    """Open a TCP connection and do the client's side of the handshake."""
    reader, writer = await asyncio.open_connection(host, port)
    key = base64.b64encode(os.urandom(16))
    writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                 "Connection: Upgrade\r\n".encode() + b"Sec-WebSocket-Key: " + key
                 + b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
    await writer.drain()
    try:
        lines = await _read_http_head(reader)
        status = lines[0].split() if lines else []
        if len(status) < 2 or status[1] != "101":
            raise HandshakeError(f"upgrade refused: {lines[:1]}")
        h = _headers(lines[1:])
        if h.get("sec-websocket-accept", "").encode() != accept_key(key):
            raise HandshakeError("wrong Sec-WebSocket-Accept")
        if h.get("sec-websocket-extensions"):
            raise HandshakeError(f"the server chose an extension we did not offer: "
                                 f"{h['sec-websocket-extensions']}")
    except HandshakeError:
        writer.close()
        raise
    return WebSocket(reader, writer, client=True, max_size=max_size)
