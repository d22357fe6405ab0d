"""RFC 6455 websockets on the standard library, both halves.

The port's stand-in for ``aiohttp``'s websocket client and server, which
the card's machine does not have.  ``connect`` is the client half (the
counterpart of ``ClientSession.ws_connect(url, headers=...,
heartbeat=20, max_msg_size=0)``): the HTTP/1.1 upgrade with a random
``Sec-WebSocket-Key`` whose ``Sec-WebSocket-Accept`` is checked, masked
frames, 7-, 16- and 64-bit payload lengths, fragmented messages
reassembled from continuation frames, a pong for every ping, a ping every
``heartbeat`` seconds (the peer is dropped when nothing comes back
within half of that, as aiohttp does) and the close handshake; messages
have no size bound, and each frame leaves at once (``TCP_NODELAY``, as
aiohttp sets it).  ``accept`` is the server half over an
``http.server`` request handler (test scaffolding uses it: the tunnel's
hub is control-plane code and stays in the reference).

A ``WebSocket`` may be written from several threads (one lock around
every frame) and is read by one.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import ssl
import struct
import threading
import time
import urllib.parse
from typing import Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
CLOSE_NORMAL = 1000


class WebSocketClosed(ConnectionError):
    """The connection ended: a close frame, or the socket went away."""


class HandshakeError(ConnectionError):
    """The server refused the upgrade (``status`` is its HTTP status)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a ``Sec-WebSocket-Key``."""
    return base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()).decode()


def _xor(data: bytes, mask: bytes) -> bytes:
    """``data`` masked with the 4-byte ``mask`` (one big-int XOR)."""
    n = len(data)
    if not n:
        return b""
    m = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(m, "big")).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, *, mask: bool,
                 fin: bool = True) -> bytes:
    """One frame: FIN and opcode, the shortest length form, the mask key
    and masked payload when ``mask`` (a client's frames)."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 1 << 16:
        head += bytes([bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([bit | 127]) + struct.pack(">Q", n)
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + _xor(payload, key)


class WebSocket:
    """One open websocket over a connected socket.  ``client``: this side
    masks what it sends (and the peer must not).  ``heartbeat``: seconds
    between this side's pings (None: no pings)."""

    def __init__(self, sock: socket.socket, rfile, *, client: bool,
                 heartbeat: Optional[float] = None):
        self.sock = sock
        self.rfile = rfile
        self.client = client
        self.heartbeat = heartbeat
        self._send_lock = threading.Lock()
        self._close_sent = False
        self.closed = threading.Event()
        self.close_code: Optional[int] = None
        self._last_recv = time.monotonic()
        self._pinger = None
        if heartbeat:
            self._pinger = threading.Thread(target=self._ping_loop,
                                            name="helix-ws-ping", daemon=True)
            self._pinger.start()

    # -- sending ------------------------------------------------------------

    def _send(self, opcode: int, payload: bytes = b"") -> None:
        frame = encode_frame(opcode, payload, mask=self.client)
        with self._send_lock:
            if self._close_sent:
                raise WebSocketClosed("the websocket is closing")
            if opcode == OP_CLOSE:
                self._close_sent = True
            try:
                self.sock.sendall(frame)
            except OSError as e:
                self._drop()
                raise WebSocketClosed(f"send failed: {e}") from e

    def send_bytes(self, data: bytes) -> None:
        self._send(OP_BINARY, bytes(data))

    def _ping_loop(self) -> None:
        """A ping every ``heartbeat`` seconds; the peer is gone when
        nothing (a pong or any frame) arrived within half of that."""
        while not self.closed.wait(self.heartbeat):
            sent = time.monotonic()
            try:
                self._send(OP_PING)
            except WebSocketClosed:
                return
            if self.closed.wait(self.heartbeat / 2):
                return
            if self._last_recv < sent:
                self._drop()
                return

    # -- receiving ----------------------------------------------------------

    def _read(self, n: int) -> bytes:
        data = self.rfile.read(n) if n else b""
        if len(data) < n:
            self._drop()
            raise WebSocketClosed("connection lost")
        return data

    def _frame(self) -> tuple:
        b0, b1 = self._read(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        key = self._read(4) if b1 & 0x80 else None
        payload = self._read(n)
        if key is not None:
            payload = _xor(payload, key)
        self._last_recv = time.monotonic()
        return bool(b0 & 0x80), b0 & 0x0F, payload

    def recv(self) -> tuple:
        """The next data message as ``(opcode, payload)`` (``OP_TEXT`` or
        ``OP_BINARY``; continuation frames joined); pings are answered
        here.  Raises ``WebSocketClosed`` once the peer closed (the
        close frame echoed) or the socket went away."""
        parts, first_op = [], None
        while True:
            try:
                fin, op, payload = self._frame()
            except OSError as e:
                self._drop()
                raise WebSocketClosed(f"connection lost: {e}") from e
            if op == OP_PING:
                try:
                    self._send(OP_PONG, payload)
                except WebSocketClosed:
                    pass
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                self.close_code = (struct.unpack(">H", payload[:2])[0]
                                   if len(payload) >= 2 else None)
                try:
                    self._send(OP_CLOSE, payload[:2])
                except WebSocketClosed:
                    pass
                self._drop()
                raise WebSocketClosed(f"closed by peer ({self.close_code})")
            if op == OP_CONT:
                if first_op is None:
                    continue          # a stray continuation: ignored
                parts.append(payload)
            else:
                first_op, parts = op, [payload]
            if fin:
                return first_op, b"".join(parts)

    # -- closing ------------------------------------------------------------

    def close(self, code: int = CLOSE_NORMAL, wait: float = 2.0) -> None:
        """Start the close handshake; the socket is shut once the reader
        has seen the peer's close frame, or after ``wait`` seconds."""
        if self.closed.is_set():
            return
        try:
            self._send(OP_CLOSE, struct.pack(">H", code))
        except WebSocketClosed:
            pass
        if not self.closed.wait(wait):
            self._drop()

    def _drop(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect(url: str, headers: Optional[dict] = None, *,
            timeout: float = 10.0,
            heartbeat: Optional[float] = 20.0) -> WebSocket:
    """Dial ``url`` (``http``/``ws``, or ``https``/``wss`` over TLS) and
    upgrade; raises ``HandshakeError`` when the server answers anything
    but a 101 with the right accept key, ``OSError`` when it cannot be
    reached."""
    u = urllib.parse.urlsplit(url)
    tls = u.scheme in ("https", "wss")
    host = u.hostname or "localhost"
    port = u.port or (443 if tls else 80)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        _no_delay(sock)
        if tls:
            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=host)
        key = base64.b64encode(os.urandom(16)).decode()
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        lines = [f"GET {path} HTTP/1.1", f"Host: {u.netloc}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        rfile = sock.makefile("rb")
        status_line = rfile.readline(65537).decode("latin-1").strip()
        parts = status_line.split(" ", 2)
        status = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() \
            else 0
        got = {}
        while True:
            line = rfile.readline(65537).decode("latin-1")
            if line in ("\r\n", "\n", ""):
                break
            k, _, v = line.partition(":")
            got[k.strip().lower()] = v.strip()
        if status != 101:
            raise HandshakeError(status, f"websocket upgrade refused: "
                                 f"{status_line!r}")
        if got.get("upgrade", "").lower() != "websocket" or \
                got.get("sec-websocket-accept") != accept_key(key):
            raise HandshakeError(status, "websocket upgrade: bad "
                                 "Upgrade / Sec-WebSocket-Accept")
        sock.settimeout(None)
        return WebSocket(sock, rfile, client=True, heartbeat=heartbeat)
    except BaseException:
        sock.close()
        raise


def _no_delay(sock: socket.socket) -> None:
    """Send each frame at once: without ``TCP_NODELAY`` a small frame
    written while the previous one is unacknowledged waits for the peer's
    delayed ACK (~40 ms on Linux); an SSE stream is many small frames."""
    if sock.family in (socket.AF_INET, socket.AF_INET6):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def accept(handler, *, heartbeat: Optional[float] = None) -> WebSocket:
    """The server half: answer an ``http.server`` handler's upgrade
    request with 101 and return the socket as a ``WebSocket`` (the
    handler's thread then owns it).  Raises ``HandshakeError`` (after
    answering 400) for a request that is not an upgrade."""
    key = handler.headers.get("Sec-WebSocket-Key", "")
    if handler.headers.get("Upgrade", "").lower() != "websocket" or not key:
        handler.send_error(400, "expected a websocket upgrade")
        raise HandshakeError(400, "not a websocket upgrade")
    handler.protocol_version = "HTTP/1.1"
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    handler.close_connection = True
    _no_delay(handler.connection)
    return WebSocket(handler.connection, handler.rfile, client=False,
                     heartbeat=heartbeat)
