"""Reverse tunnel, runner side: a node behind NAT dials OUT to the control
plane, which sends its requests back through the same websocket.

Port of ``helix_tpu/control/tunnel.py`` (the RevDial transport): the frame
codec, byte for byte, and ``TunnelAgent``.  One websocket per runner
carries multiplexed logical HTTP streams in binary frames ``[sid: u32
BE][op: u8][payload]``:

    OP_OPEN  (control->runner)  JSON {method, path, headers}
    OP_BODY  (both directions)  raw body bytes
    OP_END   (both directions)  body finished
    OP_RESP  (runner->control)  JSON {status, headers}
    OP_ERR   (runner->control)  JSON {error}
    OP_CLOSE (both directions)  abort the stream

The runner serves its OpenAI surface on a unix socket (no listening TCP
port: ``OpenAIServer.make_unix_server``) and the agent bridges frames to
it.  The reference is asyncio over aiohttp; the port is threads over the
standard library (``control.websocket``): one reader thread per tunnel,
one thread per stream, one lock around the socket's sends.  A stream
opens on ``OP_OPEN``, collects ``OP_BODY`` and is dispatched at
``OP_END``; the response goes back as ``OP_RESP`` (``Content-Type`` and
the trace header), then every chunk as ``read1`` hands it over (an SSE
frame leaves when the server flushes it, never buffered), then
``OP_END``; an exception becomes ``OP_ERR`` ``{"error": "<Type>:
<msg>"}``.  ``OP_CLOSE`` cancels the local request: its unix socket is
shut (the raw socket: ``http.client`` lets go of it once an HTTP/1.0
response is read), the server's next write sees the hang-up and the
engine aborts the request; nothing more is forwarded.  The hub is control-plane code and stays in the reference
(``testing.control_stub`` has a stand-in for runs without aiohttp).
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import struct
import threading
import time
from typing import Optional

from helix_tpu_torch.control import websocket
from helix_tpu_torch.obs.trace import TRACE_HEADER

log = logging.getLogger(__name__)

OP_OPEN = 0
OP_BODY = 1
OP_END = 2
OP_RESP = 3
OP_ERR = 4
OP_CLOSE = 5

_HDR = struct.Struct(">IB")
# request headers the local connection sets itself
_HOP = frozenset(("host", "content-length", "transfer-encoding",
                  "connection"))
READ_CHUNK = 1 << 16
# seconds between the tunnel's own pings (aiohttp's ``heartbeat=20``)
HEARTBEAT_SECONDS = 20.0
# a tunneled request's local timeout (the reference's ClientTimeout)
LOCAL_TIMEOUT = 600.0


def pack_frame(sid: int, op: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(sid, op) + payload


def unpack_frame(data: bytes) -> tuple[int, int, bytes]:
    sid, op = _HDR.unpack_from(data)
    return sid, op, data[_HDR.size:]


class TunnelClosed(Exception):
    """The runner's tunnel dropped (mid-stream or before dispatch)."""


class UnixHTTPConnection(http.client.HTTPConnection):
    """``http.client`` over an ``AF_UNIX`` socket."""

    def __init__(self, path: str, timeout: float = LOCAL_TIMEOUT):
        super().__init__("localhost", timeout=timeout)
        self.unix_path = path

    def connect(self):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        try:
            s.connect(self.unix_path)
        except OSError:
            s.close()
            raise
        self.sock = s


class _Dispatch:
    """One tunneled request against the local server, on its own
    thread."""

    def __init__(self, agent: "TunnelAgent", ws, sid: int, spec: dict,
                 body: bytes, streams: dict):
        self.agent, self.ws, self.sid = agent, ws, sid
        self.spec, self.body, self.streams = spec, body, streams
        self.cancelled = threading.Event()
        self._lock = threading.Lock()
        # the local socket itself: the server answers HTTP/1.0, so
        # ``getresponse`` closes the connection and sets ``conn.sock`` to
        # None while the response's file goes on reading this socket
        self.raw: Optional[socket.socket] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"helix-tunnel-{sid}")

    def cancel(self) -> None:
        """The control plane aborted the stream: shut the local socket so
        the server's next write fails and the engine aborts."""
        with self._lock:
            self.cancelled.set()
            raw = self.raw
        if raw is not None:
            _shut(raw)

    def _send(self, op: int, payload: bytes = b"") -> None:
        self.ws.send_bytes(pack_frame(self.sid, op, payload))

    def _run(self) -> None:
        conn = resp = None
        try:
            conn = UnixHTTPConnection(self.agent.unix_socket,
                                      timeout=LOCAL_TIMEOUT)
            conn.connect()
            with self._lock:
                self.raw = conn.sock
                if self.cancelled.is_set():
                    return
            headers = {k: v for k, v in
                       (self.spec.get("headers") or {}).items()
                       if k.lower() not in _HOP}
            conn.request(self.spec.get("method", "POST"),
                         self.spec.get("path", "/"),
                         body=self.body or None, headers=headers)
            resp = conn.getresponse()
            out = {"Content-Type": resp.getheader("Content-Type",
                                                  "application/json")}
            # trace correlation survives the tunnel hop
            tid = resp.getheader(TRACE_HEADER)
            if tid:
                out[TRACE_HEADER] = tid
            if self.cancelled.is_set():
                return
            self._send(OP_RESP, json.dumps(
                {"status": resp.status, "headers": out}).encode())
            while True:
                chunk = resp.read1(READ_CHUNK)
                if self.cancelled.is_set():
                    return
                if not chunk:
                    break
                self._send(OP_BODY, chunk)
            self._send(OP_END)
        except Exception as e:  # noqa: BLE001 — reported through the tunnel
            if not self.cancelled.is_set():
                try:
                    self._send(OP_ERR, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                except Exception:  # noqa: BLE001 — socket already gone
                    pass
        finally:
            if resp is not None:
                resp.close()
            if conn is not None:
                conn.close()
            if self.streams.get(self.sid) is self:
                self.streams.pop(self.sid, None)
            self.agent._active.discard(self)


def _shut(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:   # already closed
        pass


class TunnelAgent:
    """Runner side: dial the control plane, serve tunneled requests
    against the local (unix-socket) HTTP surface, stream responses back.
    ``run`` blocks, re-dialing ``reconnect_delay`` seconds after every
    drop until ``stop``; ``start`` runs it on a thread.  ``connects``
    counts successful dials."""

    def __init__(
        self,
        runner_id: str,
        control_url: str,
        *,
        unix_socket: str,
        runner_token: str = "",
        reconnect_delay: float = 1.0,
    ):
        self.runner_id = runner_id
        self.control_url = control_url.rstrip("/")
        self.unix_socket = unix_socket
        self.runner_token = runner_token
        self.reconnect_delay = reconnect_delay
        self._stop = threading.Event()
        self._ws: Optional[websocket.WebSocket] = None
        self._thread: Optional[threading.Thread] = None
        self._active: set = set()     # dispatches in flight
        self.connects = 0   # observability: how many times we dialed

    @property
    def url(self) -> str:
        return f"{self.control_url}/api/v1/runners/{self.runner_id}/tunnel"

    def run(self) -> None:
        headers = ({"X-Runner-Token": self.runner_token}
                   if self.runner_token else {})
        while not self._stop.is_set():
            try:
                ws = websocket.connect(self.url, headers,
                                       heartbeat=HEARTBEAT_SECONDS)
            except (OSError, websocket.HandshakeError) as e:
                log.debug("tunnel dial to %s failed: %s", self.url, e)
            else:
                self.connects += 1
                self._ws = ws
                try:
                    if not self._stop.is_set():
                        self._serve(ws)
                finally:
                    self._ws = None
                    ws.close(wait=1.0)
            self._stop.wait(self.reconnect_delay)

    def start(self) -> "TunnelAgent":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="helix-tunnel")
        self._thread.start()
        return self

    def stop(self, join: bool = False, drain: float = 10.0) -> None:
        """Stop dialing; the streams in flight get up to ``drain`` seconds
        to end (their last frames leave through the tunnel, as after a
        node's own drain), then the tunnel closes."""
        self._stop.set()
        deadline = time.monotonic() + drain
        for d in list(self._active):
            d.thread.join(max(0.0, deadline - time.monotonic()))
        ws = self._ws
        if ws is not None:
            ws.close(wait=1.0)
        if join and self._thread is not None:
            self._thread.join(timeout=5.0)

    def _serve(self, ws: websocket.WebSocket) -> None:
        bodies: dict = {}
        opens: dict = {}
        streams: dict = {}
        try:
            while True:
                kind, data = ws.recv()
                if kind != websocket.OP_BINARY:
                    continue
                sid, op, payload = unpack_frame(data)
                if op == OP_OPEN:
                    opens[sid] = json.loads(payload)
                    bodies[sid] = bytearray()
                elif op == OP_BODY and sid in bodies:
                    bodies[sid] += payload
                elif op == OP_END and sid in opens:
                    d = _Dispatch(self, ws, sid, opens.pop(sid),
                                  bytes(bodies.pop(sid)), streams)
                    streams[sid] = d
                    self._active.add(d)
                    d.thread.start()
                elif op == OP_CLOSE:
                    # the control plane aborted the stream (client went
                    # away): cancel the local request so the engine aborts
                    opens.pop(sid, None)
                    bodies.pop(sid, None)
                    d = streams.pop(sid, None)
                    if d is not None:
                        d.cancel()
        except websocket.WebSocketClosed:
            pass
        finally:
            for d in list(streams.values()):
                d.cancel()
