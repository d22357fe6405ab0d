"""A stand-in for the control plane's runner endpoints (standard library).

The reference control plane (``helix_tpu/control/server.py``) is written
on aiohttp; this stub serves the three endpoints a node agent calls, with
the reference's JSON, so a port runner can be driven where aiohttp is not
installed:

- ``POST /api/v1/runners/{id}/heartbeat``: records every body with its
  arrival time (``time.monotonic()``) in ``beats[id]``; a body with
  ``draining: true`` clears that runner's drain request, as the
  reference's does; answers ``{"ok": true}``;
- ``GET /api/v1/runners/{id}/assignment``: ``{"runner_id",
  "profile_name", "profile", "drain"}`` from ``assign(id, profile)`` and
  ``request_drain(id)``; each answer is logged in ``polls[id]`` as
  (arrival time, profile name, drain);
- ``GET /api/v1/runners/{id}/migration-targets``: ``{"targets": [...]}``,
  the reference router's rule over the recorded heartbeats (a running,
  not draining runner with an address and models, other than the asker),
  each ``{"id", "address", "models", "role"}``;
- ``GET /api/v1/runners/{id}/tunnel``: a runner's reverse-tunnel dial (a
  websocket, ``control.websocket``).  A newer dial replaces an older
  one; ``dials[id]`` counts them.  ``tunnel_request(id, method, path,
  headers, body)`` sends one request through it in the reference hub's
  frames (``control.tunnel``) and returns ``(status, headers, chunks)``,
  ``chunks`` an iterator of the body's chunks as they arrive (closing it
  early sends ``OP_CLOSE``); a request made while the runner has no
  tunnel waits up to ``GRACE`` seconds for its dial, as the hub's queued
  dials do, and ``TunnelClosed`` is raised when none comes or the tunnel
  drops.
  ``drop_tunnel(id)`` closes the runner's websocket from this side;
- the disaggregated handoff plan (the reference control plane's one
  handoff attempt per streamed request): ``disagg_request(model, body,
  prefill_id, decode_id)`` sends a streamed request to the prefill node
  with ``X-Helix-Disagg`` and the decode node's id and address; on a
  ``migrated ... peer=`` frame it resumes the stream on the peer through
  ``/v1/migrate/resume``, and on any other failure of the attempt before
  a token was forwarded it dispatches the request to the decode node as
  an ordinary stream.  It returns the client's text and frames and the
  rung taken (``handoff``, ``prefill_local`` or ``fallback``).

    stub = ControlStub().start()        # stub.url: http://127.0.0.1:<port>
    stub.assign("a", profile_dict)
    ...
    stub.stop()
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from helix_tpu_torch.control import websocket
from helix_tpu_torch.control.tunnel import (
    OP_BODY,
    OP_CLOSE,
    OP_END,
    OP_ERR,
    OP_OPEN,
    OP_RESP,
    TunnelClosed,
    pack_frame,
    unpack_frame,
)
from helix_tpu_torch.serving.migration import (
    DISAGG_HEADER,
    DISAGG_PEER_ADDR_HEADER,
    DISAGG_PEER_ID_HEADER,
    parse_migrated_peer,
)

_PREFIX = "/api/v1/runners/"
# seconds a request waits for a runner's dial (the hub's reconnect grace)
GRACE = 30.0


class _Tunnel:
    """One runner's live websocket, multiplexing logical streams (the
    reference hub's ``TunnelConn`` on threads)."""

    def __init__(self, ws: websocket.WebSocket):
        self.ws = ws
        self._lock = threading.Lock()
        self._streams: dict = {}     # sid -> queue of events
        self._sids = itertools.count(1)
        self.closed = False

    def pump(self) -> None:
        """Read frames until the socket dies; fan out to streams."""
        try:
            while True:
                kind, data = self.ws.recv()
                if kind != websocket.OP_BINARY:
                    continue
                sid, op, payload = unpack_frame(data)
                with self._lock:
                    q = self._streams.get(sid)
                    if q is not None and op in (OP_END, OP_ERR, OP_CLOSE):
                        del self._streams[sid]
                if q is None:
                    continue
                if op == OP_RESP:
                    q.put(("resp", json.loads(payload)))
                elif op == OP_BODY:
                    q.put(("body", payload))
                elif op == OP_END:
                    q.put(("end", None))
                elif op in (OP_ERR, OP_CLOSE):
                    detail = ""
                    if payload:
                        try:
                            detail = json.loads(payload).get("error", "")
                        except ValueError:
                            detail = payload[:200].decode("utf-8", "replace")
                    q.put(("err", detail or "stream closed by runner"))
        except websocket.WebSocketClosed:
            pass
        finally:
            self.close("tunnel disconnected")

    def close(self, reason: str) -> None:
        with self._lock:
            self.closed = True
            streams, self._streams = self._streams, {}
        for q in streams.values():
            q.put(("err", reason))
        self.ws.close(wait=1.0)

    def request(self, method, path, headers, body, timeout) -> tuple:
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            if self.closed:
                raise TunnelClosed("tunnel is closed")
            sid = next(self._sids)
            self._streams[sid] = q
        try:
            self.ws.send_bytes(pack_frame(sid, OP_OPEN, json.dumps(
                {"method": method, "path": path,
                 "headers": headers or {}}).encode()))
            if body:
                self.ws.send_bytes(pack_frame(sid, OP_BODY, body))
            self.ws.send_bytes(pack_frame(sid, OP_END))
        except websocket.WebSocketClosed as e:
            raise TunnelClosed(f"tunnel send failed: {e}") from e
        kind, doc = q.get(timeout=timeout)
        if kind != "resp":
            raise TunnelClosed(doc)

        def chunks():
            try:
                while True:
                    kind, item = q.get(timeout=timeout)
                    if kind == "end":
                        return
                    if kind == "err":
                        raise TunnelClosed(item)
                    yield item
            finally:
                # the caller stopped early: abort the runner's request
                with self._lock:
                    live = self._streams.pop(sid, None) is not None
                if live:
                    try:
                        self.ws.send_bytes(pack_frame(sid, OP_CLOSE))
                    except websocket.WebSocketClosed:
                        pass

        return int(doc["status"]), dict(doc.get("headers", {})), chunks()


class ControlStub:
    def __init__(self):
        self.tunnels: dict = {}        # runner id -> live _Tunnel
        self.dials: dict = {}          # runner id -> tunnel dials accepted
        self._lock = threading.Lock()
        self._dialed = threading.Condition(self._lock)
        self.beats: dict = {}          # runner id -> [(t, body), ...]
        self.assignments: dict = {}    # runner id -> profile dict
        self.drain_requested: set = set()
        # runner id -> [(time, profile name answered, drain), ...]
        self.polls: dict = {}
        self.httpd: Optional[ThreadingHTTPServer] = None

    # -- operator side ----------------------------------------------------

    def assign(self, runner_id: str, profile: Optional[dict]) -> None:
        with self._lock:
            self.assignments[runner_id] = profile

    def request_drain(self, runner_id: str) -> None:
        with self._lock:
            self.drain_requested.add(runner_id)

    def heartbeats(self, runner_id: str) -> list:
        """(arrival time, body) of every heartbeat of ``runner_id``."""
        with self._lock:
            return list(self.beats.get(runner_id, ()))

    def last(self, runner_id: str) -> Optional[dict]:
        beats = self.heartbeats(runner_id)
        return beats[-1][1] if beats else None

    def wait_for(self, runner_id: str, pred, timeout: float = 600.0,
                 after: float = 0.0) -> dict:
        """The first heartbeat of ``runner_id`` that arrived after
        ``after`` and satisfies ``pred(body)``; raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for t, body in self.heartbeats(runner_id):
                if t > after and pred(body):
                    return body
            time.sleep(0.05)
        raise TimeoutError(f"no heartbeat of {runner_id!r} matched within "
                           f"{timeout:.0f}s")

    def address(self, runner_id: str) -> str:
        """The address ``runner_id`` advertised in its last heartbeat."""
        body = self.last(runner_id) or {}
        if not body.get("address"):
            raise KeyError(f"runner {runner_id!r} advertised no address")
        return body["address"].rstrip("/")

    # -- the disaggregated handoff plan -------------------------------------

    @staticmethod
    def _sse(url: str, body: dict, headers: dict, timeout: float) -> tuple:
        """The JSON frames of one streamed POST (``[DONE]`` left out) and
        the arrival time (``time.monotonic()``) of the first frame that
        carries text, or None; raises ``urllib.error.URLError`` /
        ``OSError`` on a failed dispatch and ``HTTPError`` on a status
        other than 200."""
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **headers})
        frames, t_text = [], None
        with urllib.request.urlopen(req, timeout=timeout) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: {"):
                    continue
                frames.append(json.loads(line[6:]))
                if t_text is None and ControlStub._text([frames[-1]])[0]:
                    t_text = time.monotonic()
        return frames, t_text

    @staticmethod
    def _text(frames: list) -> tuple:
        """(text, finish reason, error frames) of OpenAI chunk frames or
        of ``/v1/migrate/resume``'s ``{"delta", "finish_reason"}``
        frames."""
        text, finish, errors = "", None, []
        for f in frames:
            if "error" in f:
                errors.append(f["error"])
                continue
            if "choices" not in f:
                text += f.get("delta", "") or ""
                finish = f.get("finish_reason") or finish
                continue
            ch = f["choices"][0]
            delta = ch.get("delta")
            text += (delta.get("content", "") if delta is not None
                     else ch.get("text", "")) or ""
            finish = ch.get("finish_reason") or finish
        return text, finish, errors

    def disagg_request(self, model: str, body: dict, prefill_id: str,
                       decode_id: str, path: str = "/v1/chat/completions",
                       timeout: float = 600.0) -> dict:
        """One streamed request through the handoff plan: ``{"rung",
        "text", "finish", "frames", "errors", "peer", "request_id",
        "prior_text", "attempt_error", "ttft_s"}``.  ``prior_text`` is
        what the prefill node streamed before its ``migrated`` frame;
        ``attempt_error`` the failure that sent the request to the
        fallback dispatch; ``ttft_s`` the seconds from the dispatch to
        the first frame with text the client got."""
        body = {**body, "model": model, "stream": True}
        peer_addr = self.address(decode_id)
        token = os.environ.get("HELIX_RUNNER_TOKEN", "")
        auth = {"X-Runner-Token": token} if token else {}
        out = {"rung": None, "text": "", "finish": None, "frames": [],
               "errors": [], "peer": None, "request_id": None,
               "prior_text": "", "attempt_error": None, "ttft_s": None}
        t0 = time.monotonic()

        def since(t):
            return None if t is None else t - t0

        try:
            frames, t_text = self._sse(
                self.address(prefill_id) + path, body,
                {**auth, DISAGG_HEADER: "prefill",
                 DISAGG_PEER_ID_HEADER: decode_id,
                 DISAGG_PEER_ADDR_HEADER: peer_addr}, timeout)
        except (OSError, ValueError) as e:
            frames, out["attempt_error"] = None, repr(e)
        if frames is not None:
            text, finish, errors = self._text(frames)
            migrated = next((e for e in errors if parse_migrated_peer(
                str(e.get("message", "")))), None)
            if migrated is not None:
                peer = parse_migrated_peer(migrated["message"])
                try:
                    target = self.address(peer)
                except KeyError:
                    target = peer_addr
                resumed, t_res = self._sse(target + "/v1/migrate/resume", {
                    "request_id": migrated.get("request_id", ""),
                    "emitted_chars": len(text)}, auth, timeout)
                more, finish, errors = self._text(resumed)
                out.update(rung="handoff", peer=peer,
                           request_id=migrated.get("request_id"),
                           prior_text=text, frames=frames + resumed,
                           text=text + more, finish=finish, errors=errors,
                           ttft_s=since(t_text if t_text is not None
                                        else t_res))
                return out
            if not errors or text:
                # served on the prefill node; once tokens reached the
                # client, the attempt's error is the client's
                out.update(rung="prefill_local", text=text, finish=finish,
                           frames=frames, errors=errors,
                           ttft_s=since(t_text))
                return out
            out["attempt_error"] = errors[0].get("message", "")
        frames, t_text = self._sse(self.address(decode_id) + path, body,
                                   auth, timeout)
        text, finish, errors = self._text(frames)
        out.update(rung="fallback", text=text, finish=finish, frames=frames,
                   errors=errors, ttft_s=since(t_text))
        return out

    # -- the runner endpoints ---------------------------------------------

    def _heartbeat(self, rid: str, body: dict) -> dict:
        with self._lock:
            self.beats.setdefault(rid, []).append((time.monotonic(), body))
            if body.get("draining") is True:
                self.drain_requested.discard(rid)
        return {"ok": True}

    def _assignment(self, rid: str) -> dict:
        with self._lock:
            prof = self.assignments.get(rid)
            doc = {"runner_id": rid,
                   "profile_name": (prof or {}).get("name"),
                   "profile": prof,
                   "drain": rid in self.drain_requested}
            self.polls.setdefault(rid, []).append(
                (time.monotonic(), doc["profile_name"], doc["drain"]))
            return doc

    def _targets(self, rid: str) -> dict:
        out = []
        with self._lock:
            for other in sorted(self.beats):
                body = self.beats[other][-1][1]
                prof = body.get("profile") or {}
                if (other != rid and body.get("address")
                        and not body.get("draining")
                        and prof.get("status") == "running"
                        and prof.get("models")):
                    out.append({"id": other, "address": body["address"],
                                "models": list(prof["models"]),
                                "role": body.get("role", "mixed")})
        return {"targets": out}

    # -- the reverse tunnel -------------------------------------------------

    def _serve_tunnel(self, rid: str, handler) -> None:
        """A runner's dial, on its handler thread until the socket dies."""
        ws = websocket.accept(handler)
        conn = _Tunnel(ws)
        with self._dialed:
            old = self.tunnels.get(rid)
            self.tunnels[rid] = conn
            self.dials[rid] = self.dials.get(rid, 0) + 1
            self._dialed.notify_all()
        if old is not None:
            old.close("replaced by a newer tunnel")
        try:
            conn.pump()
        finally:
            with self._lock:
                if self.tunnels.get(rid) is conn:
                    del self.tunnels[rid]

    def tunnel_request(self, runner_id: str, method: str, path: str,
                       headers: Optional[dict] = None, body: bytes = b"",
                       timeout: float = 600.0) -> tuple:
        """One request through ``runner_id``'s tunnel: ``(status,
        headers, chunks)``."""
        deadline = time.monotonic() + GRACE
        with self._dialed:
            while True:
                conn = self.tunnels.get(runner_id)
                if conn is not None and not conn.closed:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TunnelClosed(f"runner {runner_id} has no tunnel "
                                       f"(waited {GRACE}s)")
                self._dialed.wait(left)
        return conn.request(method, path, headers, body, timeout)

    def drop_tunnel(self, runner_id: str) -> None:
        """Close the runner's websocket from the control plane's side."""
        with self._lock:
            conn = self.tunnels.get(runner_id)
        if conn is not None:
            conn.ws.close(wait=1.0)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> "ControlStub":
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, status: int, doc: dict):
                data = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _route(self):
                if not self.path.startswith(_PREFIX):
                    return None, ""
                rid, _, what = self.path[len(_PREFIX):].partition("/")
                return rid, what

            def do_POST(self):
                rid, what = self._route()
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._reply(400, {"error": "invalid JSON body"})
                    return
                if rid and what == "heartbeat" and isinstance(body, dict):
                    self._reply(200, stub._heartbeat(rid, body))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_GET(self):
                rid, what = self._route()
                if rid and what == "tunnel":
                    stub._serve_tunnel(rid, self)
                elif rid and what == "assignment":
                    self._reply(200, stub._assignment(rid))
                elif rid and what == "migration-targets":
                    self._reply(200, stub._targets(rid))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="helix-control-stub").start()
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self) -> None:
        with self._lock:
            conns = list(self.tunnels.values())
        for conn in conns:
            conn.ws.close(wait=1.0)
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
