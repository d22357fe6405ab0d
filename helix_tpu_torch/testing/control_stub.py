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
  each ``{"id", "address", "models", "role"}``.

    stub = ControlStub().start()        # stub.url: http://127.0.0.1:<port>
    stub.assign("a", profile_dict)
    ...
    stub.stop()
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PREFIX = "/api/v1/runners/"


class ControlStub:
    def __init__(self):
        self._lock = threading.Lock()
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
                if rid and what == "assignment":
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
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
