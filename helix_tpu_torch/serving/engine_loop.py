"""Engine driver thread: bridges HTTP handler threads to the step loop.

Port of the core of ``helix_tpu/serving/engine_loop.py``: one dedicated
thread owns the ``Engine`` (every device call stays on it); handlers submit
through a thread-safe inbox and receive per-request ``TokenEvent``s through
callbacks, called on the engine thread.  A step that raises fails the
requests in flight with an error event and the loop keeps serving.

Not ported yet: the scheduler, SLO accounting, flight recorder, admission
bounds, quarantine bisection, migration and disaggregation.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Callable, Optional

from helix_tpu_torch.engine.engine import Engine, Request

log = logging.getLogger("helix_tpu_torch.engine")

SHUTTING_DOWN = "shutting_down"


@dataclasses.dataclass
class TokenEvent:
    request_id: str
    token_id: int
    finished: bool
    finish_reason: Optional[str] = None
    error: Optional[str] = None


def _error_event(request_id: str, message: str) -> TokenEvent:
    return TokenEvent(request_id=request_id, token_id=-1, finished=True,
                      finish_reason="error", error=message)


class EngineLoop:
    def __init__(self, engine: Engine, name: str = "engine"):
        self.engine = engine
        self.name = name
        self._inbox: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._subscribers: dict[str, Callable[[TokenEvent], None]] = {}
        self._thread: Optional[threading.Thread] = None

    def submit(self, req: Request, on_event: Callable[[TokenEvent], None]):
        """Queue a request; ``on_event`` receives its tokens and a final
        event.  Unservable requests get an error event at once."""
        err = self.engine.validate_request(req)
        if err is None and self._stop.is_set():
            err = f"{SHUTTING_DOWN}: engine '{self.name}' is stopping"
        if err:
            on_event(_error_event(req.id, err))
            return
        self._inbox.put((req, on_event))
        self._wake.set()

    def abort(self, request_id: str):
        self._inbox.put((request_id, None))
        self._wake.set()

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name=f"helix-torch-engine-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, join: bool = True):
        self._stop.set()
        self._wake.set()
        if join and self._thread is not None:
            self._thread.join(timeout=30)

    # -- engine thread ------------------------------------------------------

    def _drain_inbox(self):
        while True:
            try:
                item, on_event = self._inbox.get_nowait()
            except queue.Empty:
                return
            if on_event is None:   # abort
                self.engine.abort(item)
                self._subscribers.pop(item, None)
                continue
            try:
                self.engine.add_request(item)
            except ValueError as e:
                on_event(_error_event(item.id, str(e)))
                continue
            self._subscribers[item.id] = on_event

    def _deliver(self, emitted) -> None:
        """``[(req, token), ...]`` -> events.  Within one step a finishing
        request's LAST token carries the finished flag."""
        last = {req.id: idx for idx, (req, _tok) in enumerate(emitted)}
        for idx, (req, token) in enumerate(emitted):
            fin = req.finished and last[req.id] == idx
            cb = self._subscribers.get(req.id)
            if cb is None:
                continue
            cb(TokenEvent(
                request_id=req.id, token_id=token, finished=fin,
                finish_reason=(
                    req.finish_reason.value
                    if fin and req.finish_reason else None
                ),
            ))
            if fin:
                self._subscribers.pop(req.id, None)

    def _fail_all(self, message: str) -> None:
        for rid, cb in list(self._subscribers.items()):
            self.engine.abort(rid)
            cb(_error_event(rid, message))
        self._subscribers.clear()

    def _run(self):
        while not self._stop.is_set():
            self._drain_inbox()
            if not self.engine.has_work():
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            try:
                emitted = self.engine.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive a bad step
                log.exception("engine step failed")
                self._fail_all(f"engine step failed: {e}")
                continue
            self._deliver(emitted)
        self._drain_inbox()
        self._fail_all(f"{SHUTTING_DOWN}: engine '{self.name}' stopped")
