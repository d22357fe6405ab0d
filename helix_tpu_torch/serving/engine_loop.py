"""Engine driver thread: bridges HTTP handler threads to the step loop.

Port of the core of ``helix_tpu/serving/engine_loop.py``: one dedicated
thread owns the ``Engine`` (every device call stays on it); handlers submit
through a thread-safe inbox and receive per-request ``TokenEvent``s through
callbacks.  A step that raises fails the requests in flight with an error
event and the loop keeps serving.

With ``EngineConfig.enable_async_loop`` the loop pipelines (the
reference's ``_run``): it dispatches step N+1 against the engine's
predicted post-step state while step N runs on the device, then completes
step N, at most one step in flight.  It does so only where
``engine.pipeline_ready()`` says the prediction is exact (plain decode
steady state; never with speculation on); anything else reconciles first
and runs dispatch -> complete in order.  Emission then goes through a
bounded off-thread stage (``_EmissionStage``) so subscriber callbacks never
sit between a completion and the next dispatch.  Every step records its
time split (host build, device wait, emit, idle gap, wall) in a small
window; ``device_idle_ratio()`` reads it.

The KV-pressure ladder (``_memory_pressure_tick``, once per pass): with
``preempt_stall_seconds`` set, admission starved that long preempts the
newest decoder by swap to the host tier; with ``admission_timeout`` set,
queued or parked requests past it get a typed ``kv_exhausted`` error.
Both reconcile an in-flight step first, as they read the engine's host
mirrors.  ``submit_import`` re-admits a migrated-in snapshot on the
engine thread; ``stop(drain=...)`` stops taking work, keeps stepping
until the deadline, then ships what is left through ``exporter`` (a
``PeerShipper``) with a ``migrated ... peer=`` terminal event, and fails
only what could not ship.

Not ported yet: the scheduler, SLO accounting, admission bounds, the
quarantine bisection and retry ladder (ROADMAP A7), the disaggregated
prefill handoff (A12), multihost (A15).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional

from helix_tpu_torch.engine.engine import Engine, Request, SnapshotError

log = logging.getLogger("helix_tpu_torch.engine")

SHUTTING_DOWN = "shutting_down"
KV_EXHAUSTED = "kv_exhausted"
# step records kept for device_idle_ratio() (the reference's flight ring
# holds 512 and its ratio gauges read the last 256)
STEP_WINDOW = 256


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


class _EmissionStage:
    """Bounded, ordered, off-critical-path token emission.

    The async loop hands each step's events to this stage so subscriber
    callbacks never sit between a device completion and the next
    dispatch.  One worker thread keeps per-request event order; the
    bounded queue applies backpressure (a full queue blocks the engine
    thread).  Not started (synchronous loop): ``push`` calls the sink on
    the caller's thread."""

    def __init__(self, sink: Callable, depth: int = 8):
        self._sink = sink
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self.started = False

    def start(self, name: str = "emit") -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"helix-torch-emit-{name}", daemon=True
        )
        self.started = True
        self._thread.start()

    def push(self, events) -> None:
        if not events:
            return
        if not self.started:
            self._sink(events)
            return
        self._q.put(events)   # blocks when full: bounded backpressure

    def flush(self) -> None:
        """Block until every pushed batch is delivered: the ordering
        barrier before any terminal event, so an error never overtakes
        a request's queued tokens."""
        if self.started:
            self._q.join()

    def stop(self) -> None:
        if not self.started:
            return
        self._q.put(None)
        self.started = False
        if self._thread is not None:
            self._thread.join(timeout=10)

    def depth(self) -> int:
        return self._q.qsize()

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            try:
                if batch is None:
                    return
                try:
                    self._sink(batch)
                except Exception:  # noqa: BLE001 — a subscriber bug must not kill emission
                    log.exception("emission stage sink failed")
            finally:
                self._q.task_done()


class _StepWindow:
    """The last ``capacity`` per-step time records (the part of the
    reference's flight recorder that its ratio gauges read)."""

    def __init__(self, capacity: int = STEP_WINDOW):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.recorded = 0   # records ever made (a caller's window marker)

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def records(self, recent: int = STEP_WINDOW) -> list:
        """Copies of the last ``recent`` records, oldest first."""
        with self._lock:
            return [dict(r) for r in list(self._ring)[-recent:]]

    def window_ratio(self, num_key: str, den_keys: tuple,
                     recent: int = STEP_WINDOW) -> float:
        """Sum of ``num_key`` over the last ``recent`` records divided by
        the summed ``den_keys`` (0.0 on an empty window)."""
        with self._lock:
            recs = list(self._ring)[-recent:]
        num = float(sum(r.get(num_key, 0) or 0 for r in recs))
        den = float(sum(r.get(k, 0) or 0 for r in recs for k in den_keys))
        return num / den if den > 0 else 0.0


@dataclasses.dataclass
class _ImportItem:
    """An inbox entry carrying a migrated-in snapshot: ``import_request``
    runs on the engine thread; ``on_result(err, code)`` fires once it
    settles (None = accepted)."""

    snapshot: object
    on_event: Callable[[TokenEvent], None]
    on_result: Optional[Callable] = None


class EngineLoop:
    def __init__(self, engine: Engine, name: str = "engine",
                 admission_timeout: Optional[float] = None,
                 preempt_stall_seconds: Optional[float] = None):
        self.engine = engine
        self.name = name
        # the KV-pressure ladder's rungs (None disables one): preempt by
        # swap once admission has stalled preempt_stall_seconds, typed
        # kv_exhausted shed once a request has waited admission_timeout
        self.admission_timeout = admission_timeout
        self.preempt_stall_seconds = preempt_stall_seconds
        self._stall_since: Optional[float] = None
        self._admit_seen = 0        # admissions + resumes at last progress
        self._last_preempt_at = 0.0
        self.kv_exhausted_sheds = 0
        self.shed_requests = 0
        self._inbox: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # submit holds it across check + enqueue so stop(drain=...) can
        # flip _draining atomically against in-flight submits
        self._admission_lock = threading.RLock()
        self._draining = False
        self._drain_deadline = 0.0
        self._subscribers: dict[str, Callable[[TokenEvent], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.step_failures = 0
        self.async_enabled = bool(engine.cfg.enable_async_loop)
        self.pipelined_steps = 0    # steps dispatched while one was in flight
        self._emit_stage = _EmissionStage(self._deliver)
        self.window = _StepWindow()
        # the last completion's return: a dispatch made with nothing in
        # flight charges the gap since then as device idle (idle_gap_s)
        self._device_busy_until = 0.0
        # drain-deadline migration: wire dict -> accepting peer id (raises
        # on failure); None sheds survivors instead
        self.exporter: Optional[Callable[[dict], str]] = None
        self.migration_failures = 0   # failed exports / ships / imports

    def submit(self, req: Request, on_event: Callable[[TokenEvent], None]):
        """Queue a request; ``on_event`` receives its tokens and a final
        event.  Unservable requests, and any while draining, get an error
        event at once."""
        err = self.engine.validate_request(req)
        if err:
            on_event(_error_event(req.id, err))
            return
        if req.adapter:
            # a cold adapter's load starts now, on the submitter's
            # thread: the engine's readiness gate (thread-safe) kicks the
            # store's prefetch, so the load overlaps the queue wait
            self.engine._adapter_ready(req)
        with self._admission_lock:
            if self._draining or self._stop.is_set():
                self.shed_requests += 1
                on_event(_error_event(
                    req.id, f"{SHUTTING_DOWN}: engine '{self.name}' is "
                    "draining"))
                return
            self._inbox.put((req, on_event))
        self._wake.set()

    def abort(self, request_id: str):
        self._inbox.put((request_id, None))
        self._wake.set()

    def note_migration_failure(self) -> None:
        """Count a failed export, ship or import (engine thread, and the
        server's sweep of unclaimed imports)."""
        with self._admission_lock:
            self.migration_failures += 1

    @property
    def stopped(self) -> bool:
        """The engine thread has exited (or never started)."""
        return self._thread is None or not self._thread.is_alive()

    @property
    def draining(self) -> bool:
        return self._draining or self._stop.is_set()

    def submit_import(self, snapshot, on_event, on_result=None):
        """Queue a migrated-in snapshot (any thread).  The engine thread
        validates it (every page checksum before any mutation) and parks
        a KV-carrying one until a slot and pages free up;
        ``on_result(err, code)`` reports the outcome."""
        with self._admission_lock:
            if self._draining or self._stop.is_set():
                if on_result is not None:
                    on_result(f"{SHUTTING_DOWN}: engine '{self.name}' is "
                              "draining", "shutting_down")
                return
            self._inbox.put((_ImportItem(snapshot, on_event, on_result),
                             None))
        self._wake.set()

    def start(self):
        if self.async_enabled:
            self._emit_stage.start(self.name)
        self._thread = threading.Thread(
            target=self._run, name=f"helix-torch-engine-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, join: bool = True, drain: float = 0.0):
        """Stop the engine thread.  With ``drain > 0`` new submissions
        are shed (``shutting_down``, a 503) while requests in flight keep
        stepping for up to ``drain`` seconds; at the deadline the
        survivors ship through ``exporter`` when one is set, and the rest
        get an error event.  ``join=False`` with a drain leaves the
        thread to finish on its own."""
        if drain > 0 and self._thread is not None \
                and self._thread.is_alive():
            # the deadline is set before the flag the thread checks
            self._drain_deadline = time.monotonic() + drain
            with self._admission_lock:
                self._draining = True
            self._wake.set()
            if not join:
                return
            self._thread.join(timeout=drain + 30)
        self._stop.set()
        self._wake.set()
        if join and self._thread is not None:
            self._thread.join(timeout=30)

    def stats(self) -> dict:
        eng = self.engine
        return {
            "steps": self.steps,
            "step_failures": self.step_failures,
            "shed_requests": self.shed_requests,
            # KV tiering + preemption by swap
            "preemptions": eng.num_preemptions,
            "resumes": eng.num_resumes,
            "preempted_parked": len(eng.preempted),
            "kv_exhausted_sheds": self.kv_exhausted_sheds,
            "host_pool": (eng.host_pool.stats()
                          if eng.host_pool is not None else None),
            "migration": {
                "exported": eng.num_snapshots_exported,
                "imported": eng.num_snapshots_imported,
                "failures": self.migration_failures,
                "draining": self.draining,
            },
            "async_loop": {
                "enabled": self.async_enabled,
                "pipelined_steps": self.pipelined_steps,
                "device_idle_ratio": round(self.device_idle_ratio(), 4),
                "emit_queue_depth": self._emit_stage.depth(),
            },
            # multi-LoRA serving: the device pool and the host/filestore
            # store under it; None = pool off
            "adapters": (
                {**eng.adapter_pool.stats(),
                 "store": (eng.adapter_store.stats()
                           if eng.adapter_store is not None else None)}
                if eng.adapter_pool is not None else None
            ),
            # adapters resident in the device pool (0 = pool off)
            "adapters_resident": (
                eng.adapter_pool.stats()["resident"]
                if eng.adapter_pool is not None else 0
            ),
        }

    def device_idle_ratio(self) -> float:
        """The reference's gauge: window ``idle_gap_s`` / ``wall_s``.  A
        gap is charged from the previous completion's return to the next
        dispatch whenever no step was in flight in between (pipelined
        dispatches charge zero), time spent waiting for work included; a
        step's wall time starts at its own dispatch, so after an idle
        spell the ratio exceeds 1.  The traced idle share, not this
        host-side figure, is the device idle share of PERF.md."""
        return self.window.window_ratio("idle_gap_s", ("wall_s",))

    # -- engine thread ------------------------------------------------------

    def _drain_inbox(self):
        while True:
            try:
                item, on_event = self._inbox.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _ImportItem):   # migrated-in snapshot
                self._handle_import(item)
                continue
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

    def _handle_import(self, item: _ImportItem) -> None:
        """Engine-thread half of ``submit_import``."""
        rid = getattr(item.snapshot, "request_id", "")
        try:
            req = self.engine.import_request(item.snapshot)
        except SnapshotError as e:
            self.note_migration_failure()
            log.warning("engine '%s' rejected snapshot import "
                        "request_id=%s: %s", self.name, rid, e)
            if item.on_result is not None:
                item.on_result(str(e), e.code)
            return
        except Exception as e:  # noqa: BLE001 — the thread must survive
            self.note_migration_failure()
            log.exception("engine '%s' snapshot import failed "
                          "request_id=%s", self.name, rid)
            if item.on_result is not None:
                item.on_result(str(e), "snapshot_invalid")
            return
        self._subscribers[req.id] = item.on_event
        log.info("engine '%s' imported request_id=%s (%d prior token(s), "
                 "%d page(s))", self.name, req.id, len(req.output_tokens),
                 len(getattr(item.snapshot, "pages", ())))
        if item.on_result is not None:
            item.on_result(None, None)

    def _active_by_recency(self) -> list:
        """Unfinished requests with a subscriber, oldest submission first
        (the subscriber map keeps insertion order)."""
        reqs = (self.engine.get_request(rid)
                for rid in list(self._subscribers))
        return [r for r in reqs if r is not None and not r.finished]

    def _terminal(self, req, message: str) -> None:
        """End one request with an error event (after the tokens queued
        before it)."""
        self.engine.abort(req.id)
        cb = self._subscribers.pop(req.id, None)
        if cb:
            cb(_error_event(req.id, message))

    def _shed_kv_exhausted(self, req, waited: float) -> None:
        """The typed shed of a request past the admission deadline,
        queued or parked."""
        self._emit_stage.flush()
        msg = (f"{KV_EXHAUSTED}: request waited {waited:.1f}s for KV pages "
               f"(admission_timeout={self.admission_timeout}s); the engine "
               "is out of KV capacity, retry later")
        with self._admission_lock:   # submit() counts sheds too
            self.kv_exhausted_sheds += 1
            self.shed_requests += 1
        log.warning("engine '%s' shedding request_id=%s: %s", self.name,
                    req.id, msg)
        self._terminal(req, msg)

    def _pressure_pending(self) -> bool:
        """Whether the ladder has anything to watch: a waiting queue or a
        parked decoder (the pipeline never runs ahead of either)."""
        return bool(self.engine.waiting or self.engine.preempted)

    def _memory_pressure_tick(self) -> None:
        """The KV-pressure ladder, once per loop pass, with no step in
        flight.  Admission counts as starved while requests wait and no
        admission or resume lands.  Past ``preempt_stall_seconds`` the
        newest (then largest) decoder swaps out to the host tier, one per
        stall window; past ``admission_timeout`` queued and parked
        requests get the typed ``kv_exhausted`` shed."""
        eng = self.engine
        now = time.monotonic()
        progress = eng.num_admitted + eng.num_resumes
        waiting = list(eng.waiting)
        if progress != self._admit_seen:
            self._admit_seen = progress
            self._stall_since = now if waiting else None
        elif not waiting:
            self._stall_since = None
        elif self._stall_since is None:
            self._stall_since = now
        if self.admission_timeout is not None:
            # a queued request sheds only when the stall itself outlived
            # the deadline: a queue that merely moves slowly is latency,
            # not KV exhaustion
            if self._stall_since is not None \
                    and now - self._stall_since > self.admission_timeout:
                for r in waiting:
                    if not r.finished \
                            and now - r.submit_time > self.admission_timeout:
                        self._shed_kv_exhausted(r, now - r.submit_time)
            # a parked decoder that cannot get pages back is KV pressure
            # by construction
            for st in list(eng.preempted):
                waited = now - st.preempted_at
                if not st.req.finished and waited > self.admission_timeout:
                    self._shed_kv_exhausted(st.req, waited)
        if (self.preempt_stall_seconds is not None
                and self._stall_since is not None
                and now - self._stall_since > self.preempt_stall_seconds
                and now - self._last_preempt_at
                > self.preempt_stall_seconds):
            victim = eng.preempt_for_pressure()
            if victim is not None:
                self._last_preempt_at = now
                log.warning("engine '%s' admission KV-starved for %.1fs: "
                            "preempted request_id=%s (swap to host)",
                            self.name, now - self._stall_since, victim)

    def _deliver_resume_failures(self) -> None:
        """Error events for parked requests whose swap-in failed
        verification."""
        failures = self.engine.drain_resume_failures()
        if failures:
            self._emit_stage.flush()
        for req, msg in failures:
            log.warning("engine '%s' resume failed for request_id=%s: %s",
                        self.name, req.id, msg)
            cb = self._subscribers.pop(req.id, None)
            if cb:
                cb(_error_event(req.id, msg))

    def _export_survivors(self) -> int:
        """Drain-deadline migration: snapshot every unfinished request
        and ship it through ``exporter``; a shipped request ends here
        with a ``migrated ... peer=`` event.  What cannot export or ship
        is left for the ``_fail_all`` that follows.  Runs with no step in
        flight."""
        from helix_tpu_torch.serving.migration import (
            migrated_error,
            snapshot_to_wire,
        )

        self._emit_stage.flush()
        if self.exporter is None:
            return 0
        shipped = 0
        for req in self._active_by_recency():
            try:
                snap = self.engine.export_request(req.id)
            except Exception:  # noqa: BLE001 — degrade to shed
                log.exception("engine '%s' export failed for request_id=%s",
                              self.name, req.id)
                snap = None
            if snap is None:
                self.note_migration_failure()
                continue
            try:
                peer = self.exporter(snapshot_to_wire(snap))
            except Exception as e:  # noqa: BLE001 — degrade to shed
                self.note_migration_failure()
                log.warning("engine '%s' could not ship snapshot for "
                            "request_id=%s: %s", self.name, req.id, e)
                continue
            shipped += 1
            log.info("engine '%s' migrated request_id=%s to peer %s at "
                     "drain deadline", self.name, req.id, peer)
            self._terminal(req, migrated_error(req.id, peer))
        return shipped

    def _snapshot_events(self, emitted) -> list:
        """``[(req, token), ...]`` -> ``[(req, finished, TokenEvent)]``,
        rendered on the engine thread at emission time: a later step's
        reconcile may finish the request before the emission stage
        delivers, and only the token that finished it may say so.  Within
        one batch a finishing request's LAST entry carries the flag."""
        last = {req.id: idx for idx, (req, _tok) in enumerate(emitted)}
        events = []
        for idx, (req, token) in enumerate(emitted):
            fin = req.finished and last[req.id] == idx
            events.append((req, fin, TokenEvent(
                request_id=req.id, token_id=token, finished=fin,
                finish_reason=(
                    req.finish_reason.value
                    if fin and req.finish_reason else None
                ),
            )))
        return events

    def _deliver(self, events) -> None:
        for req, fin, ev in events:
            cb = self._subscribers.get(req.id)
            if cb is None:
                continue
            cb(ev)
            if fin:
                self._subscribers.pop(req.id, None)

    def _fail_all(self, message: str) -> None:
        self._emit_stage.flush()
        for rid, cb in list(self._subscribers.items()):
            self.engine.abort(rid)
            cb(_error_event(rid, message))
        self._subscribers.clear()

    def _step_failed(self, e: Exception) -> None:
        log.error("engine '%s' step %d failed: %s", self.name, self.steps, e,
                  exc_info=e)
        self.step_failures += 1
        self._fail_all(f"engine step failed: {e}")

    def _record(self, kind: str, generated: int, **timing) -> None:
        # distinct adapters sharing the batch: > 1 is a mixed-adapter
        # device call
        distinct = len({s.adapter for s in self.engine.slots
                        if s is not None and s.adapter})
        self.window.record({"kind": kind, "generated": generated,
                            "distinct_adapters": distinct,
                            **{k: round(v, 6) for k, v in timing.items()}})

    def _run(self):
        # the at-most-one dispatched-but-not-reconciled step; always None
        # under the synchronous loop
        inflight = None

        def complete(pend):
            emitted = self.engine.step_complete(pend)
            self._device_busy_until = time.monotonic()
            return emitted

        def reconcile() -> bool:
            """Complete the in-flight step and drain the emission stage
            (before the inbox mutates state, or when idle).  False: the
            completion failed and its requests were failed."""
            nonlocal inflight
            if inflight is None:
                self._emit_stage.flush()
                return True
            pend, inflight = inflight, None
            t0 = time.monotonic()
            try:
                emitted = complete(pend)
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                self.engine.discard_pending(pend)
                self._step_failed(e)
                return False
            dt_wait = time.monotonic() - t0
            t_emit = time.monotonic()
            self._emit_stage.push(self._snapshot_events(emitted))
            # the step's dispatch skipped its record: it lands here
            self._record(pend.kind, len(emitted), host_build_s=0.0,
                         device_wait_s=dt_wait,
                         emit_s=time.monotonic() - t_emit, idle_gap_s=0.0,
                         wall_s=time.monotonic() - t0, pipelined=1)
            self._emit_stage.flush()
            return True

        while not self._stop.is_set():
            if inflight is not None and not self._inbox.empty():
                # submits and aborts change state the prediction did not
                # see: reconcile first
                if not reconcile():
                    continue
            self._drain_inbox()
            if self._draining:
                if not reconcile():
                    continue
                if not self.engine.has_work():
                    break
                if time.monotonic() > self._drain_deadline:
                    # migrate instead of shed: finish -> ship -> shed
                    shipped = self._export_survivors()
                    if shipped:
                        log.info("engine '%s' exported %d request(s) at "
                                 "the drain deadline", self.name, shipped)
                    self._fail_all("drain deadline exceeded at shutdown")
                    break
            if self._pressure_pending():
                # the ladder reads and rewrites the host mirrors (a
                # preempt saves _positions / _last_token): no step may be
                # in flight.  The pipeline never runs ahead of a waiting
                # queue or a parked decoder, so this costs no overlap.
                if not reconcile():
                    continue
                self._memory_pressure_tick()
            if not self.engine.has_work():
                if not reconcile():
                    continue
                if self.engine.has_work():
                    continue   # the reconcile advanced work
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            # the pipeline gate, decided BEFORE the dispatch
            can_pipe = self.async_enabled and self.engine.pipeline_ready()
            if inflight is not None and not can_pipe:
                if not reconcile():
                    continue
            t_step = time.monotonic()
            overlapped = inflight is not None
            try:
                emitted, pend = self.engine.step_dispatch()
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                # the in-flight step is healthy dispatched work: complete
                # it first so its tokens are not lost
                if inflight is not None:
                    prev, inflight = inflight, None
                    try:
                        self._emit_stage.push(
                            self._snapshot_events(complete(prev)))
                    except Exception:  # noqa: BLE001 — poisoned chain
                        self.engine.discard_pending(prev)
                self._step_failed(e)
                continue
            t_built = time.monotonic()
            kind = pend.kind if pend is not None else "admit"
            idle_gap = 0.0
            if not overlapped and self._device_busy_until:
                # nothing was in flight while this step was built: the
                # device sat idle from the last completion's return until
                # this dispatch landed, waiting for work included
                idle_gap = max(0.0, t_built - self._device_busy_until)
            prev, inflight = inflight, None
            dt_wait = 0.0
            try:
                if prev is not None:
                    # step N+1 is queued on the device: fetch step N
                    t_w = time.monotonic()
                    emitted = complete(prev) + emitted
                    prev = None
                    dt_wait += time.monotonic() - t_w
                if pend is not None and can_pipe and pend.kind == "decode":
                    inflight, pend = pend, None
                    self.pipelined_steps += 1
                elif pend is not None:
                    t_w = time.monotonic()
                    self.engine.step_complete(pend, emitted)
                    pend = None
                    dt_wait += time.monotonic() - t_w
                    self._device_busy_until = time.monotonic()
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                for p in (prev, pend):
                    if p is not None:
                        self.engine.discard_pending(p)
                inflight = None
                self._step_failed(e)
                continue
            self.steps += 1
            if inflight is not None and not emitted:
                # pipeline-fill pass: its numbers land with its completion
                continue
            t_emit = time.monotonic()
            self._emit_stage.push(self._snapshot_events(emitted))
            self._deliver_resume_failures()
            self._record(kind, len(emitted), host_build_s=t_built - t_step,
                         device_wait_s=dt_wait,
                         emit_s=time.monotonic() - t_emit,
                         idle_gap_s=idle_gap,
                         wall_s=time.monotonic() - t_step,
                         pipelined=1 if overlapped else 0)
        # a step still in flight at shutdown: its tokens reach their
        # subscribers before the terminal sweep
        if inflight is not None:
            try:
                self._emit_stage.push(
                    self._snapshot_events(complete(inflight)))
            except Exception:  # noqa: BLE001 — best effort at shutdown
                self.engine.discard_pending(inflight)
        self._emit_stage.flush()
        self._drain_inbox()
        self._fail_all(f"{SHUTTING_DOWN}: engine '{self.name}' stopped")
        self._emit_stage.stop()
