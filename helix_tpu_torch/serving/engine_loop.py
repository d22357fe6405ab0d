"""Engine driver thread: bridges HTTP handler threads to the step loop.

Port of ``helix_tpu/serving/engine_loop.py``: one dedicated thread owns
the ``Engine`` (every device call stays on it); handlers submit through a
thread-safe inbox and receive per-request ``TokenEvent``s through
callbacks.

Robustness: a failing step does not fail every request in flight.  The
loop records the failure and retries the same state once (transient
faults), then quarantines: the requests that have not emitted yet are
pulled out and bisected back in through re-admitted clones, with a
control step, and only the culprit gets an error event; a policy victim
is the last resort (``_handle_step_failure``, ``_quarantine``).
Admission is bounded (``max_queue_depth``, ``max_queued_tokens`` and the
scheduler's per-tenant bound), so overload sheds at once with a
``queue_full`` error (HTTP 429) instead of rotting in the queue.

The scheduler (``serving/sched.py``) owns every ordering, budget and
victim decision: its pass runs on the engine thread before each dispatch
(``reorder(engine.waiting)``, then ``engine.prefill_budget``), reading only
the wait queue and the burn accounts, so it may run with a step in
flight.  ``obs.slo.SLOObserver`` takes the first-token, token, shed and
preemption notes (token notes on the emission stage, off the dispatch
path) and keeps the admission audit; ``obs.flight.FlightRecorder`` keeps
the per-step records that ``device_idle_ratio()`` and ``padding_ratio()``
read; ``obs.metrics.EngineLoopObs`` holds the latency histograms; spans
of traced requests land in ``obs.trace``'s store.

With ``EngineConfig.enable_async_loop`` the loop pipelines: it dispatches
step N+1 against the engine's predicted post-step state while step N runs
on the device, then completes step N, at most one step in flight.  It does
so only where ``engine.pipeline_ready()`` says the prediction is exact
(plain decode steady state; never with speculation on); anything else
reconciles first and runs dispatch -> complete in order.  Emission then
goes through a bounded off-thread stage (``_EmissionStage``).

The KV-pressure ladder (``_memory_pressure_tick``, once per pass): with
``preempt_stall_seconds`` set, admission starved that long preempts a
decoder by swap to the host tier (the scheduler's victim under WFQ);
with ``admission_timeout`` set, queued or parked requests past it get a
typed ``kv_exhausted`` error.  ``submit_import`` re-admits a migrated-in
snapshot on the engine thread; ``stop(drain=...)`` stops taking work,
keeps stepping until the deadline, then ships what is left through
``exporter`` (a ``PeerShipper``) with a ``migrated ... peer=`` terminal
event, and fails only what could not ship.

The disaggregated prefill handoff: a handler stages an export before it
submits (``stage_disagg_export``); once the request's first token exists
the engine thread reconciles any step in flight, snapshots the request
(``Engine.export_prefill``), encodes the wire and hands it to the
handler's callback, which ships it off this thread (``_disagg_tick``).
The request keeps decoding here until the handler confirms the ship.

Not ported yet: multihost (A15b).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional

from helix_tpu_torch.engine.engine import Engine, Request, SnapshotError
from helix_tpu_torch.obs import trace as obs_trace
from helix_tpu_torch.obs.flight import (
    SATURATION_KEYS,
    FlightRecorder,
    RateTracker,
)
from helix_tpu_torch.obs.metrics import EngineLoopObs
from helix_tpu_torch.obs.slo import ANON_TENANT, SLOObserver
from helix_tpu_torch.serving.sched import (
    PREEMPT_VICTIM,
    SHED_VICTIM,
    TENANT_QUEUE_FULL,
    make_scheduler,
)
from helix_tpu_torch.testing import faults

log = logging.getLogger("helix_tpu_torch.engine")

# error-message prefixes the HTTP layer maps onto statuses (429 / 503)
QUEUE_FULL = "queue_full"
SHUTTING_DOWN = "shutting_down"
KV_EXHAUSTED = "kv_exhausted"


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
    callbacks and the per-tenant SLO notes never sit between a device
    completion and the next dispatch.  One worker thread keeps
    per-request event order; the bounded queue applies backpressure (a
    full queue blocks the engine thread).  Not started (synchronous
    loop): ``push`` calls the sink on the caller's thread."""

    def __init__(self, sink: Callable, obs_hist, depth: int = 8):
        self._sink = sink
        self._obs = obs_hist
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
            t0 = time.monotonic()
            self._sink(events)
            self._obs.observe(time.monotonic() - t0)
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
                t0 = time.monotonic()
                try:
                    self._sink(batch)
                except Exception:  # noqa: BLE001 — a subscriber bug must not kill emission
                    log.exception("emission stage sink failed")
                self._obs.observe(time.monotonic() - t0)
            finally:
                self._q.task_done()


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
                 max_queue_seconds: float = 600.0,
                 max_queue_depth: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 admission_timeout: Optional[float] = None,
                 preempt_stall_seconds: Optional[float] = None,
                 slo_targets: Optional[dict] = None,
                 tenant_top_k: Optional[int] = None,
                 burn_windows: Optional[tuple] = None,
                 sched_config=None):
        self.engine = engine
        self.name = name
        self.max_queue_seconds = max_queue_seconds
        # admission bounds (None = unbounded): depth counts requests
        # waiting for a slot (inbox + engine wait queue), tokens bound the
        # queued prefill work
        self.max_queue_depth = max_queue_depth
        self.max_queued_tokens = max_queued_tokens
        # the KV-pressure ladder's rungs (None disables one): preempt by
        # swap once admission has stalled preempt_stall_seconds, typed
        # kv_exhausted shed once a request has waited admission_timeout
        self.admission_timeout = admission_timeout
        self.preempt_stall_seconds = preempt_stall_seconds
        self._stall_since: Optional[float] = None
        self._admit_seen = 0        # admissions + resumes at last progress
        self._last_preempt_at = 0.0
        self.kv_exhausted_sheds = 0
        self._inbox: "queue.Queue" = queue.Queue()
        self._pending = 0           # submitted, not yet drained to the engine
        self._pending_tokens = 0
        # per-tenant inbox depth (admission lock); the per-tenant bound
        # adds the engine-side wait-queue count on demand
        self._pending_by_tenant: dict[str, int] = {}
        # submit holds it across check + enqueue so stop(drain=...) can
        # flip _draining atomically against in-flight submits
        self._admission_lock = threading.RLock()
        self._subscribers: dict[str, Callable[[TokenEvent], None]] = {}
        self._admit_order: list[str] = []   # request ids, admission order
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = False
        self._drain_deadline = 0.0
        self._thread: Optional[threading.Thread] = None
        self._last_reap = time.monotonic()
        self._consec_failures = 0
        self._barren_rounds = 0   # quarantine rounds that found no culprit
        # serving counters (scraped by /metrics)
        self.steps = 0
        self.step_failures = 0
        self.step_retries = 0
        self.quarantine_evictions = 0
        self.shed_requests = 0
        self.started_at = time.monotonic()
        # host seconds of the scheduler pass, and how many ran
        self.sched_pass_seconds = 0.0
        self.sched_passes = 0
        # latency histograms, folded into /metrics with a model label
        self.obs = EngineLoopObs()
        # per-step records + anomaly watchdog (GET /v1/debug/flight)
        self.flight = FlightRecorder()
        # goodput tokens/s over a trailing window
        self._tps = RateTracker()
        # per-tenant SLO accounting, burn rates against the profile's
        # targets, and the admission audit (GET /v1/debug/admissions)
        self.slo = SLOObserver(
            targets=slo_targets, top_k=tenant_top_k, windows=burn_windows
        )
        self._trace = obs_trace.default_store()
        self._first_emit: dict[str, float] = {}   # req id -> first-token t
        self._last_emit: dict[str, float] = {}    # req id -> last-token t
        # the scheduler: every ordering / per-tenant-bound / victim
        # decision.  The FIFO baseline keeps the pre-scheduler order.
        self.sched = make_scheduler(sched_config)
        self._sched_active = self.sched.active
        self.async_enabled = bool(engine.cfg.enable_async_loop)
        self.pipelined_steps = 0    # steps dispatched while one was in flight
        self._emit_stage = _EmissionStage(self._deliver,
                                          self.obs.emit_seconds)
        # the last completion's return: a dispatch made with nothing in
        # flight charges the gap since then as device idle (idle_gap_s)
        self._device_busy_until = 0.0
        # drain-deadline migration: wire dict -> accepting peer id (raises
        # on failure); None sheds survivors instead
        self.exporter: Optional[Callable[[dict], str]] = None
        self.migration_failures = 0   # failed exports / ships / imports
        # staged disaggregated prefill exports: request id -> callback;
        # the staged ids whose request has reached the engine, and those
        # whose finishing token was emitted
        self._disagg_cb: dict[str, Callable] = {}
        self._disagg_live: set = set()
        self._disagg_done: set = set()
        self.disagg_exports = 0       # prefill snapshots handed to a handler
        engine.on_admit = self._note_admit
        if self._sched_active:
            engine.victim_policy = self.sched.preempt_order

    @property
    def window(self) -> FlightRecorder:
        """The step-record window (the flight recorder)."""
        return self.flight

    # -- called from any thread --------------------------------------------

    def check_admission(
        self, prompt_len: int, count_shed: bool = False,
        tenant: str = ANON_TENANT, trace_id: str = "",
        request_id: str = "",
    ) -> Optional[str]:
        """Would a submit of this size be shed right now?  Returns the
        error string (``queue_full: ...`` / ``shutting_down: ...`` /
        ``kv_exhausted: ...``) or None.  HTTP handlers pre-check so a
        stream gets a clean 429/503 status instead of an SSE error frame;
        callers that act on the verdict pass ``count_shed=True``, so the
        counters, the tenant's accounting and the audit record are kept
        here, in one place."""
        hit = self._check_admission(prompt_len, tenant)
        if hit is None:
            return None
        reason, err = hit
        if count_shed:
            with self._admission_lock:
                self.shed_requests += 1
                kv = reason == KV_EXHAUSTED
                if kv:
                    self.kv_exhausted_sheds += 1
            if reason == TENANT_QUEUE_FULL:
                # the flooding tenant overflowed ITS bounded queue;
                # everyone else keeps admitting
                self.sched.note_tenant_shed()
            self.slo.note_shed(tenant, kv_exhausted=kv)
            self._audit(reason, tenant=tenant, trace_id=trace_id,
                        request_id=request_id, detail=err)
        return err

    def _audit(self, reason: str, tenant: str = ANON_TENANT,
               trace_id: str = "", request_id: str = "",
               detail: str = "") -> None:
        """One admission-decision audit record with the queue state at
        the moment of the decision (O(1) reads only)."""
        eng = self.engine
        self.slo.audit.record(
            reason, tenant=tenant, trace_id=trace_id,
            request_id=request_id, detail=detail,
            queue_depth=self.queue_depth(),
            kv_pages_free=eng.allocator.free_pages,
            slots_busy=sum(1 for s in eng.slots if s is not None),
            preempted_parked=len(eng.preempted),
        )

    def queue_depth(self) -> int:
        """Requests awaiting a slot (inbox + engine wait queue): the one
        queue-depth formula of the bound, the audit, the saturation
        summary and the flight records."""
        return self._pending + len(self.engine.waiting)

    def queued_tokens(self) -> int:
        """Prompt tokens awaiting admission (inbox + engine wait queue):
        the quantity ``max_queued_tokens`` bounds.  Aborted-while-queued
        requests do not count."""
        return self._pending_tokens + sum(
            len(r.prompt_tokens) for r in list(self.engine.waiting)
            if not r.finished
        )

    def _tenant_depth(self, tenant: str) -> int:
        """Queued requests of ONE tenant (inbox + engine wait queue)."""
        return self._pending_by_tenant.get(tenant, 0) + sum(
            1 for r in list(self.engine.waiting)
            if not r.finished and r.tenant == tenant
        )

    def _check_admission(self, prompt_len: int,
                         tenant: str = ANON_TENANT) -> Optional[tuple]:
        """(audit_reason, error_string) when a submit of this size would
        be shed right now, else None."""
        if self._draining or self._stop.is_set():
            return (SHUTTING_DOWN,
                    f"{SHUTTING_DOWN}: engine '{self.name}' is draining")
        # KV-starved fast-fail: admission already stalled past the
        # deadline, so a new arrival would only age out the same way
        stall_since = self._stall_since
        if (self.admission_timeout is not None
                and stall_since is not None
                and time.monotonic() - stall_since > self.admission_timeout):
            return (KV_EXHAUSTED,
                    f"{KV_EXHAUSTED}: engine '{self.name}' admission has "
                    f"been KV-starved for "
                    f"{time.monotonic() - stall_since:.1f}s "
                    f"(admission_timeout={self.admission_timeout}s)")
        depth = self.queue_depth()
        if self.max_queue_depth is not None and depth >= self.max_queue_depth:
            return (QUEUE_FULL,
                    f"{QUEUE_FULL}: {depth} request(s) already queued "
                    f"(max_queue_depth={self.max_queue_depth})")
        # bounded per-tenant queues: the flooding tenant overflows ITS
        # queue instead of filling the global bound
        if self.sched.cfg.max_tenant_queue_depth is not None:
            td = self._tenant_depth(tenant)
            if self.sched.tenant_overflow(tenant, td):
                return (TENANT_QUEUE_FULL,
                        f"{QUEUE_FULL}: tenant '{tenant}' already has {td} "
                        f"request(s) queued (max_tenant_queue_depth="
                        f"{self.sched.cfg.max_tenant_queue_depth})")
        if self.max_queued_tokens is not None:
            queued = self.queued_tokens()
            if queued + prompt_len > self.max_queued_tokens:
                return (QUEUE_FULL,
                        f"{QUEUE_FULL}: {queued} tokens queued + "
                        f"{prompt_len} requested exceeds "
                        f"max_queued_tokens={self.max_queued_tokens}")
        return None

    def submit(self, req: Request, on_event: Callable[[TokenEvent], None]):
        """Queue a request; ``on_event`` receives its tokens and a final
        event.  Unservable requests, shed ones and any while draining get
        an error event at once."""
        # the priority class is resolved once, at the edge
        if not req.sched_class:
            req.sched_class = self.sched.cfg.default_class
        err = self.engine.validate_request(req) or self.check_admission(
            len(req.prompt_tokens), count_shed=True, tenant=req.tenant,
            trace_id=req.trace_id, request_id=req.id,
        )
        if err:
            on_event(_error_event(req.id, err))
            return
        if req.adapter:
            # a cold adapter's load starts now, on the submitter's
            # thread: the engine's readiness gate (thread-safe) kicks the
            # store's prefetch, so the load overlaps the queue wait
            self.engine._adapter_ready(req)
        with self._admission_lock:
            # re-checked under the lock: stop() flips _draining inside it,
            # so no request slips into the inbox after the terminal sweep
            if self._draining or self._stop.is_set():
                self.shed_requests += 1
                self.slo.note_shed(req.tenant)
                self._audit(SHUTTING_DOWN, tenant=req.tenant,
                            trace_id=req.trace_id, request_id=req.id,
                            detail="draining")
                on_event(_error_event(
                    req.id, f"{SHUTTING_DOWN}: engine '{self.name}' is "
                    "draining"))
                return
            self._pending += 1
            self._pending_tokens += len(req.prompt_tokens)
            self._pending_by_tenant[req.tenant] = (
                self._pending_by_tenant.get(req.tenant, 0) + 1)
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

    def stage_disagg_export(self, request_id: str, on_snapshot) -> None:
        """Stage the disaggregated prefill export of ``request_id`` (call
        before ``submit``, so the first token cannot race the staging):
        once its prefill has completed the engine thread fires
        ``on_snapshot(kind, wire)`` exactly once, ``kind`` being
        ``"snapshot"`` (the wire attached; the request keeps decoding
        here until the caller confirms the ship and aborts it),
        ``"completed"`` (it finished before the export: serve the
        buffered events), ``"local"`` (the export was refused or failed:
        it goes on here) or ``"gone"`` (it vanished before the export)."""
        self._disagg_cb[request_id] = on_snapshot

    def unstage_disagg_export(self, request_id: str) -> None:
        """Withdraw a staged export (the handler timed out or chose to
        serve locally)."""
        self._disagg_cb.pop(request_id, None)
        self._disagg_live.discard(request_id)
        self._disagg_done.discard(request_id)

    def _handoff_work(self) -> bool:
        """True when a staged export can act: its request reached the
        engine and has a token, finished or vanished.  The loop then
        reconciles any step in flight before ``_disagg_tick``: the export
        gathers pages and reads the slot's sampler state, and
        ``export_request`` refuses a request with an unreconciled step."""
        for rid in list(self._disagg_cb):
            if rid not in self._disagg_live:
                continue   # staged, its submit not drained yet
            req = self.engine.get_request(rid)
            if req is None or req.finished or req.output_tokens:
                return True
        return False

    def _disagg_tick(self) -> None:
        """Engine-thread half of the handoff: export every staged request
        whose prefill completed, encode its wire and hand it to the
        callback; the handler ships it off this thread.  A request waits
        here until its submit has reached the engine (the engine forgets
        a finished request, so "not found" means gone only after that)."""
        from helix_tpu_torch.serving.migration import snapshot_to_wire

        for rid, cb in list(self._disagg_cb.items()):
            if rid not in self._disagg_live:
                continue
            req = self.engine.get_request(rid)
            if req is None or req.finished:
                done = rid in self._disagg_done
                self.unstage_disagg_export(rid)
                cb("completed" if done else "gone", None)
                continue
            if not req.output_tokens:
                continue   # still queued or prefilling
            self.unstage_disagg_export(rid)
            t0 = time.monotonic()
            try:
                snap = self.engine.export_prefill(rid)
                wire = snapshot_to_wire(snap) if snap is not None else None
            except Exception:  # noqa: BLE001 — degrade to local serving
                log.exception("engine '%s' prefill export failed for "
                              "request_id=%s", self.name, rid)
                wire = None
            if wire is None:
                cb("local", None)
                continue
            self.disagg_exports += 1
            self._trace.record(req.trace_id, "disagg export", t0,
                               time.monotonic(), plane="engine",
                               request_id=rid,
                               pages=len(wire.get("pages") or ()))
            cb("snapshot", wire)

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
        """Counter snapshot for /metrics (plain reads)."""
        eng = self.engine
        return {
            "steps": self.steps,
            "step_failures": self.step_failures,
            "step_retries": self.step_retries,
            "quarantine_evictions": self.quarantine_evictions,
            "shed_requests": self.shed_requests,
            "prefill_tokens": eng.num_prefill_tokens,
            "decode_tokens": eng.num_decode_tokens,
            "generated_tokens": eng.num_generated_tokens,
            "prefill_padding_tokens": eng.num_prefill_padding_tokens,
            "prefill_padding_ratio": self.padding_ratio(),
            "mixed_steps": eng.num_mixed_steps,
            "moe_dropped_tokens": eng.moe_dropped_tokens,
            "spec_steps": eng.num_spec_steps,
            "spec_drafted_tokens": eng.num_spec_drafted_tokens,
            "spec_accepted_tokens": eng.num_spec_accepted_tokens,
            "waiting": len(eng.waiting),
            "active_slots": sum(1 for s in eng.slots if s is not None),
            "free_pages": eng.allocator.free_pages,
            "kv_pages_used": eng.kv_pages_used,
            "kv_pages_peak": eng.allocator.peak_used,
            "flight_anomalies": self.flight.anomalies_total,
            "kv_cache_dtype": eng.cache_cfg.dtype,
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
                # disaggregated prefill handoffs
                "prefill_exports": eng.num_prefill_exports,
                "disagg_exports": self.disagg_exports,
            },
            # the persistent filestore KV tier; None = tier off
            "filestore": (eng.kv_filestore.stats()
                          if eng.kv_filestore is not None else None),
            # per-tenant SLO accounting: pooled totals + top-K bounding
            "tenants": self.slo.stats(),
            # scheduler policy + per-class admission / victim counters
            "sched": self.sched.stats(),
            # host seconds of the scheduler pass
            "host_seconds": {
                "sched_pass": round(self.sched_pass_seconds, 6),
                "sched_passes": self.sched_passes,
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
        return self.flight.window_ratio("idle_gap_s", ("wall_s",))

    def tokens_per_sec(self) -> float:
        """Goodput: generated tokens/s over the trailing rate window."""
        return self._tps.rate(self.engine.num_generated_tokens)

    def padding_ratio(self) -> float:
        """Prefill padding / (padding + useful prefill) over the flight
        window."""
        return self.flight.window_ratio(
            "padding_tokens", ("padding_tokens", "prefill_tokens"))

    def saturation(self) -> dict:
        """The compact saturation summary, keyed and ordered as
        ``obs.flight.SATURATION_KEYS``.  Plain reads, safe from any
        thread."""
        eng = self.engine
        pc = eng.prefix_cache
        hits = pc.hits if pc is not None else 0
        misses = pc.misses if pc is not None else 0
        denom = hits + misses
        hp = eng.host_pool
        out = {
            "kv_occupancy": round(
                eng.kv_pages_used / eng.kv_pages_capacity, 4),
            "slots_busy": sum(1 for s in eng.slots if s is not None),
            "slots_total": len(eng.slots),
            "queue_depth": self.queue_depth(),
            "tokens_per_sec": round(self.tokens_per_sec(), 2),
            "prefix_hit_rate": round(hits / denom, 4) if denom else 0.0,
            "spec_acceptance_ratio": round(eng.spec_acceptance_ratio, 4),
            "kv_host_occupancy": round(
                hp.occupancy if hp is not None else 0.0, 4),
            "preempted_requests": len(eng.preempted),
            # the budget this engine runs under (0 = unbudgeted)
            "prefill_budget_tokens": int(eng.prefill_budget or 0),
            "adapters_resident": (
                eng.adapter_pool.stats()["resident"]
                if eng.adapter_pool is not None else 0),
            # tiered residency: cold-middle pages demoted to the host
            # tier, how much admitted context lives past the pool
            "kv_cold_pages": int(eng.kv_cold_pages),
        }
        return {k: out[k] for k in SATURATION_KEYS}

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
                # the emission worker may still deliver this request's
                # queued tokens: let it finish before forgetting
                self._emit_stage.flush()
                self.engine.abort(item)
                self._subscribers.pop(item, None)
                self._forget_request(item)
                continue
            with self._admission_lock:
                self._pending = max(0, self._pending - 1)
                self._pending_tokens = max(
                    0, self._pending_tokens - len(item.prompt_tokens))
                n = self._pending_by_tenant.get(item.tenant, 0) - 1
                if n > 0:
                    self._pending_by_tenant[item.tenant] = n
                else:
                    self._pending_by_tenant.pop(item.tenant, None)
            try:
                self.engine.add_request(item)
            except Exception as e:  # noqa: BLE001 — the thread must survive
                on_event(_error_event(item.id, str(e)))
                continue
            if item.id in self._disagg_cb:
                self._disagg_live.add(item.id)
            self._subscribers[item.id] = on_event
            self._admit_order.append(item.id)

    def _handle_import(self, item: _ImportItem) -> None:
        """Engine-thread half of ``submit_import``."""
        rid = getattr(item.snapshot, "request_id", "")
        t0 = time.monotonic()
        try:
            req = self.engine.import_request(item.snapshot)
        except SnapshotError as e:
            self.note_migration_failure()
            self.flight.note_anomaly("import_rejected", request_id=rid,
                                     detail=str(e)[:200])
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
        self._admit_order.append(req.id)
        self._trace.record(
            getattr(item.snapshot, "trace_id", ""), "engine import admit",
            t0, time.monotonic(), plane="engine", request_id=req.id,
            prior_tokens=len(req.output_tokens),
            pages=len(getattr(item.snapshot, "pages", ())))
        log.info("engine '%s' imported request_id=%s (%d prior token(s), "
                 "%d page(s))", self.name, req.id, len(req.output_tokens),
                 len(getattr(item.snapshot, "pages", ())))
        if item.on_result is not None:
            item.on_result(None, None)

    def _note_admit(self, req) -> None:
        """The engine's admission-confirm hook (engine thread, inside
        ``_try_claim``): the scheduler's class counters and fair-share
        account are charged on CONFIRMED admissions only."""
        try:
            self.sched.note_admitted(req)
        except Exception:  # noqa: BLE001 — bookkeeping never fails admission
            log.exception("scheduler note_admitted failed")

    def _observe_emit(self, req: Request, finished: bool) -> None:
        """Latency histograms, the first-token SLO note and the engine
        spans of one emitted token.  ``finished`` is the emission-time
        snapshot (the live ``req.finished`` may reflect a later step)."""
        now = time.monotonic()
        rid = req.id
        last = self._last_emit.get(rid)
        if rid not in self._first_emit:
            self._first_emit[rid] = now
            admitted = req.admitted_time or now
            self.obs.queue_wait.observe(max(0.0, admitted - req.submit_time))
            self.obs.ttft.observe(max(0.0, now - req.submit_time))
            self.slo.note_first_token(
                req.tenant, max(0.0, now - req.submit_time),
                max(0.0, admitted - req.submit_time), len(req.prompt_tokens))
            if req.trace_id:
                self._trace.record(req.trace_id, "queue", req.submit_time,
                                   admitted, plane="engine", request_id=rid)
                self._trace.record(
                    req.trace_id, "prefill", admitted, now, plane="engine",
                    request_id=rid, prompt_tokens=len(req.prompt_tokens),
                    cached_tokens=req.cached_tokens)
        elif last is not None:
            self.obs.inter_token.observe(max(0.0, now - last))
        self._last_emit[rid] = now
        if finished:
            t_first = self._first_emit.pop(rid, now)
            self._last_emit.pop(rid, None)
            if req.trace_id:
                self._trace.record(
                    req.trace_id, "decode", t_first, now, plane="engine",
                    request_id=rid, output_tokens=len(req.output_tokens),
                    finish_reason=(req.finish_reason.value
                                   if req.finish_reason else None))

    def _forget_request(self, request_id: str) -> None:
        """Drop per-request emit bookkeeping (abort / evict paths where
        no finished token event flows)."""
        self._first_emit.pop(request_id, None)
        self._last_emit.pop(request_id, None)

    def _emit(self, emitted) -> None:
        """Snapshot + deliver in one call (the quarantine's synchronous
        steps)."""
        self._deliver(self._snapshot_events(emitted))

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
            if fin and req.id in self._disagg_cb:
                self._disagg_done.add(req.id)
            events.append((req, fin, TokenEvent(
                request_id=req.id, token_id=token, finished=fin,
                finish_reason=(
                    req.finish_reason.value
                    if fin and req.finish_reason else None
                ),
            )))
        return events

    def _deliver(self, events) -> None:
        # per-tenant token counts go to the accounting once per tenant
        # per batch, not per token (its lock is shared with scrapes)
        tenant_tokens: dict = {}
        for req, fin, ev in events:
            self._observe_emit(req, fin)
            tenant_tokens[req.tenant] = tenant_tokens.get(req.tenant, 0) + 1
            cb = self._subscribers.get(req.id)
            if cb is None:
                continue
            cb(ev)
            if fin:
                self._subscribers.pop(req.id, None)
        for t, n in tenant_tokens.items():
            self.slo.note_tokens(t, n)

    def _shed_kv_exhausted(self, req, waited: float) -> None:
        """The typed shed of a request past the admission deadline,
        queued or parked."""
        self._emit_stage.flush()   # no error frame may overtake tokens
        msg = (f"{KV_EXHAUSTED}: request waited {waited:.1f}s for KV pages "
               f"(admission_timeout={self.admission_timeout}s); the engine "
               "is out of KV capacity, retry later")
        self.engine.abort(req.id)
        with self._admission_lock:   # submit() counts sheds too
            self.kv_exhausted_sheds += 1
            self.shed_requests += 1
        self.slo.note_shed(req.tenant, kv_exhausted=True)
        self._audit(KV_EXHAUSTED, tenant=req.tenant, trace_id=req.trace_id,
                    request_id=req.id, detail=msg)
        log.warning("engine '%s' shedding request_id=%s: %s", self.name,
                    req.id, msg)
        self._forget_request(req.id)
        cb = self._subscribers.pop(req.id, None)
        if cb:
            cb(_error_event(req.id, msg))

    def _pressure_pending(self) -> bool:
        """Whether the ladder has anything to watch: a waiting queue or a
        parked decoder (the pipeline never runs ahead of either)."""
        return bool(self.engine.waiting or self.engine.preempted)

    def _memory_pressure_tick(self) -> None:
        """The KV-pressure ladder, once per loop pass, with no step in
        flight.  Admission counts as starved while requests wait and no
        admission or resume lands.  Past ``preempt_stall_seconds`` a
        decoder swaps out to the host tier (the scheduler's victim under
        WFQ, else the newest then largest), one per stall window; past
        ``admission_timeout`` queued and parked requests get the typed
        ``kv_exhausted`` shed."""
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
                over = [r for r in waiting if not r.finished
                        and now - r.submit_time > self.admission_timeout]
                if self._sched_active and len(over) > 1:
                    # every one sheds, in the policy's victim order
                    over = self.sched.preempt_order(over)
                for r in over:
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
                vreq = eng.get_request(victim)
                tenant = vreq.tenant if vreq is not None else ANON_TENANT
                self.slo.note_preemption(tenant)
                if self._sched_active and vreq is not None:
                    # the victim came from the policy ladder
                    self.sched.note_preempt_victim(vreq)
                    reason = PREEMPT_VICTIM
                else:
                    reason = "preempt_by_swap"
                self._audit(reason, tenant=tenant,
                            trace_id=getattr(vreq, "trace_id", ""),
                            request_id=victim,
                            detail=f"admission KV-starved "
                                   f"{now - self._stall_since:.1f}s")
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
            self.flight.note_anomaly("resume_corrupt", request_id=req.id,
                                     detail=msg[:200])
            self._forget_request(req.id)
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
            t0 = time.monotonic()
            try:
                peer = self.exporter(snapshot_to_wire(snap))
            except Exception as e:  # noqa: BLE001 — degrade to shed
                self.note_migration_failure()
                self._trace.record(req.trace_id, "migrate export ship", t0,
                                   time.monotonic(), plane="engine",
                                   request_id=req.id, outcome="failed")
                log.warning("engine '%s' could not ship snapshot for "
                            "request_id=%s: %s", self.name, req.id, e)
                continue
            shipped += 1
            self._trace.record(req.trace_id, "migrate export ship", t0,
                               time.monotonic(), plane="engine",
                               request_id=req.id, outcome="shipped",
                               peer=peer)
            log.info("engine '%s' migrated request_id=%s to peer %s at "
                     "drain deadline", self.name, req.id, peer)
            self.engine.abort(req.id)
            self._forget_request(req.id)
            cb = self._subscribers.pop(req.id, None)
            if cb:
                cb(_error_event(req.id, migrated_error(req.id, peer)))
        return shipped

    # -- the step-failure ladder ---------------------------------------------

    def _fault_gate(self) -> None:
        """The (normally disarmed) ``engine_step`` fault point, before
        every dispatch and every quarantine step."""
        inj = faults.active()
        if inj is not None:
            ids = [r.id for r in self.engine.slots if r is not None] + [
                r.id for r in self.engine.waiting]
            inj.maybe_fail_step(self.name, self.steps, ids)

    def _step_once(self):
        """One full synchronous engine step (the quarantine's bisection:
        no pipelining)."""
        self._fault_gate()
        return self.engine.step()

    def _dispatch_once(self):
        """Host phase of one engine step."""
        self._fault_gate()
        return self.engine.step_dispatch()

    def _handle_step_failure(self, e: Exception, dt_step: float,
                             flight_pre: tuple) -> None:
        """Record the failure, retry once on the same state, then
        quarantine."""
        self._emit_stage.flush()
        self.obs.step_seconds.observe(dt_step)
        self._flight_record(dt_step, flight_pre, generated=0, failed=str(e))
        self.step_failures += 1
        self._consec_failures += 1
        scheduled = [r.id for r in self.engine.slots if r is not None]
        log.warning("engine '%s' step %d failed (consecutive=%d, scheduled "
                    "request_ids=%s): %s", self.name, self.steps,
                    self._consec_failures, scheduled, e)
        if self._consec_failures == 1:
            # a transient fault clears on an immediate retry of the same
            # state
            self.step_retries += 1
            return
        log.error("engine '%s' step failed twice: quarantining", self.name,
                  exc_info=e)
        self._quarantine(e)
        self._consec_failures = 0

    def _flight_pre(self) -> tuple:
        """Counter snapshot taken just before a step, so its record
        carries deltas."""
        eng = self.engine
        hp = eng.host_pool
        return (
            eng.num_prefill_tokens,
            eng.num_prefill_padding_tokens,
            eng.num_decode_tokens,
            eng.num_admitted,
            self.quarantine_evictions,
            eng.num_spec_drafted_tokens,
            eng.num_spec_accepted_tokens,
            hp.spilled_pages if hp is not None else 0,
            hp.restored_pages if hp is not None else 0,
            eng.num_preemptions,
            eng.num_resumes,
            eng.num_ctx_stream_chunks,
        )

    def _flight_record(self, duration: float, pre: tuple, generated: int,
                       failed: Optional[str] = None,
                       timing: Optional[dict] = None) -> None:
        eng = self.engine
        p0, pad0, d0, a0, q0, sd0, sa0, sp0, rs0, pe0, re0, cs0 = pre
        hp = eng.host_pool
        prefill = eng.num_prefill_tokens - p0
        decode = eng.num_decode_tokens - d0
        if failed is not None:
            kind = "failed"
        elif prefill and decode:
            kind = "mixed"
        elif prefill:
            kind = "prefill"
        elif decode:
            kind = "decode"
        else:
            kind = "idle"
        rec = {
            "step": self.steps,
            "ts": time.time(),
            "duration": duration,
            "kind": kind,
            "slots_busy": sum(1 for s in eng.slots if s is not None),
            "slots_total": len(eng.slots),
            "queue_depth": self.queue_depth(),
            "kv_pages_used": eng.kv_pages_used,
            "kv_pages_free": eng.allocator.free_pages,
            "prefill_tokens": prefill,
            "padding_tokens": eng.num_prefill_padding_tokens - pad0,
            "decode_tokens": decode,
            "generated_tokens": generated,
            "admissions": eng.num_admitted - a0,
            "evictions": self.quarantine_evictions - q0,
            "spec_drafted": eng.num_spec_drafted_tokens - sd0,
            "spec_accepted": eng.num_spec_accepted_tokens - sa0,
            "spilled_pages": (hp.spilled_pages - sp0) if hp is not None else 0,
            "restored_pages": (
                (hp.restored_pages - rs0) if hp is not None else 0),
            "preemptions": eng.num_preemptions - pe0,
            "resumes": eng.num_resumes - re0,
            "host_pool_pages": hp.pages if hp is not None else 0,
            # tiered residency: cold chunks streamed through attention
            # this step, and the cold-page gauge
            "ctx_stream_chunks": eng.num_ctx_stream_chunks - cs0,
            "kv_cold_pages": int(eng.kv_cold_pages),
            # the scheduler's prefill-admission budget in force this step
            # (0 = unbudgeted)
            "prefill_budget_tokens": int(eng.prefill_budget or 0),
            # distinct tenants / adapters sharing this step's batch
            "distinct_tenants": len({s.tenant for s in eng.slots
                                     if s is not None}),
            "distinct_adapters": len({s.adapter for s in eng.slots
                                      if s is not None and s.adapter}),
        }
        if timing:
            # the step's time split: host build / device wait / emit, and
            # the device-idle gap it charged
            rec.update(timing)
        if failed is not None:
            rec["anomaly"] = "step_failure"
            rec["error"] = failed[:200]
        self.flight.record_step(rec)
        # a goodput sample while the engine works (throttled inside)
        self._tps.rate(eng.num_generated_tokens)

    def _sched_pass(self) -> None:
        """The scheduler pass (engine thread, the wait queue's owner):
        rewrite the queue into dispatch order and refresh the per-step
        prefill budget from the live latency burn.  It reads only the
        wait queue and the burn accounts, so it is safe with a step in
        flight and makes no device call."""
        t0 = time.perf_counter()
        self.sched.reorder(self.engine.waiting)
        self.engine.prefill_budget = self.sched.prefill_budget(self.slo)
        self.sched_pass_seconds += time.perf_counter() - t0
        self.sched_passes += 1

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
            completion failed and the failure ladder ran."""
            nonlocal inflight
            if inflight is None:
                self._emit_stage.flush()
                return True
            pend, inflight = inflight, None
            pre = self._flight_pre()
            t0 = time.monotonic()
            try:
                emitted = complete(pend)
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                self.engine.discard_pending(pend)
                self._handle_step_failure(e, time.monotonic() - t0, pre)
                return False
            dt_wait = time.monotonic() - t0
            t_emit = time.monotonic()
            self._emit_stage.push(self._snapshot_events(emitted))
            # the step's dispatch skipped its record: it lands here
            self._flight_record(dt_wait, pre, generated=len(emitted),
                                timing={
                                    "host_build_s": 0.0,
                                    "device_wait_s": round(dt_wait, 6),
                                    "emit_s": round(
                                        time.monotonic() - t_emit, 6),
                                    "idle_gap_s": 0.0,
                                    "wall_s": round(
                                        time.monotonic() - t0, 6),
                                    "pipelined": 1,
                                })
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
            if time.monotonic() - self._last_reap > 10.0:
                self._last_reap = time.monotonic()
                reaped = self.engine.reap_stuck(self.max_queue_seconds)
                if reaped:
                    self._emit_stage.flush()
                for req in reaped:
                    self._forget_request(req.id)
                    cb = self._subscribers.pop(req.id, None)
                    if cb:
                        cb(_error_event(req.id,
                                        "request timed out in queue"))
            if self._pressure_pending():
                # the ladder reads and rewrites the host mirrors (a
                # preempt saves _positions / _last_token): no step may be
                # in flight.  The pipeline never runs ahead of a waiting
                # queue or a parked decoder, so this costs no overlap.
                if not reconcile():
                    continue
                self._memory_pressure_tick()
            if self._disagg_cb and self._handoff_work():
                if not reconcile():
                    continue
                self._disagg_tick()
            if not self.engine.has_work():
                if not reconcile():
                    continue
                if self.engine.has_work():
                    continue   # the reconcile advanced work
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            if self._sched_active:
                self._sched_pass()
            # the pipeline gate, decided BEFORE the dispatch
            can_pipe = (self.async_enabled and not self._draining
                        and self.engine.pipeline_ready())
            if inflight is not None and not can_pipe:
                if not reconcile():
                    continue
            t_step = time.monotonic()
            flight_pre = self._flight_pre()
            overlapped = inflight is not None
            try:
                emitted, pend = self._dispatch_once()
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                # the in-flight step is healthy dispatched work: complete
                # it first so its tokens are not lost, and record it
                if inflight is not None:
                    prev, inflight = inflight, None
                    pre_prev = self._flight_pre()
                    t0_prev = time.monotonic()
                    try:
                        prev_emitted = complete(prev)
                    except Exception:  # noqa: BLE001 — poisoned chain
                        self.engine.discard_pending(prev)
                    else:
                        self._emit_stage.push(
                            self._snapshot_events(prev_emitted))
                        dt_prev = time.monotonic() - t0_prev
                        self._flight_record(
                            dt_prev, pre_prev, generated=len(prev_emitted),
                            timing={"host_build_s": 0.0,
                                    "device_wait_s": round(dt_prev, 6),
                                    "emit_s": 0.0, "idle_gap_s": 0.0,
                                    "wall_s": round(dt_prev, 6),
                                    "pipelined": 1})
                self._handle_step_failure(e, time.monotonic() - t_step,
                                          flight_pre)
                continue
            t_built = time.monotonic()
            dt_build = t_built - t_step
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
                    # stage the next step's cold chunks while this step
                    # still runs: the gathers queue behind it
                    self.engine.prefetch_cold()
                    self.engine.step_complete(pend, emitted)
                    pend = None
                    dt_wait += time.monotonic() - t_w
                    self._device_busy_until = time.monotonic()
            except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                for p in (prev, pend):
                    if p is not None:
                        self.engine.discard_pending(p)
                inflight = None
                self._handle_step_failure(e, time.monotonic() - t_step,
                                          flight_pre)
                continue
            dt_step = time.monotonic() - t_step
            self.obs.step_seconds.observe(dt_step)
            self.obs.host_build.observe(dt_build)
            self._consec_failures = 0
            self._barren_rounds = 0
            self.steps += 1
            if inflight is not None and not emitted:
                # pipeline-fill pass: its numbers land with its completion
                continue
            t_emit = time.monotonic()
            self._emit_stage.push(self._snapshot_events(emitted))
            dt_emit = time.monotonic() - t_emit
            self._deliver_resume_failures()
            self._flight_record(dt_step, flight_pre, generated=len(emitted),
                                timing={
                                    "host_build_s": round(dt_build, 6),
                                    "device_wait_s": round(dt_wait, 6),
                                    "emit_s": round(dt_emit, 6),
                                    "idle_gap_s": round(idle_gap, 6),
                                    "wall_s": round(
                                        time.monotonic() - t_step, 6),
                                    "pipelined": 1 if overlapped else 0,
                                })
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

    # -- poisoned-request quarantine ------------------------------------------

    def _active_by_recency(self) -> list:
        """Unfinished submitted requests, oldest admission first."""
        out = []
        for rid in self._admit_order:
            req = self.engine.get_request(rid)
            if req is not None and not req.finished:
                out.append(req)
        # prune finished ids so the order list does not grow unboundedly
        self._admit_order = [r.id for r in out]
        return out

    def _evict_victim(self, cands: list, msg: str) -> None:
        """Shed ONE of ``cands`` (oldest admission first): the scheduler
        picks the victim (the policy ladder under WFQ, the newest under
        the FIFO baseline), and the decision is audited."""
        victim = self.sched.pick_shed_victim(cands)
        if victim is None:
            return
        if self._sched_active:
            self.sched.note_shed_victim(victim)
            self._audit(SHED_VICTIM, tenant=victim.tenant,
                        trace_id=victim.trace_id, request_id=victim.id,
                        detail=f"policy victim among {len(cands)} "
                               "candidate(s)")
        self._evict(victim, msg)

    def _evict(self, req, msg: str) -> None:
        self._emit_stage.flush()   # no error frame may overtake tokens
        self.engine.abort(req.id)
        self.quarantine_evictions += 1
        self._note_quarantine(req, msg,
                              self._first_emit.get(req.id, time.monotonic()))

    def _note_quarantine(self, req, msg: str, span_start: float) -> None:
        """The anomaly, audit, log and span of one quarantine eviction,
        then the request's error event."""
        self.flight.note_anomaly("quarantine", request_id=req.id,
                                 detail=msg[:200])
        self._audit("quarantine", tenant=req.tenant, trace_id=req.trace_id,
                    request_id=req.id, detail=msg)
        log.warning("engine '%s' evicting request_id=%s trace_id=%s: %s",
                    self.name, req.id, req.trace_id or "-", msg)
        if req.trace_id:
            self._trace.record(req.trace_id, "quarantine", span_start,
                               time.monotonic(), plane="engine",
                               request_id=req.id, reason=msg)
        self._forget_request(req.id)
        cb = self._subscribers.pop(req.id, None)
        if cb:
            cb(_error_event(req.id, msg))

    @staticmethod
    def _clone_for_readmit(req) -> Request:
        """A fresh Request (same id, so subscribers stay valid) for a
        quarantined request that never emitted a token, to re-prefill it
        from scratch during bisection."""
        return Request(
            id=req.id,
            prompt_tokens=list(req.prompt_tokens),
            sampling=req.sampling,
            stop_token_ids=req.stop_token_ids,
            image_embeds=req.image_embeds,
            image_positions=req.image_positions,
            positions3=req.positions3,
            mrope_delta=req.mrope_delta,
            trace_id=req.trace_id,
            tenant=req.tenant,
            sched_class=req.sched_class,
            adapter=req.adapter,
        )

    def _trial(self, group: list) -> bool:
        """Re-admit ``group`` (clones) and step until each member emits or
        finishes.  True: the group is clean (members left running);
        False: a step failed, members re-aborted (subscribers kept)."""
        clones = []
        for req in group:
            clone = self._clone_for_readmit(req)
            try:
                self.engine.add_request(clone)
            except Exception as e:  # noqa: BLE001 — validation changed?
                self._evict(clone, f"engine rejected request: {e}")
                continue
            clones.append(clone)
        if not clones:
            return True
        # admission + every prefill chunk + slack: no unbounded spin if a
        # clone can never reach its first token
        chunk = max(1, self.engine.cfg.max_prefill_len)
        budget = 8 + sum(len(c.prompt_tokens) // chunk + 1 for c in clones)
        for _ in range(budget):
            try:
                emitted = self._step_once()
            except Exception:  # noqa: BLE001 — the culprit is in this group
                for c in clones:
                    self.engine.abort(c.id)
                return False
            self.steps += 1
            self._emit(emitted)
            if all(c.finished or c.output_tokens for c in clones):
                return True
        return True   # budget spent without a failure: call it clean

    def _quarantine(self, err: Exception) -> None:
        """The step failed twice on the same state: blame the most
        recently admitted request(s) instead of failing everyone.

        Requests that have not emitted a token yet (the usual poison: a
        prompt whose prefill trips the fault) can be re-prefilled safely,
        so they are pulled out and bisected back in; only the subset whose
        re-admission still fails the step is evicted.  A control step
        with the suspects removed guards the other direction: if the fault
        persists without them, it lives in an emitting request, the
        suspects are re-admitted untouched and one policy victim is shed
        instead."""
        self._emit_stage.flush()   # bisection emits directly from here
        active = self._active_by_recency()
        suspects = [r for r in active if not r.output_tokens]
        emitting = [r for r in active if r.output_tokens]
        if suspects:
            for r in suspects:
                self.engine.abort(r.id)   # keep subscribers: clones re-emit
            if emitting and self.engine.has_work():
                # control step: suspects out, only the emitting set runs;
                # a failure here exonerates the suspects
                try:
                    emitted = self._step_once()
                    self.steps += 1
                    self._emit(emitted)
                except Exception:  # noqa: BLE001 — the fault is in the batch
                    for r in suspects:
                        try:
                            self.engine.add_request(
                                self._clone_for_readmit(r))
                        except Exception as e:  # noqa: BLE001
                            self._evict(r, f"engine rejected request: {e}")
                    self._evict_victim(
                        emitting, "evicted after repeated engine step "
                        f"failures ({err})")
                    return
            culprits: list = []
            stack = [suspects]
            while stack:
                group = stack.pop()
                if self._trial(group):
                    continue
                if len(group) == 1:
                    culprits.append(group[0])
                    continue
                mid = len(group) // 2
                stack.append(group[:mid])    # older half
                stack.append(group[mid:])    # newer half tested first
            for r in culprits:
                self.quarantine_evictions += 1
                now = time.monotonic()
                self._note_quarantine(
                    r, "request quarantined: engine step failed while "
                    f"scheduled ({err})", now)
            if culprits:
                self._barren_rounds = 0
                return
            # every suspect came back clean: the fault was transient (one
            # more chance) or it lives in an emitting request (shed a
            # policy victim next round)
            self._barren_rounds += 1
            if self._barren_rounds < 2:
                return
        if active:
            self._evict_victim(
                active, f"evicted after repeated engine step failures ({err})")

    def _fail_all(self, message: str) -> None:
        self._emit_stage.flush()   # no error frame may overtake tokens
        for req in self._active_by_recency():
            self.engine.abort(req.id)
            self._forget_request(req.id)
            cb = self._subscribers.pop(req.id, None)
            if cb:
                cb(_error_event(req.id, message))
        # subscribers whose request the engine no longer holds
        for rid, cb in list(self._subscribers.items()):
            self.engine.abort(rid)
            cb(_error_event(rid, message))
        self._subscribers.clear()
