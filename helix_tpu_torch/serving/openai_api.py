"""OpenAI-compatible HTTP surface on the standard library.

A subset of ``helix_tpu/serving/openai_api.py`` served by
``http.server.ThreadingHTTPServer`` (one thread per connection), so the
port needs no web framework:

- ``GET /healthz`` (the declared model names), ``GET /v1/models`` (the
  models the registry holds: with a ``ResidencyManager`` behind it, the
  resident ones, as in the reference; and each model's published
  multi-LoRA adapters as bounded ``base@adapter`` entries);
- ``model@adapter`` addressing on the generation routes: the base model
  resolves through the registry (a ``ResidencyManager`` loads it), the
  adapter id is sanitised and must be published on the engine's store
  (404 otherwise, and for a model without an adapter pool), and its
  prefetch is kicked;
- ``POST /v1/adapters`` ``{"model", "name", "checkpoint"[, "scale"]}``
  (runner-token gated): 400 for a bad name or no checkpoint, 404 / 503
  for the model, 409 without an adapter pool, and 501 with the store's
  error, since publishing from a training checkpoint waits for
  torch-native checkpoints (ROADMAP A18);
- ``POST /admin/prefetch`` ``{"model"}``: stage a model in the background
  through the ``ResidencyManager`` behind the registry (200 with
  ``"prefetch": "started"|"declined"``, 404 for an unknown model, 409
  without a manager); a request whose model cannot be loaded within the
  budget (``MemoryError`` from ``registry.get``) answers 503
  ``overloaded_error`` with the manager's message;
- ``POST /v1/chat/completions`` and ``POST /v1/completions``, non-stream
  and SSE (``text/event-stream``: ``data: {...}\\n\\n`` frames ending in
  ``data: [DONE]``), with the reference's JSON fields, stop strings and
  error shape ``{"error": {"message", "type"[, "code", "request_id"]}}``;
  a draining engine answers 503, a ``kv_exhausted`` shed 503 with that
  code, and a request shipped to a peer at the drain deadline ends its
  stream with a ``migrated: ... peer=<id>`` error frame (503, code
  ``migrated``, without a stream);
- ``POST /v1/migrate/import`` (a wire snapshot from a peer runner, every
  checksum verified before the engine changes; 422 with a typed code
  when it is refused) and ``POST /v1/migrate/resume`` (the imported
  request's stream as neutral SSE deltas: the catch-up text the client
  has not seen, then live tokens).  Both take ``X-Runner-Token`` when
  ``HELIX_RUNNER_TOKEN`` is set;
- the disaggregated prefill handoff: a streamed chat or completion that
  carries ``X-Helix-Disagg`` (and the runner token, when one is set) is
  prefilled here and, at its first token, shipped to the decode peer
  that ``X-Helix-Disagg-Peer`` / ``-Peer-Addr`` name; the stream then
  ends with the ``migrated ... peer=<id>`` frame, or is served here
  whole when the export or the ship fails (``_disagg_prefill``);

- ``GET /metrics``: Prometheus text rendered by the port's registry
  (``obs.metrics``), with the reference's ``_collect_metrics`` series
  (names, types and label sets) wherever the port has the quantity: the
  engine, loop, saturation, prefix-cache, host-tier and preemption
  series, the loop's latency histograms, the tenant and SLO series
  (``obs.slo``), the scheduler's (``serving.sched``), the residency
  manager's, the adapters' (``engine.adapters``), the migration and
  transfer series (``serving.migration``), the filestore tier's
  (``serving.kv_filestore``) and the trace-loss counter
  (``obs.trace``).  ``helix_mfu_estimate`` needs ``HELIX_PEAK_FLOPS``
  (the card's peak FLOP/s); without it the gauge is left out;
- ``GET /v1/debug/traces``, ``/v1/debug/traces/{trace_id}`` (``?format=
  chrome`` for Chrome ``trace_event`` JSON), ``/v1/debug/flight`` and
  ``/v1/debug/admissions`` (``?model=``, ``?recent=``), with the
  reference's JSON shapes, runner-token gated like migration;
- tenant and class: ``X-Helix-Tenant`` (``obs.slo.sanitize_tenant``) and
  ``X-Helix-Class`` (``serving.sched.sanitize_class``) ride onto the
  ``Request``, and ``X-Helix-Trace-Id`` is adopted (or minted) and echoed
  on errors; a request the engine loop would shed is answered before any
  stream starts: ``queue_full`` 429 with ``Retry-After: 1``, a draining
  engine 503, a KV-starved one 503 ``kv_exhausted``.

- ``POST /v1/messages``: the Anthropic Messages surface (``system``,
  ``messages``, ``max_tokens``, ``temperature``, ``top_p``, ``top_k``,
  ``stop_sequences``), non-stream and SSE (``event: <name>`` frames from
  ``message_start`` to ``message_stop``), with the reference's JSON;
- ``GET /logs?tail=N``: the node's log ring (``serving.logbuf``);
- ``POST /admin/profiler`` ``{"seconds"}`` (runner-token gated): one
  ``torch.profiler`` capture at a time (409 while one runs) of the host
  and, on the card, the CUDA activity, exported as a Chrome trace into a
  directory minted under ``HELIX_PROFILER_DIR`` or the temp dir;
  answers ``{"log_dir", "seconds"}``;
- ``GET /api/v1/state``: the node agent's heartbeat body, when the server
  was given one (``state=``).

- ``POST /v1/embeddings``: text inputs of an embedding model
  (``kind="embedding"``, a ``models.bge.EmbeddingRunner``), with the
  reference's JSON and ``usage`` block; text and ``{"image": <url /
  base64>}`` inputs of a vision-embedding model
  (``kind="vision-embedding"``, a ``models.vision_embed.
  VisionEmbeddingRunner``), in order; a model of another kind answers
  404 "is not an embedding model", a dict input without ``image`` 400,
  an ``{"image": ...}`` input to a text embedder 400 "cannot embed
  images".  The generation routes answer an embedding model 404 as the
  reference does (chat: "is an embedding model"; the others: "does not
  serve generation");
- image parts in a chat (``{"type": "image_url" | "image"}``): a
  ``kind="vision"`` model's ``VisionRunner.prepare`` runs on the
  handler's thread (the tower on the card, off the engine thread) and
  the request carries its image state; any other model answers 400
  "does not accept image input", a failed decode or resize 400 "image
  processing failed: ..." (the reference's texts).  Such a request is
  never handed off to a decode peer;

A client that hangs up mid-response (a broken pipe or a reset) ends its
request as the engine's abort does, with one log line and no traceback.
``make_unix_server`` serves the same routes on a unix socket (the
reverse tunnel's local side, ``control.tunnel``).

- the context-caching API (``serving.context_cache``): ``POST
  /v1/context`` (``{"model", "messages" | "prompt"}``) prefills the
  prefix once as a pinned one-token greedy request and answers its
  content-addressed handle (``"cached": true`` when it already existed;
  429 ``overloaded_error`` / ``context_quota_exceeded`` past the
  tenant's ``HELIX_CTX_TENANT_TOKENS``); ``GET /v1/context`` lists the
  handles; ``context_id`` on a chat or completion prepends the span
  (404 ``context_not_found`` for an unknown handle), ``usage`` charging
  the whole span.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import queue
import socketserver
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from helix_tpu_torch.engine.adapters import (
    ADAPTER_SEP,
    MAX_LISTED_ADAPTERS,
    collect_adapter_metrics,
    sanitize_adapter_id,
    split_model_adapter,
)
from helix_tpu_torch.engine.engine import Request, SnapshotError
from helix_tpu_torch.engine.residency import model_param_count
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.obs.metrics import Collector, Registry
from helix_tpu_torch.obs.slo import ANON_TENANT, TENANT_HEADER, sanitize_tenant
from helix_tpu_torch.obs.trace import (
    TRACE_HEADER,
    adopt_trace_id,
    collect_trace_metrics,
    default_store,
    is_trace_id,
)
from helix_tpu_torch.serving.logbuf import install as install_logbuf
from helix_tpu_torch.serving.engine_loop import (
    KV_EXHAUSTED,
    QUEUE_FULL,
    SHUTTING_DOWN,
)
from helix_tpu_torch.serving.context_cache import (
    collect_ctx_metrics,
    context_cache_for,
    context_handle,
)
from helix_tpu_torch.serving.kv_filestore import (
    collect_filestore_kv,
    kv_filestore_dir,
)
from helix_tpu_torch.serving.migration import (
    DISAGG_HEADER,
    DISAGG_PEER_ADDR_HEADER,
    DISAGG_PEER_ID_HEADER,
    MIGRATED,
    ImportedStream,
    ImportedStreams,
    PeerShipper,
    XferConfig,
    collect_runner_migration,
    collect_xfer,
    json_loads,
    migrated_error,
    migration_timeout,
    wire_to_snapshot,
)
from helix_tpu_torch.serving.sched import CLASS_HEADER, sanitize_class
from helix_tpu_torch.serving.tokenizer import IncrementalDetokenizer

log = logging.getLogger(__name__)
# the client went away: the request ends, the server goes on
HANGUP = (BrokenPipeError, ConnectionResetError)


class EngineRequestError(Exception):
    """A request the engine rejected or failed mid-flight."""

    def __init__(self, message: str, request_id: str = ""):
        super().__init__(message)
        self.request_id = request_id


def _error_body(message: str, etype: str = "invalid_request_error",
                code: str = "", request_id: str = "",
                trace_id: str = "") -> dict:
    err: dict = {"message": message, "type": etype}
    if code:
        err["code"] = code
    if trace_id:
        err["trace_id"] = trace_id
    if request_id:
        err["request_id"] = request_id
    return {"error": err}


def _engine_error(e: EngineRequestError) -> tuple:
    """(status, body, headers) for an engine error: shed load is a 429
    with ``Retry-After``, a drain or KV exhaustion a 503, an engine
    timeout a 504, anything else a 400."""
    msg = str(e)
    if msg.startswith(QUEUE_FULL):
        return 429, _error_body(msg, "overloaded_error",
                                request_id=e.request_id), {"Retry-After": "1"}
    if msg.startswith(KV_EXHAUSTED):
        return 503, _error_body(msg, "overloaded_error", code=KV_EXHAUSTED,
                                request_id=e.request_id), {"Retry-After": "2"}
    if msg.startswith(SHUTTING_DOWN):
        return 503, _error_body(msg, "overloaded_error",
                                request_id=e.request_id), {"Retry-After": "5"}
    if msg.startswith(MIGRATED):
        # exported to a peer at the drain deadline: the control plane's
        # failover resumes streams there; others get a typed retry
        return 503, _error_body(msg, "overloaded_error", code=MIGRATED,
                                request_id=e.request_id), {"Retry-After": "1"}
    if msg.startswith("inter_token_timeout"):
        return 504, _error_body(msg, "timeout_error",
                                request_id=e.request_id), {}
    return 400, _error_body(msg, request_id=e.request_id), {}


def sampling_from_body(body: dict) -> SamplingParams:
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        max_tokens=int(
            body.get("max_tokens") or body.get("max_completion_tokens")
            or 256
        ),
        stop=tuple(stop),
        seed=body.get("seed"),
    )


def _peak_flops() -> float:
    """Peak device FLOP/s for the MFU denominator: ``HELIX_PEAK_FLOPS``
    when the operator sets it, else 0 (the gauge is left out)."""
    try:
        return float(os.environ.get("HELIX_PEAK_FLOPS", "") or 0.0)
    except ValueError:
        return 0.0


class OpenAIServer:
    """Routes OpenAI requests to the registry's engine loops."""

    def __init__(self, registry,
                 inter_token_timeout: Optional[float] = 600.0,
                 state=None):
        self.registry = registry
        self.inter_token_timeout = inter_token_timeout
        # the node agent's heartbeat body for GET /api/v1/state
        self.state = state
        self.logbuf = install_logbuf()
        self._profiler_lock = threading.Lock()
        # migrated-in requests whose stream nobody has claimed yet
        self.imported = ImportedStreams()
        self.started = time.monotonic()
        self.traces = default_store()
        # the context-cache registry, shared with the node agent's
        # heartbeat through the filestore root
        self.ctx_cache = context_cache_for(kv_filestore_dir())
        # the /metrics surface: every series comes from scrape-time
        # collection over the live engines
        self.obs = Registry()
        self.obs.register_callback(self._collect_metrics)

    def residency_manager(self):
        """The ResidencyManager behind the registry, if hot-swap is on."""
        for cand in (self.registry, getattr(self.registry, "inner", None)):
            if cand is not None and hasattr(cand, "prefetch"):
                return cand
        return None

    def sweep_imports(self) -> None:
        """Abort imported requests whose stream was not claimed within
        the migration timeout: nobody will read them."""
        for stream in self.imported.sweep():
            served = self.registry.get(stream.model)
            if served is not None and served.loop is not None:
                served.loop.abort(stream.request_id)
                served.loop.note_migration_failure()

    def generate(self, served, prompt_ids, sampling: SamplingParams,
                 adapter: str = "", tenant: str = ANON_TENANT,
                 sched_class: str = "", trace_id: str = "",
                 request_id: str = "", ctx_pin: bool = False,
                 extra: Optional[dict] = None):
        """Submit to the engine loop; yields ``(delta_text, token_id,
        finished, finish_reason)``.  Serving-level stop strings end the
        stream at the match.  ``adapter``: a sanitised, published adapter
        id of the model ("" = the base model); ``tenant`` /
        ``sched_class``: the sanitised identity headers ("" class = the
        profile's default); ``ctx_pin``: keep the request fully resident
        (a context creation); ``extra``: a VL request's image fields
        (``VisionRunner.prepare``)."""
        q: "queue.Queue" = queue.Queue()
        req = Request(
            id=request_id or f"req-{uuid.uuid4().hex[:12]}",
            prompt_tokens=list(prompt_ids),
            sampling=sampling,
            stop_token_ids=tuple(served.tokenizer.eos_ids),
            adapter=adapter,
            tenant=tenant,
            sched_class=sched_class,
            trace_id=trace_id,
            ctx_pin=ctx_pin,
            **(extra or {}),
        )
        served.loop.submit(req, q.put)
        yield from self.token_stream(served, req, sampling, q.get)

    def token_stream(self, served, req: Request, sampling: SamplingParams,
                     next_event):
        """The ``generate`` tuples of a submitted request whose events
        ``next_event(timeout)`` returns (raising ``queue.Empty`` past the
        timeout); the request is aborted if the stream ends before it."""
        detok = IncrementalDetokenizer(served.tokenizer)
        emitted_len = 0
        try:
            while True:
                try:
                    ev = next_event(self.inter_token_timeout)
                except queue.Empty:
                    served.loop.abort(req.id)
                    raise EngineRequestError(
                        f"inter_token_timeout: no engine event for "
                        f"{self.inter_token_timeout:.0f}s; request "
                        f"{req.id} aborted", request_id=req.id,
                    ) from None
                if ev.error:
                    raise EngineRequestError(ev.error, request_id=req.id)
                is_eos = ev.token_id in served.tokenizer.eos_ids
                delta = "" if is_eos else detok.push(ev.token_id)
                hit_stop = None
                for s in sampling.stop:
                    idx = detok._emitted.find(s, max(0, emitted_len - len(s)))
                    if idx >= 0:
                        hit_stop = idx
                        break
                if hit_stop is not None:
                    final_delta = detok._emitted[:hit_stop][emitted_len:]
                    served.loop.abort(req.id)
                    yield final_delta, ev.token_id, True, "stop"
                    return
                emitted_len = len(detok._emitted)
                yield delta, ev.token_id, ev.finished, ev.finish_reason
                if ev.finished:
                    return
        finally:
            if not req.finished:
                served.loop.abort(req.id)

    # -- /metrics -----------------------------------------------------------

    def render_metrics(self) -> str:
        return self.obs.render()

    def _collect_metrics(self, c: Collector) -> None:
        """Scrape-time collection from every live engine (per-model
        labels) and the residency manager: the reference's series, read
        off plain counters of the engine thread's state."""
        c.gauge("helix_uptime_seconds", time.monotonic() - self.started,
                help="Runner process uptime")
        collect_xfer(c)
        collect_trace_metrics(c, self.traces)
        collect_ctx_metrics(c, self.ctx_cache)
        for m in self.registry.list():
            if m.loop is None:
                continue
            loop, eng = m.loop, m.loop.engine
            lbl = {"model": m.name}
            c.counter("helix_engine_steps", loop.steps, lbl)
            c.counter("helix_prefill_tokens_total", eng.num_prefill_tokens,
                      lbl)
            c.counter("helix_decode_tokens_total", eng.num_decode_tokens,
                      lbl)
            c.counter("helix_mixed_steps_total", eng.num_mixed_steps, lbl)
            # MoE prefill routing assignments dropped to expert capacity
            # (their tokens rode the residual stream)
            c.counter("helix_moe_dropped_tokens_total",
                      eng.moe_dropped_tokens, lbl)
            c.counter("helix_spec_drafted_tokens_total",
                      eng.num_spec_drafted_tokens, lbl)
            c.counter("helix_spec_accepted_tokens_total",
                      eng.num_spec_accepted_tokens, lbl)
            c.gauge("helix_spec_acceptance_ratio",
                    eng.spec_acceptance_ratio, lbl)
            c.gauge("helix_spec_disabled_slots", eng.spec_disabled_slots(),
                    lbl)
            c.gauge("helix_waiting_requests", len(eng.waiting), lbl)
            c.gauge("helix_active_slots",
                    sum(1 for s in eng.slots if s is not None), lbl)
            c.gauge("helix_free_pages", eng.allocator.free_pages, lbl)
            c.counter("helix_step_failures_total", loop.step_failures, lbl)
            c.counter("helix_step_retries_total", loop.step_retries, lbl)
            c.counter("helix_quarantine_evictions_total",
                      loop.quarantine_evictions, lbl)
            c.counter("helix_shed_requests_total", loop.shed_requests, lbl)
            c.counter("helix_pipelined_steps_total", loop.pipelined_steps,
                      lbl)
            c.gauge("helix_device_idle_ratio",
                    round(loop.device_idle_ratio(), 4), lbl)
            loop.obs.collect(c, lbl)
            self._collect_saturation(c, loop, eng, lbl)
            loop.slo.collect(c, lbl)
            loop.sched.collect(c, lbl)
            collect_runner_migration(c, loop, lbl)
            collect_filestore_kv(c, loop, lbl)
            collect_adapter_metrics(c, loop, lbl)
            pc = eng.prefix_cache
            if pc is not None:
                st = pc.stats
                c.gauge("helix_prefix_cache_pages", st["pages"], lbl)
                c.counter("helix_prefix_cache_hit_pages_total", st["hits"],
                          lbl)
                c.counter("helix_prefix_cache_miss_pages_total",
                          st["misses"], lbl)
                c.counter("helix_prefix_cache_hits_total",
                          eng.prefix_cache_hits, lbl)
                c.counter("helix_prefix_cache_misses_total",
                          eng.prefix_cache_misses, lbl)
                c.counter("helix_prefix_cache_evicted_pages_total",
                          st.get("evicted_pages", 0), lbl)
            s = []
            for _ in range(3):
                # the engine thread appends concurrently; a mutation
                # during the copy raises, so retry on a fresh one
                try:
                    s = sorted(eng.recent_ttfts)
                    break
                except RuntimeError:
                    continue
            if s:
                c.gauge("helix_ttft_p50_seconds", s[len(s) // 2], lbl)
                c.gauge("helix_ttft_p95_seconds",
                        s[min(len(s) - 1, int(len(s) * 0.95))], lbl)
        mgr = self.residency_manager()
        if mgr is not None:
            st = mgr.stats()
            c.counter("helix_residency_loads_total", st["loads"])
            c.counter("helix_residency_evictions_total", st["evictions"])
            c.gauge("helix_residency_used_bytes", st["used_bytes"])
            c.gauge("helix_residency_budget_bytes",
                    st.get("budget_bytes", 0))
            for name, secs in sorted(st["swap_seconds"].items()):
                c.gauge("helix_model_swap_seconds", secs, {"model": name})
            for name, secs in sorted(st["load_seconds"].items()):
                c.gauge("helix_model_load_seconds", secs, {"model": name})

    def _collect_saturation(self, c: Collector, loop, eng,
                            lbl: dict) -> None:
        """Per-model capacity gauges: KV occupancy and its high-water
        mark, decode-slot use, queue depth and queued tokens, goodput,
        padding waste, the host tier and preemption, and the MFU estimate
        when ``HELIX_PEAK_FLOPS`` is set."""
        sat = loop.saturation()
        c.gauge("helix_kv_pages_used", eng.kv_pages_used, lbl)
        c.gauge("helix_kv_pages_capacity", eng.kv_pages_capacity, lbl)
        c.gauge("helix_kv_pages_used_peak", eng.allocator.peak_used, lbl)
        c.gauge("helix_kv_occupancy_ratio", sat["kv_occupancy"], lbl)
        c.gauge("helix_decode_slots_busy", sat["slots_busy"], lbl)
        c.gauge("helix_decode_slots_capacity", sat["slots_total"], lbl)
        c.gauge("helix_decode_slot_utilization",
                sat["slots_busy"] / max(1, sat["slots_total"]), lbl)
        c.gauge("helix_queue_depth", sat["queue_depth"], lbl)
        c.gauge("helix_queued_tokens", loop.queued_tokens(), lbl)
        c.counter("helix_generated_tokens_total", eng.num_generated_tokens,
                  lbl)
        c.counter("helix_prefill_padding_tokens_total",
                  eng.num_prefill_padding_tokens, lbl)
        c.gauge("helix_prefill_padding_ratio", loop.padding_ratio(), lbl)
        c.gauge("helix_goodput_tokens_per_second", sat["tokens_per_sec"],
                lbl)
        c.gauge("helix_prefix_cache_hit_ratio", sat["prefix_hit_rate"], lbl)
        c.counter("helix_flight_anomalies_total",
                  loop.flight.anomalies_total, lbl)
        hp = eng.host_pool
        if hp is not None:
            c.counter("helix_kv_spilled_pages_total", hp.spilled_pages, lbl)
            c.counter("helix_kv_restored_pages_total", hp.restored_pages,
                      lbl)
            c.counter("helix_kv_host_evicted_pages_total", hp.evicted_pages,
                      lbl)
            c.counter("helix_kv_host_corrupt_pages_total", hp.corrupt_pages,
                      lbl)
            c.counter("helix_kv_host_alloc_failures_total",
                      hp.alloc_failures, lbl)
            c.gauge("helix_kv_host_pool_pages", hp.pages, lbl)
            c.gauge("helix_kv_host_pool_used_bytes", hp.used_bytes, lbl)
            c.gauge("helix_kv_host_pool_budget_bytes", hp.budget_bytes, lbl)
            c.gauge("helix_kv_host_occupancy_ratio", hp.occupancy, lbl)
            c.counter("helix_kv_restore_seconds_total", eng.restore_seconds,
                      lbl)
        c.counter("helix_preemptions_total", eng.num_preemptions, lbl)
        c.counter("helix_resumes_total", eng.num_resumes, lbl)
        c.gauge("helix_preempted_requests", len(eng.preempted), lbl)
        c.counter("helix_kv_exhausted_sheds_total", loop.kv_exhausted_sheds,
                  lbl)
        peak = _peak_flops()
        if peak > 0:
            # decode-side MFU estimate: each generated token moves ~2
            # FLOPs per parameter
            c.gauge("helix_mfu_estimate",
                    sat["tokens_per_sec"] * 2
                    * model_param_count(eng.model_cfg) / peak, lbl)

    def debug_flight(self, want: str = "", recent: int = 64) -> dict:
        out = {}
        for m in self.registry.list():
            if m.loop is None or (want and m.name != want):
                continue
            out[m.name] = m.loop.flight.snapshot(recent=recent)
        return out

    def debug_admissions(self, want: str = "", recent: int = 64) -> dict:
        out = {}
        for m in self.registry.list():
            if m.loop is None or (want and m.name != want):
                continue
            out[m.name] = m.loop.slo.audit.snapshot(recent=recent)
        return out

    def models_body(self) -> dict:
        data = []
        for m in self.registry.list():
            entry = {"id": m.name, "object": "model", "created": m.created,
                     "owned_by": m.owned_by}
            if m.context_length:
                entry["context_length"] = m.context_length
            data.append(entry)
            # published adapters: bounded base@adapter entries, served
            # through the same generation routes
            store = getattr(getattr(m.loop, "engine", None),
                            "adapter_store", None)
            if store is not None:
                for aid in store.ids(MAX_LISTED_ADAPTERS):
                    data.append({"id": f"{m.name}{ADAPTER_SEP}{aid}",
                                 "object": "model", "created": m.created,
                                 "owned_by": m.owned_by, "parent": m.name})
        return {"object": "list", "data": data}

    def handler_class(self):
        server = self

        class Handler(_Handler):
            api = server

        return Handler

    def make_http_server(self, host: str = "0.0.0.0",
                         port: int = 8000) -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((host, port), self.handler_class())
        httpd.daemon_threads = True
        return httpd

    def make_unix_server(self, path: str) -> "UnixHTTPServer":
        """The same routes on a unix socket at ``path`` (no TCP
        listener): what ``serve-node --tunnel`` serves."""
        return UnixHTTPServer(path, self.handler_class())

    def start(self, host: str = "127.0.0.1", port: int = 0):
        """Serve on a background thread; returns the HTTP server (its
        ``server_address`` holds the bound port; ``shutdown()`` stops
        it)."""
        httpd = self.make_http_server(host, port)
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="helix-torch-http").start()
        return httpd


class UnixHTTPServer(socketserver.ThreadingMixIn,
                     socketserver.UnixStreamServer):
    """``ThreadingHTTPServer`` on an ``AF_UNIX`` socket."""

    daemon_threads = True

    def server_bind(self):
        # a socket file left by an earlier run
        if os.path.exists(self.server_address):
            os.unlink(self.server_address)
        super().server_bind()


class _Handler(BaseHTTPRequestHandler):
    api: OpenAIServer = None   # set by OpenAIServer.handler_class

    def log_message(self, fmt, *args):   # quiet: no per-request stderr
        pass

    # -- plumbing -------------------------------------------------------

    def _json(self, status: int, body: dict, headers: Optional[dict] = None):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str,
               etype: str = "invalid_request_error", code: str = ""):
        self._json(status, _error_body(message, etype, code))

    def _text(self, status: int, text: str,
              ctype: str = "text/plain; version=0.0.4; charset=utf-8"):
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _trace_id(self) -> str:
        """The request's end-to-end trace identity: the caller's
        ``X-Helix-Trace-Id`` when it is shaped like one, else minted."""
        return adopt_trace_id(self.headers.get(TRACE_HEADER))

    def _tenant(self) -> str:
        """The request's tenant (``X-Helix-Tenant``), sanitised: a
        malformed value or a claim on ``__other__`` lands under
        ``anonymous``; the top-K accounting bounds the series count."""
        return sanitize_tenant(self.headers.get(TENANT_HEADER, ""))

    def _sched_class(self) -> str:
        """The request's priority class (``X-Helix-Class``), sanitised to
        the known names; "" defers to the profile's default class."""
        return sanitize_class(self.headers.get(CLASS_HEADER, ""))

    def _body(self) -> Optional[dict]:
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json_loads(self.rfile.read(n) or b"{}")
        except (ValueError, UnicodeDecodeError):
            return None
        return body if isinstance(body, dict) else None

    def _start_sse(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

    def _sse(self, obj) -> None:
        data = obj if isinstance(obj, str) else json.dumps(obj)
        self.wfile.write(f"data: {data}\n\n".encode())
        self.wfile.flush()

    def _served(self, body: dict):
        """Resolve the request's model on this handler's thread: with a
        ResidencyManager behind the registry a synchronous load stalls
        this request only."""
        return self._lookup(body.get("model", ""))

    def _lookup(self, model: str):
        try:
            served = self.api.registry.get(model)
        except MemoryError as e:
            self._error(503, str(e), "overloaded_error")
            return None
        if served is None:
            self._error(
                404,
                f"model '{model}' not found; available: "
                f"{self.api.registry.names()}",
                "model_not_found",
            )
        return served

    def _served_generation(self, body: dict) -> tuple:
        """Resolve a generation target, ``base@adapter`` included (the
        reference's ``_lookup_generation``): the base model resolves as
        ``_served`` does; the adapter id is sanitised and must be
        published on the engine's store (404 otherwise: a hostile id
        never reaches a path), and its prefetch is kicked.  Returns
        ``(served, adapter)``, served None once an error was sent."""
        model = body.get("model", "")
        base, adapter, ok = split_model_adapter(model)
        if isinstance(model, str) and ADAPTER_SEP in model:
            # a model registered under a literal name with '@' keeps
            # resolving by that name
            try:
                lit = self.api.registry.get(model)
            except MemoryError as e:
                self._error(503, str(e), "overloaded_error")
                return None, ""
            if lit is not None:
                return lit, ""
        if not ok:
            self._error(404, f"model '{model}' not found (invalid adapter "
                        "id)", "model_not_found")
            return None, ""
        served = self._lookup(base)
        if served is None or not adapter:
            return served, ""
        eng = getattr(served.loop, "engine", None)
        pool = getattr(eng, "adapter_pool", None)
        store = getattr(eng, "adapter_store", None)
        if pool is None or store is None:
            self._error(404, f"model '{base}' does not serve adapters "
                        "(engine.adapter_pool_slots is off)",
                        "model_not_found")
            return None, ""
        if not (pool.resident(adapter) or store.contains(adapter)):
            self._error(
                404, f"adapter '{adapter}' is not published for model "
                f"'{base}'; available: {store.ids(MAX_LISTED_ADAPTERS)}",
                "model_not_found")
            return None, ""
        if not pool.resident(adapter):
            store.prefetch(adapter)
        return served, adapter

    # -- routes -----------------------------------------------------------

    def _hung_up(self, e: Exception) -> None:
        """The client went away mid-response: whatever stream it had was
        closed (and its request aborted) on the way out; log one line."""
        self.close_connection = True
        log.info("client hung up on %s %s (%s)", self.command, self.path,
                 type(e).__name__)

    def do_GET(self):
        try:
            self._get()
        except HANGUP as e:
            self._hung_up(e)

    def _get(self):
        url = urllib.parse.urlsplit(self.path)
        path = url.path
        query = dict(urllib.parse.parse_qsl(url.query))
        if path == "/healthz":
            self._json(200, {"status": "ok",
                             "models": self.api.registry.names()})
        elif path == "/v1/models":
            self._json(200, self.api.models_body())
        elif path == "/v1/context":
            self._json(200, {"object": "list",
                             "data": self.api.ctx_cache.entries()})
        elif path == "/metrics":
            self._text(200, self.api.render_metrics())
        elif path.startswith("/v1/debug/"):
            self._debug(path[len("/v1/debug/"):], query)
        elif path == "/logs":
            try:
                n = max(1, min(int(query.get("tail", 200)), 2000))
            except ValueError:
                self._error(400, "tail must be an integer")
                return
            self._json(200, {"logs": self.api.logbuf.tail(n)})
        elif path == "/api/v1/state" and self.api.state is not None:
            self._json(200, self.api.state())
        else:
            self._error(404, f"no route {self.path}", "not_found")

    def _debug(self, route: str, query: dict):
        """The debug routes, runner-token gated: traces (ids, one trace
        as JSON or ``?format=chrome``), the flight recorders and the
        admission audits (``?model=``, ``?recent=``)."""
        if self._runner_token_denied():
            return
        if route == "traces":
            self._json(200, {"traces": self.api.traces.ids()[-100:]})
            return
        if route.startswith("traces/"):
            tid = route[len("traces/"):]
            doc = (self.api.traces.chrome_trace(tid)
                   if query.get("format") == "chrome"
                   else self.api.traces.get(tid))
            if doc is None:
                self._error(404, f"unknown trace {tid!r}")
                return
            self._json(200, doc)
            return
        if route not in ("flight", "admissions"):
            self._error(404, f"no route {self.path}", "not_found")
            return
        cap = 512 if route == "flight" else 256
        want = query.get("model", "")
        try:
            recent = max(1, min(int(query.get("recent", 64)), cap))
        except ValueError:
            self._error(400, "recent must be an integer")
            return
        if route == "flight":
            out = self.api.debug_flight(want, recent)
            missing = f"model {want!r} has no engine flight recorder"
        else:
            out = self.api.debug_admissions(want, recent)
            missing = f"model {want!r} has no admission audit"
        if want and not out:
            self._error(404, missing)
            return
        self._json(200, {"models": out})

    def do_POST(self):
        try:
            self._post()
        except HANGUP as e:
            # a stream's generator was closed on the way out (its request
            # aborted): no traceback for a client that left
            self._hung_up(e)

    def _post(self):
        routes = {"/v1/chat/completions": self._chat,
                  "/v1/completions": self._completions,
                  "/v1/embeddings": self._embeddings,
                  "/admin/prefetch": self._prefetch,
                  "/v1/adapters": self._publish_adapter,
                  "/v1/migrate/import": self._migrate_import,
                  "/v1/migrate/resume": self._migrate_resume,
                  "/v1/messages": self._messages,
                  "/v1/context": self._context_create,
                  "/admin/profiler": self._profiler}
        route = routes.get(self.path)
        if route is None:
            self._error(404, f"no route {self.path}", "not_found")
            return
        body = self._body()
        if body is None:
            self._error(400, "invalid JSON body")
            return
        route(body)

    def _require_loop(self, served, model: str) -> bool:
        """Generation needs an engine loop: an embedding model answers 404
        (the reference's ``_require_loop`` text).  True once answered."""
        if served.loop is not None:
            return False
        self._error(404, f"'{model}' does not serve generation",
                    "model_not_found")
        return True

    def _chat(self, body: dict):
        served, adapter = self._served_generation(body)
        if served is None:
            return
        model = body.get("model", "")
        if served.kind == "embedding":
            tid = self._trace_id()
            self._json(404, _error_body(
                f"model '{model}' is an embedding model", "model_not_found",
                trace_id=tid), {TRACE_HEADER: tid})
            return
        if self._require_loop(served, model):
            return
        messages = body.get("messages")
        if not messages:
            self._error(400, "'messages' is required")
            return
        has_images = any(
            isinstance(m.get("content"), list)
            and any(p.get("type") in ("image_url", "image")
                    for p in m["content"])
            for m in messages)
        extra = None
        if has_images:
            tid = self._trace_id()
            if served.vision is None:
                self._error_traced(
                    400, f"model '{model}' does not accept image input", tid)
                return
            try:
                extra = served.vision.prepare(messages, served.tokenizer)
            except Exception as e:  # noqa: BLE001 — bad image data etc.
                self._error_traced(400, f"image processing failed: {e}",
                                   tid)
                return
            prompt_ids = extra.pop("prompt_tokens")
        else:
            prompt_ids = served.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        prompt_ids = self._with_context(body, prompt_ids)
        if prompt_ids is not None:
            self._run(body, served, prompt_ids, chat=True, adapter=adapter,
                      extra=extra)

    def _completions(self, body: dict):
        served, adapter = self._served_generation(body)
        model = body.get("model", "")
        if served is None or self._require_loop(served, model):
            return
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        prompt_ids = self._with_context(body,
                                        served.tokenizer.encode(prompt))
        if prompt_ids is not None:
            self._run(body, served, prompt_ids, chat=False, adapter=adapter)

    def _error_traced(self, status: int, message: str, tid: str,
                      etype: str = "invalid_request_error",
                      code: str = "") -> None:
        """An error carrying the trace id in its body and header (the
        reference's ``_error(..., trace_id=)``)."""
        self._json(status, _error_body(message, etype, code, trace_id=tid),
                   {TRACE_HEADER: tid})

    def _with_context(self, body: dict, prompt_ids):
        """The prompt with the span of its ``context_id`` in front (the
        reference's ``_resolve_context``), or None once an error was sent:
        400 for a handle that is not a string, 404 ``context_not_found``
        for an unknown or unreadable one."""
        ctx_id = body.get("context_id", "")
        if not ctx_id:
            return prompt_ids
        if not isinstance(ctx_id, str):
            self._error_traced(400, "'context_id' must be a string",
                               self._trace_id())
            return None
        cached = self.api.ctx_cache.get(ctx_id)
        if cached is None:
            self._error_traced(
                404, f"context '{ctx_id}' not found (expired, evicted, or "
                "never created on this runner)", self._trace_id(),
                code="context_not_found")
            return None
        return list(cached) + list(prompt_ids)

    def _context_create(self, body: dict):
        """``POST /v1/context`` (the reference's ``create_context``): the
        prefix runs through the engine once as a one-token greedy
        request with ``ctx_pin`` (fully resident, so the prefix cache
        adopts every page), then its handle registers."""
        served, adapter = self._served_generation(body)
        if served is None:
            return
        model = body.get("model", "")
        tid, tenant = self._trace_id(), self._tenant()
        if served.kind == "embedding":
            self._error_traced(404, f"model '{model}' is an embedding model",
                               tid, "model_not_found")
            return
        if self._require_loop(served, model):
            return
        messages, prompt = body.get("messages"), body.get("prompt")
        if messages:
            # no generation prompt: the span is a prefix later turns extend
            prompt_ids = served.tokenizer.apply_chat_template(
                messages, add_generation_prompt=False)
        elif isinstance(prompt, list) and all(isinstance(t, int)
                                              for t in prompt):
            prompt_ids = list(prompt)
        elif isinstance(prompt, str) and prompt:
            prompt_ids = served.tokenizer.encode(prompt)
        else:
            self._error_traced(400, "'messages' or 'prompt' is required",
                               tid)
            return
        if not prompt_ids:
            self._error_traced(400, "context prefix is empty", tid)
            return
        cache = self.api.ctx_cache
        handle = context_handle(prompt_ids)
        answer = {"id": handle, "object": "context",
                  "created": int(time.time()), "model": model,
                  "tokens": len(prompt_ids)}
        if cache.contains(handle):
            # already pinned: no prefill, no new charge
            self._json(200, {**answer, "cached": True}, {TRACE_HEADER: tid})
            return
        if not cache.admit(tenant, len(prompt_ids)):
            self._error_traced(
                429, f"tenant '{tenant}' is over its context-cache token "
                f"quota ({cache.tenant_token_cap} tokens)", tid,
                "overloaded_error", code="context_quota_exceeded")
            return
        if self._shed(served, prompt_ids, tid, tenant):
            return
        t0 = time.monotonic()
        try:
            for _d, _t, finished, _r in self.api.generate(
                    served, prompt_ids,
                    SamplingParams(temperature=0.0, max_tokens=1), adapter,
                    tenant=tenant, trace_id=tid, ctx_pin=True):
                if finished:
                    break
        except EngineRequestError as e:
            self._engine_error_reply(e, tid)
            return
        handle = cache.put(prompt_ids, tenant=tenant)
        self.api.traces.record(
            tid, "context create", t0, time.monotonic(), plane="runner",
            model=model, prompt_tokens=len(prompt_ids), handle=handle,
            tenant=tenant)
        self._json(200, {**answer, "cached": False}, {TRACE_HEADER: tid})

    def _run(self, body: dict, served, prompt_ids, *, chat: bool,
             adapter: str = "", extra: Optional[dict] = None):
        try:
            sampling = sampling_from_body(body)
        except (TypeError, ValueError) as e:
            self._error(400, f"invalid sampling parameters: {e}")
            return
        model = body.get("model", "")
        tid, tenant = self._trace_id(), self._tenant()
        if self._shed(served, prompt_ids, tid, tenant):
            return
        rid = (f"chatcmpl-{uuid.uuid4().hex[:16]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:16]}")
        created = int(time.time())
        obj = "chat.completion" if chat else "text_completion"
        if (self.headers.get(DISAGG_HEADER) and body.get("stream")
                and extra is None and self._runner_token_ok()):
            # the control plane marked this dispatch prefill-only and
            # named a decode peer; a non-stream body ignores the header
            # and is served here
            self._disagg_prefill(served, model, prompt_ids, sampling,
                                 rid, created, obj, chat, tid, tenant,
                                 adapter)
            return
        gen = self.api.generate(served, prompt_ids, sampling, adapter,
                                tenant=tenant, sched_class=self._sched_class(),
                                trace_id=tid, extra=extra)
        if body.get("stream"):
            self._stream(gen, rid, created, model, obj, chat)
            return
        parts, n, finish = [], 0, "stop"
        try:
            for delta, _tok, finished, reason in gen:
                parts.append(delta)
                n += 1
                if finished:
                    finish = reason or "stop"
                    break
        except EngineRequestError as e:
            self._engine_error_reply(e, tid)
            return
        text = "".join(parts)
        choice = (
            {"index": 0, "message": {"role": "assistant", "content": text},
             "finish_reason": finish}
            if chat else
            {"index": 0, "text": text, "finish_reason": finish}
        )
        self._json(200, {
            "id": rid, "object": obj, "created": created, "model": model,
            "choices": [choice],
            "usage": {"prompt_tokens": len(prompt_ids),
                      "completion_tokens": n,
                      "total_tokens": len(prompt_ids) + n},
        })

    def _disagg_prefill(self, served, model, prompt_ids, sampling, rid,
                        created, obj, chat, tid, tenant, adapter) -> None:
        """The disaggregated prefill handoff, runner side (the
        reference's ``_disagg_prefill``, on this handler's thread).  The
        request is submitted as an ordinary stream with its export
        staged; once its first token exists the engine thread snapshots
        it and the wire comes back here, where it ships to the decode
        peer the headers name with the ``HELIX_XFER_*`` retry, backoff
        and deadline discipline.  Every rung falls back one step, and
        none leaves a stream stuck or wrong:

        - the ship is confirmed: the local request is aborted and the
          answer is the single ``migrated ... peer=<id>`` frame the
          control plane resumes on the peer;
        - the ship failed (the peer unreachable, the snapshot rejected as
          corrupt, the deadline passed): the request never stopped
          decoding here, and the stream is served from here, whole;
        - the export was refused, or the prefill outran the deadline: the
          request is served here;
        - it finished before the export: its buffered events are the
          stream."""
        peer_id = self.headers.get(DISAGG_PEER_ID_HEADER, "")
        peer_addr = self.headers.get(DISAGG_PEER_ADDR_HEADER, "")
        loop = served.loop
        traces = self.api.traces
        itt = self.api.inter_token_timeout
        itt = float("inf") if itt is None else itt
        q: "queue.Queue" = queue.Queue()
        req = Request(
            id=f"req-{uuid.uuid4().hex[:12]}",
            prompt_tokens=list(prompt_ids), sampling=sampling,
            stop_token_ids=tuple(served.tokenizer.eos_ids),
            adapter=adapter, tenant=tenant,
            sched_class=self._sched_class(), trace_id=tid)
        t_plan = time.monotonic()
        if peer_addr:
            loop.stage_disagg_export(
                req.id, lambda kind, wire: q.put(("export", kind, wire)))
        loop.submit(req, lambda ev: q.put(("ev", ev)))
        traces.record(tid, "disagg handoff plan", t_plan, time.monotonic(),
                      plane="runner", request_id=req.id,
                      peer=peer_id or peer_addr or "(none)",
                      staged=bool(peer_addr))
        xfer = XferConfig()
        deadline = time.monotonic() + xfer.deadline
        last_event = time.monotonic()
        buffered: list = []
        t_wait = time.monotonic()
        outcome, wire = (None, None) if peer_addr else ("local", None)
        while outcome is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the prefill did not complete inside the transfer
                # deadline: serve here, never a stuck handoff
                loop.unstage_disagg_export(req.id)
                outcome = "local"
                break
            try:
                item = q.get(timeout=min(remaining, itt))
            except queue.Empty:
                loop.unstage_disagg_export(req.id)
                if time.monotonic() - last_event < itt:
                    # the transfer deadline cut the wait short, not a
                    # wedged engine: serve here
                    outcome = "local"
                    break
                loop.abort(req.id)
                self._engine_error_reply(EngineRequestError(
                    f"inter_token_timeout: no engine event for {itt:.0f}s; "
                    f"request {req.id} aborted", request_id=req.id), tid)
                return
            last_event = time.monotonic()
            if item[0] == "export":
                kind = item[1]
                if kind == "gone":
                    self._json(502, _error_body(
                        f"request {req.id} vanished before the prefill "
                        "handoff", "overloaded_error", code="disagg_failed",
                        trace_id=tid), {TRACE_HEADER: tid})
                    return
                outcome = kind if kind in ("snapshot", "completed") \
                    else "local"
                wire = item[2]
                continue
            ev = item[1]
            if ev.error:
                loop.unstage_disagg_export(req.id)
                self._engine_error_reply(
                    EngineRequestError(ev.error, request_id=req.id), tid)
                return
            buffered.append(ev)
            if ev.finished:
                loop.unstage_disagg_export(req.id)
                outcome = "completed"
        if peer_addr:
            traces.record(tid, "disagg prefill wait", t_wait,
                          time.monotonic(), plane="runner",
                          request_id=req.id, outcome=outcome)
        if outcome == "snapshot":
            # the ship spends what is left of the one transfer deadline
            # (prefill wait, every attempt and backoff)
            shipper = PeerShipper(
                runner_token=os.environ.get("HELIX_RUNNER_TOKEN", ""),
                targets=[{"id": peer_id or peer_addr, "address": peer_addr,
                          "models": [model]}],
                config=XferConfig(
                    attempt_timeout=xfer.attempt_timeout,
                    max_attempts=xfer.max_attempts,
                    backoff_base=xfer.backoff_base,
                    backoff_cap=xfer.backoff_cap,
                    deadline=max(0.0, deadline - time.monotonic())),
                prefill=True)
            peer, ship_err = None, ""
            t_ship = time.monotonic()
            try:
                peer = shipper(wire)
            except Exception as e:  # noqa: BLE001 — degrade to local serving
                ship_err = str(e)
            traces.record(tid, "disagg ship", t_ship, time.monotonic(),
                          plane="runner", request_id=req.id,
                          peer=peer or peer_id or peer_addr,
                          outcome="confirmed" if peer is not None
                          else "failed")
            if peer is not None:
                # confirmed: tear the local request down and hand the
                # stream to the control plane's resume
                loop.abort(req.id)
                now = time.monotonic()
                traces.record(tid, "disagg migrated frame", now, now,
                              plane="runner", request_id=req.id, peer=peer)
                err = {"message": migrated_error(req.id, peer),
                       "code": MIGRATED, "request_id": req.id}
                if tid:
                    err["trace_id"] = tid
                self._start_sse()
                self._sse({"error": err})
                self._sse("[DONE]")
                return
            log.warning("disagg ship for request %s to %s failed (%s): "
                        "serving locally", req.id, peer_id or peer_addr,
                        ship_err[:200])
        if peer_addr and outcome != "completed":
            # a fallback rung: name it, so the timeline says why the
            # decode peer never appears
            now = time.monotonic()
            traces.record(tid, "disagg fallback rung", now, now,
                          plane="runner", request_id=req.id,
                          rung=("ship_failed" if outcome == "snapshot"
                                else "prefill_local"))

        def next_event(timeout):
            while not buffered:
                item = q.get(timeout=timeout)
                if item[0] == "ev":   # a late export sentinel is moot
                    return item[1]
            return buffered.pop(0)

        self._stream(self.api.token_stream(served, req, sampling,
                                           next_event),
                     rid, created, model, obj, chat)

    def _shed(self, served, prompt_ids, tid: str, tenant: str) -> bool:
        """Answer a request the loop would shed (429 / 503) before any
        response header: a stream must not answer 200 and then fail
        in-band.  True when it was answered."""
        err = served.loop.check_admission(len(prompt_ids), count_shed=True,
                                          tenant=tenant, trace_id=tid)
        if err is None:
            return False
        self._engine_error_reply(EngineRequestError(err), tid)
        return True

    def _engine_error_reply(self, e: EngineRequestError, tid: str) -> None:
        status, body, headers = _engine_error(e)
        body["error"]["trace_id"] = tid
        self._json(status, body, {**headers, TRACE_HEADER: tid})

    def _stream(self, gen, rid, created, model, obj, chat):
        self._start_sse()
        first = True
        try:
            for delta, _tok, finished, reason in gen:
                if chat:
                    d = {}
                    if first:
                        d["role"] = "assistant"
                        first = False
                    if delta:
                        d["content"] = delta
                    choice = {"index": 0, "delta": d,
                              "finish_reason": reason if finished else None}
                else:
                    choice = {"index": 0, "text": delta,
                              "finish_reason": reason if finished else None}
                self._sse({"id": rid, "object": obj + ".chunk" if chat
                           else obj, "created": created, "model": model,
                           "choices": [choice]})
                if finished:
                    break
        except EngineRequestError as e:
            frame = _error_body(str(e), request_id=e.request_id)
            if str(e).startswith(MIGRATED):
                # the control plane resumes the stream on the named peer
                frame["error"]["code"] = MIGRATED
            self._sse(frame)
        finally:
            gen.close()
        self._sse("[DONE]")

    def _messages(self, body: dict):
        """The Anthropic Messages surface over the same engine path as
        chat (the reference's ``anthropic_messages``)."""
        served, adapter = self._served_generation(body)
        model = body.get("model", "")
        if served is None or self._require_loop(served, model):
            return
        messages = list(body.get("messages", []))
        if body.get("system"):
            messages = [{"role": "system", "content": body["system"]}] \
                + messages
        try:
            sampling = SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", 0)),
                max_tokens=int(body.get("max_tokens", 256)),
                stop=tuple(body.get("stop_sequences", []) or []),
            )
        except (TypeError, ValueError) as e:
            self._error(400, f"invalid sampling parameters: {e}")
            return
        tid, tenant = self._trace_id(), self._tenant()
        prompt_ids = served.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True)
        if self._shed(served, prompt_ids, tid, tenant):
            return
        rid = f"msg_{uuid.uuid4().hex[:20]}"
        gen = self.api.generate(served, prompt_ids, sampling, adapter,
                                tenant=tenant, sched_class=self._sched_class(),
                                trace_id=tid)
        n, stop_reason, parts = 0, "end_turn", []
        if not body.get("stream"):
            try:
                for delta, _tok, finished, reason in gen:
                    parts.append(delta)
                    n += 1
                    if finished:
                        stop_reason = ("max_tokens" if reason == "length"
                                       else "end_turn")
                        break
            except EngineRequestError as e:
                self._engine_error_reply(e, tid)
                return
            self._json(200, {
                "id": rid, "type": "message", "role": "assistant",
                "model": model,
                "content": [{"type": "text", "text": "".join(parts)}],
                "stop_reason": stop_reason,
                "usage": {"input_tokens": len(prompt_ids),
                          "output_tokens": n},
            }, {TRACE_HEADER: tid})
            return

        def ev(name, obj):
            self.wfile.write(
                f"event: {name}\ndata: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header(TRACE_HEADER, tid)
        self.end_headers()
        ev("message_start", {"type": "message_start", "message": {
            "id": rid, "type": "message", "role": "assistant",
            "model": model, "content": [],
            "usage": {"input_tokens": len(prompt_ids), "output_tokens": 0}}})
        ev("content_block_start", {"type": "content_block_start", "index": 0,
                                   "content_block": {"type": "text",
                                                     "text": ""}})
        try:
            for delta, _tok, finished, reason in gen:
                n += 1
                if delta:
                    ev("content_block_delta", {
                        "type": "content_block_delta", "index": 0,
                        "delta": {"type": "text_delta", "text": delta}})
                if finished:
                    stop_reason = ("max_tokens" if reason == "length"
                                   else "end_turn")
                    break
        except EngineRequestError as e:
            err_frame = {"message": str(e), "trace_id": tid}
            if e.request_id:
                err_frame["request_id"] = e.request_id
            ev("error", {"type": "error", "error": err_frame})
        finally:
            gen.close()
        ev("content_block_stop", {"type": "content_block_stop", "index": 0})
        ev("message_delta", {"type": "message_delta",
                             "delta": {"stop_reason": stop_reason},
                             "usage": {"output_tokens": n}})
        ev("message_stop", {"type": "message_stop"})

    def _embeddings(self, body: dict):
        """Text embeddings (the reference's ``embeddings``, key for key):
        each input encoded once (no special tokens), embedded in chunks
        of the runner's ``max_batch``, ``usage`` the untruncated token
        count."""
        model = body.get("model", "")
        served = self._lookup(model)
        if served is None:
            return
        if served.kind not in ("embedding", "vision-embedding"):
            self._error(404, f"'{model}' is not an embedding model",
                        "model_not_found")
            return
        inputs = body.get("input", [])
        if isinstance(inputs, (str, dict)):
            inputs = [inputs]
        bad = [x for x in inputs if isinstance(x, dict) and "image" not in x]
        if bad:
            self._error(400, "dict inputs must be {\"image\": <url/base64>}; "
                        f"got keys {sorted(bad[0])}")
            return
        has_images = any(isinstance(x, dict) for x in inputs)
        if has_images and served.kind != "vision-embedding":
            self._error(400, f"'{model}' cannot embed images; serve a "
                        "vision-embedding model")
            return
        if served.kind == "vision-embedding":
            self._vision_embeddings(served, model, inputs, has_images)
            return
        try:
            ids = [served.tokenizer.encode(t) for t in inputs]
            vectors = served.embedder.embed_tokens(ids)
        except Exception as e:  # noqa: BLE001 — answered 500, as aiohttp
            log.exception("embedding request for %r failed", model)
            self._error(500, f"embedding failed: {type(e).__name__}: {e}",
                        "server_error")
            return
        n = sum(len(t) for t in ids)
        self._json(200, {
            "object": "list", "model": model,
            "data": [{"object": "embedding", "index": i,
                      "embedding": list(map(float, v))}
                     for i, v in enumerate(vectors)],
            "usage": {"prompt_tokens": n, "total_tokens": n},
        })

    def _vision_embeddings(self, served, model: str, inputs: list,
                           has_images: bool) -> None:
        """A vision-embedding model's ``/v1/embeddings`` (the reference's:
        text only through ``embed_texts``, with images ``embed_mixed`` in
        order; ``usage`` counts the text inputs' tokens).  A failure
        answers 500, as the reference's unhandled error does."""
        runner = served.embedder
        try:
            vectors = (runner.embed_mixed(inputs) if has_images
                       else runner.embed_texts(inputs))
        except Exception as e:  # noqa: BLE001 — answered 500, as aiohttp
            log.exception("embedding request for %r failed", model)
            self._error(500, f"embedding failed: {type(e).__name__}: {e}",
                        "server_error")
            return
        n = sum(len(served.tokenizer.encode(t)) for t in inputs
                if isinstance(t, str))
        self._json(200, {
            "object": "list", "model": model,
            "data": [{"object": "embedding", "index": i,
                      "embedding": list(map(float, v))}
                     for i, v in enumerate(vectors)],
            "usage": {"prompt_tokens": n, "total_tokens": n},
        })

    def _profiler(self, body: dict):
        """One ``torch.profiler`` capture of ``seconds`` (0.01-60) of the
        live node: the host's operators and, on the card, every CUDA
        kernel, written as ``trace.json`` (Chrome trace) into a fresh
        directory under ``HELIX_PROFILER_DIR`` (else the temp dir); the
        client never picks the path.  Runner-token gated; 409 while a
        capture runs."""
        if self._runner_token_denied():
            return
        try:
            seconds = min(max(float(body.get("seconds", 2.0)), 0.01), 60.0)
        except (TypeError, ValueError):
            self._error(400, "'seconds' must be a number")
            return
        if not self.api._profiler_lock.acquire(blocking=False):
            self._error(409, "a profiler capture is already running",
                        "overloaded_error")
            return
        try:
            import tempfile

            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            base = os.environ.get("HELIX_PROFILER_DIR") or None
            d = tempfile.mkdtemp(prefix="helix-torch-profile-", dir=base)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            try:
                time.sleep(seconds)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception as e:  # noqa: BLE001 — profiler not available
            self._error(501, f"torch profiler capture failed: {e}")
            return
        finally:
            self.api._profiler_lock.release()
        self._json(200, {"log_dir": d, "seconds": seconds})

    def _prefetch(self, body: dict):
        """Stage a model's weights in the background ahead of traffic."""
        name = body.get("model", "")
        mgr = self.api.residency_manager()
        if mgr is None:
            self._error(
                409, "no residency manager: profile has no residency block")
            return
        if name not in mgr.names():
            self._error(404, f"unknown model {name!r}")
            return
        started = bool(mgr.prefetch(name))
        self._json(200, {"model": name,
                         "prefetch": "started" if started else "declined"})

    def _publish_adapter(self, body: dict):
        """Publish a LoRA checkpoint for ``model@name`` serving (the
        reference's ``POST /v1/adapters``, with its checks and codes)."""
        if self._runner_token_denied():
            return
        base = body.get("model", "")
        adapter_id = sanitize_adapter_id(body.get("name", ""))
        ckpt = body.get("checkpoint", "")
        if not adapter_id:
            self._error(400, "'name' must be a bounded [A-Za-z0-9._-] "
                        "adapter id")
            return
        if not ckpt or not isinstance(ckpt, str):
            self._error(400, "'checkpoint' directory is required")
            return
        served = self._lookup(base)
        if served is None:
            return
        store = getattr(getattr(served.loop, "engine", None),
                        "adapter_store", None)
        if store is None:
            self._error(409, f"model '{base}' serves without an adapter "
                        "pool (engine.adapter_pool_slots)")
            return
        scale = body.get("scale")
        try:
            spec = store.publish_checkpoint(
                adapter_id, ckpt, float(scale) if scale is not None else None)
        except NotImplementedError as e:
            self._error(501, str(e), "not_implemented_error")
            return
        except FileNotFoundError as e:
            self._error(404, str(e))
            return
        except (ValueError, TypeError, KeyError) as e:
            self._error(400, f"adapter rejected: {e}")
            return
        self._json(200, {"id": f"{base}{ADAPTER_SEP}{adapter_id}",
                         "object": "model", "parent": base,
                         "rank": spec.rank, "scale": spec.scale,
                         "bytes": spec.nbytes})

    # -- migration ----------------------------------------------------------

    def _runner_token_ok(self) -> bool:
        """The caller presents ``HELIX_RUNNER_TOKEN`` (or none is set)."""
        token = os.environ.get("HELIX_RUNNER_TOKEN", "")
        return not token or hmac.compare_digest(
            self.headers.get("X-Runner-Token", ""), token)

    def _runner_token_denied(self) -> bool:
        """Migration, the debug routes and the profiler are
        cluster-internal: with ``HELIX_RUNNER_TOKEN`` set the caller must
        present it (403 otherwise, as in the reference)."""
        if self._runner_token_ok():
            return False
        self._error(403, "requires the runner token")
        return True

    def _migrate_import(self, body: dict):
        """Accept one request snapshot from a peer runner.  It is
        decoded here and re-admitted on the engine thread, where every
        page checksum is verified before any allocator change; a refused
        snapshot answers 422 with its typed code.  The request parks
        until it has a slot and pages, and its events buffer until
        ``/v1/migrate/resume`` attaches."""
        if self._runner_token_denied():
            return
        self.api.sweep_imports()
        try:
            snap = wire_to_snapshot(body)
        except SnapshotError as e:
            self._error(422, str(e), code=e.code)
            return
        hdr = self.headers.get(TRACE_HEADER)
        trace_id = hdr if is_trace_id(hdr) else (
            snap.trace_id if is_trace_id(snap.trace_id) else "")
        served = self._served({"model": snap.model})
        if served is None or self._require_loop(served, snap.model):
            return
        stream = ImportedStream(
            snap.request_id, snap.model, snap.output_tokens,
            stop=tuple(snap.sampling.get("stop") or ()), trace_id=trace_id)
        if not self.api.imported.register(stream):
            self._json(429, _error_body(
                "too many unclaimed imported requests", "overloaded_error"),
                {"Retry-After": "2"})
            return
        done = threading.Event()
        result = {}

        def on_result(err, code):
            result.update(err=err, code=code)
            done.set()

        served.loop.submit_import(snap, stream.on_event, on_result=on_result)
        if not done.wait(migration_timeout()):
            # the source counts a 504 as a failed ship and may ship
            # elsewhere: no orphan may keep generating here
            self.api.imported.discard(snap.request_id)
            served.loop.abort(snap.request_id)
            self._error(504, "import was not admitted in time",
                        "timeout_error")
            return
        if result["err"] is not None:
            self.api.imported.discard(snap.request_id)
            code = result["code"] or "snapshot_invalid"
            self._error(503 if code == "shutting_down" else 422,
                        result["err"], code=code)
            return
        self._json(200, {"ok": True, "request_id": snap.request_id,
                         "model": snap.model,
                         "prior_tokens": len(snap.output_tokens)})

    def _migrate_resume(self, body: dict):
        """Attach a client stream to a migrated-in request: neutral SSE
        frames ``{"request_id", "delta", "finish_reason"}``, first the
        catch-up text the source emitted past ``emitted_chars`` (what the
        client already has), then live deltas.  The snapshot's prior
        tokens seed the detokenizer, so the character arithmetic is
        exact: every token reaches the client once."""
        if self._runner_token_denied():
            return
        self.api.sweep_imports()
        rid = str(body.get("request_id", ""))
        try:
            emitted_chars = max(0, int(body.get("emitted_chars", 0) or 0))
        except (TypeError, ValueError):
            self._error(400, "'emitted_chars' must be an integer")
            return
        stream = self.api.imported.get(rid)
        if stream is None:
            self._error(404, f"no imported request {rid!r} awaiting resume")
            return
        served = self._served({"model": stream.model})
        if served is None:
            return
        q: "queue.Queue" = queue.Queue()
        if not stream.attach(q.put):
            self._error(409, f"request {rid!r} was already resumed")
            return
        self.api.imported.discard(rid)
        eos = served.tokenizer.eos_ids
        detok = IncrementalDetokenizer(served.tokenizer)
        full = "".join(detok.push(t) for t in stream.prior_tokens
                       if t not in eos)
        sent = min(emitted_chars, len(full))

        def stop_hit(scan_from: int):
            """Earliest stop-string index at or after ``scan_from`` (a
            stop may span the migration point)."""
            hits = [full.find(s, max(0, scan_from - len(s)))
                    for s in stream.stop]
            hits = [h for h in hits if h >= 0]
            return min(hits) if hits else None

        def send(delta, finish=None, **extra):
            self._sse({"request_id": rid, "delta": delta,
                       "finish_reason": finish, **extra})

        finished = False
        self._start_sse()
        try:
            hit = stop_hit(0)
            if hit is not None:
                finished = True
                served.loop.abort(rid)
                send(full[sent:hit], "stop")
            elif len(full) > sent:
                send(full[sent:], catchup=True)
                sent = len(full)
            while not finished:
                try:
                    ev = q.get(timeout=self.api.inter_token_timeout)
                except queue.Empty:
                    self._sse({"request_id": rid, "error": {
                        "message": "inter_token_timeout on resumed "
                                   "stream"}})
                    break
                if ev.error:
                    finished = True
                    self._sse({"request_id": rid,
                               "error": {"message": ev.error}})
                    break
                prev = len(full)
                full += "" if ev.token_id in eos else detok.push(ev.token_id)
                hit = stop_hit(prev)
                if hit is not None:
                    finished = True
                    served.loop.abort(rid)
                    send(full[min(sent, hit):hit], "stop")
                    break
                send(full[sent:], ev.finish_reason if ev.finished else None)
                sent = len(full)
                finished = ev.finished
            self._sse("[DONE]")
        finally:
            if not finished:
                served.loop.abort(rid)
