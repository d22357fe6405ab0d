"""Lightweight in-process request tracing for the runner.

The runner-side half of ``helix_tpu/obs/trace.py``, the port's own copy
(standard library only).  A trace id arrives in the ``X-Helix-Trace-Id``
header (adopted when it is shaped like one, minted otherwise) and rides
the request into the engine loop, which records its queue, prefill,
decode and quarantine spans here.  Spans land in a bounded ring-buffer
:class:`TraceStore`; ``/v1/debug/traces/{id}`` serves them as JSON or
Chrome ``trace_event`` format (load in ``chrome://tracing`` / Perfetto).
Recording is a no-op for requests without a trace id, so the engine
path pays one truthiness check when tracing is unused.

Federation, runner side: with ``HELIX_TRACE_FEDERATION`` on (the
default) the node agent turns on the store's export ring, and each
heartbeat carries up to ``HELIX_TRACE_EXPORT_BATCH`` completed spans in
the reference's wire shape (``span_to_wire``) to the control plane, which
stitches them per trace.  The ring holds ``HELIX_TRACE_BUFFER`` spans; an
overflow drops the oldest unsent span and counts it in
``helix_trace_dropped_spans_total``.
"""

from __future__ import annotations

import collections
import os
import re
import threading
import time
import uuid
from typing import Optional

TRACE_HEADER = "X-Helix-Trace-Id"

# what an adoptable trace id looks like (uuid hex + room for external
# id schemes); anything else from a client header is replaced, never
# stored or echoed verbatim
_TRACE_ID_RE = re.compile(r"[A-Za-z0-9_-]{8,64}")

# monotonic -> wall anchor, fixed at import: spans are recorded on the
# monotonic clock (immune to NTP steps) and converted for display
_MONO0 = time.monotonic()
_WALL0 = time.time()

# stable Chrome-trace pids per plane so cross-plane spans of one request
# line up as separate process tracks
_PLANE_PIDS = {"control": 1, "runner": 2, "engine": 3}


# -- federation knobs: the export rides the heartbeat, so its cadence is
# the node agent's heartbeat interval


def federation_enabled() -> bool:
    """``HELIX_TRACE_FEDERATION``: runners push completed spans to the
    control plane inside the heartbeat (default on)."""
    return os.environ.get("HELIX_TRACE_FEDERATION", "1").lower() not in (
        "0", "false", "off", ""
    )


def _int_env(name: str, default: int, lo: int, hi: int) -> int:
    try:
        return max(lo, min(int(os.environ.get(name, default)), hi))
    except (TypeError, ValueError):
        return default


def export_batch() -> int:
    """``HELIX_TRACE_EXPORT_BATCH``: most spans per heartbeat push."""
    return _int_env("HELIX_TRACE_EXPORT_BATCH", 256, 1, 4096)


def export_buffer() -> int:
    """``HELIX_TRACE_BUFFER``: the pending-export ring's size."""
    return _int_env("HELIX_TRACE_BUFFER", 2048, 16, 65536)


def mono_to_wall(mono: float) -> float:
    return _WALL0 + (mono - _MONO0)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def is_trace_id(value) -> bool:
    """Whether ``value`` is shaped like an adoptable trace id (the
    header/regex contract) — for callers that FORWARD an id and must
    not fabricate one when it is missing or garbage."""
    return isinstance(value, str) and bool(_TRACE_ID_RE.fullmatch(value))


def adopt_trace_id(value: Optional[str]) -> str:
    """Adopt a caller-supplied trace id if it is shaped like one, else
    mint fresh — multi-KB garbage header values must not become store
    keys or ride back in response headers."""
    if value and _TRACE_ID_RE.fullmatch(value):
        return value
    return new_trace_id()


class Span:
    __slots__ = ("trace_id", "name", "plane", "start", "end", "attrs")

    def __init__(self, trace_id: str, name: str, plane: str,
                 start: float, end: float, attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.name = name
        self.plane = plane
        self.start = start
        self.end = end
        self.attrs = attrs or {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "plane": self.plane,
            "start_unix": mono_to_wall(self.start),
            "duration_ms": (self.end - self.start) * 1000.0,
            "attrs": self.attrs,
        }


class TraceStore:
    """Bounded in-memory trace storage: an LRU ring of traces, each a
    capped span list.  Thread-safe — spans arrive from the event loop,
    the engine thread and executor threads concurrently."""

    def __init__(self, max_traces: int = 512,
                 max_spans_per_trace: int = 256):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        # trace_id -> [spans list, dropped count]
        self._traces: "collections.OrderedDict[str, list]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.dropped_spans = 0   # spans lost to the per-trace cap (global)
        # pending-export ring (federation): None until enable_export(); a
        # bounded deque, so a dead heartbeat loop cannot grow memory
        self._export: Optional[collections.deque] = None
        self.export_dropped = 0  # spans lost to export-ring overflow

    def enable_export(self, cap: Optional[int] = None) -> None:
        """Start buffering completed spans for the heartbeat.  Spans
        recorded before this call are not exported."""
        with self._lock:
            if self._export is None:
                self._export = collections.deque(
                    maxlen=cap or export_buffer()
                )

    def drain_export(self, limit: Optional[int] = None) -> list:
        """Pop up to ``limit`` pending wire spans (oldest first) for the
        next heartbeat; ``[]`` when export is off."""
        n = limit if limit is not None else export_batch()
        out: list = []
        with self._lock:
            if self._export is None:
                return out
            while self._export and len(out) < n:
                out.append(self._export.popleft())
        return out

    def record(self, trace_id: str, name: str, start: float, end: float,
               plane: str = "", **attrs) -> None:
        """Record one completed span.  No-op without a trace id, so
        callers can pass ``req.trace_id`` unconditionally."""
        if not trace_id:
            return
        span = Span(trace_id, name, plane, start, end, attrs)
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = self._traces[trace_id] = [[], 0]
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace_id)
            if len(entry[0]) >= self.max_spans_per_trace:
                # ring: drop the OLDEST span so a flooded trace keeps
                # its most recent activity (the part being debugged)
                entry[0].pop(0)
                self.dropped_spans += 1
                entry[1] += 1
            entry[0].append(span)
            if self._export is not None:
                if len(self._export) == self._export.maxlen:
                    self.export_dropped += 1
                self._export.append(span_to_wire(span))

    def ids(self) -> list:
        with self._lock:
            return list(self._traces)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans, dropped = list(entry[0]), entry[1]
        spans.sort(key=lambda s: s.start)
        doc = {
            "trace_id": trace_id,
            "spans": [s.to_dict() for s in spans],
        }
        if dropped:
            # truncation must be visible in the payload, not silent — a
            # flooded trace otherwise reads as "no decode/emit happened"
            doc["dropped_spans"] = dropped
        return doc

    def chrome_trace(self, trace_id: str) -> Optional[dict]:
        """Chrome ``trace_event`` JSON (complete 'X' events, one pid per
        plane) — load the payload in chrome://tracing or Perfetto."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = list(entry[0])
        spans.sort(key=lambda s: s.start)
        events = []
        seen_planes = set()
        for s in spans:
            pid = _PLANE_PIDS.get(s.plane, 9)
            if s.plane not in seen_planes:
                seen_planes.add(s.plane)
                events.append({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": f"helix:{s.plane or 'other'}"},
                })
            events.append({
                "name": s.name,
                "cat": s.plane or "other",
                "ph": "X",
                "pid": pid,
                "tid": 1,
                "ts": mono_to_wall(s.start) * 1e6,
                "dur": max((s.end - s.start) * 1e6, 1.0),
                "args": {k: str(v) for k, v in s.attrs.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def span_to_wire(span: Span) -> dict:
    """One completed span in the federation wire shape (wall clock)."""
    start = mono_to_wall(span.start)
    return {
        "trace_id": span.trace_id,
        "name": span.name,
        "plane": span.plane,
        "start_unix": start,
        "end_unix": start + max(0.0, span.end - span.start),
        "attrs": {k: str(v) for k, v in span.attrs.items()},
    }


# -- metric minting ----------------------------------------------------
#
# Every helix_trace_* series of the port is minted HERE and only here;
# the serving surface imports this collector.


def collect_trace_metrics(c, store: Optional[TraceStore] = None) -> None:
    """Runner-side trace-loss series (scrape-time collector)."""
    st = store if store is not None else default_store()
    c.counter(
        "helix_trace_dropped_spans_total",
        st.dropped_spans + st.export_dropped,
        help="Spans lost to the per-trace cap or the export ring",
    )


# one process-wide store by default: the runner's HTTP surface and every
# engine loop of the process record into it
_default_store = TraceStore()


def default_store() -> TraceStore:
    return _default_store
