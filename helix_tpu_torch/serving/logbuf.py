"""Runner log ring buffer: the port's copy of
``helix_tpu/serving/logbuf.py`` (standard library only).

A ``logging.Handler`` that keeps the last N records in memory; the node's
``GET /logs?tail=N`` serves the tail, and a control plane proxies it to
its admin surface.  Records carry the ``trace_id`` / ``request_id``
attached to the log record (via ``extra={...}``) when present, so the log
tail correlates with ``/v1/debug/traces``."""

from __future__ import annotations

import collections
import logging
import threading
import time


class RingLogBuffer(logging.Handler):
    def __init__(self, capacity: int = 2000):
        super().__init__()
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # noqa: BLE001 — formatting must never raise
            line = record.getMessage()
        tid = str(getattr(record, "trace_id", "") or "")
        rid = str(getattr(record, "request_id", "") or "")
        with self._lock:
            self.records.append((time.time(), line, tid, rid))

    def push(self, line: str) -> None:
        """Non-logging writes (engine step notes, apply progress)."""
        with self._lock:
            self.records.append((time.time(), line, "", ""))

    def tail(self, n: int = 200) -> list:
        with self._lock:
            items = list(self.records)[-n:]
        out = []
        for ts, line, tid, rid in items:
            d = {"ts": ts, "line": line}
            if tid:
                d["trace_id"] = tid
            if rid:
                d["request_id"] = rid
            out.append(d)
        return out


_global: RingLogBuffer | None = None


def install(capacity: int = 2000) -> RingLogBuffer:
    """Attach one ring buffer to the root logger (idempotent).

    Deliberately does NOT change the root logger's level: the buffer
    captures whatever the deployment's logging config emits, plus
    explicit ``push()`` writes from the serving layer. Flooding other
    handlers with INFO as a construction side effect would be worse than
    a quieter ring."""
    global _global
    if _global is None:
        _global = RingLogBuffer(capacity)
        logging.getLogger().addHandler(_global)
    return _global
