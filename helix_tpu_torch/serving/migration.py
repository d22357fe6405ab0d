"""Cross-runner request migration: the wire format and the shipper.

Port of the wire and transport halves of ``helix_tpu/serving/
migration.py``.  The engine builds and consumes ``RequestSnapshot``s
(``Engine.export_request`` / ``import_request``); this module owns:

- the **wire format**: a JSON-safe document of a snapshot, page buffers
  as base64 with dtype and shape, scalar fields under a meta checksum,
  shipped over ``POST /v1/migrate/import``.  It is the reference's byte
  for byte, so a snapshot crosses between a JAX runner and a torch
  runner in either direction: a bf16 page travels as its raw 2-byte
  words under the dtype string ``"bfloat16"`` and decodes through an
  int16 view, without ``ml_dtypes``;
- the **shipper** (``PeerShipper``): POSTs a wire snapshot to a peer
  runner with per-attempt timeouts, capped exponential backoff and a
  whole-transfer deadline (``urllib``: the card's machine has no
  ``requests``), for the drain and for the disaggregated prefill handoff
  (the ``DISAGG_*`` headers; ``helix_xfer_prefill_handoffs_total``);
- the **imported-stream registry** (``ImportedStreams``): a migrated-in
  request's token events buffer until ``POST /v1/migrate/resume``
  attaches, or its claim times out.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import json
import os
import re
import secrets
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

import numpy as np
import torch

from helix_tpu_torch.engine.adapters import sanitize_adapter_id
from helix_tpu_torch.engine.engine import (
    SNAPSHOT_VERSION,
    RequestSnapshot,
    SnapshotError,
)
from helix_tpu_torch.engine.kv_cache import PAGE_FIELDS, _raw_view
from helix_tpu_torch.obs.trace import TRACE_HEADER, is_trace_id
from helix_tpu_torch.testing import faults

# the migration and transfer series, minted by this module only (the
# reference's names)
MIGRATIONS_EXPORTED = "helix_migrations_exported_total"
MIGRATIONS_IMPORTED = "helix_migrations_imported_total"
MIGRATION_FAILURES = "helix_migration_failures_total"
MIGRATION_DRAIN_STATE = "helix_migration_drain_state"
XFER_ATTEMPTS = "helix_xfer_attempts_total"
XFER_SHIP_SECONDS = "helix_xfer_ship_seconds_total"
XFER_SHIPPED_BYTES = "helix_xfer_shipped_bytes_total"
XFER_DEADLINE_EXCEEDED = "helix_xfer_deadline_exceeded_total"
XFER_PREFILL_HANDOFFS = "helix_xfer_prefill_handoffs_total"


# every way one ship attempt can end
XFER_OUTCOMES = ("ok", "unreachable", "rejected", "http_error", "timeout")


class XferStats:
    """Process-wide snapshot-transfer accounting; shippers increment
    under the lock from their threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.attempts = {o: 0 for o in XFER_OUTCOMES}
        self.ship_seconds = 0.0
        self.shipped_bytes = 0
        self.shipped_pages = 0
        self.deadline_exceeded = 0
        self.prefill_handoffs = 0

    def note_attempt(self, outcome: str, seconds: float = 0.0) -> None:
        with self._lock:
            if outcome not in self.attempts:
                outcome = "http_error"
            self.attempts[outcome] += 1
            self.ship_seconds += max(0.0, seconds)

    def note_shipped(self, wire: dict, prefill: bool = False) -> None:
        with self._lock:
            pages = wire.get("pages") or []
            self.shipped_pages += len(pages)
            self.shipped_bytes += sum(
                len((f or {}).get("b64", ""))
                for p in pages for f in (p or {}).values()
                if isinstance(f, dict)
            )
            if prefill:
                self.prefill_handoffs += 1

    def note_deadline(self) -> None:
        with self._lock:
            self.deadline_exceeded += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "attempts": dict(self.attempts),
                "ship_seconds": self.ship_seconds,
                "shipped_bytes": self.shipped_bytes,
                "shipped_pages": self.shipped_pages,
                "deadline_exceeded": self.deadline_exceeded,
                "prefill_handoffs": self.prefill_handoffs,
            }


XFER_STATS = XferStats()


def collect_xfer(c) -> None:
    """Runner-side KV-transfer series (the OpenAI server's scrape-time
    collector calls it)."""
    snap = XFER_STATS.snapshot()
    for outcome, n in sorted(snap["attempts"].items()):
        c.counter(
            XFER_ATTEMPTS, n, {"outcome": outcome},
            help="KV snapshot ship attempts by outcome",
        )
    c.counter(
        XFER_SHIP_SECONDS, snap["ship_seconds"],
        help="Cumulative wall time spent shipping KV snapshots",
    )
    c.counter(
        XFER_SHIPPED_BYTES, snap["shipped_bytes"],
        help="Wire bytes of successfully shipped KV snapshots",
    )
    c.counter(
        XFER_DEADLINE_EXCEEDED, snap["deadline_exceeded"],
        help="Ships abandoned at the total transfer deadline",
    )
    c.counter(
        XFER_PREFILL_HANDOFFS, snap["prefill_handoffs"],
        help="Disaggregated prefill snapshots shipped to a decode peer",
    )


def collect_runner_migration(c, loop, labels: dict) -> None:
    """Runner-side migration series for one engine loop (plain reads)."""
    eng = loop.engine
    c.counter(
        MIGRATIONS_EXPORTED, eng.num_snapshots_exported, labels,
        help="Request snapshots exported for cross-runner migration",
    )
    c.counter(
        MIGRATIONS_IMPORTED, eng.num_snapshots_imported, labels,
        help="Request snapshots imported from a peer runner",
    )
    c.counter(
        MIGRATION_FAILURES, loop.migration_failures, labels,
        help="Failed exports/ships/imports (request shed instead)",
    )
    c.gauge(
        MIGRATION_DRAIN_STATE, 1 if loop.draining else 0, labels,
        help="1 while this engine loop is draining (shutdown ladder)",
    )

# error-message prefix of a request exported instead of shed; the control
# plane's mid-stream failover reads the peer out of the message
MIGRATED = "migrated"
_PEER_RE = re.compile(r"peer=([A-Za-z0-9._:\-]+)")


def migrated_error(request_id: str, peer_id: str) -> str:
    """The terminal event of a drained-and-shipped request."""
    return f"{MIGRATED}: request {request_id} exported to peer={peer_id}"


def parse_migrated_peer(message: str) -> Optional[str]:
    """The peer runner id of a ``migrated_error`` message, or None."""
    if not message.startswith(MIGRATED):
        return None
    m = _PEER_RE.search(message)
    return m.group(1) if m else None


# the disaggregated handoff's headers: the control plane marks a dispatch
# prefill-only and names the decode peer the snapshot ships to
# (runner-token gated on the runner, like /v1/migrate/*)
DISAGG_HEADER = "X-Helix-Disagg"
DISAGG_PEER_ID_HEADER = "X-Helix-Disagg-Peer"
DISAGG_PEER_ADDR_HEADER = "X-Helix-Disagg-Peer-Addr"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except (TypeError, ValueError):
        return default


def migration_timeout() -> float:
    """HELIX_MIGRATION_TIMEOUT: the ship deadline at export and the TTL
    an imported request waits for its stream to be claimed."""
    return _env_float("HELIX_MIGRATION_TIMEOUT", 30.0)


def drain_seconds() -> float:
    """HELIX_DRAIN_SECONDS: the graceful-shutdown drain window before
    survivors are exported (the node agent's SIGTERM path)."""
    return _env_float("HELIX_DRAIN_SECONDS", 10.0)


class XferConfig:
    """Ship retry discipline: a per-attempt timeout, capped exponential
    backoff between rounds over the targets, and a hard deadline for the
    whole transfer (``HELIX_XFER_*`` env knobs, as the reference)."""

    def __init__(self, attempt_timeout: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 deadline: Optional[float] = None):
        def pick(v, env, default):
            return v if v is not None else _env_float(env, default)

        self.attempt_timeout = pick(attempt_timeout,
                                    "HELIX_XFER_ATTEMPT_TIMEOUT", 10.0)
        self.max_attempts = (
            max_attempts if max_attempts is not None
            else max(1, int(_env_float("HELIX_XFER_MAX_ATTEMPTS", 3)))
        )
        self.backoff_base = pick(backoff_base, "HELIX_XFER_BACKOFF_BASE",
                                 0.1)
        self.backoff_cap = pick(backoff_cap, "HELIX_XFER_BACKOFF_CAP", 2.0)
        self.deadline = pick(deadline, "HELIX_XFER_DEADLINE",
                             migration_timeout())


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

# RequestSnapshot fields under the meta checksum (all but the pages,
# which carry digests of their own)
_META_FIELDS = (
    "version", "model", "request_id", "prompt_tokens", "output_tokens",
    "sampling", "stop_token_ids", "tenant", "trace_id", "sched_class",
    "max_len", "preempt_count", "position", "last_token", "mrope_delta",
    "key", "token_counts", "page_size", "num_layers", "kv_heads",
    "head_dim", "kv_dtype", "page_checksums", "total_pages", "adapter",
)
# wire dtype name -> (numpy type of the raw words, torch view of them)
_WIRE_DTYPES = {
    "float32": (np.float32, torch.float32),
    "float16": (np.float16, torch.float16),
    "bfloat16": (np.int16, torch.bfloat16),
    "int8": (np.int8, torch.int8),
}
_TORCH_NAMES = {t: name for name, (_np, t) in _WIRE_DTYPES.items()}


def _wire_adapter(doc: dict) -> str:
    """The snapshot's adapter id, sanitised at the wire boundary: the id
    becomes a filestore path component once the adapter serves.  A
    present but hostile id refuses the snapshot with the reference's
    error as its caller sees it: the reference raises ``snapshot_invalid``
    inside ``wire_to_snapshot``'s field decoding, whose handler wraps
    every ``ValueError`` as a malformed field."""
    raw = doc.get("adapter", "") or ""
    if not raw:
        return ""
    adapter = sanitize_adapter_id(str(raw))
    if not adapter:
        raise SnapshotError(
            "malformed snapshot field: snapshot adapter id failed "
            "sanitisation", code="snapshot_corrupt",
        )
    return adapter


def _meta_checksum(doc: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    canon = {k: doc.get(k) for k in _META_FIELDS}
    if not canon.get("adapter"):
        # adapter-free snapshots hash as wires from before the key
        canon.pop("adapter", None)
    h.update(json.dumps(canon, sort_keys=True, default=str).encode())
    return h.hexdigest()


class _Buffer(dict):
    """One page buffer's JSON member (``dtype``, ``shape``, ``b64``) with
    the bytes behind its base64 text, valid while ``b64`` is still the
    string ``text`` they came with: ``ascii``, the text's own bytes,
    which ``json_bytes`` writes verbatim (the alphabet needs no JSON
    escape), or ``raw``, the decoded bytes that ``json_loads`` read and
    ``_decode_array`` takes."""

    text = ascii = raw = None

    def current(self) -> bool:
        return self.get("b64") is self.text


def _encode_array(a) -> Optional[dict]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        dtype = _TORCH_NAMES[a.dtype]
    else:
        a = np.ascontiguousarray(a)
        dtype = str(a.dtype)
    b64 = base64.b64encode(_raw_view(a))
    buf = _Buffer(dtype=dtype, shape=[int(d) for d in a.shape],
                  b64=b64.decode("ascii"))
    buf.text, buf.ascii = buf["b64"], b64
    return buf


def json_bytes(doc) -> bytes:
    """``json.dumps(doc).encode()``, byte for byte, with the base64 text
    of page buffers (``_encode_array``'s) written verbatim instead of
    through the encoder's escape scan, which costs more than the base64
    itself on a wire of ~100 MB of pages (one interpreter's lock serves
    every handoff and decode step on a node)."""
    parts: list = []
    _json_parts(doc, parts)
    return b"".join(parts)


def _json_parts(v, out: list) -> None:
    if isinstance(v, dict) and type(v) in (dict, _Buffer) \
            and all(type(k) is str for k in v):
        verbatim = type(v) is _Buffer and v.ascii is not None \
            and v.current()
        out.append(b"{")
        for i, (k, x) in enumerate(v.items()):
            out += (b", " if i else b"", json.dumps(k).encode(), b": ")
            if verbatim and k == "b64":
                out += (b'"', v.ascii, b'"')
            else:
                _json_parts(x, out)
        out.append(b"}")
    elif type(v) in (list, tuple) and any(
            type(x) in (dict, _Buffer, list, tuple) for x in v):
        out.append(b"[")
        for i, x in enumerate(v):
            if i:
                out.append(b", ")
            _json_parts(x, out)
        out.append(b"]")
    else:
        out.append(json.dumps(v).encode())


_B64_MEMBER = b'"b64": "'


def json_loads(data: bytes):
    """``json.loads(data)``, with the base64 text of every page buffer (a
    ``"b64": "..."`` member, as ``json_bytes`` writes it) cut out before
    the parse and decoded, so the parser's string scan never runs over
    the ~100 MB of pages.  Each such member's object comes back as a
    ``_Buffer`` equal to the parser's, holding the decoded bytes.  The
    whole document goes through ``json.loads`` instead when a cut text is
    not plain base64 (the decoded length proves every character but the
    trailing padding was of the alphabet, so the parser would have read
    the same string) or a cut is not a whole ``b64`` string member."""
    nonce = "\x00" + secrets.token_hex(8) + ":"
    view = memoryview(data)
    cuts, skeleton, pos = [], [], 0
    while True:
        i = data.find(_B64_MEMBER, pos)
        if i < 0:
            break
        start = i + len(_B64_MEMBER)
        end = data.find(b'"', start)
        if end < 0:
            return json.loads(data)
        tail = data[max(start, end - 2):end]
        pad = len(tail) - len(tail.rstrip(b"="))
        try:
            raw = binascii.a2b_base64(view[start:end])
        except (binascii.Error, ValueError):
            return json.loads(data)
        if (end - start) % 4 or len(raw) != (end - start) // 4 * 3 - pad:
            return json.loads(data)
        skeleton += (view[pos:start],
                     json.dumps(nonce + str(len(cuts)))[1:-1].encode())
        cuts.append((start, end, raw))
        pos = end
    if not cuts:
        return json.loads(data)
    skeleton.append(view[pos:])
    doc = json.loads(b"".join(skeleton))
    # each cut must read back as the whole ``b64`` member of an object:
    # every index once (an unguessable nonce, so no text forges one)
    sites, stack = [], [(None, None, doc)]
    while stack:
        parent, key, v = stack.pop()
        if isinstance(v, (dict, list)):
            stack += ((v, k, x) for k, x in (
                v.items() if isinstance(v, dict) else enumerate(v)))
        tag = v.get("b64") if isinstance(v, dict) else None
        if isinstance(tag, str) and tag.startswith(nonce):
            sites.append((parent, key, v, tag[len(nonce):]))
    if sorted(int(t) if t.isdigit() else -1
              for *_pkv, t in sites) != list(range(len(cuts))):
        return json.loads(data)
    for parent, key, v, t in reversed(sites):   # inner members first
        start, end, raw = cuts[int(t)]
        buf = _Buffer(v)
        buf["b64"] = buf.text = str(view[start:end], "ascii")
        buf.raw = raw
        if parent is None:
            doc = buf
        else:
            parent[key] = buf
    return doc


def _decode_array(doc) -> Optional[torch.Tensor]:
    if doc is None:
        return None
    try:
        np_type, view = _WIRE_DTYPES[doc["dtype"]]
        raw = doc.raw if type(doc) is _Buffer and doc.current() else None
        if raw is None:
            raw = base64.b64decode(doc["b64"])
        a = np.frombuffer(raw, dtype=np_type)
        a = a.reshape([int(d) for d in doc["shape"]]).copy()
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotError(f"undecodable page buffer: {e!r}",
                            code="snapshot_corrupt") from e
    return torch.from_numpy(a).view(view)


def snapshot_to_wire(snap: RequestSnapshot) -> dict:
    """The JSON-safe document of a snapshot: scalar fields verbatim (in
    the dataclass's field order, as ``dataclasses.asdict`` gives them),
    page buffers as base64 with dtype and shape, and a meta checksum."""
    doc = {f.name: getattr(snap, f.name)
           for f in dataclasses.fields(RequestSnapshot)}
    doc["sampling"] = dict(snap.sampling)
    doc["token_counts"] = {str(k): int(v)
                           for k, v in snap.token_counts.items()}
    doc["pages"] = [{f: _encode_array(p.get(f)) for f in PAGE_FIELDS}
                    for p in snap.pages]
    doc["meta_checksum"] = _meta_checksum(doc)
    return doc


def wire_to_snapshot(doc: dict) -> RequestSnapshot:
    """Decode and structurally validate one wire document.  Raises
    ``SnapshotError`` on version, shape or meta-checksum problems; page
    checksums are verified by the engine, before any mutation."""
    if not isinstance(doc, dict):
        raise SnapshotError("snapshot body must be a JSON object")
    version = doc.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot version {version!r} != supported {SNAPSHOT_VERSION}",
            code="snapshot_unsupported")
    claimed = doc.get("meta_checksum")
    if not claimed or _meta_checksum(doc) != claimed:
        raise SnapshotError("snapshot meta checksum mismatch",
                            code="snapshot_corrupt")
    counts_doc = doc.get("token_counts") or {}
    if not isinstance(counts_doc, dict):
        raise SnapshotError("token_counts must be an object",
                            code="snapshot_corrupt")

    def opt_int(name):
        return int(doc[name]) if doc.get(name) is not None else None

    try:
        token_counts = {int(k): int(v) for k, v in counts_doc.items()}
        pages = [{f: _decode_array((p or {}).get(f)) for f in PAGE_FIELDS}
                 for p in doc.get("pages") or []]
        return RequestSnapshot(
            version=int(version),
            model=str(doc.get("model", "")),
            request_id=str(doc.get("request_id", "")),
            prompt_tokens=[int(t) for t in doc.get("prompt_tokens", [])],
            output_tokens=[int(t) for t in doc.get("output_tokens", [])],
            sampling=dict(doc.get("sampling") or {}),
            stop_token_ids=[int(t) for t in doc.get("stop_token_ids", [])],
            tenant=str(doc.get("tenant", "")),
            trace_id=str(doc.get("trace_id", "")),
            sched_class=str(doc.get("sched_class", "")),
            max_len=opt_int("max_len"),
            preempt_count=int(doc.get("preempt_count", 0)),
            position=opt_int("position"),
            last_token=opt_int("last_token"),
            mrope_delta=int(doc.get("mrope_delta", 0)),
            key=([int(w) for w in doc["key"]]
                 if doc.get("key") is not None else None),
            token_counts=token_counts,
            page_size=int(doc.get("page_size", 0)),
            num_layers=int(doc.get("num_layers", 0)),
            kv_heads=int(doc.get("kv_heads", 0)),
            head_dim=int(doc.get("head_dim", 0)),
            kv_dtype=str(doc.get("kv_dtype", "")),
            pages=pages,
            page_checksums=[str(s) for s in doc.get("page_checksums", [])],
            total_pages=int(doc.get("total_pages", 0) or 0),
            adapter=_wire_adapter(doc),
        )
    except (TypeError, ValueError) as e:
        if isinstance(e, SnapshotError):
            raise
        raise SnapshotError(f"malformed snapshot field: {e}",
                            code="snapshot_corrupt") from e


# ---------------------------------------------------------------------------
# imported-stream registry (runner side)
# ---------------------------------------------------------------------------


class ImportedStream:
    """Token-event buffer of one migrated-in request: the peer engine
    resumes it as soon as it has room, usually before the resume call
    lands, so events buffer until exactly one consumer attaches.  The
    engine thread calls ``on_event``; an HTTP handler thread calls
    ``attach``."""

    def __init__(self, request_id: str, model: str, prior_tokens: list,
                 stop: tuple = (), trace_id: str = ""):
        self.request_id = request_id
        self.model = model
        self.prior_tokens = list(prior_tokens)
        self.trace_id = trace_id
        # serving-level stop strings travel with the snapshot
        self.stop = tuple(s for s in (stop or ()) if s)
        self.created = time.monotonic()
        self._lock = threading.Lock()
        self._backlog: list = []
        self._consumer: Optional[Callable] = None
        self.claimed = False

    def on_event(self, ev) -> None:
        with self._lock:
            if self._consumer is not None:
                self._consumer(ev)
            else:
                self._backlog.append(ev)

    def attach(self, put: Callable) -> bool:
        """Claim the stream (once): the backlog goes to ``put`` first,
        later events follow live.  False: already claimed."""
        with self._lock:
            if self.claimed:
                return False
            self.claimed = True
            for ev in self._backlog:
                put(ev)
            self._backlog = []
            self._consumer = put
            return True


class ImportedStreams:
    """Bounded registry of migrated-in requests awaiting their stream;
    ``sweep`` returns (and removes) unclaimed entries past the TTL so the
    caller can abort them."""

    def __init__(self, max_entries: int = 256):
        self._lock = threading.Lock()
        self._entries: dict[str, ImportedStream] = {}
        self.max_entries = max_entries

    def register(self, stream: ImportedStream) -> bool:
        with self._lock:
            if len(self._entries) >= self.max_entries:
                return False
            self._entries[stream.request_id] = stream
            return True

    def get(self, request_id: str) -> Optional[ImportedStream]:
        with self._lock:
            return self._entries.get(request_id)

    def discard(self, request_id: str) -> None:
        with self._lock:
            self._entries.pop(request_id, None)

    def sweep(self, ttl: Optional[float] = None) -> list:
        if ttl is None:
            ttl = migration_timeout()
        now = time.monotonic()
        with self._lock:
            dead = [s for s in self._entries.values()
                    if not s.claimed and now - s.created > ttl]
            for s in dead:
                del self._entries[s.request_id]
            return dead


# ---------------------------------------------------------------------------
# drain shipper
# ---------------------------------------------------------------------------


class _Response:
    def __init__(self, status_code: int, body: bytes = b""):
        self.status_code = status_code
        self.body = body


def http_post(url: str, json=None, headers: Optional[dict] = None,
              timeout: float = 10.0) -> _Response:
    """POST a JSON body with ``urllib``; any HTTP status is a response
    (the ``requests.post`` contract ``PeerShipper`` was written to)."""
    data = json_bytes(json)
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return _Response(r.status, r.read())
    except urllib.error.HTTPError as e:
        return _Response(e.code, e.read())



def _flip_wire_page(wire: dict, page_idx: int) -> dict:
    """``wire`` with one byte flipped in page ``page_idx``'s k buffer
    (the ``transfer`` fault's corrupt mode)."""
    pages = list(wire.get("pages") or [])
    if not pages:
        return wire
    i = max(0, min(page_idx, len(pages) - 1))
    page = dict(pages[i])
    k = dict(page.get("k") or {})
    raw = bytearray(base64.b64decode(k.get("b64", "") or "AA=="))
    raw[0] ^= 0xFF
    k["b64"] = base64.b64encode(bytes(raw)).decode("ascii")
    page["k"] = k
    pages[i] = page
    return {**wire, "pages": pages}


class PeerShipper:
    """Ships wire snapshots to a peer runner (the drain ladder, and with
    ``prefill=True`` the disaggregated prefill handoff, counted in
    ``prefill_handoffs``).

    Targets are given (``targets=[{"id", "address", "models"}]``) or
    fetched once from the control plane's migration-targets endpoint.
    The call contract is ``EngineLoop.exporter``'s: given a wire dict,
    return the id of the peer that accepted it, raise on failure.
    ``post`` / ``clock`` / ``sleep`` are injectable for tests."""

    def __init__(self, control_plane_url: str = "", runner_id: str = "",
                 runner_token: str = "", targets: Optional[list] = None,
                 timeout: Optional[float] = None,
                 config: Optional[XferConfig] = None,
                 post=None, clock=time.monotonic, sleep=time.sleep,
                 stats: Optional[XferStats] = None, prefill: bool = False):
        self.control_plane_url = control_plane_url.rstrip("/")
        self.runner_id = runner_id
        self.runner_token = runner_token
        self._targets = targets
        self.config = config if config is not None else XferConfig(
            attempt_timeout=timeout)
        self.timeout = self.config.attempt_timeout
        self._post = post if post is not None else http_post
        self._clock = clock
        self._sleep = sleep
        self.stats = stats if stats is not None else XFER_STATS
        self.prefill = prefill

    def _headers(self) -> dict:
        return ({"X-Runner-Token": self.runner_token}
                if self.runner_token else {})

    def _ship_headers(self, wire: dict) -> dict:
        """The runner token plus the request's trace id, when it is
        shaped like one (never fabricated)."""
        h = self._headers()
        tid = wire.get("trace_id")
        if is_trace_id(tid):
            h[TRACE_HEADER] = tid
        return h

    def targets(self) -> list:
        if self._targets is not None:
            return self._targets
        req = urllib.request.Request(
            f"{self.control_plane_url}/api/v1/runners/{self.runner_id}/"
            "migration-targets", headers=self._headers())
        with urllib.request.urlopen(req,
                                    timeout=min(self.timeout, 10.0)) as r:
            doc = json.loads(r.read() or b"{}")
        self._targets = [t for t in doc.get("targets", [])
                         if t.get("address")]
        return self._targets

    def __call__(self, wire: dict) -> str:
        cfg = self.config
        model = wire.get("model", "")
        deadline = self._clock() + cfg.deadline
        last_err = "no migration target"
        candidates = [t for t in self.targets()
                      if not model or model in (t.get("models") or [model])]
        if not candidates:
            raise RuntimeError(f"snapshot ship failed: {last_err}")

        def past_deadline():
            self.stats.note_deadline()
            return RuntimeError(
                f"snapshot ship failed: transfer deadline "
                f"({cfg.deadline:.1f}s) exceeded; last error: {last_err}")

        for attempt in range(cfg.max_attempts):
            for t in candidates:
                peer_id = t.get("id", t.get("address", ""))
                remaining = deadline - self._clock()
                if remaining <= 0:
                    raise past_deadline()
                body = wire
                inj = faults.active()
                fault = inj.transfer_fault(peer_id) if inj else None
                if fault is not None:
                    if fault["mode"] == "slow":
                        self._sleep(fault["delay"])
                    elif fault["mode"] == "corrupt":
                        body = _flip_wire_page(wire, fault["page"])
                    elif fault["mode"] == "partial":
                        pages = list(wire.get("pages") or [])
                        body = {**wire, "pages": pages[: len(pages) // 2]}
                    else:   # drop: the peer is unreachable
                        self.stats.note_attempt("unreachable")
                        last_err = f"{peer_id}: injected transfer drop"
                        continue
                t0 = self._clock()
                try:
                    r = self._post(
                        f"{t['address'].rstrip('/')}/v1/migrate/import",
                        json=body, headers=self._ship_headers(wire),
                        timeout=min(cfg.attempt_timeout, remaining))
                except Exception as e:  # noqa: BLE001 — try the next peer
                    timed_out = ("timeout" in type(e).__name__.lower()
                                 or "timed out" in str(e).lower())
                    self.stats.note_attempt(
                        "timeout" if timed_out else "unreachable",
                        self._clock() - t0)
                    last_err = f"{peer_id}: {e}"
                    continue
                dt = self._clock() - t0
                if r.status_code == 200:
                    self.stats.note_attempt("ok", dt)
                    self.stats.note_shipped(body, prefill=self.prefill)
                    return peer_id
                self.stats.note_attempt(
                    "rejected" if 400 <= r.status_code < 500
                    else "http_error", dt)
                last_err = f"{peer_id}: HTTP {r.status_code}"
            if attempt + 1 >= cfg.max_attempts:
                break
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise past_deadline()
            backoff = min(cfg.backoff_cap,
                          cfg.backoff_base * (2 ** attempt))
            self._sleep(min(backoff, remaining))
        raise RuntimeError(f"snapshot ship failed: {last_err}")
