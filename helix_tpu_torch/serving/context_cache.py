"""The context-caching API's registry: a prompt prefix kept behind a handle.

Port of the runner half of ``helix_tpu/serving/context_cache.py``.
``POST /v1/context`` prefills a prefix once as a pinned one-token request
(``Request.ctx_pin``: fully resident even on a tiered engine, so the
prefix cache adopts every page and the filestore tier writes them
through) and registers a **content-addressed handle**, ``ctx-`` + blake2b
of the token bytes.  A chat or completion carrying ``context_id``
prepends the span; the prefix-cache ladder then serves its pages.

- the same prefix gives the same handle and charges nothing new;
- ``HELIX_CTX_TENANT_TOKENS`` caps the cached tokens one tenant may hold
  (creation is refused past it, reads never are);
- a registry entry that fails to load is a typed miss, never wrong
  tokens;
- the registry persists under the filestore root (``kv_filestore_dir``)
  with the reference's owner, index and blob layout, so a handle made by
  either package resolves in the other on one root.

The ``helix_ctx_*`` series are minted here only (``collect_ctx_metrics``);
the node agent's heartbeat reads ``ContextCache.stats_block`` through
``context_cache_for``.  The control plane's ``validate_ctx_block`` stays
in the reference.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Optional

from helix_tpu_torch.control.filestore import Filestore

log = logging.getLogger("helix.context_cache")

CTX_CREATES = "helix_ctx_creates_total"
CTX_HITS = "helix_ctx_hits_total"
CTX_MISSES = "helix_ctx_misses_total"
CTX_QUOTA_REJECTS = "helix_ctx_quota_rejects_total"
CTX_LOAD_ERRORS = "helix_ctx_load_errors_total"
CTX_ENTRIES = "helix_ctx_entries"
CTX_TOKENS = "helix_ctx_tokens"

_HANDLE_DIGEST_CHARS = 24


def ctx_tenant_token_cap() -> int:
    """HELIX_CTX_TENANT_TOKENS: total cached prompt tokens one tenant may
    hold across its handles (0 or unset = unlimited)."""
    try:
        return int(os.environ.get("HELIX_CTX_TENANT_TOKENS", "0") or 0)
    except (TypeError, ValueError):
        return 0


def context_handle(token_ids) -> str:
    """The content-addressed handle of a token prefix."""
    h = hashlib.blake2b(digest_size=16)
    for t in token_ids:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return "ctx-" + h.hexdigest()[:_HANDLE_DIGEST_CHARS]


class ContextCache:
    """Handle -> cached prompt prefix, persisted through the filestore
    root (``root=''``: in memory only).  One lock guards the registry;
    the counters are plain ints read without it."""

    OWNER = "ctx-cache"   # the registry's owner prefix in the store

    def __init__(self, root: str = "",
                 tenant_token_cap: Optional[int] = None):
        self.root = root
        self.store = Filestore(root) if root else None
        self.tenant_token_cap = (tenant_token_cap
                                 if tenant_token_cap is not None
                                 else ctx_tenant_token_cap())
        self._lock = threading.Lock()
        # handle -> {"tenant", "tokens" (count), "created"}; the ids load
        # lazily from per-handle blobs
        self._index: dict = {}
        self._tokens: dict = {}
        self.creates = 0
        self.hits = 0
        self.misses = 0
        self.quota_rejects = 0
        self.load_errors = 0
        if self.store is not None:
            self._index = self._load_index()

    # -- persistence -------------------------------------------------------

    @staticmethod
    def _blob_path(handle: str) -> str:
        return f"{handle[4:6] or '00'}/{handle}.json"

    def _load_index(self) -> dict:
        try:
            doc = json.loads(self.store.read(self.OWNER, "index.json"))
            return {
                str(h): {"tenant": str(e.get("tenant", "")),
                         "tokens": int(e.get("tokens", 0)),
                         "created": float(e.get("created", 0.0))}
                for h, e in doc.items() if isinstance(e, dict)
            }
        except FileNotFoundError:
            return {}
        except Exception:  # noqa: BLE001 — a mangled index resets, never errors
            log.warning("context-cache index unreadable; starting empty")
            return {}

    def _save_index_locked(self) -> None:
        if self.store is None:
            return
        try:
            self.store.write(self.OWNER, "index.json",
                             json.dumps(self._index).encode())
        except OSError:
            log.warning("could not persist context-cache index")

    # -- quota -------------------------------------------------------------

    def usage(self, tenant: str) -> int:
        """Total cached tokens charged to ``tenant``."""
        with self._lock:
            return sum(e["tokens"] for e in self._index.values()
                       if e["tenant"] == tenant)

    def admit(self, tenant: str, n_tokens: int) -> bool:
        """Would ``n_tokens`` more keep ``tenant`` inside its quota?
        False counts a reject; call once per creation, before the
        prefill."""
        if self.tenant_token_cap <= 0:
            return True
        if self.usage(tenant) + int(n_tokens) > self.tenant_token_cap:
            self.quota_rejects += 1
            return False
        return True

    # -- registry ------------------------------------------------------------

    def contains(self, handle: str) -> bool:
        with self._lock:
            return handle in self._index

    def put(self, token_ids, tenant: str = "") -> str:
        """Register a prefix and return its handle; a prefix already
        registered returns the same handle and charges nothing."""
        ids = [int(t) for t in token_ids]
        handle = context_handle(ids)
        with self._lock:
            if handle in self._index:
                return handle
            self._index[handle] = {"tenant": tenant, "tokens": len(ids),
                                   "created": time.time()}
            self._tokens[handle] = ids
            if self.store is not None:
                try:
                    self.store.write(
                        self.OWNER, self._blob_path(handle),
                        json.dumps({"tokens": ids,
                                    "tenant": tenant}).encode())
                except OSError:
                    log.warning("could not persist context blob %s", handle)
            self._save_index_locked()
        self.creates += 1
        return handle

    def get(self, handle: str) -> Optional[list]:
        """The token ids of ``handle``, or None: an unknown handle or an
        unreadable blob, both misses."""
        with self._lock:
            known = handle in self._index
            ids = self._tokens.get(handle)
        if not known:
            self.misses += 1
            return None
        if ids is not None:
            self.hits += 1
            return list(ids)
        # indexed but not in memory (a restart, or another process on
        # the root): load the blob and check its content address
        try:
            doc = json.loads(self.store.read(self.OWNER,
                                             self._blob_path(handle)))
            ids = [int(t) for t in doc["tokens"]]
            if context_handle(ids) != handle:
                raise ValueError("content address mismatch")
        except Exception as e:  # noqa: BLE001 — unreadable blob = typed miss
            self.load_errors += 1
            self.misses += 1
            log.warning("dropping unreadable context %s: %s", handle, e)
            with self._lock:
                self._index.pop(handle, None)
                self._save_index_locked()
            return None
        with self._lock:
            self._tokens[handle] = ids
        self.hits += 1
        return list(ids)

    def delete(self, handle: str) -> bool:
        with self._lock:
            if handle not in self._index:
                return False
            self._index.pop(handle, None)
            self._tokens.pop(handle, None)
            if self.store is not None:
                try:
                    self.store.delete(self.OWNER, self._blob_path(handle))
                except OSError:
                    pass
            self._save_index_locked()
        return True

    def entries(self) -> list:
        """The listing of the HTTP surface (metadata only), oldest
        first."""
        with self._lock:
            return [{"id": h, "tokens": e["tokens"], "created": e["created"]}
                    for h, e in sorted(self._index.items(),
                                       key=lambda kv: kv[1]["created"])]

    def _totals(self) -> tuple:
        with self._lock:
            return (len(self._index),
                    sum(e["tokens"] for e in self._index.values()))

    def stats_block(self) -> dict:
        """The heartbeat's ``ctx`` block; ``{}`` while empty and idle."""
        entries, tokens = self._totals()
        if not entries and not (self.creates or self.hits or self.misses):
            return {}
        return {"entries": entries, "tokens": tokens,
                "creates": self.creates, "hits": self.hits,
                "misses": self.misses, "quota_rejects": self.quota_rejects}


# one cache per filestore root per process: the HTTP surface and the
# node agent's heartbeat read the same instance
_CACHES: dict = {}
_CACHES_LOCK = threading.Lock()


def context_cache_for(root: str = "") -> ContextCache:
    """The process-wide ``ContextCache`` of ``root`` ('' = in memory)."""
    with _CACHES_LOCK:
        cache = _CACHES.get(root)
        if cache is None:
            cache = _CACHES[root] = ContextCache(root)
        return cache


def collect_ctx_metrics(c, cache: Optional[ContextCache]) -> None:
    """The runner's ``helix_ctx_*`` series (scrape time)."""
    if cache is None:
        return
    entries, tokens = cache._totals()
    c.gauge(CTX_ENTRIES, entries,
            help="Context handles registered on this runner")
    c.gauge(CTX_TOKENS, tokens,
            help="Total prompt tokens held across context handles")
    c.counter(CTX_CREATES, cache.creates,
              help="Context handles created (prefix prefilled + "
                   "registered)")
    c.counter(CTX_HITS, cache.hits,
              help="Requests that resolved a context handle (cached-span "
                   "prefill skipped via the prefix-cache ladder)")
    c.counter(CTX_MISSES, cache.misses,
              help="context_id references that resolved to no usable "
                   "entry")
    c.counter(CTX_QUOTA_REJECTS, cache.quota_rejects,
              help="Context creations rejected by the per-tenant token "
                   "quota")
    c.counter(CTX_LOAD_ERRORS, cache.load_errors,
              help="Persisted context blobs dropped as unreadable/"
                   "mismatched (degrade to miss, never wrong tokens)")
