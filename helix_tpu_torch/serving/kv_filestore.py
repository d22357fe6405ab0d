"""Persistent filestore tier for the KV residency ladder.

Port of ``helix_tpu/serving/kv_filestore.py``.  The ladder: device pool
(``PageAllocator`` + ``PrefixCache``) -> host RAM (``HostPagePool``) ->
peer runner (request snapshots) -> this module, the bottom rung: a
persistent, content-addressed blob store for full prefix-cache pages over
``control.filestore.Filestore`` (a shared file system in a fleet, a local
directory on one node).  Agent fleets replay the same system prompts for
days; the device cache dies with the process and the host tier with the
host, the filestore survives restarts, so a restarted node (or a new
decode node on the shared directory) serves a warm prefix without
prefilling it again.

Contract, as the reference's:

- blobs are content-addressed by the engine's prefix-chain digest
  (``PrefixCache.page_hashes``; an adapter row's seeded digest) under a
  namespace of model and KV geometry, so a blob is only ever adopted by a
  pool it is bit-compatible with;
- every blob carries the ``page_checksum`` digest the host tier and the
  snapshots use, verified on every read before any engine state is
  touched: a corrupt or truncated blob is deleted, counted and treated as
  a miss (the prompt recomputes, never attends wrong KV);
- writes are quota'd per tenant (``HELIX_FILESTORE_KV_QUOTA_BYTES``);
  reads are never gated.

A blob is the reference's JSON document byte for byte (the same keys in
the same order; page buffers through the migration wire's codec, so a
bf16 page is written as ``"bfloat16"`` without ``ml_dtypes``): a
reference runner and a port runner on one directory adopt each other's
pages.

On the card ``put_async`` receives pages that ``gather_pages`` queued on
the engine's stream, with an event recorded after the gather; the writer
thread waits on that event before its device-to-host copy, so a blob
always holds the gathered bytes.  The ``helix_filestore_kv_*`` series are
minted here only; the server's ``/metrics`` calls
``collect_filestore_kv``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from helix_tpu_torch.control.filestore import Filestore
from helix_tpu_torch.engine.kv_cache import PAGE_FIELDS, page_checksum
from helix_tpu_torch.serving.migration import (
    _decode_array,
    _encode_array,
    json_bytes,
    json_loads,
)

log = logging.getLogger("helix_tpu_torch.kv_filestore")

FILESTORE_KV_HITS = "helix_filestore_kv_hits_total"
FILESTORE_KV_MISSES = "helix_filestore_kv_misses_total"
FILESTORE_KV_CORRUPT = "helix_filestore_kv_corrupt_total"
FILESTORE_KV_STORES = "helix_filestore_kv_stores_total"
FILESTORE_KV_QUOTA_REJECTS = "helix_filestore_kv_quota_rejects_total"
FILESTORE_KV_STORE_DROPS = "helix_filestore_kv_store_drops_total"
FILESTORE_KV_BYTES = "helix_filestore_kv_bytes"

WRITE_QUEUE_DEPTH = 256


def kv_filestore_dir() -> str:
    """HELIX_FILESTORE_KV_DIR: root of the persistent KV blob store
    ('' = tier off)."""
    return os.environ.get("HELIX_FILESTORE_KV_DIR", "")


def kv_filestore_quota_bytes() -> int:
    """HELIX_FILESTORE_KV_QUOTA_BYTES: per-tenant write quota (0 =
    unlimited)."""
    try:
        return int(os.environ.get("HELIX_FILESTORE_KV_QUOTA_BYTES", "0")
                   or 0)
    except (TypeError, ValueError):
        return 0


def _hex(digest) -> str:
    return digest.hex() if isinstance(digest, bytes) else str(digest)


def _to_host(a):
    """One page buffer in host memory (a torch tensor is copied off the
    device once; a numpy array stays as it is)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu")
    return np.asarray(a)


class KVFilestore:
    """Content-addressed page-blob store over ``control.filestore``.

    Thread contract: ``contains`` / ``get`` / ``put`` / ``put_async`` run
    on the engine thread, ``put`` also on the writer thread; the
    ``/metrics`` collector reads the counters from the scrape thread."""

    # blobs live under one reserved owner in the backing store, so user
    # files and KV blobs can share a root
    OWNER = "kv-pages"

    def __init__(self, root: str, namespace: str,
                 quota_bytes: Optional[int] = None):
        self.store = Filestore(root)
        self.namespace = namespace
        self.quota_bytes = (quota_bytes if quota_bytes is not None
                            else kv_filestore_quota_bytes())
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.stores = 0
        self.quota_rejects = 0
        self.store_drops = 0
        # the single background writer of put_async, started lazily
        self._writeq: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        # positive-presence cache: misses fall through to the file
        # system, so blobs a peer process wrote are found
        self._known: set = set()
        # per-tenant usage, persisted beside the blobs so the quota
        # survives restarts (advisory across processes)
        self._usage: dict = self._load_usage()

    @staticmethod
    def namespace_for(model: str, page_size: int, num_layers: int,
                      kv_heads: int, head_dim: int, kv_dtype: str) -> str:
        h = hashlib.blake2b(digest_size=8)
        h.update(f"{model}|{page_size}|{num_layers}|{kv_heads}|{head_dim}|"
                 f"{kv_dtype}".encode())
        return h.hexdigest()

    # -- paths / ledger ----------------------------------------------------

    def _path(self, digest) -> str:
        d = _hex(digest)
        return f"{self.namespace}/{d[:2]}/{d}.json"

    def _usage_path(self) -> str:
        return f"{self.namespace}/usage.json"

    def _load_usage(self) -> dict:
        try:
            doc = json.loads(self.store.read(self.OWNER, self._usage_path()))
            return {str(k): int(v) for k, v in doc.items()}
        except Exception:  # noqa: BLE001 — a bad ledger resets
            return {}

    def _save_usage(self) -> None:
        with self._lock:
            raw = json.dumps(self._usage).encode()
        try:
            self.store.write(self.OWNER, self._usage_path(), raw)
        except OSError:
            log.warning("could not persist the KV filestore usage ledger")

    def usage(self, tenant: str) -> int:
        with self._lock:
            return int(self._usage.get(tenant, 0))

    # -- blob operations ---------------------------------------------------

    def contains(self, digest) -> bool:
        d = _hex(digest)
        if d in self._known:
            return True
        try:
            self.store.stat(self.OWNER, self._path(d))
        except OSError:
            return False
        self._known.add(d)
        return True

    def get(self, digest) -> Optional[dict]:
        """The stored page (``gather_pages``' field layout, host tensors,
        checksum-verified), or None on a miss or a corrupt blob.  A
        corrupt blob is deleted and counted; the caller recomputes and
        the next writer stores a good copy."""
        d = _hex(digest)
        try:
            raw = self.store.read(self.OWNER, self._path(d))
        except OSError:
            self.misses += 1
            self._known.discard(d)
            return None
        try:
            doc = json_loads(raw)
            entry = {f: _decode_array((doc.get("page") or {}).get(f))
                     for f in PAGE_FIELDS}
            if entry["k"] is None or entry["v"] is None:
                raise ValueError("page missing k/v buffers")
            if page_checksum(entry).hex() != str(doc.get("checksum", "")):
                raise ValueError("page checksum mismatch")
        except Exception as e:  # noqa: BLE001 — corrupt: a typed miss
            self.corrupt += 1
            self._known.discard(d)
            log.warning("dropping corrupt KV filestore blob %s: %s", d, e)
            try:
                self.store.delete(self.OWNER, self._path(d))
            except OSError:
                pass
            return None
        self.hits += 1
        self._known.add(d)
        return entry

    def put(self, digest, entry: dict, tenant: str = "") -> bool:
        """Store one page blob charged to ``tenant``'s quota.  True when
        stored or already present; False when the quota rejected it
        (counted) or the write failed (logged).  Never raises."""
        d = _hex(digest)
        if self.contains(d):
            return True
        charged = 0
        try:
            host = {f: None if entry.get(f) is None else _to_host(entry[f])
                    for f in PAGE_FIELDS}
            doc = {
                "namespace": self.namespace,
                "tenant": tenant,
                "checksum": page_checksum(host).hex(),
                "page": {f: _encode_array(host[f]) for f in PAGE_FIELDS},
            }
            raw = json_bytes(doc)
            with self._lock:
                if self.quota_bytes and (self._usage.get(tenant, 0)
                                         + len(raw) > self.quota_bytes):
                    self.quota_rejects += 1
                    return False
                self._usage[tenant] = self._usage.get(tenant, 0) + len(raw)
                charged = len(raw)
            self.store.write(self.OWNER, self._path(d), raw)
            self._save_usage()
        except Exception:  # noqa: BLE001 — the tier degrades, never errors
            if charged:
                # the blob never landed: give the tenant its bytes back
                with self._lock:
                    self._usage[tenant] = max(
                        0, self._usage.get(tenant, 0) - charged)
            log.exception("KV filestore store failed for %s", d)
            return False
        self.stores += 1
        self._known.add(d)
        return True

    def put_async(self, digest, entry: dict, tenant: str = "",
                  ready=None) -> None:
        """Queue ``put`` on the single writer thread, which pays the
        device-to-host copy, the checksum, the encode and the disk write.
        ``ready``: an event recorded after the work that filled
        ``entry`` (the gather); the writer waits on it before reading.
        The queue is bounded: when it is full the write is dropped and
        counted (a dropped page is a later miss), serving never blocks."""
        with self._lock:
            if self._writer is None:
                self._writeq = queue.Queue(maxsize=WRITE_QUEUE_DEPTH)
                self._writer = threading.Thread(
                    target=self._write_loop, daemon=True,
                    name="kv-filestore-writer")
                self._writer.start()
        try:
            self._writeq.put_nowait((digest, entry, tenant, ready))
        except queue.Full:
            self.store_drops += 1

    def _write_loop(self) -> None:
        while True:
            digest, entry, tenant, ready = self._writeq.get()
            try:
                if ready is not None:
                    ready.synchronize()
                self.put(digest, entry, tenant=tenant)
            except Exception:  # noqa: BLE001 — the writer never dies
                log.exception("async KV filestore store failed for %s",
                              _hex(digest))
            finally:
                self._writeq.task_done()

    def flush(self, timeout: float = 30.0) -> None:
        """Wait until every queued write has landed (tests and shutdown,
        not the serving path)."""
        q = self._writeq
        if q is None:
            return
        deadline = time.monotonic() + timeout
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    # -- observability -----------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._usage.values())

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "corrupt": self.corrupt,
            "stores": self.stores,
            "quota_rejects": self.quota_rejects,
            "store_drops": self.store_drops,
            "bytes": self.total_bytes(),
            "quota_bytes": self.quota_bytes,
            "namespace": self.namespace,
        }


def filestore_for_engine(root: str, model_cfg, cache_cfg,
                         quota_bytes: Optional[int] = None) -> KVFilestore:
    """A store bound to one engine's KV geometry (the namespace that makes
    content addressing safe across mixed fleets)."""
    ns = KVFilestore.namespace_for(
        model_cfg.name, cache_cfg.page_size, model_cfg.num_layers,
        model_cfg.num_kv_heads, model_cfg.head_dim, cache_cfg.dtype)
    return KVFilestore(root, ns, quota_bytes=quota_bytes)


def collect_filestore_kv(c, loop, labels: dict) -> None:
    """The filestore tier's series for one engine loop (no-op when the
    tier is off)."""
    fs = loop.engine.kv_filestore
    if fs is None:
        return
    c.counter(FILESTORE_KV_HITS, fs.hits, labels,
              help="Prefix pages restored from the persistent filestore "
                   "tier")
    c.counter(FILESTORE_KV_MISSES, fs.misses, labels,
              help="Filestore lookups that found no blob (prompt "
                   "recomputed)")
    c.counter(FILESTORE_KV_CORRUPT, fs.corrupt, labels,
              help="Corrupt/truncated blobs dropped pre-adoption "
                   "(recompute, never an error)")
    c.counter(FILESTORE_KV_STORES, fs.stores, labels,
              help="Full prefix pages persisted to the filestore tier")
    c.counter(FILESTORE_KV_QUOTA_REJECTS, fs.quota_rejects, labels,
              help="Writes rejected by the per-tenant filestore quota")
    c.counter(FILESTORE_KV_STORE_DROPS, fs.store_drops, labels,
              help="Async write-throughs dropped at the bounded writer "
                   "queue")
    c.gauge(FILESTORE_KV_BYTES, fs.total_bytes(), labels,
            help="Bytes of KV blobs this engine's namespace holds")
