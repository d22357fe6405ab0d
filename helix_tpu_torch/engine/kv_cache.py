"""Paged KV cache: device page pool + host-side allocator.

Port of ``helix_tpu/engine/kv_cache.py`` (device tier).

- The pool is two tensors per model, ``k_pages``/``v_pages`` of shape
  ``[L, N, P, KVH, D]`` — the same layout as the reference, so one
  ``(layer, page)`` slice is a contiguous ``[P, KVH, D]`` block and one
  token's ``[KVH, D]`` is contiguous.  Int8 pools add float32 scale pools
  ``k_scale``/``v_scale`` ``[L, N, P, KVH]``, one scale per (token slot,
  KV head).
- ``write_kv`` scatters fresh K/V IN PLACE (the reference returns a new
  pool that jit donation makes in-place; here the mutation is explicit),
  quantizing on write into int8 pools.  Padding tokens go to page 0, the
  garbage page, so duplicate indices are expected there and only there.
- ``PageAllocator`` and ``PrefixCache`` are host Python, copied.
- The host-RAM tier: ``HostPagePool`` holds spilled pages in pageable
  host memory under a byte budget, ``gather_pages`` / ``restore_pages``
  move whole pages between the pool and host buffers (one
  ``index_select`` / ``index_copy_`` per field), ``page_checksum`` is the
  reference's blake2b digest over the stored bytes.

Tiered residency keeps a long row's demoted pages in the same host pool
(pinned entries keyed ``("ctx", request_id, page_index)``), read back
page by page through ``HostPagePool.get``; a page that fails verification
there is a ``ColdPageError`` for its request.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from helix_tpu_torch.device import torch_dtype, upload
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.ops.quant import quantize_kv
from helix_tpu_torch.testing import faults

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_pages: int
    page_size: int = 16
    max_pages_per_seq: int = 128
    dtype: str = "bfloat16"

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq

    def page_bytes(self, model: ModelConfig) -> int:
        per_elem = 2 * model.num_layers * self.page_size * model.num_kv_heads
        total = per_elem * model.head_dim * _ITEMSIZE[self.dtype]
        if self.quantized:
            # f32 scale per (token slot, kv head), for K and V pools
            total += per_elem * 4
        return total

    def total_bytes(self, model: ModelConfig) -> int:
        return self.num_pages * self.page_bytes(model)

    @classmethod
    def fit_hbm(
        cls,
        model: ModelConfig,
        hbm_budget_bytes: int,
        page_size: int = 16,
        max_pages_per_seq: int = 128,
        dtype: str = "bfloat16",
    ) -> "CacheConfig":
        """Size the page pool to a device-memory budget (what is left
        after weights)."""
        probe = cls(num_pages=1, page_size=page_size,
                    max_pages_per_seq=max_pages_per_seq, dtype=dtype)
        num_pages = max(hbm_budget_bytes // probe.page_bytes(model), 0)
        return cls(
            num_pages=int(num_pages),
            page_size=page_size,
            max_pages_per_seq=max_pages_per_seq,
            dtype=dtype,
        )


@dataclasses.dataclass
class PagedKVCache:
    """The device page pool; ``k_scale``/``v_scale`` are the f32 scale
    pools of an int8 pool, ``None`` for float pools."""

    k_pages: torch.Tensor  # [L, N, P, KVH, D]
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, model: ModelConfig, cache: CacheConfig,
               device, kv_heads: Optional[int] = None) -> "PagedKVCache":
        """Zeroed pools on ``device``; ``kv_heads``: the KV heads this
        pool holds (a tensor-parallel shard's ``KVH / n``), all of the
        model's by default."""
        shape = (model.num_layers, cache.num_pages, cache.page_size,
                 kv_heads or model.num_kv_heads, model.head_dim)
        if not cache.quantized:
            dt = torch_dtype(cache.dtype)
            return cls(
                k_pages=torch.zeros(shape, dtype=dt, device=device),
                v_pages=torch.zeros(shape, dtype=dt, device=device),
            )
        sshape = shape[:-1]
        return cls(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        )

    @property
    def num_layers(self):
        return self.k_pages.shape[0]

    @classmethod
    def create_sharded(cls, model: ModelConfig, cache: CacheConfig,
                       mesh) -> list:
        """The pool of a tensor-parallel mesh, sharded over
        ``cache_heads`` as the reference shards it
        (``parallel.sharding.POOL_AXES``; ``helix_tpu/engine/
        kv_cache.py:123-165``): one pool per shard on its device, holding
        that shard's ``KVH / n`` KV heads ``[L, N, P, KVH / n, D]``
        (int8: with its scales ``[L, N, P, KVH / n]``).  Page ids are
        global: page p of every shard holds page p's tokens."""
        from helix_tpu_torch.parallel.sharding import POOL_AXES, shard_block

        shape = (model.num_layers, cache.num_pages, cache.page_size,
                 model.num_kv_heads, model.head_dim)
        return [cls.create(model, cache, d,
                           shard_block(shape, POOL_AXES, mesh, i)[3][1])
                for i, d in enumerate(mesh.devices)]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer_view(self, layer: int):
        return self.k_pages[layer], self.v_pages[layer]

    def carry(self):
        """The pools as the forward's carry protocol threads them, plus
        the scale pools when quantized."""
        if self.k_scale is None:
            return (self.k_pages, self.v_pages)
        return (self.k_pages, self.v_pages, self.k_scale, self.v_scale)

    @classmethod
    def from_carry(cls, carry) -> "PagedKVCache":
        if len(carry) == 2:
            return cls(k_pages=carry[0], v_pages=carry[1])
        return cls(k_pages=carry[0], v_pages=carry[1], k_scale=carry[2],
                   v_scale=carry[3])


def write_kv(
    cache: PagedKVCache,
    k_new: torch.Tensor,   # [L, B, S, KVH, D]
    v_new: torch.Tensor,
    pages: torch.Tensor,   # [B, S] — destination page per token
    offsets: torch.Tensor,  # [B, S] — offset within page
    valid: torch.Tensor,   # [B, S] bool — False for padding tokens
) -> PagedKVCache:
    """Scatter fresh KV into the pool in place and return it.

    One ``index_copy_`` per pool at the fused token index
    ``page * page_size + offset`` on the flat ``[L, N*P, KVH, D]`` view;
    padding tokens land on garbage page 0, the only page that may receive
    racing duplicate writes.  Int8 pools quantize here (``quantize_kv``)
    and scatter the scale rows into the scale pools at the same index."""
    L, B, S, KVH, D = k_new.shape
    Lp, N, P, _, _ = cache.k_pages.shape
    flat_idx = torch.where(
        valid, pages.long() * P + offsets.long(), torch.zeros_like(pages.long())
    ).reshape(-1)
    writes = [(cache.k_pages, k_new), (cache.v_pages, v_new)]
    if cache.quantized:
        k_q, k_sc = quantize_kv(k_new)
        v_q, v_sc = quantize_kv(v_new)
        writes = [(cache.k_pages, k_q), (cache.v_pages, v_q)]
        for pool, sc in ((cache.k_scale, k_sc), (cache.v_scale, v_sc)):
            pool.view(Lp, N * P, KVH).index_copy_(
                1, flat_idx, sc.reshape(L, B * S, KVH)
            )
    for pool, new in writes:
        pool.view(Lp, N * P, KVH, D).index_copy_(
            1, flat_idx, new.reshape(L, B * S, KVH, D).to(pool.dtype)
        )
    return cache


class PageAllocator:
    """Host-side free-list allocator for the page pool.

    Page 0 is reserved as the garbage page that padding writes land on
    (``write_kv``), so it is never handed out.  Invariants:
    ``used + free == num_pages - 1`` after every operation, ``free()`` of
    a sequence that owns nothing is an error, ``give_back()`` of a page
    already free is an error, and ``allocate()`` either fully succeeds or
    changes nothing."""

    def __init__(self, num_pages: int, max_pages_per_seq: int):
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self._free = list(range(num_pages - 1, 0, -1))  # page 0 reserved
        self._free_set = set(self._free)
        self._owned: dict[str, list[int]] = {}
        self.peak_used = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def pages_needed(self, num_tokens: int, page_size: int) -> int:
        return -(-num_tokens // page_size)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, seq_id: str, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"allocate({seq_id!r}, {n}): negative count")
        if n == 0:
            return []
        if len(self._free) < n:
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}"
            )
        if len(self._owned.get(seq_id, ())) + n > self.max_pages_per_seq:
            raise MemoryError(f"sequence {seq_id} exceeds max_pages_per_seq")
        got = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(got)
        self.peak_used = max(self.peak_used, self.used_pages)
        self._owned.setdefault(seq_id, []).extend(got)
        return got

    def seq_pages(self, seq_id: str) -> list[int]:
        return list(self._owned.get(seq_id, []))

    def owns(self, seq_id: str) -> bool:
        return seq_id in self._owned

    def free(self, seq_id: str) -> None:
        if seq_id not in self._owned:
            raise KeyError(
                f"free() of sequence {seq_id!r} that owns no pages "
                "(double free, or never allocated?)"
            )
        pages = self._owned.pop(seq_id)
        self._free.extend(reversed(pages))
        self._free_set.update(pages)

    def detach(self, seq_id: str, pages: list) -> None:
        """Remove ``pages`` from the sequence's ownership WITHOUT freeing
        them (the prefix cache adopts them)."""
        drop = set(pages)
        owned = self._owned.get(seq_id)
        if owned:
            self._owned[seq_id] = [p for p in owned if p not in drop]

    def give_back(self, pages: list) -> None:
        """Return cache-evicted pages to the free list."""
        dup = self._free_set.intersection(pages)
        if dup:
            raise ValueError(
                f"give_back() of already-free page(s) {sorted(dup)}"
            )
        self._free.extend(pages)
        self._free_set.update(pages)


def slot_to_page_offset(slots, page_table, page_size: int):
    """(page, offset) for absolute slot indices given per-seq page tables.

    ``slots``: [B, S] absolute token positions; ``page_table``: [B, maxP].
    Positions past the table (a verify row's padding near the end of a
    slot's pages) read its last entry; their writes are masked out.
    """
    page_idx = torch.div(slots, page_size, rounding_mode="floor").long()
    page_idx = page_idx.clamp(max=page_table.shape[-1] - 1)
    offsets = slots % page_size
    pages = torch.gather(page_table, -1, page_idx)
    return pages.to(torch.int32), offsets.to(torch.int32)


class PrefixCache:
    """Automatic prefix caching: content-hashed full pages of prompt KV
    shared across requests.  Pages enter the cache when a request's prompt
    finishes prefilling (``adopt``), are shared by later requests whose
    prompt starts with the same pages (``acquire``, refcounted), and return
    to the free list only through LRU eviction of refcount-0 entries.

    Hash chain: h_i = blake2b(h_{i-1} || tokens[i*ps:(i+1)*ps]), h_{-1}
    empty; a multi-LoRA adapter row's chain starts from its adapter's
    weights checksum instead (``seed``), because the adapter changes the
    page's K/V (the reference chains tokens alone and shares pages across
    adapters: ROADMAP C)."""

    def __init__(self):
        self._entries: dict[bytes, list] = {}   # digest -> [page, refs, tick]
        self._by_page: dict[int, bytes] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evicted_pages = 0

    @staticmethod
    def page_hashes(tokens, page_size: int, max_pages: int,
                    seed: bytes = b"") -> list:
        """Chain digests for the first ``max_pages`` FULL pages; ``seed``
        (empty for adapter-free rows: the reference's digests) starts the
        chain."""
        out = []
        prev = seed
        for i in range(max_pages):
            chunk = tokens[i * page_size:(i + 1) * page_size]
            if len(chunk) < page_size:
                break
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(np.asarray(chunk, np.int32).tobytes())
            prev = h.digest()
            out.append(prev)
        return out

    def match_len(self, hashes: list) -> int:
        n = 0
        for h in hashes:
            if h not in self._entries:
                break
            n += 1
        return n

    def acquire(self, hashes: list) -> list:
        pages = []
        self._tick += 1
        for h in hashes:
            e = self._entries.get(h)
            if e is None:
                break
            e[1] += 1
            e[2] = self._tick
            pages.append(e[0])
        return pages

    def record_claim(self, hit_pages: int, total_pages: int) -> None:
        self.hits += hit_pages
        self.misses += total_pages - hit_pages

    def release(self, pages: list) -> None:
        for p in pages:
            h = self._by_page.get(p)
            if h is None:
                continue
            e = self._entries.get(h)
            if e is not None and e[1] > 0:
                e[1] -= 1

    def adopt(self, hashes: list, pages: list) -> list:
        adopted = []
        self._tick += 1
        for h, p in zip(hashes, pages):
            if h in self._entries or p in self._by_page:
                continue
            self._entries[h] = [p, 1, self._tick]
            self._by_page[p] = h
            adopted.append(p)
        return adopted

    def evict(self, n: int) -> list:
        return [p for _, p in self.evict_entries(n)]

    def evict_entries(self, n: int) -> list:
        if n <= 0:
            return []
        victims = sorted(
            (e for e in self._entries.values() if e[1] == 0),
            key=lambda e: e[2],
        )[:n]
        freed = []
        for e in victims:
            page = e[0]
            h = self._by_page.pop(page)
            del self._entries[h]
            freed.append((h, page))
        self.evicted_pages += len(freed)
        return freed

    @property
    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "pages": len(self._by_page),
            "hits": self.hits,
            "misses": self.misses,
            "evicted_pages": self.evicted_pages,
        }


# ---------------------------------------------------------------------------
# Host-RAM page tier: spill instead of die
# ---------------------------------------------------------------------------

PAGE_FIELDS = ("k", "v", "k_scale", "v_scale")
# pinned bytes that spills may hold in flight before a spill waits for
# the oldest copy to land (the staging bound; stored pages are pageable)
STAGING_BYTES = 512 << 20


def raw_bytes(a) -> bytes:
    """The stored bytes of one page buffer (a torch tensor or a numpy
    array), C order: a bf16 page is its raw 2-byte words, the bytes the
    JAX package's numpy arrays hold."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _raw_view(a):
    """The stored bytes of a page buffer as a buffer object: a view of a
    host tensor (no copy), else ``raw_bytes``."""
    if isinstance(a, torch.Tensor) and a.device.type == "cpu" \
            and a.is_contiguous():
        return a.detach().reshape(-1).view(torch.uint8).numpy()
    return raw_bytes(a)


def page_checksum(arrays: dict) -> bytes:
    """blake2b-16 over a page's buffers in the fixed field order ``k, v,
    k_scale, v_scale`` (the reference's ``page_checksum``): int8 pools
    checksum raw codes + scale rows, so a restore is verified bit-exact
    in the stored representation, in either package."""
    h = hashlib.blake2b(digest_size=16)
    for field in PAGE_FIELDS:
        a = arrays.get(field)
        if a is not None:
            h.update(_raw_view(a))
    return h.digest()


class ColdPageError(RuntimeError):
    """A tiered sequence's demoted cold-middle page failed checksum
    verification (or vanished from the host pool) at stream time (the
    reference's ``ColdPageError``).  A cold page has no recompute path
    mid-decode -- the tokens it holds were already conditioned on -- so
    the only safe outcome is a typed failure for its request, never
    attention over wrong KV."""


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _flip_first_byte(a):
    """A detached copy of ``a`` with its first byte flipped."""
    if isinstance(a, torch.Tensor):
        out = a.detach().to("cpu").clone()
        out.reshape(-1).view(torch.uint8)[0] ^= 0xFF
        return out
    out = np.array(a)
    out.view(np.uint8).reshape(-1)[0] ^= 0xFF
    return out


class _HostPage:
    """One spilled page.  Until ``HostPagePool._finalize`` runs,
    ``arrays`` may be pinned staging tensors whose device-to-host copy is
    still in flight (``event``); finalizing waits for it, copies the page
    into pageable memory and stamps the checksum."""

    __slots__ = ("key", "arrays", "nbytes", "pinned", "tick", "checksum",
                 "ready", "device", "event", "staged")

    def __init__(self, key, arrays: dict, nbytes: int, pinned: bool,
                 tick: int):
        self.key = key
        self.arrays = arrays
        self.nbytes = nbytes
        self.pinned = pinned
        self.tick = tick
        self.checksum: Optional[bytes] = None
        self.ready = False
        self.device: Optional[dict] = None   # prefetched device tensors
        self.event = None                    # the D2H copy's CUDA event
        self.staged = 0                      # pinned staging bytes held


class HostPagePool:
    """Byte-budgeted host-RAM tier under the device page pool (port of
    the reference's ``HostPagePool``).

    Two key spaces share one budget: prefix pages keyed by the
    ``PrefixCache`` chain digest, and a preempted sequence's private
    pages keyed ``("seq", request_id, table_pos)``.  "Pinned" entries are
    EXEMPT FROM LRU (a parked decoder's pages must survive until resume
    or abort); it says nothing about page-locked memory.  Unpinned
    entries LRU-evict to fit the budget.  Every entry carries a content
    checksum verified at restore and at prefetch: a corrupt host buffer
    is dropped and counted, and the caller sees a miss (prefix) or a
    resume failure (preempted), never wrong KV.

    Device pages move without a synchronising call: ``put`` queues each
    field's copy into a pinned staging tensor on the current stream (the
    stream that queued the gather, ahead of any later write to the freed
    pool page) and records an event; ``drain_pending`` (once per engine
    step) finalizes the entries whose event has fired.  At most
    ``STAGING_BYTES`` of staging are in flight: past that a spill first
    finalizes the oldest entries, waiting for their copies.  The budget
    itself is pageable memory and never page-locked.  Engine-thread
    owned; counters are plain ints for other threads to read."""

    def __init__(self, budget_bytes: int, device="cpu"):
        self.budget_bytes = int(budget_bytes)
        self.device = torch.device(device)
        self._entries: dict = {}
        self._pending: list = []   # keys spilled but not yet finalized
        self._tick = 0
        self._bytes = 0
        self._staged = 0
        # counters (monotonic)
        self.spilled_pages = 0      # pages demoted device -> host
        self.restored_pages = 0     # pages promoted host -> device
        self.evicted_pages = 0      # unpinned pages LRU-dropped for budget
        self.corrupt_pages = 0      # checksum failures detected at restore
        self.alloc_failures = 0     # spills dropped: budget/fault

    # -- occupancy ----------------------------------------------------------

    @property
    def used_bytes(self) -> int:
        return self._bytes

    @property
    def pages(self) -> int:
        return len(self._entries)

    @property
    def occupancy(self) -> float:
        return self._bytes / self.budget_bytes if self.budget_bytes else 0.0

    @property
    def staged_bytes(self) -> int:
        return self._staged

    def stats(self) -> dict:
        return {
            "pages": len(self._entries),
            "used_bytes": self._bytes,
            "budget_bytes": self.budget_bytes,
            "spilled_pages": self.spilled_pages,
            "restored_pages": self.restored_pages,
            "evicted_pages": self.evicted_pages,
            "corrupt_pages": self.corrupt_pages,
            "alloc_failures": self.alloc_failures,
        }

    # -- write side ---------------------------------------------------------

    @staticmethod
    def _fault(op: str) -> Optional[dict]:
        inj = faults.active()
        return inj.host_pool_fault(op) if inj is not None else None

    def put(self, key, arrays: dict, pinned: bool = False) -> bool:
        """Adopt one page's buffers: device tensors fresh off a gather
        (their copy to the host is queued here), or host tensors / numpy
        arrays (kept as they are).  False (counted in ``alloc_failures``)
        when the page cannot fit."""
        fault = self._fault("spill")
        if fault is not None and fault.get("mode") == "alloc_fail":
            self.alloc_failures += 1
            return False
        nbytes = sum(_nbytes(a) for a in arrays.values() if a is not None)
        old = self._entries.get(key)
        if old is not None:
            self._drop(key)
        if nbytes > self.budget_bytes or not self._evict_for(nbytes):
            # a failed RE-spill must not destroy the previously valid host
            # copy (same digest = same content): it fit before and only
            # evictions happened since
            if old is not None \
                    and self._bytes + old.nbytes <= self.budget_bytes:
                self._entries[key] = old
                self._bytes += old.nbytes
                self._staged += old.staged
            self.alloc_failures += 1
            return False
        self._tick += 1
        e = _HostPage(key, dict(arrays), nbytes, pinned, self._tick)
        if any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in arrays.values()):
            self._stage(e)
        self._entries[key] = e
        self._bytes += nbytes
        self._pending.append(key)
        self.spilled_pages += 1
        return True

    def _stage(self, e: _HostPage) -> None:
        """Queue the page's device-to-host copy into pinned staging."""
        while self._staged + e.nbytes > STAGING_BYTES:
            oldest = next((self._entries[k] for k in self._pending
                           if k in self._entries
                           and self._entries[k].event is not None), None)
            if oldest is None:
                break
            self._finalize(oldest)
        staged = {}
        src = None
        for f, a in e.arrays.items():
            if a is None:
                staged[f] = None
                continue
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            staged[f] = host
            src = a.device
        e.arrays = staged
        e.event = torch.cuda.Event()
        e.event.record(torch.cuda.current_stream(src))
        e.staged = e.nbytes
        self._staged += e.nbytes

    def drain_pending(self) -> None:
        """Finalize spills whose copies have landed (once per engine
        step): pageable copy + checksum, staging released.  Never waits:
        an entry whose event has not fired stays pending."""
        if not self._pending:
            return
        keep = []
        for key in self._pending:
            e = self._entries.get(key)
            if e is None or e.ready:
                continue
            if e.event is not None and not e.event.query():
                keep.append(key)
                continue
            self._finalize(e, landed=True)
        self._pending = keep

    def _evict_for(self, nbytes: int) -> bool:
        """LRU-drop unpinned entries until ``nbytes`` fit; False when the
        pinned set alone exceeds the headroom."""
        while self._bytes + nbytes > self.budget_bytes:
            victims = [e for e in self._entries.values() if not e.pinned]
            if not victims:
                return False
            victim = min(victims, key=lambda e: e.tick)
            self._drop(victim.key)
            self.evicted_pages += 1
        return True

    def _drop(self, key) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes
            self._staged -= e.staged

    def discard(self, key) -> None:
        """Remove an entry without restore accounting (an aborted
        preempted request)."""
        self._drop(key)

    # -- read side ----------------------------------------------------------

    def contains(self, key) -> bool:
        """Presence only: never waits for an in-flight copy."""
        return key in self._entries

    def _finalize(self, e: _HostPage, landed: bool = False) -> None:
        """Pageable copy + checksum; waits for the page's copy unless
        ``landed`` (its event was seen complete)."""
        if e.ready:
            return
        if e.event is not None:
            if not landed:
                e.event.synchronize()
            # out of the staging block into pageable memory: the budget
            # is never page-locked
            e.arrays = {
                f: None if a is None
                else torch.empty(a.shape, dtype=a.dtype).copy_(a)
                for f, a in e.arrays.items()
            }
            e.event = None
            self._staged -= e.staged
            e.staged = 0
        e.checksum = page_checksum(e.arrays)
        e.ready = True

    def get(self, key) -> Optional[dict]:
        """One page's host buffers for restore, checksum-verified.  None
        on a miss OR a detected corruption (the entry is dropped and
        counted)."""
        e = self._entries.get(key)
        if e is None:
            return None
        fault = self._fault("restore")
        if fault is not None:
            if fault.get("mode") == "slow":
                time.sleep(float(fault.get("delay", 0.05)))
            elif fault.get("mode") == "corrupt":
                self._finalize(e)
                e.arrays = {**e.arrays, "k": _flip_first_byte(e.arrays["k"])}
        self._finalize(e)
        if page_checksum(e.arrays) != e.checksum:
            self._drop(key)
            self.corrupt_pages += 1
            return None
        self._tick += 1
        e.tick = self._tick
        return e.arrays

    def prefetch(self, key) -> bool:
        """Queue the host-to-device upload of a page expected to restore
        soon (its request is still waiting for a slot or pages), from
        pinned staging; verified first, so a corrupt page drops here."""
        e = self._entries.get(key)
        if e is None:
            return False
        if e.device is not None:
            return True
        arrays = self.get(key)
        if arrays is None:
            return False
        e.device = {f: None if a is None else _to_device(a, self.device)
                    for f, a in arrays.items()}
        return True

    def release_device(self, key) -> None:
        """Drop a prefetched entry's device tensors (the host copy
        stays)."""
        e = self._entries.get(key)
        if e is not None:
            e.device = None

    def take_restored(self, key) -> Optional[dict]:
        """Claim a page for device restore: verified buffers (device
        tensors when prefetched, else host), removed from the pool and
        counted as restored."""
        e = self._entries.get(key)
        if e is None:
            return None
        if e.device is not None:
            out = e.device
        else:
            out = self.get(key)
            if out is None:
                return None
        self._drop(key)
        self.restored_pages += 1
        return out


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host page buffer on ``device``; on the card through pinned
    staging, queued (``non_blocking``), so the upload is asynchronous."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.to(device)
    stage = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stage.copy_(t)
    return stage.to(device, non_blocking=True)


def gather_pages(cache: PagedKVCache, page_ids: list) -> list:
    """``page_ids`` out of the device pool as per-page dicts (``[L, P,
    KVH, D]`` each, scale rows ``[L, P, KVH]`` for int8 pools): one
    ``index_select`` per field, queued on the current stream, into fresh
    page-major buffers, so a page freed right after may be rewritten by
    a later write without touching what was gathered."""
    if not page_ids:
        return []
    idx = upload(np.asarray(page_ids, np.int64), cache.k_pages.device)
    fields = {"k": cache.k_pages, "v": cache.v_pages,
              "k_scale": cache.k_scale, "v_scale": cache.v_scale}
    got = {f: None if pool is None
           else pool.index_select(1, idx).transpose(0, 1).contiguous()
           for f, pool in fields.items()}
    return [{f: None if g is None else g[i] for f, g in got.items()}
            for i in range(len(page_ids))]


def _stack_pages(parts: list, n_pad: int, device: torch.device):
    """``[L, len(parts) + n_pad, ...]`` on ``device`` from per-page
    buffers (prefetched device tensors, or host buffers: those go up in
    one pinned, queued upload); the padding rows are zeros."""
    first = torch.as_tensor(parts[0])
    shape = (first.shape[0], len(parts) + n_pad) + tuple(first.shape[1:])
    out = torch.zeros(shape, dtype=first.dtype, device=device)
    on_host = []
    for i, p in enumerate(parts):
        t = torch.as_tensor(p)
        if t.device == device:
            out[:, i].copy_(t)
        else:
            on_host.append(i)
    if on_host:
        stage = torch.empty((len(on_host),) + tuple(first.shape),
                            dtype=first.dtype,
                            pin_memory=device.type == "cuda")
        for j, i in enumerate(on_host):
            stage[j].copy_(torch.as_tensor(parts[i]))
        up = stage.to(device, non_blocking=True)
        out.index_copy_(1, upload(np.asarray(on_host, np.int64), device),
                        up.transpose(0, 1))
    return out


def restore_pages(cache: PagedKVCache, page_ids: list,
                  entries: list) -> PagedKVCache:
    """Write page contents (from ``HostPagePool.take_restored`` or a
    snapshot) into pool pages ``page_ids``, in place: one ``index_copy_``
    per field.  The batch pads to a power of two, as the reference's
    bucketed scatter does, with the padding rows aimed at garbage page
    0."""
    if not page_ids:
        return cache
    n = len(page_ids)
    bucket = 1
    while bucket < n:
        bucket *= 2
    idx = np.zeros((bucket,), np.int64)   # padding targets garbage page 0
    idx[:n] = page_ids
    dev = cache.k_pages.device
    idx_t = upload(idx, dev)
    fields = [("k", cache.k_pages), ("v", cache.v_pages)]
    if cache.quantized:
        fields += [("k_scale", cache.k_scale), ("v_scale", cache.v_scale)]
    for f, pool in fields:
        batch = _stack_pages([e[f] for e in entries], bucket - n, dev)
        pool.index_copy_(1, idx_t, batch.to(pool.dtype))
    return cache
