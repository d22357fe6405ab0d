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

The host-RAM and tiered page pools (ROADMAP A12, A14) are not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from helix_tpu_torch.device import torch_dtype
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.ops.quant import quantize_kv

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
               device) -> "PagedKVCache":
        shape = (model.num_layers, cache.num_pages, cache.page_size,
                 model.num_kv_heads, model.head_dim)
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

    Hash chain: h_i = blake2b(h_{i-1} || tokens[i*ps:(i+1)*ps])."""

    def __init__(self):
        self._entries: dict[bytes, list] = {}   # digest -> [page, refs, tick]
        self._by_page: dict[int, bytes] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evicted_pages = 0

    @staticmethod
    def page_hashes(tokens, page_size: int, max_pages: int) -> list:
        """Chain digests for the first ``max_pages`` FULL pages."""
        out = []
        prev = b""
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
