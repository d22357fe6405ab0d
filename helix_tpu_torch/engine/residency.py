"""HBM-accounted multi-model residency: in-process hot-swap.

Port of ``helix_tpu/engine/residency.py``: models are in-process engines
loaded on demand against a device-memory budget and evicted least
recently used, idle ones only:

- every model's footprint = weight bytes (exact, from the param tree) +
  page-pool bytes (from ``CacheConfig``) + an activation headroom margin;
- ``acquire(name)`` loads on demand, evicting least-recently-used IDLE
  models (never one with requests in flight) until the budget fits; with
  an ``estimate`` it evicts first and builds after;
- ``prefetch(name)`` builds on a background thread, holding the estimate
  as a reservation meanwhile.

Every decision (which model, when, which error) is the reference's.  What
differs is how an eviction frees memory: XLA frees a dead array at once,
while PyTorch's caching allocator frees a tensor only when its last
reference dies.  So an eviction here stops the loop, waits for its engine
thread, drops the engine's tensors (``Engine.release``) and collects
before it returns, and the next build allocates into memory that is
really free.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Optional

import torch

from helix_tpu_torch.device import release_device_memory, torch_dtype
from helix_tpu_torch.engine.engine import EngineConfig
from helix_tpu_torch.serving.registry import ServedModel

log = logging.getLogger(__name__)

# the engine fields the page pool's size comes from: the rest of an entry's
# engine block is checked where the model is built
_CACHE_FIELDS = ("num_pages", "page_size", "max_pages_per_seq",
                 "kv_cache_dtype")


def tree_bytes(tree) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def model_param_count(model_cfg) -> int:
    """Architectural parameter count from a config (dense-path weights).
    For an MoE config this is the reference's active-per-token shape:
    one FFN per layer, no router, so Mixtral-8x7B counts 7.24 B of its
    46.70 B and an entry's estimate falls short of its footprint by the
    other experts (ROADMAP C: the reference's fault, kept)."""
    c = model_cfg
    embed = c.vocab_size * c.hidden_size
    per_layer = (
        c.hidden_size * c.num_heads * c.head_dim        # wq
        + 2 * c.hidden_size * c.num_kv_heads * c.head_dim  # wk, wv
        + c.num_heads * c.head_dim * c.hidden_size      # wo
        + 3 * c.hidden_size * c.intermediate_size       # gate, up, down
        + 2 * c.hidden_size                             # norms
    )
    return embed * (1 if c.tie_word_embeddings else 2) + (
        c.num_layers * per_layer + c.hidden_size
    )


def estimate_model_bytes(
    model_cfg,
    engine_kwargs: dict,
    quantization: Optional[str] = None,
    headroom: float = 0.10,
) -> int:
    """Predict a chat model's device footprint from its config BEFORE
    building: weight bytes (arch param count x itemsize, one byte per
    parameter for int8) + page-pool bytes + headroom."""
    c = model_cfg
    itemsize = (1 if quantization == "int8"
                else torch_dtype(c.dtype).itemsize)
    weight_bytes = model_param_count(c) * itemsize
    ecfg = EngineConfig(**{k: v for k, v in (engine_kwargs or {}).items()
                           if k in _CACHE_FIELDS})
    cache_bytes = ecfg.cache_config(dtype=c.dtype).total_bytes(c)
    return int((weight_bytes + cache_bytes) * (1 + headroom))


def host_pool_budget_bytes(default: int = 0) -> int:
    """Operator-declared host-RAM KV tier budget
    (``HELIX_KV_HOST_POOL_BYTES``); 0 = tier disabled."""
    v = os.environ.get("HELIX_KV_HOST_POOL_BYTES", "")
    return int(v) if v else default


def host_tier_pages(model_cfg, cache_cfg, host_budget_bytes: int) -> int:
    """How many spilled pages a host budget holds for this model (a page
    spills at its stored size: int8 pages stay int8)."""
    per_page = cache_cfg.page_bytes(model_cfg)
    return int(host_budget_bytes // per_page) if per_page else 0


def served_model_bytes(m: ServedModel, headroom: float = 0.10) -> int:
    """Footprint of a live ServedModel: weights + KV pages (+headroom);
    a vision model's tower counts beside its text tower."""
    total = 0
    if m.loop is not None:
        eng = m.loop.engine
        total += tree_bytes(eng.params)     # one tree a shard on a mesh
        # pools + int8 scale pools, one per shard
        total += tree_bytes([pool.carry() for pool in eng.caches])
    elif m.embedder is not None:
        total += tree_bytes(m.embedder.params)
        total += tree_bytes(getattr(m.embedder, "vparams", None) or {})
    if m.vision is not None:
        total += tree_bytes(m.vision.vparams)
    return int(total * (1 + headroom))


def release_served_model(m: ServedModel) -> None:
    """Stop ``m``'s loop, wait for its engine thread to let go, drop the
    engine's tensors and collect: the memory is free when this returns.
    An embedder (no loop) drops its weights."""
    if m.loop is None:
        if m.embedder is not None:
            m.embedder.params = None
            if hasattr(m.embedder, "vparams"):
                m.embedder.vparams = None
            release_device_memory()
        return
    m.loop.stop(join=True)
    if not m.loop.stopped:
        # the thread may still touch the engine: leave its tensors be
        log.warning("engine '%s' did not stop; its memory stays held",
                    m.name)
        return
    m.loop.engine.release()
    if m.vision is not None:
        m.vision.vparams = None
    release_device_memory()


@dataclasses.dataclass
class Resident:
    model: ServedModel
    bytes: int
    last_used: float
    loads: int = 0


class ResidencyManager:
    """A ModelRegistry whose ``get`` faults models in against a budget."""

    def __init__(
        self,
        hbm_budget_bytes: int,
        build: Callable[[str], ServedModel],
        estimate: Optional[Callable[[str], int]] = None,
        measure: Callable[[ServedModel], int] = served_model_bytes,
    ):
        """``estimate(name)`` predicts a model's footprint BEFORE building
        it so eviction happens first (mandatory on the card: build-then-
        evict would hold both models at once).  Without it, acquire
        builds first and measures (fine on the CPU and in tests)."""
        self.budget = hbm_budget_bytes
        self._build = build
        self._estimate = estimate
        self._measure = measure
        self._resident: dict[str, Resident] = {}
        self._known: set = set()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._loading: set = set()
        self._load_errors: dict[str, BaseException] = {}
        # bytes held for in-flight prefetches so concurrent acquires can't
        # claim the headroom the prefetch just evicted for
        self._reserved: dict[str, int] = {}
        # metrics
        self.evictions = 0
        self.loads = 0
        # model -> last acquire stall / build duration, in seconds
        self.swap_seconds: dict[str, float] = {}
        self.load_seconds: dict[str, float] = {}

    # -- registry-compatible surface --------------------------------------
    def register_name(self, name: str) -> None:
        self._known.add(name)

    def names(self) -> list:
        return sorted(self._known)

    def resident_names(self) -> list:
        return sorted(self._resident)

    def get(self, name: str) -> Optional[ServedModel]:
        if name not in self._known:
            return None
        return self.acquire(name)

    def list(self) -> list:
        with self._lock:
            return [r.model for _, r in sorted(self._resident.items())]

    def used_bytes(self) -> int:
        with self._lock:
            return self.used_bytes_locked()

    def stats(self) -> dict:
        """Consistent snapshot; used_bytes includes in-flight prefetch
        reservations, the number admission actually sees."""
        with self._lock:
            return {
                "loads": self.loads,
                "evictions": self.evictions,
                "used_bytes": self.used_bytes_locked(),
                "budget_bytes": self.budget,
                "swap_seconds": dict(self.swap_seconds),
                "load_seconds": dict(self.load_seconds),
            }

    # -- residency ----------------------------------------------------------
    def _is_idle(self, r: Resident) -> bool:
        loop = r.model.loop
        if loop is None:
            return True
        return not loop.engine.has_work()

    def _evict_until_fits(self, need: int) -> bool:
        """Evict LRU idle models until ``need`` bytes fit. Lock held."""
        while self.used_bytes_locked() + need > self.budget:
            victims = [r for r in self._resident.values()
                       if self._is_idle(r)]
            if not victims:
                return False
            victim = min(victims, key=lambda r: r.last_used)
            self._evict(victim.model.name)
        return True

    def used_bytes_locked(self) -> int:
        return sum(r.bytes for r in self._resident.values()) + sum(
            self._reserved.values()
        )

    def _evict(self, name: str) -> None:
        r = self._resident.pop(name, None)
        if r is None:
            return
        release_served_model(r.model)
        self.evictions += 1

    def prefetch(self, name: str) -> bool:
        """Stage ``name`` in the background so the NEXT acquire is
        (near-)free: evict idle models for headroom now, build on a
        daemon thread, publish as resident on completion.  Busy models
        are never evicted.

        Returns False when overlap is impossible: unknown name, or the
        headroom cannot be freed without evicting a busy model (the next
        ``acquire`` then does the synchronous swap)."""
        with self._lock:
            r = self._resident.get(name)
            if r is not None:
                # already warm: refresh its LRU standing
                r.last_used = time.monotonic()
                return True
            if name not in self._known or name in self._loading:
                return name in self._loading
            if self._estimate is not None:
                need = self._estimate(name)
                if not self._evict_until_fits(need):
                    return False
                self._reserved[name] = need
            self._loading.add(name)
            self._load_errors.pop(name, None)

        def run():
            t0 = time.monotonic()
            try:
                model = self._build(name)
                need = self._measure(model)
                ok = False
                with self._lock:
                    self._reserved.pop(name, None)
                    # measured > estimated: make room, idle victims only
                    ok = self._evict_until_fits(need)
                    if ok:
                        self._resident[name] = Resident(
                            model=model, bytes=need,
                            last_used=time.monotonic(), loads=1,
                        )
                        self.loads += 1
                        self.load_seconds[name] = time.monotonic() - t0
                if not ok:
                    release_served_model(model)
                    raise MemoryError(
                        f"prefetched model '{name}' ({need >> 20} MiB) no "
                        f"longer fits: resident models busy"
                    )
            except BaseException as e:  # noqa: BLE001 — delivered to waiters
                with self._lock:
                    self._load_errors[name] = e
            finally:
                with self._lock:
                    self._reserved.pop(name, None)
                    self._loading.discard(name)
                    self._cond.notify_all()

        threading.Thread(
            target=run, name=f"helix-torch-prefetch-{name}", daemon=True
        ).start()
        return True

    def acquire(self, name: str) -> ServedModel:
        t_enter = time.monotonic()
        with self._lock:
            # a prefetch in flight for this name: wait for it instead of
            # double-building (the wait IS the swap latency)
            waited = False
            while name in self._loading:
                waited = True
                self._cond.wait(timeout=0.5)
            err = self._load_errors.pop(name, None)
            if err is not None:
                if waited:
                    raise err
                # stale failure from an unattended prefetch: a fresh
                # build may well succeed now
                log.warning("dropping stale prefetch failure for %s: %s",
                            name, err)
            r = self._resident.get(name)
            if r is not None:
                r.last_used = time.monotonic()
                self.swap_seconds[name] = time.monotonic() - t_enter
                return r.model
            if self._estimate is not None:
                # device path: predict the footprint, evict FIRST, build
                need = self._estimate(name)
                if not self._evict_until_fits(need):
                    raise MemoryError(
                        f"cannot fit model '{name}' ({need >> 20} MiB) in "
                        f"HBM budget {self.budget >> 20} MiB: all resident "
                        f"models busy"
                    )
                model = self._build(name)
                need = max(need, self._measure(model))
            else:
                # host/test path: build first, measure exactly, then evict
                model = self._build(name)
                need = self._measure(model)
                if not self._evict_until_fits(need):
                    release_served_model(model)
                    raise MemoryError(
                        f"cannot fit model '{name}' ({need >> 20} MiB) in "
                        f"HBM budget {self.budget >> 20} MiB: all resident "
                        f"models busy"
                    )
            self._resident[name] = Resident(
                model=model, bytes=need, last_used=time.monotonic(), loads=1
            )
            self.loads += 1
            # synchronous swap: the requesting call stalled for the whole
            # build, the latency prefetch() exists to hide
            swap = time.monotonic() - t_enter
            self.swap_seconds[name] = swap
            self.load_seconds[name] = swap
            return model

    def evict(self, name: str) -> None:
        with self._lock:
            self._evict(name)

    def touch(self, name: str) -> None:
        with self._lock:
            r = self._resident.get(name)
            if r:
                r.last_used = time.monotonic()
