"""Multi-LoRA adapter serving: residency tiers and the device pool.

Port of ``helix_tpu/engine/adapters.py``.  One resident base model serves
many LoRA adapters at once: requests address ``model@adapter``, every row
of a device step carries its adapter's pool slot, and every targeted
projection adds ``scale[g] * (x @ A[g]) @ B[g]`` per token from a stacked
pool (``ops.quant.maybe_dequant_dense``), so a mixed-adapter wave packs
one device call.

Residency, as in the reference:

- :class:`AdapterPool`, the device rung: fixed-capacity stacked slot
  tensors per LoRA target on the engine's device.  Slot 0 is the zero
  identity adapter (zero factors at scale 0), so adapter-free rows add an
  exact ``+0.0``.  Loading writes one slot in place (same shapes, on the
  engine thread's stream, so it is ordered after every step already
  queued and needs no synchronising call); LRU over refcount-0 slots.
- :class:`AdapterStore`, the host rung: a byte-budgeted LRU of decoded
  host specs over an optional filestore rung (checksummed ``.npz`` blobs
  in the reference's layout, so either package reads a blob the other
  wrote), with a prefetch worker kicked at admission so a cold adapter
  loads during its queue wait and never stalls an engine step.

The pool's ``a`` factors are stored ``[L, in, N, r]`` (the reference's
are ``[L, N, in, r]``): a layer's ``[in, N, r]`` slice is then a view of
``[in, N * r]``, the operand of the first of the pool's two dense GEMMs,
with no copy per projection.  ``b`` is ``[L, N, r, out]`` as in the
reference.

``AdapterStore.publish_checkpoint`` publishes a LoRA training checkpoint
(``training.checkpoint``, the port's torch-native format, as ``python -m
helix_tpu_torch sft --output`` writes it): train, publish, serve without
a restart.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import logging
import os
import re
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from helix_tpu_torch.device import resolve_device, torch_dtype

log = logging.getLogger(__name__)

# ``model@adapter`` addressing: the separator and the adapter-id shape.
# Ids are bounded and character-restricted before they can mint a metrics
# label or become a filestore path component: no leading dot, no path
# separators, bounded length.
ADAPTER_SEP = "@"
MAX_ADAPTER_ID_LEN = 64
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# bound on /v1/models listings of published adapters
MAX_LISTED_ADAPTERS = 32

# per-adapter accounting is top-K bounded: the K most recently active
# adapters keep their own count, the rest fold into __other__
ADAPTER_TOP_K = 8
OTHER_ADAPTER = "__other__"

# bound on the heartbeat's adapter-residency block
MAX_RESIDENCY_ENTRIES = 128


def sanitize_adapter_id(value) -> str:
    """Bound a caller-supplied adapter id to the shapes that may mint a
    metrics label or a filestore path component.  Returns "" for
    anything hostile (too long, path-ish, wrong charset, a claim on the
    ``__other__`` fold bucket)."""
    if not isinstance(value, str):
        return ""
    v = value.strip()
    if not v or len(v) > MAX_ADAPTER_ID_LEN or v == OTHER_ADAPTER:
        return ""
    if not _ID_RE.match(v):
        return ""
    return v


def split_model_adapter(name) -> tuple:
    """``"base@adapter"`` -> ``(base, adapter_id, ok)``.

    ``ok`` is False when an ``@`` was present but the adapter id failed
    sanitisation (the caller answers 404, never passes the raw value
    on).  A plain model name returns ``(name, "", True)``."""
    if not isinstance(name, str) or ADAPTER_SEP not in name:
        return name, "", True
    base, _, raw = name.partition(ADAPTER_SEP)
    adapter = sanitize_adapter_id(raw)
    return base, adapter, bool(adapter)


def adapter_prefetch_enabled() -> bool:
    """HELIX_ADAPTER_PREFETCH: 0/false forces synchronous tier loads;
    default on (cold adapters load on a background worker)."""
    v = os.environ.get("HELIX_ADAPTER_PREFETCH", "").strip().lower()
    return v not in ("0", "false", "no", "off")


def adapter_host_pool_bytes(default: int = 256 * 1024 * 1024) -> int:
    """HELIX_ADAPTER_HOST_POOL_BYTES: byte budget of the host rung.
    Default 256 MiB; 0 = unbounded."""
    v = os.environ.get("HELIX_ADAPTER_HOST_POOL_BYTES", "").strip()
    if not v:
        return default
    return int(v)


def adapter_pool_slots_env() -> Optional[int]:
    """HELIX_ADAPTER_POOL_SLOTS: the node operator's override of every
    engine's ``adapter_pool_slots`` (0 turns the pool off).  None = unset,
    the profile applies."""
    v = os.environ.get("HELIX_ADAPTER_POOL_SLOTS", "").strip()
    if not v:
        return None
    return max(0, int(v))


def target_dims(cfg) -> dict:
    """``{target: (fan_in, fan_out)}`` of every LoRA-targetable projection
    of a model config (a copy of ``helix_tpu/training/lora.py``
    ``_target_dims``)."""
    E, H, KVH, D, F = (
        cfg.hidden_size,
        cfg.num_heads,
        cfg.num_kv_heads,
        cfg.head_dim,
        cfg.intermediate_size,
    )
    dims = {
        "wq": (E, H * D),
        "wk": (E, KVH * D),
        "wv": (E, KVH * D),
        "wo": (H * D, E),
        "w_gate": (E, F),
        "w_up": (E, F),
        "w_down": (F, E),
    }
    if cfg.num_experts > 0:
        # MoE replaces the dense FFN: attention targets only
        for t in ("w_gate", "w_up", "w_down"):
            del dims[t]
    return dims


# ---------------------------------------------------------------------------
# adapter specs (host representation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdapterSpec:
    """One published adapter, decoded to host numpy: per-target stacked
    ``a [L, fan_in, r]`` / ``b [L, r, fan_out]`` factors (f32) plus the
    serving scale (alpha/rank)."""

    adapter_id: str
    rank: int
    scale: float
    targets: dict                 # {target: {"a": np, "b": np}}
    checksum: str = ""

    @property
    def nbytes(self) -> int:
        return sum(
            int(f["a"].nbytes) + int(f["b"].nbytes)
            for f in self.targets.values()
        )


def pack_lora_tree(adapter_id: str, lora_params: dict,
                   scaling: float) -> AdapterSpec:
    """A training-side LoRA tree (``{target: {lora_a [L, in, r], lora_b
    [L, r, out]}}``, numpy arrays or tensors) as an :class:`AdapterSpec`."""
    targets = {}
    rank = 0
    for t, lp in lora_params.items():
        a = _f32(lp["lora_a"])
        b = _f32(lp["lora_b"])
        if a.ndim != 3 or b.ndim != 3 or a.shape[-1] != b.shape[-2]:
            raise ValueError(
                f"adapter {adapter_id!r}: target {t!r} factors have "
                f"incompatible shapes {a.shape} x {b.shape}"
            )
        rank = max(rank, a.shape[-1])
        targets[t] = {"a": a, "b": b}
    if not targets:
        raise ValueError(f"adapter {adapter_id!r}: no LoRA targets")
    return AdapterSpec(
        adapter_id=adapter_id, rank=rank, scale=float(scaling),
        targets=targets,
    )


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _spec_checksum(spec: AdapterSpec) -> str:
    """blake2b-16 over the spec's geometry and its factors' bytes, byte
    for byte the reference's digest."""
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(
        {"rank": spec.rank, "scale": spec.scale,
         "targets": sorted(spec.targets)}, sort_keys=True,
    ).encode())
    for t in sorted(spec.targets):
        h.update(np.ascontiguousarray(spec.targets[t]["a"]).tobytes())
        h.update(np.ascontiguousarray(spec.targets[t]["b"]).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# AdapterStore: host rung + persistent filestore rung, async prefetch
# ---------------------------------------------------------------------------


class AdapterStore:
    """Published adapters for ONE base model: a byte-budgeted host LRU
    of decoded :class:`AdapterSpec` trees over an optional checksummed
    filestore directory (the persistent rung, shared by every runner on
    the filesystem).

    Thread-safe: publish threads, the prefetch worker and the engine
    thread all go through one lock.  ``prefetch`` never blocks the
    caller; ``ready`` is the engine's admission gate."""

    def __init__(self, model_name: str, dims: dict, num_layers: int,
                 rank_cap: int, host_budget_bytes: Optional[int] = None,
                 root_dir: str = "", prefetch: Optional[bool] = None):
        self.model_name = model_name
        self.dims = dict(dims)          # {target: (fan_in, fan_out)}
        self.num_layers = int(num_layers)
        self.rank_cap = int(rank_cap)
        self.budget_bytes = (
            adapter_host_pool_bytes() if host_budget_bytes is None
            else int(host_budget_bytes)
        )
        self.root = root_dir or ""
        if self.root:
            os.makedirs(self.root, exist_ok=True)
        self._prefetch_on = (
            adapter_prefetch_enabled() if prefetch is None else bool(prefetch)
        )
        self._lock = threading.Lock()
        self._host: "collections.OrderedDict[str, AdapterSpec]" = (
            collections.OrderedDict()
        )
        self._host_bytes = 0
        # per-id publish generation, bumped by every explicit publish (not
        # by blob reads, which restore the same content): the pool reloads
        # a slot loaded from an older generation
        self._gens: dict = {}
        # ids known to have a filestore blob: host-LRU eviction checks
        # this set, never the filesystem (no I/O under the lock)
        self._blob_backed: set = set()
        self._inflight: set = set()      # ids with a prefetch in flight
        self._worker: Optional[threading.Thread] = None
        self._queue: "collections.deque" = collections.deque()
        self._wake = threading.Event()
        self.publishes = 0
        self.prefetches = 0
        self.host_evictions = 0
        self.load_errors = 0

    # -- publish -----------------------------------------------------------

    def validate_spec(self, spec: AdapterSpec) -> Optional[str]:
        """None when the spec fits this base model's geometry, else the
        reason (an HTTP 400 at the publish endpoint)."""
        if spec.rank > self.rank_cap:
            return (
                f"adapter rank {spec.rank} exceeds the pool rank cap "
                f"{self.rank_cap} (EngineConfig.adapter_rank)"
            )
        for t, f in spec.targets.items():
            want = self.dims.get(t)
            if want is None:
                return (
                    f"target {t!r} is not servable by the batched pool "
                    f"for {self.model_name!r} (pool targets: "
                    f"{sorted(self.dims)})"
                )
            a, b = f["a"], f["b"]
            if a.shape[0] != self.num_layers or (
                a.shape[1], b.shape[2]
            ) != want:
                return (
                    f"target {t!r} factors {a.shape} x {b.shape} do not "
                    f"match model dims L={self.num_layers}, "
                    f"(in, out)={want}"
                )
        return None

    def publish(self, spec: AdapterSpec, persist: bool = True) -> None:
        """Admit a validated spec to the host rung (and write it through
        to the filestore rung when one is configured): servable at once,
        with no restart."""
        if sanitize_adapter_id(spec.adapter_id) != spec.adapter_id:
            # enforced at the store: the id is about to become a
            # filestore path component
            raise ValueError(
                f"adapter id {spec.adapter_id!r} failed sanitisation "
                "(bounded [A-Za-z0-9._-], no leading dot)"
            )
        err = self.validate_spec(spec)
        if err:
            raise ValueError(err)
        if not spec.checksum:
            spec.checksum = _spec_checksum(spec)
        persisted = False
        if persist and self.root:
            self._write_blob(spec)
            persisted = True
        with self._lock:
            if persisted:
                self._blob_backed.add(spec.adapter_id)
            self._install(spec)
            self._gens[spec.adapter_id] = (
                self._gens.get(spec.adapter_id, 0) + 1
            )
        self.publishes += 1

    def publish_checkpoint(self, adapter_id: str, ckpt_dir: str,
                           scale: Optional[float] = None) -> AdapterSpec:
        """Publish a LoRA SFT checkpoint (the latest step under
        ``ckpt_dir``): restore, pack, validate, admit.  The scale is
        ``scale``, else the checkpoint's ``lora_scaling`` (1.0 when that is
        0).  ``FileNotFoundError`` when there is no checkpoint there,
        ``ValueError`` when it is not a LoRA checkpoint or does not fit
        this model."""
        from helix_tpu_torch.training.checkpoint import restore_adapter

        lora, scaling = restore_adapter(ckpt_dir, scale)
        spec = pack_lora_tree(adapter_id, lora, scaling)
        self.publish(spec)
        return spec

    # -- host rung ---------------------------------------------------------

    def _install(self, spec: AdapterSpec) -> None:
        """Lock must be held."""
        old = self._host.pop(spec.adapter_id, None)
        if old is not None:
            self._host_bytes -= old.nbytes
        self._host[spec.adapter_id] = spec
        self._host_bytes += spec.nbytes
        if self.budget_bytes > 0:
            # LRU-evict host copies past the budget, only those the
            # filestore rung can reload: an unpersisted adapter's only
            # copy is never dropped
            for aid in list(self._host):
                if self._host_bytes <= self.budget_bytes:
                    break
                if aid == spec.adapter_id or aid not in self._blob_backed:
                    continue
                victim = self._host.pop(aid)
                self._host_bytes -= victim.nbytes
                self.host_evictions += 1

    def generation(self, adapter_id: str) -> int:
        """Publish generation of an adapter (0 = never explicitly
        published in this process, e.g. restored from a blob)."""
        with self._lock:
            return self._gens.get(adapter_id, 0)

    def ready(self, adapter_id: str) -> bool:
        """Host-resident (a pool load can proceed this step)."""
        with self._lock:
            return adapter_id in self._host

    def contains(self, adapter_id: str) -> bool:
        """Published on any rung (host, an in-flight prefetch, or the
        filestore); the in-memory checks come first."""
        with self._lock:
            if adapter_id in self._host or adapter_id in self._inflight:
                return True
        return self._has_blob(adapter_id)

    def get_resident(self, adapter_id: str) -> Optional[AdapterSpec]:
        """Host-rung hit or None, with no disk I/O: the engine thread's
        pool-load lookup (a cold adapter defers to the prefetch)."""
        with self._lock:
            spec = self._host.get(adapter_id)
            if spec is not None:
                self._host.move_to_end(adapter_id)
            return spec

    def get(self, adapter_id: str) -> Optional[AdapterSpec]:
        """Host hit, or a synchronous filestore load."""
        spec = self.get_resident(adapter_id)
        if spec is not None:
            return spec
        spec = self._read_blob(adapter_id)
        if spec is not None:
            with self._lock:
                self._blob_backed.add(adapter_id)
                self._install(spec)
        return spec

    def ids(self, bound: int = MAX_LISTED_ADAPTERS) -> list:
        """Published adapter ids across rungs, sorted, bounded (the
        /v1/models listing)."""
        with self._lock:
            out = set(self._host)
        if self.root:
            try:
                for fn in os.listdir(self.root):
                    if fn.endswith(".npz"):
                        aid = sanitize_adapter_id(fn[:-4])
                        if aid:
                            out.add(aid)
            except OSError:
                pass
        return sorted(out)[:bound]

    # -- async prefetch ----------------------------------------------------

    def prefetch(self, adapter_id: str) -> bool:
        """Kick a filestore -> host load on the background worker and
        return at once (True when the adapter is or may become
        host-resident).  No filesystem I/O on the caller's thread; with
        prefetch off (HELIX_ADAPTER_PREFETCH=0) the load runs inline."""
        with self._lock:
            if adapter_id in self._host:
                return True
            if adapter_id in self._inflight:
                return True
        if not self.root:
            return False
        if not self._prefetch_on:
            return self.get(adapter_id) is not None
        with self._lock:
            if adapter_id in self._inflight:
                return True
            self._inflight.add(adapter_id)
            self._queue.append(adapter_id)
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._prefetch_loop,
                    name="adapter-prefetch", daemon=True,
                )
                self._worker.start()
        self._wake.set()
        self.prefetches += 1
        return True

    def _prefetch_loop(self) -> None:
        while True:
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    aid = self._queue.popleft()
                try:
                    spec = self._read_blob(aid)
                    if spec is not None:
                        with self._lock:
                            self._blob_backed.add(aid)
                            self._install(spec)
                except Exception:  # noqa: BLE001 — the tier degrades, never dies
                    self.load_errors += 1
                    log.exception("adapter prefetch failed for %s", aid)
                finally:
                    with self._lock:
                        self._inflight.discard(aid)

    # -- filestore rung ----------------------------------------------------

    def _blob_path(self, adapter_id: str) -> str:
        return os.path.join(self.root, f"{adapter_id}.npz")

    def _has_blob(self, adapter_id: str) -> bool:
        return bool(self.root) and os.path.isfile(
            self._blob_path(adapter_id)
        )

    def _write_blob(self, spec: AdapterSpec) -> None:
        arrays = {}
        for t, f in spec.targets.items():
            arrays[f"a__{t}"] = f["a"]
            arrays[f"b__{t}"] = f["b"]
        meta = json.dumps({
            "adapter_id": spec.adapter_id, "rank": spec.rank,
            "scale": spec.scale, "checksum": spec.checksum,
            "model": self.model_name,
        })
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(
            meta.encode(), dtype=np.uint8
        ), **arrays)
        path = self._blob_path(spec.adapter_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)

    def _read_blob(self, adapter_id: str) -> Optional[AdapterSpec]:
        if not self._has_blob(adapter_id):
            return None
        try:
            # allow_pickle stays off: a blob holds plain arrays only
            with np.load(self._blob_path(adapter_id)) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                targets = {}
                for k in z.files:
                    if k.startswith("a__"):
                        t = k[3:]
                        targets[t] = {
                            "a": z[f"a__{t}"], "b": z[f"b__{t}"],
                        }
            spec = AdapterSpec(
                adapter_id=adapter_id, rank=int(meta["rank"]),
                scale=float(meta["scale"]), targets=targets,
                checksum=str(meta.get("checksum", "")),
            )
            # the checksum is verified before the spec can reach a pool
            # slot: a corrupt blob is a miss, never wrong weights
            if spec.checksum and _spec_checksum(spec) != spec.checksum:
                self.load_errors += 1
                log.warning(
                    "dropping corrupt adapter blob %s (checksum "
                    "mismatch)", adapter_id,
                )
                return None
            if self.validate_spec(spec) is not None:
                self.load_errors += 1
                return None
            return spec
        except Exception:  # noqa: BLE001 — a bad blob is a miss, not a crash
            self.load_errors += 1
            log.exception("unreadable adapter blob %s", adapter_id)
            return None

    def stats(self) -> dict:
        with self._lock:
            resident = len(self._host)
            used = self._host_bytes
        return {
            "host_resident": resident,
            "host_used_bytes": used,
            "host_budget_bytes": self.budget_bytes,
            "publishes": self.publishes,
            "prefetches": self.prefetches,
            "host_evictions": self.host_evictions,
            "load_errors": self.load_errors,
        }


def default_adapter_store(model_cfg, engine_cfg) -> AdapterStore:
    """The store an Engine builds for itself when the pool is on:
    geometry from the model config, host budget and prefetch from the
    environment, and the persistent rung under
    ``HELIX_FILESTORE_KV_DIR/adapters/<model>`` when that is set."""
    dims = target_dims(model_cfg)
    targets = tuple(
        t for t in engine_cfg.adapter_targets if t in dims
    )
    root = ""
    fs = os.environ.get("HELIX_FILESTORE_KV_DIR", "")
    if fs:
        ns = re.sub(r"[^A-Za-z0-9._-]", "_", model_cfg.name or "model")
        root = os.path.join(fs, "adapters", ns)
    return AdapterStore(
        model_cfg.name or "model",
        {t: dims[t] for t in targets},
        model_cfg.num_layers,
        engine_cfg.adapter_rank,
        root_dir=root,
    )


# ---------------------------------------------------------------------------
# AdapterPool: the device rung (stacked slots grafted into every step)
# ---------------------------------------------------------------------------


class AdapterPool:
    """Fixed-capacity device-resident adapter slots for one engine.

    Per LoRA target: ``a [L, fan_in, N, R]`` and ``b [L, N, R, fan_out]``
    in the model dtype, and one shared per-slot scale ``[L, N]`` f32.
    Slot 0 is the identity (zero factors, zero scale).  Loading writes one
    slot of each tensor in place; slots are LRU over refcount-0 entries,
    and an engine holds one ref per live request (admission to finish,
    parked requests included), so an adapter in use is never evicted."""

    def __init__(self, model_cfg, targets: tuple, rank: int, slots: int,
                 dtype=None, device="cuda"):
        if slots < 2:
            raise ValueError(
                f"adapter_pool_slots ({slots}) must be >= 2 (slot 0 is "
                "the reserved identity adapter)"
            )
        dims = target_dims(model_cfg)
        self.targets = tuple(t for t in targets if t in dims)
        if not self.targets:
            raise ValueError(
                f"no usable adapter targets in {targets} for "
                f"{model_cfg.name}"
            )
        self.rank = int(rank)
        self.slots = int(slots)
        self.device = resolve_device(device)
        L = model_cfg.num_layers
        dt = torch_dtype(dtype or torch.float32)
        self._a = {
            t: torch.zeros((L, dims[t][0], self.slots, self.rank),
                           dtype=dt, device=self.device)
            for t in self.targets
        }
        self._b = {
            t: torch.zeros((L, self.slots, self.rank, dims[t][1]),
                           dtype=dt, device=self.device)
            for t in self.targets
        }
        self._scale = torch.zeros((L, self.slots), dtype=torch.float32,
                                  device=self.device)
        self._slot_of: dict = {}        # adapter id -> slot index
        self._lru: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict()
        )
        self._refs: dict = {}           # adapter id -> live request count
        self._gen_loaded: dict = {}     # adapter id -> publish generation
        self._sum_loaded: dict = {}     # adapter id -> checksum of the load
        self.version = 0                # bumps per load/evict (graft cache)
        self.loads = 0
        self.evictions = 0
        self.load_seconds = 0.0
        # bounded per-adapter activity (rows applied in device steps):
        # top-K most recently active + __other__, totals conserved
        self._rows: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._rows_other = 0
        self.rows_applied_total = 0
        self._lock = threading.Lock()

    # -- graft surface (engine dispatch path) ------------------------------

    def entries(self) -> dict:
        """Per-target pool entries to merge into ``params["layers"]``:
        the forward slices the leading L dim like the base weights, and
        ``maybe_dequant_dense`` picks the ``lora_pool_*`` keys up."""
        return {
            t: {
                "lora_pool_a": self._a[t],
                "lora_pool_b": self._b[t],
                "lora_pool_scale": self._scale,
            }
            for t in self.targets
        }

    def hbm_bytes(self) -> int:
        """Device bytes of the factor stacks (the reference's count: the
        ``[L, N]`` scales are left out)."""
        return sum(
            a.numel() * a.element_size() for a in self._a.values()
        ) + sum(b.numel() * b.element_size() for b in self._b.values())

    # -- residency ---------------------------------------------------------

    def resident(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._slot_of

    def resident_ids(self) -> list:
        with self._lock:
            return sorted(self._slot_of)

    def slot_for(self, adapter_id: str) -> Optional[int]:
        with self._lock:
            return self._slot_of.get(adapter_id)

    def checksum_of(self, adapter_id: str) -> str:
        """``_spec_checksum`` of the weights the adapter's slot holds
        ("" when it is not resident): the prefix cache keys an adapter
        row's pages by it."""
        with self._lock:
            return self._sum_loaded.get(adapter_id, "")

    def acquire(self, adapter_id: str,
                lookup: Callable[[str], Optional[AdapterSpec]],
                generation: Optional[int] = None) -> Optional[int]:
        """Pin ``adapter_id`` into a slot for one request.

        Resident: refcount + 1 and return the slot.  Host-ready
        (``lookup`` yields a spec): load into a free or LRU refcount-0
        slot.  Otherwise None: the caller defers admission.

        ``generation`` is the store's publish generation: a resident slot
        loaded from an older generation reloads in place when no live
        request pins it; pinned slots keep serving the weights their live
        rows were conditioned on until the refs drain."""
        with self._lock:
            slot = self._slot_of.get(adapter_id)
            if slot is not None:
                stale = (
                    generation is not None
                    and self._gen_loaded.get(adapter_id) != generation
                    and self._refs.get(adapter_id, 0) <= 0
                )
                if not stale:
                    self._refs[adapter_id] = (
                        self._refs.get(adapter_id, 0) + 1
                    )
                    self._lru.move_to_end(adapter_id)
                    return slot
        spec = lookup(adapter_id)
        if spec is None:
            return None
        with self._lock:
            slot = self._slot_of.get(adapter_id)
            refresh = slot is not None
            if refresh and (
                generation is None
                or self._gen_loaded.get(adapter_id) == generation
                or self._refs.get(adapter_id, 0) > 0
            ):
                # raced: another thread loaded or refreshed it already
                self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
                self._lru.move_to_end(adapter_id)
                return slot
            if not refresh:
                slot = self._free_slot_locked()
                if slot is None:
                    return None    # every slot pinned by live requests
            t0 = time.monotonic()
            self._load_locked(slot, spec)
            self.load_seconds += time.monotonic() - t0
            self._slot_of[adapter_id] = slot
            self._lru[adapter_id] = None
            self._lru.move_to_end(adapter_id)
            self._refs[adapter_id] = 1
            if generation is not None:
                self._gen_loaded[adapter_id] = generation
            self._sum_loaded[adapter_id] = (
                spec.checksum or _spec_checksum(spec))
            self.loads += 1
            self.version += 1
            return slot

    def release(self, adapter_id: str) -> None:
        with self._lock:
            n = self._refs.get(adapter_id, 0) - 1
            if n > 0:
                self._refs[adapter_id] = n
            else:
                self._refs.pop(adapter_id, None)

    def _free_slot_locked(self) -> Optional[int]:
        used = set(self._slot_of.values())
        for s in range(1, self.slots):   # slot 0 = identity, never used
            if s not in used:
                return s
        # LRU-evict a refcount-0 resident (its slot data stays until
        # overwritten; no live row carries its slot)
        for aid in list(self._lru):
            if self._refs.get(aid, 0) <= 0:
                s = self._slot_of.pop(aid)
                self._lru.pop(aid, None)
                self._gen_loaded.pop(aid, None)
                self._sum_loaded.pop(aid, None)
                self.evictions += 1
                self.version += 1
                return s
        return None

    def _load_locked(self, slot: int, spec: AdapterSpec) -> None:
        """Write ``spec`` into ``slot``, zero-padded to the pool rank: each
        factor is staged once in pinned memory and copied up without a
        synchronising call, then written in place on the current stream,
        behind every step already queued on it."""
        for t in self.targets:
            a, b = self._a[t], self._b[t]
            f = spec.targets.get(t)
            r = 0 if f is None else f["a"].shape[-1]
            if r < self.rank:
                # the padding (or a target the adapter leaves out) is 0
                a[:, :, slot].zero_()
                b[:, slot].zero_()
            if r:
                a[:, :, slot, :r].copy_(self._stage(f["a"]))
                b[:, slot, :r].copy_(self._stage(f["b"]))
        self._scale[:, slot] = float(spec.scale)

    def _stage(self, host: np.ndarray) -> torch.Tensor:
        """A host factor on the pool's device: one pinned copy and a
        queued upload on the card (the pinned block is not reused before
        the upload has run), the array itself on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- bounded per-adapter activity --------------------------------------

    def note_rows(self, counts: dict) -> None:
        """Bank device-step rows per adapter id (top-K + __other__,
        totals conserved)."""
        with self._lock:
            for aid, n in counts.items():
                n = int(n)
                if n <= 0:
                    continue
                self.rows_applied_total += n
                if aid in self._rows:
                    self._rows[aid] += n
                    self._rows.move_to_end(aid)
                elif len(self._rows) < ADAPTER_TOP_K:
                    self._rows[aid] = n
                    self._rows.move_to_end(aid)
                else:
                    # demote the stalest tracked adapter into __other__
                    old_id, old_n = self._rows.popitem(last=False)
                    self._rows_other += old_n
                    self._rows[aid] = n

    def rows_applied(self) -> dict:
        with self._lock:
            out = dict(self._rows)
            if self._rows_other:
                out[OTHER_ADAPTER] = self._rows_other
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "resident": len(self._slot_of),
                "pinned": sum(
                    1 for v in self._refs.values() if v > 0
                ),
                "loads": self.loads,
                "evictions": self.evictions,
                "load_seconds": round(self.load_seconds, 6),
                "rows_applied": self.rows_applied_total,
                "hbm_bytes": self.hbm_bytes(),
            }


def collect_adapter_metrics(c, loop, labels: dict) -> None:
    """Runner-side adapter series for one engine loop (the runner's
    scrape surface calls it; every ``helix_adapter_*`` name of the port
    is minted here).  No-op when the engine serves without a pool."""
    eng = loop.engine
    pool = eng.adapter_pool
    if pool is None:
        return
    st = pool.stats()
    c.gauge(
        "helix_adapter_pool_slots", st["slots"], labels,
        help="HBM adapter-pool slot capacity (slot 0 = identity)",
    )
    c.gauge(
        "helix_adapter_resident", st["resident"], labels,
        help="Adapters currently resident in the HBM pool",
    )
    c.gauge(
        "helix_adapter_pool_bytes", st["hbm_bytes"], labels,
        help="HBM bytes held by the stacked adapter pool",
    )
    c.counter(
        "helix_adapter_loads_total", st["loads"], labels,
        help="Adapter loads into an HBM pool slot",
    )
    c.counter(
        "helix_adapter_evictions_total", st["evictions"], labels,
        help="LRU evictions of refcount-0 adapters from the HBM pool",
    )
    c.counter(
        "helix_adapter_load_seconds_total", st["load_seconds"], labels,
        help="Cumulative host->HBM adapter load time",
    )
    for aid, n in sorted(pool.rows_applied().items()):
        c.counter(
            "helix_adapter_rows_applied_total", n,
            {**labels, "adapter": aid},
            help="Device-step rows served per adapter (top-K bounded "
                 "+ __other__)",
        )
    store = eng.adapter_store
    if store is None:
        return
    sst = store.stats()
    c.counter(
        "helix_adapter_publishes_total", sst["publishes"], labels,
        help="Adapters published (train -> publish -> serve)",
    )
    c.counter(
        "helix_adapter_prefetches_total", sst["prefetches"], labels,
        help="Async filestore->host adapter prefetches kicked",
    )
    c.counter(
        "helix_adapter_host_evictions_total", sst["host_evictions"],
        labels,
        help="Host-tier adapter evictions (filestore-backed only)",
    )
    c.counter(
        "helix_adapter_load_errors_total", sst["load_errors"], labels,
        help="Corrupt/unreadable adapter blobs dropped at load",
    )
    c.gauge(
        "helix_adapter_host_pool_used_bytes", sst["host_used_bytes"],
        labels,
        help="Host-tier bytes held by decoded adapter trees",
    )
    c.gauge(
        "helix_adapter_host_pool_budget_bytes",
        sst["host_budget_bytes"], labels,
        help="Host-tier adapter byte budget "
             "(HELIX_ADAPTER_HOST_POOL_BYTES)",
    )


def adapter_residency_summary(models) -> list:
    """The heartbeat's adapter-residency block: bounded, sorted
    ``model@adapter`` ids resident in any live engine's device pool (the
    control plane's adapter-affinity signal).  ``models``: the node
    agent's lock-free live-model snapshot."""
    out = []
    for m in models:
        loop = getattr(m, "loop", None)
        pool = getattr(getattr(loop, "engine", None), "adapter_pool", None)
        if pool is None:
            continue
        name = getattr(m, "name", "")
        for aid in pool.resident_ids():
            out.append(f"{name}{ADAPTER_SEP}{aid}")
            if len(out) >= MAX_RESIDENCY_ENTRIES:
                return sorted(out)
    return sorted(out)
