"""The serving engine: continuous batching over a paged KV cache.

Port of the main path of ``helix_tpu/engine/engine.py`` to eager PyTorch.
One ``Engine`` owns one model's weights and page pool on one device and
exposes token-level ``add_request`` / ``step``.  Every device step is the
reference's unified ragged step (``_build_ragged_step_fn``), run as plain
code:

1. **Prefill segment** — one flat token axis of ragged rows padded to a
   token-bucket rung: cold packed prompts (no history: kernel K2, flash
   attention with segment ids), prefix-cache hits and chunk continuations
   (history: kernel K1, ragged paged attention).  One forward, one
   ``write_kv`` scatter, one batched first-token sample.
2. **State segment** — every decode slot as a ``W``-token row over its
   paged history (kernel K1): its last token plus up to ``W - 1``
   host-drafted speculative tokens (``draft_len`` of them; 0 = a plain
   decode step, -1 = the slot sits the call out).  ``W`` is
   ``spec_tokens + 1`` with speculative decoding on, else 1.  Every live
   position samples with the penalty histogram carried along the drafted
   prefix; the longest agreeing prefix is kept and positions, last token
   and histogram roll back on the device (the keys do not: a split is
   spent at every live position, as in the reference).
3. **Fused tail** — ``n_extra`` more plain decode steps before the one
   host fetch of the step (``decode_steps_per_sync``).

``step()`` is ``step_complete(step_dispatch())``.  The dispatch half
admits, builds metadata, uploads it (``device.upload``: pinned copies,
queued) and queues the device work and its one device-to-host copy
(``device.Fetch``) without a synchronising call; the completion waits for
that copy and does every host-visible effect.  ``serving.engine_loop``
dispatches step N+1 before completing step N when ``pipeline_ready()``
(plain decode steady state).  A chunk-final first token is not fetched on
its own: it rides the next decode or verify fetch (``_pending_first``).

Admission packs waiting short prompts into waves, long prompts prefill in
``max_prefill_len`` chunks, and while a chunk is in flight the mixed step
runs it together with every decode row in one call.  The page pool is
updated in place (the reference donates it to jit).

``kv_cache_dtype="int8"`` serves an int8 page pool with float32 scale
pools: ``write_kv`` quantizes on write and every history read goes
through K1's int8 form.  Params from ``ops.quant.quantize_params`` (int8
weights) serve through the same path.

``adapter_pool_slots >= 2`` serves multi-LoRA adapters
(``engine.adapters``): a request names its adapter (``Request.adapter``,
``model@adapter`` at the HTTP surface), admission pins it into a slot of
the engine's ``AdapterPool`` (a cold one defers while the store's
prefetch loads it), and every row of a device step carries its slot, so
a mixed-adapter wave is one call; adapter-free rows ride slot 0, the
zero identity.  An adapter row's prefix-cache pages are keyed by its
adapter's weights checksum, so no row reuses K/V that another adapter or
the base model prefilled.

``host_pool_bytes > 0`` puts a host-RAM tier (``HostPagePool``) under the
page pool: prefix-cache evictions spill there and restore into fresh
device pages when a later prompt chains onto them; ``preempt`` swaps a
decoder's private pages and sampler state out and ``_try_resume`` brings
it back exactly; ``export_request`` / ``import_request`` move a request
between engines (of either package) as a checksummed
``RequestSnapshot``; ``export_prefill`` is that export at the first
token, the disaggregated prefill handoff.  ``kv_filestore`` (a
``serving.kv_filestore.KVFilestore``, wired after construction) is the
rung below the host tier: fresh full prompt pages write through to disk
and a later prompt chaining onto them restores them from there, after a
restart too.

``ctx_hot_pages > 0`` (with a host tier) turns on tiered KV residency
for long contexts: a row needing more than ``ctx_hot_pages +
ctx_stream_pages`` pages past its cached prefix admits with only its
first dispatch's pages, grows its table step by step, and demotes every
full page behind its hot tail to the host tier (pinned, checksummed).
Each step stages the demoted middles of all tiered rows as one slab of
``ctx_stream_pages``-page chunks on the device (rebuilt whenever the
demoted spans change) and attends them through K1's cold form, so a
long chat holds about ``ctx_hot_pages`` pool pages.  A corrupt or
missing cold page raises ``ColdPageError``.  ``ctx_pin`` rows (context
cache creation) stay resident; a tiered row is neither preempted nor
exported.

An mrope model (the Qwen2-VL text tower, ``models.qwen2_vl``) serves
the reference's VL path: a request carries its spliced image embeddings
(``image_embeds`` at ``image_positions``), its three M-RoPE position
streams (``positions3``) and the decode offset ``mrope_delta``; its
prompt prefills alone in ONE bucketed call through K2 (``_prefill``:
never packed into a wave, never chunked, never from the prefix cache)
and its decode rows rotate by ``position + mrope_delta`` on all three
streams.  Speculation and the adapter pool are logged off for such a
model, tiered residency is refused, and a request with image state is
never exported.

A mixture-of-experts model (Mixtral, ``models.moe``) serves under the
reference's MoE rules: admission packs one request per prefill call (the
experts' capacity is shared by the call's tokens, so batch-mates would
perturb each other's routing), the prefill segment routes the tokens of
its bucket that are not padding (the capacity follows the bucket), the
state segment routes its live rows (decode is dropless), speculation is
logged off, and prefill capacity drops are queued as device scalars and
folded into ``moe_dropped_tokens`` where a fetch has already synced.
An adapter pool on such a model serves its attention targets.

``mesh`` (a ``device.mesh.Mesh`` of ``tp`` shards, the reference's
``Engine(mesh=...)``) serves tensor parallel on one host, one process
driving every shard: ``params`` is one tree per shard
(``parallel.sharding.shard_params``), the page pool holds each shard's
``KVH / n`` KV heads on its device (``PagedKVCache.create_sharded``),
every step runs each layer on every shard through
``models.llama.forward_sharded`` (K1 and K2 on each shard's heads, two
float32 sums per layer), the step's metadata is copied to every shard's
device, and the sampler runs on the first device on the gathered logits.
Page ids, the allocator and the prefix cache are those of one device.  A
mesh engine refuses by name what a later part of ROADMAP A15b serves
(``mesh_refusals``): axes other than ``tp``, speculation, the host tier,
tiered context, the adapter pool, MoE and mrope models, and export /
import.

Outside this slice, and refused loudly by ``Engine``: the multihost plan
plane (ROADMAP A15b).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from helix_tpu_torch.device import (
    DEFAULT_DEVICE,
    Fetch,
    resolve_device,
    torch_dtype,
    upload,
)
from helix_tpu_torch.engine.adapters import (
    AdapterPool,
    default_adapter_store,
    pack_lora_tree,
)
from helix_tpu_torch.engine.kv_cache import (
    PAGE_FIELDS,
    CacheConfig,
    ColdPageError,
    HostPagePool,
    PageAllocator,
    PagedKVCache,
    PrefixCache,
    gather_pages,
    page_checksum,
    restore_pages,
    slot_to_page_offset,
    write_kv,
)
from helix_tpu_torch.engine.ragged import (
    PrefillPlan,
    bucket_tokens,
    parse_token_buckets,
)
from helix_tpu_torch.engine.sampling import (
    SamplingParams,
    SamplingState,
    apply_penalties,
    sample,
    split_keys,
)
from helix_tpu_torch.engine.spec import SpecConfig, SpecDecoder
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import (
    forward,
    forward_sharded,
    project_logits,
    project_logits_sharded,
)
from helix_tpu_torch.obs.slo import ANON_TENANT
from helix_tpu_torch.ops.attention import attention
from helix_tpu_torch.ops.paged import ragged_paged_attention
from helix_tpu_torch.ops.quant import embed_lookup


class FinishReason(str, enum.Enum):
    STOP = "stop"
    LENGTH = "length"
    ABORT = "abort"


@dataclasses.dataclass
class Request:
    id: str
    prompt_tokens: list
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    stop_token_ids: tuple = ()
    # --- multimodal (VL models): image embeddings spliced at the prompt
    # indices image_positions, the M-RoPE streams [3, S] and the decode
    # offset of every stream past the prompt ---
    image_embeds: Optional[object] = None
    image_positions: Optional[list] = None
    positions3: Optional[object] = None
    mrope_delta: int = 0
    # mutable state
    output_tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    slot: Optional[int] = None
    max_len: Optional[int] = None   # page-capacity cap set at admission
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    admitted_time: Optional[float] = None
    first_token_time: Optional[float] = None
    trace_id: str = ""
    tenant: str = ANON_TENANT
    sched_class: str = ""
    adapter: str = ""
    cached_tokens: int = 0          # prompt tokens served by prefix cache
    preempt_count: int = 0
    ctx_pin: bool = False
    _page_hashes: Optional[list] = None

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's ``EngineConfig``: same fields, same defaults."""

    max_decode_batch: int = 8
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 128
    max_prefill_len: int = 2048
    max_model_len: Optional[int] = None
    # None: the hand-written kernels (plain versions on CPU tensors);
    # "reference": the plain versions on any device, for comparisons
    attn_backend: Optional[str] = None
    eos_token_ids: tuple = ()
    decode_steps_per_sync: int = 1
    adaptive_sync_max_streams: int = 2
    enable_prefix_cache: bool = True
    kv_cache_dtype: str = "auto"   # auto | bfloat16 | float32 | int8
    enable_mixed_step: bool = True
    enable_spec_decode: bool = False
    spec_tokens: int = 4
    enable_async_loop: bool = False
    adapter_pool_slots: int = 0
    adapter_rank: int = 16
    adapter_targets: tuple = ("wq", "wk", "wv", "wo")
    host_pool_bytes: int = 0
    ctx_hot_pages: int = 0
    ctx_stream_pages: int = 4

    def __post_init__(self):
        if self.enable_spec_decode and self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens ({self.spec_tokens}) must be >= 1 when "
                "enable_spec_decode is set"
            )
        if self.attn_backend not in (None, "reference"):
            raise ValueError(
                f"attn_backend {self.attn_backend!r}: expected None or "
                "'reference'"
            )

    def cache_config(self, dtype: str = "bfloat16") -> CacheConfig:
        kv_dtype = (
            dtype
            if self.kv_cache_dtype in ("auto", None, "")
            else self.kv_cache_dtype
        )
        return CacheConfig(
            num_pages=self.num_pages,
            page_size=self.page_size,
            max_pages_per_seq=self.max_pages_per_seq,
            dtype=kv_dtype,
        )


# ---------------------------------------------------------------------------
# Host-side key derivation, copied from the reference (engine.py:300-317)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_SEED_DOMAIN = 0xA076_1D64_78BD_642F  # seeded-request key domain


def _bucket(n: int, lo: int, hi: int) -> int:
    """The reference's prefill bucket: the power-of-two multiple of
    ``lo`` that holds ``n``, at most ``hi``."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E37_79B9_7F4A_7C15) & _M64
    z = ((x ^ (x >> 30)) * 0xBF58_476D_1CE4_E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D0_49BB_1331_11EB) & _M64
    return z ^ (z >> 31)


def _host_key(x: int) -> np.ndarray:
    """uint32[2] key data from a 64-bit state."""
    z = _splitmix64(x)
    return np.array([z >> 32, z & 0xFFFF_FFFF], np.uint32)


def _host_split(key: np.ndarray, n: int = 2) -> list:
    """Derive n child keys from a host key, deterministically."""
    base = (int(key[0]) << 32) | int(key[1])
    return [_host_key(base ^ (0xD6E8_FEB8_6659_FD93 * (i + 1))) for i in
            range(n)]


@dataclasses.dataclass
class DecodeState:
    """Device-resident per-slot decode state.  Steady-state decode uploads
    nothing: last tokens, positions and the output-token histogram advance
    on the device; the host re-syncs only when the slot set changes
    (``Engine._sync_state``), keeping surviving slots' histograms.  The
    per-slot sampling keys advance on the host (``Engine._dkeys``)."""

    last_token: torch.Tensor    # [B] i64
    positions: torch.Tensor     # [B] i64
    page_tables: torch.Tensor   # [B, maxP] i32
    active: torch.Tensor        # [B] i64
    token_counts: torch.Tensor  # [B, V] i32 — output-token histogram
    sampling: SamplingState
    adapter_slots: torch.Tensor  # [B] i64 — multi-LoRA pool slot (0 = none)
    mrope_delta: torch.Tensor   # [B] i64 — VL decode position offset


@dataclasses.dataclass
class PendingStep:
    """One dispatched-but-not-reconciled device step.

    ``step_dispatch`` queues the device work and returns one of these;
    ``step_complete`` waits for its ONE device-to-host copy (``fetch``,
    queued at dispatch) and does the bookkeeping (emits, stop conditions,
    slot frees).  ``rows`` snapshots the slot occupants at dispatch, so a
    completion that runs after the slot set changed never attributes
    tokens to a later occupant: a row whose slot no longer holds the same
    request discards its tokens, as a fused window's overrun does."""

    kind: str                   # "decode" | "spec" | "mixed"
    rows: list                  # [(slot_index, Request)] at dispatch
    fetch: Fetch                # the step's results, on their way to the host
    n: int = 1                  # fused window size (decode)
    n_extra: int = 0            # fused tail length (spec)
    draft_len: Optional[np.ndarray] = None   # [B] (spec)
    # deferred chunk-final first tokens: [(Request, [R] device tensor)],
    # copied in this step's fetch instead of their own
    pending_first: list = dataclasses.field(default_factory=list)
    st: Optional[dict] = None   # mixed: the in-flight chunking record
    final: bool = False         # mixed: this chunk completes the prompt


@dataclasses.dataclass
class PreemptedSeq:
    """A decoder swapped out to host RAM, parked for exact resume.

    Private page contents live in the host pool under ``("seq", req.id,
    table_pos)``, pinned against LRU; this record keeps what rebuilds the
    slot bit for bit: the table layout (shared prefix pages keep their
    device ids, their refcounts held while parked), the decode position,
    last token, the evolved sampling key and the output-token histogram.
    An imported snapshot carries its (already verified) pages inline in
    ``entries`` instead, so it parks on an engine without a host tier."""

    req: Request
    table: np.ndarray           # first n_pages entries of the page table
    private_pos: list           # table indices whose pages were spilled
    position: int
    last_token: int
    mrope_delta: int
    key: np.ndarray             # evolved per-slot key, [2] uint32
    counts: np.ndarray          # output-token histogram, [V] int32
    preempted_at: float = dataclasses.field(default_factory=time.monotonic)
    entries: Optional[list] = None


# ---------------------------------------------------------------------------
# portable request snapshots: export / migrate / import
# ---------------------------------------------------------------------------

SNAPSHOT_VERSION = 1


class SnapshotError(ValueError):
    """A snapshot that must not touch the engine: wrong version,
    incompatible KV geometry, or a failed page checksum.  ``code`` is the
    typed discriminator HTTP callers see."""

    def __init__(self, message: str, code: str = "snapshot_invalid"):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class RequestSnapshot:
    """One in-flight request as a portable object, field for field the
    reference's ``RequestSnapshot`` (so both packages' wire documents and
    meta checksums agree): prompt and emitted tokens, the evolved sampler
    state, the sequence's KV pages in their STORED representation (raw
    int8 codes + scales for int8 pools) with a blake2b checksum each, and
    the tenant / trace / class identity.  ``pages`` hold host buffers per
    field (torch tensors here, numpy arrays in the reference)."""

    version: int
    model: str
    request_id: str
    prompt_tokens: list
    output_tokens: list
    sampling: dict              # dataclasses.asdict(SamplingParams)
    stop_token_ids: list
    tenant: str
    trace_id: str
    sched_class: str
    max_len: Optional[int]
    preempt_count: int
    # None: the request never reached a slot (queued / mid-chunk) and
    # replays from the prompt
    position: Optional[int]
    last_token: Optional[int]
    mrope_delta: int
    key: Optional[list]         # evolved sampling key, two uint32 words
    token_counts: dict          # sparse {token_id: count} histogram
    page_size: int
    num_layers: int
    kv_heads: int
    head_dim: int
    kv_dtype: str
    pages: list                 # [{k, v, k_scale, v_scale}, ...]
    page_checksums: list        # blake2b hex digest per page
    # table capacity the importer allocates (>= len(pages)): only pages
    # holding written KV ship
    total_pages: int = 0
    adapter: str = ""

    @property
    def has_kv(self) -> bool:
        return self.position is not None and bool(self.pages)


def mesh_refusals(cfg: EngineConfig, model_cfg: ModelConfig,
                  mesh_spec) -> list:
    """What a mesh of ``mesh_spec`` (a ``MeshSpec``) cannot serve yet of
    this engine and model, each naming its ROADMAP item (empty: served).
    ``Engine`` raises them; the node checks a profile with them before
    anything is built."""
    out = []
    other = {a: n for a, n in mesh_spec.axis_sizes().items()
             if a != "tp" and n > 1}
    if other:
        out.append(f"mesh axes {other}: only tp is served on a mesh "
                   "(ROADMAP A15b: dp / fsdp / pp / ep / sp)")
    if mesh_spec.tp <= 1:
        return out
    if model_cfg.mrope_sections is not None:
        out.append("a vision (mrope) model on a mesh is not ported yet "
                   "(ROADMAP A15b: vision on a mesh)")
    if model_cfg.num_experts > 0:
        out.append("a mixture-of-experts model on a mesh is not ported "
                   "yet (ROADMAP A15b: MoE on a mesh)")
    if cfg.enable_spec_decode:
        out.append("speculative decoding on a mesh is not ported yet "
                   "(ROADMAP A15b: speculation on a mesh)")
    if cfg.host_pool_bytes > 0:
        out.append("the host KV tier on a mesh is not ported yet "
                   "(ROADMAP A15b: host tier and tiered context on a "
                   "mesh)")
    if cfg.ctx_hot_pages > 0:
        out.append("tiered context on a mesh is not ported yet (ROADMAP "
                   "A15b: host tier and tiered context on a mesh)")
    if cfg.adapter_pool_slots > 1:
        out.append("the adapter pool on a mesh is not ported yet "
                   "(ROADMAP A15b: adapters on a mesh)")
    for what, n in (("heads", model_cfg.num_heads),
                    ("KV heads", model_cfg.num_kv_heads),
                    ("FFN columns", model_cfg.intermediate_size),
                    ("vocabulary rows", model_cfg.vocab_size)):
        if n % mesh_spec.tp:
            out.append(f"{model_cfg.name}: {n} {what} do not divide "
                       f"over tp {mesh_spec.tp}")
    return out


_EXPORT_ON_MESH = ("export and import of requests on a mesh are not "
                   "ported yet (ROADMAP A15b: export / import on a mesh)")


class Engine:
    """Single-model serving engine on one device, or tensor parallel
    over the devices of one host (``mesh``)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params,
        cfg: EngineConfig,
        mesh=None,
        rng_seed: int = 0,
        *,
        device=DEFAULT_DEVICE,
    ):
        self.mesh = mesh
        if mesh is not None:
            why = mesh_refusals(cfg, model_cfg, mesh.spec)
            if why:
                raise NotImplementedError("; ".join(why))
            # the first shard's device takes the sampler, the step's
            # state and the host's uploads
            device = mesh.devices[0]
            if not isinstance(params, (list, tuple)) \
                    or len(params) != mesh.size:
                raise ValueError(
                    f"a mesh of {mesh.size} shards takes one parameter "
                    "tree per shard (parallel.sharding.shard_params)")
            for tree, dev in zip(params, mesh.devices):
                if tree["embed"]["weight"].device != torch.device(dev):
                    raise ValueError(
                        f"a shard's params live on "
                        f"{tree['embed']['weight'].device}, its mesh "
                        f"device is {dev}")
        self.device = resolve_device(device)
        if mesh is None:
            w = params["embed"]["weight"]
            if w.device.type != self.device.type:
                raise ValueError(
                    f"params live on {w.device}, engine device is "
                    f"{self.device}")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.params = params
        q, ps = cfg.max_prefill_len, cfg.page_size
        while q > ps and q % 2 == 0:
            q //= 2
        if q != ps:
            raise ValueError(
                f"max_prefill_len ({cfg.max_prefill_len}) must be "
                f"page_size ({ps}) times a power of two"
            )
        if cfg.kv_cache_dtype not in ("auto", None, "", "bfloat16", "float32",
                                      "int8"):
            raise ValueError(
                f"unsupported kv_cache_dtype {cfg.kv_cache_dtype!r}"
            )
        self.cache_cfg = cfg.cache_config(dtype=model_cfg.dtype)
        # one page pool per shard (one on one device)
        self.caches = ([PagedKVCache.create(model_cfg, self.cache_cfg,
                                            self.device)] if mesh is None
                       else PagedKVCache.create_sharded(
                           model_cfg, self.cache_cfg, mesh))
        self.allocator = PageAllocator(
            self.cache_cfg.num_pages, self.cache_cfg.max_pages_per_seq
        )
        B = cfg.max_decode_batch
        self.slots: list[Optional[Request]] = [None] * B
        self.waiting: list[Request] = []
        self._requests: dict[str, Request] = {}
        # host mirrors of device-visible per-slot state
        self._last_token = np.zeros((B,), np.int64)
        self._positions = np.zeros((B,), np.int64)
        self._page_tables = np.zeros(
            (B, self.cache_cfg.max_pages_per_seq), np.int32
        )
        self._mrope_delta = np.zeros((B,), np.int64)    # VL rows' offsets
        self._slot_keys = np.zeros((B, 2), np.uint32)   # admission carry keys
        self._dkeys = np.zeros((B, 2), np.uint32)       # evolving step keys
        self._active = np.zeros((B,), bool)             # as of the last sync
        self._state_dirty = True
        self._changed_slots: set[int] = set()
        self._dstate: Optional[DecodeState] = None
        self._chunking: Optional[dict] = None
        self.prefix_cache = PrefixCache() if cfg.enable_prefix_cache else None
        self._shared_pages: dict[str, list] = {}
        # host-RAM KV tier: spilled prefix pages + swapped-out decoders,
        # byte-budgeted; None = tier off (evictions free pages,
        # preemption unavailable)
        self.host_pool = (
            HostPagePool(cfg.host_pool_bytes, device=self.device)
            if cfg.host_pool_bytes > 0 else None
        )
        # tiered KV residency: demoted cold-middle pages live in the host
        # pool keyed ("ctx", req_id, page_idx); each tiered slot keeps a
        # ledger {lo, hi, top, rid, table} -- [lo, hi) the demoted page
        # span (zeroed in the table), top the high-water of allocated
        # pages.  _cold_staged holds the staged chunk slab between steps.
        if cfg.ctx_hot_pages > 0:
            if self.host_pool is None:
                raise ValueError(
                    "ctx_hot_pages > 0 requires host_pool_bytes > 0: "
                    "demoted cold pages live in the host page pool")
            if model_cfg.mrope_sections is not None:
                raise ValueError(
                    "tiered KV residency is not supported for mrope (VL) "
                    "models")
            if cfg.ctx_stream_pages < 1:
                raise ValueError(
                    f"ctx_stream_pages ({cfg.ctx_stream_pages}) must be "
                    ">= 1")
        self._tiered: dict[int, dict] = {}
        self._cold_staged: Optional[dict] = None
        self._cold_retired: list = []   # (host buffers, event) in flight
        self.num_ctx_stream_chunks = 0
        self.num_ctx_demoted_pages = 0
        # slab re-stages: count, bytes uploaded, host seconds, and the
        # recent ones as (chunks, bytes, seconds, of which reading back
        # and verifying, of which packing)
        self.num_ctx_restages = 0
        self.ctx_restage_bytes = 0
        self.ctx_restage_seconds = 0.0
        self.ctx_restage_log: collections.deque = collections.deque(
            maxlen=512)
        # the persistent filestore KV tier (``serving/kv_filestore``), the
        # ladder's bottom rung, wired after construction (the node's
        # builder arms it from HELIX_FILESTORE_KV_DIR); None = tier off
        self.kv_filestore = None
        self.filestore_restored_pages = 0
        # MoE prefill routing assignments dropped to capacity overflow:
        # device scalars queue un-fetched and fold in where a fetch has
        # synced (``_drain_moe_drops``)
        self._moe_dropped = 0
        self._moe_drop_handles: list = []
        self.preempted: list[PreemptedSeq] = []   # parked, resume FIFO
        self._resume_failures: list = []          # (req, reason) for the loop
        # resumed slots' histograms, re-injected at the next _sync_state
        self._slot_count_overrides: dict[int, np.ndarray] = {}
        self._prefetched: set = set()   # digests with queued uploads
        # scheduler delegation (serving/sched.py), wired by the loop:
        # on_admit fires once per confirmed admission (_try_claim
        # success), the fair-share charge point; victim_policy, when set,
        # orders preempt_for_pressure's candidates (None keeps the builtin
        # newest-admission/largest-footprint pick); prefill_budget caps
        # NEW prefill-admission tokens per step (None = unbudgeted)
        self.on_admit: Optional[Callable[[Request], None]] = None
        self.victim_policy: Optional[Callable[[list], list]] = None
        self.prefill_budget: Optional[int] = None
        self._budget_left: Optional[int] = None
        self._key_base = _splitmix64(0x8E1_1C9 ^ (rng_seed & _M64))
        self._key_nonce = 0
        self._token_ladder = parse_token_buckets(
            os.environ.get("HELIX_TOKEN_BUCKETS"),
            self.cache_cfg.page_size, cfg.max_prefill_len,
        )
        # speculative decoding (engine/spec.py): host-side prompt-lookup
        # drafter + per-request acceptance EMA; None = off.  An mrope
        # model's verify rows would need three streams per drafted
        # position, and an MoE model's experts would share their capacity
        # across a verify row (routing unlike plain decode): off with a
        # warning, as in the reference
        is_mrope = model_cfg.mrope_sections is not None
        self.spec = None
        if cfg.enable_spec_decode and (is_mrope or model_cfg.num_experts):
            logging.getLogger(__name__).warning(
                "speculative decoding is not supported for %s models — "
                "running plain decode", "mrope (VL)" if is_mrope else "MoE")
        elif cfg.enable_spec_decode:
            self.spec = SpecDecoder(SpecConfig(spec_tokens=cfg.spec_tokens))
        # multi-LoRA serving (engine/adapters.py): the device pool of
        # adapter slots and the host/filestore store under it; None = off
        self.adapter_pool: Optional[AdapterPool] = None
        self.adapter_store = None
        self._adapter_refs: dict[str, str] = {}   # req id -> adapter id
        self._slot_adapters = np.zeros((B,), np.int32)
        # adapter rows' seeded prefix digests: req id -> (seed, digests)
        self._adapter_hashes: dict[str, tuple] = {}
        if cfg.adapter_pool_slots > 0 and is_mrope:
            logging.getLogger(__name__).warning(
                "batched multi-LoRA serving is not supported for mrope "
                "(VL) models — running without an adapter pool")
        elif cfg.adapter_pool_slots == 1:
            # slot 0 is the identity, so one slot serves nothing: degrade
            # to off rather than fail the model's profile
            logging.getLogger(__name__).warning(
                "adapter_pool_slots=1 leaves no usable slots (slot 0 is "
                "the reserved identity): running without an adapter "
                "pool; set >= 2 to serve adapters")
        elif cfg.adapter_pool_slots > 1:
            self.adapter_pool = AdapterPool(
                model_cfg, cfg.adapter_targets, cfg.adapter_rank,
                cfg.adapter_pool_slots, dtype=model_cfg.dtype,
                device=self.device)
            self.adapter_store = default_adapter_store(model_cfg, cfg)
        self._grafted_params = None
        W = self._spec_width()
        self._inert_rows = np.full((B,), -1, np.int32)   # state rows sit out
        self._zero_rows = np.zeros((B,), np.int32)       # plain decode rows
        # per state-row width (W, and 1 for the fused tail): each row's
        # first token on the flat axis, and the offsets 0..width-1
        self._row_t0 = {w: torch.arange(0, B * w, w, dtype=torch.int32,
                                        device=self.device)
                        for w in {1, W}}
        self._offsets = {w: torch.arange(w, device=self.device)
                         for w in {1, W}}
        # deferred chunk-final first tokens (their device tensors ride the
        # next decode/verify fetch), the device-side seeds of their slots
        # at the next _sync_state, and tokens dispatched but not yet
        # reconciled per request (the async pipeline's prediction)
        self._pending_first: list = []           # [(req, [R] tensor)]
        self._pending_first_ids: set = set()
        self._pending_token_patches: dict = {}   # slot -> [1] tensor
        self._inflight_out: dict[str, int] = {}
        # optional observer of every sampled logits tensor:
        # logits_hook(kind, logits) with kind "prefill" ([R, V], each
        # row's last token), "decode" ([B, V], each state row's first
        # position) or, with speculation, "verify" ([B, W, V]); None in
        # serving
        self.logits_hook: Optional[Callable[[str, torch.Tensor], None]] = None
        # counters (the loop and the bench read these)
        self.num_prefill_tokens = 0
        self.num_decode_tokens = 0
        self.num_decode_device_steps = 0
        # active slots summed over decode device steps: decode tokens over
        # this is what a step gives each slot (1 without speculation)
        self.num_decode_slot_steps = 0
        self.num_mixed_steps = 0
        self.num_admitted = 0           # requests claimed into a slot
        self.num_generated_tokens = 0   # tokens emitted to requests
        # token-bucket padding of packed prefill segments (the rung
        # minus the tokens used)
        self.num_prefill_padding_tokens = 0
        self.prefix_cache_hits = 0      # admissions that reused a prefix
        self.prefix_cache_misses = 0    # ... and those that did not
        # prompt tokens served from the prefix cache, per adapter id ("" =
        # the base model)
        self.prefix_hit_tokens_by_adapter: dict[str, int] = {}
        # host tier: swaps out / in, host-to-device restore seconds, and
        # snapshots exported / imported
        self.num_preemptions = 0
        self.num_resumes = 0
        self.restore_seconds = 0.0
        self.num_snapshots_exported = 0
        self.num_snapshots_imported = 0
        self.num_prefill_exports = 0    # disaggregated prefill handoffs
        # verify calls issued, drafts proposed, drafts accepted
        self.num_spec_steps = 0
        self.num_spec_drafted_tokens = 0
        self.num_spec_accepted_tokens = 0
        # unified-step calls issued, and host waits on a device result
        self.num_device_calls = 0
        self.num_host_fetches = 0
        # forwards by attention kind: "k1" (rows over the paged history)
        # and "k2" (cold packed prompts); each runs every layer on every
        # shard
        self.attn_forwards: collections.Counter = collections.Counter()
        self.recent_ttfts: collections.deque = collections.deque(maxlen=200)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def kv_pages_used(self) -> int:
        """Occupied pages in the pool (prefix-cache-owned pages count as
        used: they hold live KV); page 0 is excluded from both sides."""
        return self.allocator.used_pages

    @property
    def kv_pages_capacity(self) -> int:
        return max(1, self.cache_cfg.num_pages - 1)

    @property
    def _resident_context_cap(self) -> int:
        """The limit of a fully resident row: the profile's max_model_len
        capped by per-sequence page capacity and the physical pool."""
        cap = min(
            self.cache_cfg.max_seq_len,
            (self.cache_cfg.num_pages - 1) * self.cache_cfg.page_size,
        )
        if self.cfg.max_model_len is not None:
            cap = min(cap, self.cfg.max_model_len)
        return cap

    @property
    def max_context_len(self) -> int:
        """Hard prompt+generation limit.  With tiered residency on
        (``ctx_hot_pages > 0`` and a host tier) the physical-pool term
        drops: only the hot tail must fit the pool, so the page-table
        width (and the profile's max_model_len) bounds it."""
        if self.cfg.ctx_hot_pages > 0 and self.host_pool is not None:
            cap = self.cache_cfg.max_seq_len
            if self.cfg.max_model_len is not None:
                cap = min(cap, self.cfg.max_model_len)
            return cap
        return self._resident_context_cap

    def validate_request(self, req: Request) -> Optional[str]:
        """Admission pre-check, safe from any thread; None = acceptable."""
        plen = len(req.prompt_tokens)
        if plen + 1 > self.max_context_len:
            return (
                f"prompt ({plen} tokens) exceeds the model context limit "
                f"{self.max_context_len}"
            )
        if (self.model_cfg.mrope_sections is not None
                and plen > self.cfg.max_prefill_len):
            # VL prefill is single-shot (the image splice's shapes); text
            # prompts prefill in chunks
            return (
                f"vision prompt ({plen} tokens) exceeds max_prefill_len "
                f"{self.cfg.max_prefill_len}"
            )
        if not req.prompt_tokens:
            return "empty prompt"
        if req.adapter:
            if self.adapter_pool is None:
                return (
                    f"adapter '{req.adapter}' requested but this engine "
                    "serves without an adapter pool "
                    "(EngineConfig.adapter_pool_slots)"
                )
            if (
                self.adapter_store is not None
                and not self.adapter_pool.resident(req.adapter)
                and not self.adapter_store.contains(req.adapter)
            ):
                return (
                    f"adapter '{req.adapter}' is not published for "
                    f"model '{self.model_cfg.name}'"
                )
        return None

    def add_request(self, req: Request) -> None:
        err = self.validate_request(req)
        if err:
            raise ValueError(err)
        self._requests[req.id] = req
        self.waiting.append(req)

    def abort(self, req_id: str) -> None:
        req = self._requests.get(req_id)
        if req is None or req.finished:
            return
        self._finish(req, FinishReason.ABORT)

    def get_request(self, req_id: str) -> Optional[Request]:
        return self._requests.get(req_id)

    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.preempted)
                or any(s is not None for s in self.slots))

    @property
    def cache(self) -> Optional[PagedKVCache]:
        """The page pool on one device (``caches[0]``; None once
        released).  A mesh has one pool per shard, in ``caches`` only."""
        if self.mesh is not None:
            raise NotImplementedError(
                "this path reads the one device's page pool; a mesh has "
                "one per shard (ROADMAP A15b)")
        return self.caches[0] if self.caches else None

    def release(self) -> None:
        """Drop the weights, the page pool, the device-side decode state
        and the host tier (with its pinned staging): an evicted model's
        memory goes back to the allocator once its loop has stopped,
        whoever still holds the engine.  Nothing steps it afterwards."""
        self.params = self._dstate = self.host_pool = None
        self.caches = []
        self.adapter_pool = self._grafted_params = None
        self._cold_staged, self._cold_retired = None, []
        self._row_t0, self._offsets = {}, {}
        self._pending_first, self._pending_token_patches = [], {}
        self._chunking = None

    def warmup(self) -> None:
        """Drive one tiny request through the public path, so the first
        real request pays neither the kernels' build nor the libraries'
        first-call set-up.  (The reference also walks its token-bucket
        ladder to compile every shape; eager execution has nothing to
        compile per shape.)  A VL model skips it, as the reference does:
        its prefill shapes depend on the image buckets."""
        if self.model_cfg.mrope_sections is not None:
            return
        req = Request(
            id="__warmup__",
            prompt_tokens=[0] * min(4, self.cache_cfg.page_size),
            sampling=SamplingParams(max_tokens=2, temperature=0.0),
        )
        self.add_request(req)
        while self.has_work():
            self.step()
        self._requests.pop(req.id, None)
        self.recent_ttfts.clear()

    def step(self) -> list[tuple[Request, int]]:
        """Admit + prefill waiting requests, then one decode step (or one
        mixed chunk + decode step, or one verify step).  Returns
        [(request, token), ...] for the tokens produced this step.

        Exactly ``step_complete(step_dispatch())``; a completion that
        raises rolls the dispatch's predicted advance back first, so a
        retry decodes from where the host last reconciled."""
        emitted, pend = self.step_dispatch()
        if pend is not None:
            try:
                # stage the next step's cold chunks while this one runs
                self.prefetch_cold()
                self.step_complete(pend, emitted)
            except Exception:
                self.discard_pending(pend)
                raise
        return emitted

    def step_dispatch(self) -> tuple[list, Optional[PendingStep]]:
        """The HOST phase of one engine step: admission, plan building,
        metadata upload and the device work, queued.  Returns
        ``(emitted_so_far, pending)``.  Nothing here waits for the device
        except an admission wave's batched first-token fetch."""
        emitted: list[tuple[Request, int]] = []
        if self.host_pool is not None:
            # finalize spills of earlier steps whose copies have landed
            # (step entry, so every step shape drains)
            self.host_pool.drain_pending()
        # per-step prefill-admission budget (the scheduler's feedback
        # loop): refreshed every step, charged by _try_claim
        self._budget_left = self.prefill_budget
        self._admit(emitted)
        if self._chunking is not None and self._chunking["req"].finished:
            self._chunking = None    # aborted mid-prefill
        decode_ready = any(
            self._slot_active(i) for i in range(len(self.slots))
        )
        if self._chunking is not None and decode_ready \
                and self.cfg.enable_mixed_step:
            return emitted, self._mixed_dispatch()
        if self._chunking is not None:
            self._chunk_dispatch()
        # a chunk that just completed activates its slot and decodes its
        # second token this same step; its deferred first token rides
        # that step's fetch
        if any(self._slot_active(i) for i in range(len(self.slots))):
            # speculate when the drafter has something to verify, else
            # the plain fused window
            pend = self._spec_dispatch() if self.spec is not None else None
            if pend is None:
                pend = self._decode_dispatch()
            return emitted, pend
        # nothing decodable: a deferred first token must still land
        self._flush_pending_first(emitted)
        return emitted, None

    def step_complete(self, pend: PendingStep, emitted=None) -> list:
        """The RECONCILE phase: wait for the step's one fetch, then every
        host-visible effect.  The async loop calls this after dispatching
        the next step."""
        emitted = [] if emitted is None else emitted
        if pend.kind == "decode":
            self._decode_complete(pend, emitted)
        elif pend.kind == "spec":
            self._spec_complete(pend, emitted)
        else:
            self._mixed_complete(pend, emitted)
        return emitted

    def pipeline_ready(self) -> bool:
        """True when the NEXT dispatch can run against predicted
        post-step state while a step is in flight: plain fused-decode
        steady state only.  Admissions, chunked prefill, speculation (its
        advance depends on acceptance the host has not seen), deferred
        first tokens and dirty slot state force the synchronous order."""
        if (
            self._state_dirty
            or self._dstate is None
            or self.waiting
            or self._chunking is not None
            or self.preempted
            or self.spec is not None
            or self._pending_first
            # tiered slots demote between steps: the gathers must follow
            # a reconciled step
            or self._tiered
        ):
            return False
        # every active slot needs headroom for one more predicted token;
        # one that will finish at the reconcile must reconcile first
        for i, req in enumerate(self.slots):
            if req is None or not self._slot_active(i):
                continue
            pend = self._pending_out(req)
            if (
                req.sampling.max_tokens - len(req.output_tokens) - pend <= 0
                or (req.max_len or self.cache_cfg.max_seq_len)
                - req.num_tokens - pend <= 0
            ):
                return False
        return True

    def discard_pending(self, pend: PendingStep) -> None:
        """Forget a dispatch whose completion failed or will never run:
        host bookkeeping only.  Every slot is marked changed so the next
        ``_sync_state`` re-uploads the mirrors rather than trusting device
        state the failed step may have left behind."""
        if pend.kind == "decode":
            # roll back the predicted advance: the mirror's last token is
            # still the last reconciled one, so the retry decodes from
            # there
            for i, r in pend.rows:
                if self.slots[i] is r:
                    self._positions[i] -= pend.n
        for _i, r in pend.rows:
            self._inflight_out.pop(r.id, None)
        self._pending_token_patches.clear()
        self._pending_first = []
        self._pending_first_ids.clear()
        for req, tok in pend.pending_first:
            if req.finished or req.slot is None:
                continue
            # the chunk call that sampled it succeeded: put it back, so
            # the retry seeds the slot from it and still emits token #1
            self._pending_first.append((req, tok))
            self._pending_first_ids.add(req.id)
            self._pending_token_patches[req.slot] = tok[:1]
        self._state_dirty = True
        self._changed_slots.update(range(len(self.slots)))

    def _pending_out(self, req: Request) -> int:
        """Tokens of this request dispatched but not reconciled, plus a
        deferred first token: every budget/headroom read subtracts them."""
        return self._inflight_out.get(req.id, 0) + (
            1 if req.id in self._pending_first_ids else 0
        )

    def _take_pending_first(self) -> list:
        pf, self._pending_first = self._pending_first, []
        self._pending_first_ids.clear()
        return pf

    def _finish_first_emit(self, req: Request, first_token: int,
                           emitted) -> None:
        """Deferred chunk-final emit, once its token was fetched with a
        step's results."""
        if req.finished:
            return   # aborted after activation: the token is moot
        if req.slot is not None:
            self._last_token[req.slot] = first_token
            # an unconsumed patch is superseded by the now-true mirror
            self._pending_token_patches.pop(req.slot, None)
        self._emit(req, first_token, emitted)

    def _flush_pending_first(self, emitted) -> None:
        """When no decode fetch of this step will carry the deferred first
        tokens: fetch them alone."""
        pf = self._take_pending_first()
        if not pf:
            return
        toks = self._fetch(Fetch([t[:1] for _r, t in pf]))
        for (req, _t), tok in zip(pf, toks):
            self._finish_first_emit(req, int(tok[0]), emitted)
        self._drain_moe_drops()   # the fetch above synced the device

    def _fetch(self, fetch: Fetch) -> list:
        """Wait for a queued device-to-host copy (counted)."""
        self.num_host_fetches += 1
        return fetch.wait()

    def generate(
        self, prompts: Sequence[Sequence[int]], sampling: SamplingParams
    ) -> list[list[int]]:
        """Blocking convenience wrapper (tests, bench)."""
        reqs = [
            Request(
                id=f"gen-{i}",
                prompt_tokens=list(p),
                sampling=sampling,
                stop_token_ids=tuple(self.cfg.eos_token_ids),
            )
            for i, p in enumerate(prompts)
        ]
        for r in reqs:
            self.add_request(r)
        while self.has_work():
            self.step()
        return [r.output_tokens for r in reqs]

    def _request_key(self, req: Request) -> np.ndarray:
        """Root key for one request: from its seed when given, else from
        the engine's counter stream (host-only, as in the reference)."""
        if req.sampling.seed is not None:
            return _host_key(_SEED_DOMAIN ^ (req.sampling.seed & _M64))
        self._key_nonce += 1
        return _host_key(self._key_base ^ self._key_nonce)

    def _slot_active(self, i: int) -> bool:
        """Occupied and decodable (not mid-chunked-prefill)."""
        s = self.slots[i]
        if s is None:
            return False
        return self._chunking is None or s is not self._chunking["req"]

    # ------------------------------------------------------------------
    # admission + prefill
    # ------------------------------------------------------------------

    def _prompt_hashes(self, req: Request) -> list:
        """Chain digests for the prompt's shareable full pages, capped at
        (plen-1)//ps: the page holding the LAST prompt token is never
        shared, so sampling always has a token to prefill.  An adapter
        row's chain is seeded with its adapter's weights checksum
        (``_adapter_seed``): its pages are shared only with rows of the
        same weights, in the device cache and the host tier alike."""
        ps = self.cache_cfg.page_size
        cap = (len(req.prompt_tokens) - 1) // ps
        if not req.adapter:
            if req._page_hashes is None:
                req._page_hashes = PrefixCache.page_hashes(
                    req.prompt_tokens, ps, cap
                )
            return req._page_hashes
        seed = self._adapter_seed(req)
        if seed is None:
            return []   # weights unknown yet: nothing to share
        cached = self._adapter_hashes.get(req.id)
        if cached is None or cached[0] != seed:
            cached = (seed, PrefixCache.page_hashes(
                req.prompt_tokens, ps, cap, seed=seed))
            self._adapter_hashes[req.id] = cached
        return cached[1]

    def _cached_prefix_pages(self, req: Request) -> int:
        """Resident prefix length in pages: the device chain, its
        host-spilled continuation, then the filestore rung's."""
        if self.prefix_cache is None:
            return 0
        hashes = self._prompt_hashes(req)
        k = self.prefix_cache.match_len(hashes)
        if self.host_pool is not None:
            while k < len(hashes) and self.host_pool.contains(hashes[k]):
                k += 1
        if self.kv_filestore is not None:
            while k < len(hashes) and self.kv_filestore.contains(hashes[k]):
                k += 1
        return k

    def _ensure_pages(self, need: int) -> bool:
        """can_allocate, with prefix-cache LRU eviction as the backstop.
        With a host tier, eviction SPILLS: the pages' contents demote to
        host buffers under the chain digest ``match_len`` looks up, so a
        later prompt sharing the prefix restores them instead of
        prefilling again."""
        if self.allocator.can_allocate(need):
            return True
        if self.prefix_cache is not None:
            entries = self.prefix_cache.evict_entries(
                need - self.allocator.free_pages)
            if entries:
                if self.host_pool is not None:
                    self._spill_prefix_pages(entries)
                self.allocator.give_back([p for _, p in entries])
        return self.allocator.can_allocate(need)

    def _spill_prefix_pages(self, entries: list) -> None:
        """Demote evicted prefix pages (``[(digest, page), ...]``) to the
        host tier.  The gather is queued on the current stream before any
        later write to the freed pages, and ``put`` queues the copies to
        the host without waiting.  A page the pool rejects (budget,
        injected ``alloc_fail``) is lost, as without the tier."""
        arrays = gather_pages(self.cache, [p for _, p in entries])
        for (digest, _page), page_arrays in zip(entries, arrays):
            self.host_pool.put(digest, page_arrays)

    # ------------------------------------------------------------------
    # multi-LoRA adapters (engine/adapters.py)
    # ------------------------------------------------------------------

    def publish_adapter(self, adapter_id: str, lora_params: dict,
                        scaling: float) -> None:
        """Publish a trained LoRA tree (``{target: {lora_a [L, in, r],
        lora_b [L, r, out]}}``) for ``model@adapter_id`` serving:
        validated against this model's geometry and admitted to the
        store, servable at once."""
        if self.adapter_pool is None or self.adapter_store is None:
            raise ValueError(
                "adapter serving is off for this engine "
                "(EngineConfig.adapter_pool_slots)"
            )
        self.adapter_store.publish(
            pack_lora_tree(adapter_id, lora_params, scaling)
        )

    def _adapter_ready(self, req: Request) -> bool:
        """Can this request's adapter reach a pool slot this step?
        Resident or host-resident: yes; otherwise the store's prefetch is
        (re-)kicked and admission defers, so a cold adapter loads during
        the queue wait and never blocks a step.  Safe from any thread."""
        aid = req.adapter
        if not aid or self.adapter_pool is None:
            return True
        if self.adapter_pool.resident(aid):
            return True
        if self.adapter_store is None:
            return False
        if self.adapter_store.ready(aid):
            return True
        self.adapter_store.prefetch(aid)
        return False

    def ensure_adapter_resident(self, adapter_id: str) -> bool:
        """Stage an adapter onto the host rung synchronously, so the next
        admission or resume pins it without deferring."""
        if not adapter_id or self.adapter_pool is None:
            return not adapter_id
        if self.adapter_pool.resident(adapter_id):
            return True
        if self.adapter_store is None:
            return False
        if self.adapter_store.ready(adapter_id):
            return True
        return self.adapter_store.get(adapter_id) is not None

    def _acquire_adapter(self, req: Request) -> Optional[int]:
        """Pin the request's adapter into a pool slot (idempotent per
        request: one ref from admission to finish, parked requests
        included).  None: not loadable this step (cold, or every slot
        pinned); the caller defers."""
        aid = req.adapter
        if not aid:
            return 0
        if self.adapter_pool is None:
            return None
        if req.id in self._adapter_refs:
            return self.adapter_pool.slot_for(aid)
        if self.adapter_store is not None:
            # host-resident specs only: a filestore read here would stall
            # every decode in flight; a cold adapter defers instead
            lookup = self.adapter_store.get_resident
            gen = self.adapter_store.generation(aid)
        else:
            lookup, gen = (lambda _id: None), None
        slot = self.adapter_pool.acquire(aid, lookup, generation=gen)
        if slot is not None:
            self._adapter_refs[req.id] = aid
        return slot

    def _release_adapter(self, req: Request) -> None:
        aid = self._adapter_refs.pop(req.id, None)
        if aid is not None and self.adapter_pool is not None:
            self.adapter_pool.release(aid)

    def _adapter_seed(self, req: Request) -> Optional[bytes]:
        """The prefix-chain seed of an adapter row: the checksum of the
        weights its slot holds once pinned; before that, of the spec the
        store or the pool holds now (it decides only whether a claim
        looks the cache up: the claim hashes again after pinning).  None
        when neither holds the adapter."""
        aid = req.adapter
        if req.id in self._adapter_refs:
            digest = self.adapter_pool.checksum_of(aid)
        else:
            spec = (self.adapter_store.get_resident(aid)
                    if self.adapter_store is not None else None)
            digest = (spec.checksum if spec is not None
                      else self.adapter_pool.checksum_of(aid))
        return bytes.fromhex(digest) if digest else None

    def _graft_params(self):
        """The model params with the pool's stacked slot tensors merged
        into each targeted layer entry (shallow dict copies).  Built once:
        a load writes its slot in place, so the tensors never change."""
        if self.adapter_pool is None:
            return self.params
        if self._grafted_params is None:
            merged = dict(self.params)
            layers = dict(merged["layers"])
            for t, entry in self.adapter_pool.entries().items():
                layers[t] = {**layers[t], **entry}
            merged["layers"] = layers
            self._grafted_params = merged
        return self._grafted_params

    def _note_adapter_rows(self, plan, draft_len) -> None:
        """Bank this device call's rows per adapter id (the pool's
        bounded top-K accounting): host dict math only."""
        pool = self.adapter_pool
        if pool is None:
            return
        counts: dict = {}
        if plan is not None:
            for row in plan.rows:
                if row.adapter and row.req is not None and row.req.adapter:
                    aid = row.req.adapter
                    counts[aid] = counts.get(aid, 0) + 1
        for i, req in enumerate(self.slots):
            if req is not None and draft_len[i] >= 0 and req.adapter:
                counts[req.adapter] = counts.get(req.adapter, 0) + 1
        if counts:
            pool.note_rows(counts)

    def _try_claim(self, req: Request, use_cache: bool = False):
        """Allocate pages + a slot for one waiting request; returns its
        page table or None when resources are unavailable.  With
        ``use_cache`` the longest cached prefix is acquired and stitched
        in front of freshly allocated pages; ``req.cached_tokens`` records
        how many prompt tokens are already resident."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        adapter_slot = 0
        if req.adapter:
            # pin the adapter into a pool slot before any page or slot
            # changes (and before the digests, which its weights seed): a
            # cold adapter defers the whole claim; the ref, once held,
            # survives queue waits and parks until finish
            got = self._acquire_adapter(req)
            if got is None:
                return None
            adapter_slot = got
        plen = len(req.prompt_tokens)
        ps = self.cache_cfg.page_size
        maxP = self.cache_cfg.max_pages_per_seq
        limit = min(plen + req.sampling.max_tokens, self.max_context_len)
        need = min(self.allocator.pages_needed(limit, ps), maxP)
        hashes: list = []
        shared: list = []
        k = 0
        if use_cache and self.prefix_cache is not None:
            hashes = self._prompt_hashes(req)
            k = self.prefix_cache.match_len(hashes)
        # tiered residency: a row longer than its cached prefix + hot tail
        # + one stream chunk admits with only its FIRST dispatch's pages;
        # ctx_pin rows (context creation) stay resident, and so must fit
        # the pool as on an engine without tiering
        tiered_on = self.cfg.ctx_hot_pages > 0 and self.host_pool is not None
        tiered = (tiered_on and not req.ctx_pin and need > k
                  + self.cfg.ctx_hot_pages + self.cfg.ctx_stream_pages)
        if tiered_on and not tiered:
            limit = min(limit, self._resident_context_cap)
            need = min(self.allocator.pages_needed(limit, ps), maxP)
        need_now = need
        if tiered:
            # the first chunk of a long prompt, else the prompt and one
            # decode token (a wave dispatches before any prep pass)
            first = min(limit, self.cfg.max_prefill_len
                        if plen > self.cfg.max_prefill_len else plen + 1)
            need_now = min(need, max(k, self.allocator.pages_needed(first,
                                                                    ps)))
        if use_cache and self.prefix_cache is not None:
            if not self._ensure_pages(need_now - k):
                return None
            shared = self.prefix_cache.acquire(hashes)
        need_new = need_now - len(shared)
        if not self._ensure_pages(need_new):
            if shared:
                self.prefix_cache.release(shared)
            return None
        slot = free_slots[0]
        pages = shared + self.allocator.allocate(req.id, need_new)
        req.slot = slot
        req.admitted_time = time.monotonic()
        restored = 0
        if use_cache and self.host_pool is not None and hashes:
            restored = self._restore_host_prefix(req, hashes, shared, pages)
        if use_cache and self.kv_filestore is not None and hashes:
            # the rung below the host tier: the chain's continuation may
            # survive on disk across restarts; a missing or corrupt blob
            # ends the chain and the rest prefills
            restored += self._restore_filestore_prefix(
                req, hashes, len(shared) + restored, pages)
        req.cached_tokens = (len(shared) + restored) * ps
        self.num_admitted += 1
        if self._budget_left is not None:
            # charge the uncached prefill work this admission injects
            self._budget_left -= max(1, plen - req.cached_tokens)
        if self.on_admit is not None:
            try:
                self.on_admit(req)
            except Exception:  # noqa: BLE001 — policy hooks never fail admission
                logging.getLogger(__name__).exception(
                    "on_admit hook failed for request %s", req.id)
        if shared or restored:
            self.prefix_cache_hits += 1
            by = self.prefix_hit_tokens_by_adapter
            by[req.adapter] = by.get(req.adapter, 0) + req.cached_tokens
        elif self.prefix_cache is not None:
            self.prefix_cache_misses += 1
        if use_cache and self.prefix_cache is not None:
            self.prefix_cache.record_claim(len(shared) + restored,
                                           len(hashes))
        if shared:
            self._shared_pages.setdefault(req.id, []).extend(shared)
        # a tiered row keeps the logical limit: its table grows lazily
        req.max_len = (limit if tiered
                       else min(len(pages) * ps, self.max_context_len))
        self.slots[slot] = req
        self._slot_adapters[slot] = adapter_slot
        table = np.zeros((maxP,), np.int32)
        table[: len(pages)] = pages
        self._page_tables[slot] = table
        if tiered:
            # lo == hi == the cached prefix: a shared head never demotes.
            # ``table`` is the object prefill plans alias, so growth and
            # demotion reach plans already built.  The slot's position
            # mirror starts at what is written, not the previous
            # occupant's, since the residency pass reads it.
            self._positions[slot] = req.cached_tokens
            self._tiered[slot] = {
                "lo": req.cached_tokens // ps, "hi": req.cached_tokens // ps,
                "top": len(pages), "rid": req.id, "table": table,
            }
        return table

    def _restore_host_prefix(self, req: Request, hashes: list, shared: list,
                             pages: list) -> int:
        """Promote the host-resident continuation of the prefix chain
        into this request's fresh device pages: digests past the device
        head are claimed from the host pool (checksum-verified; a corrupt
        or evicted entry ends the chain and the rest prefills), written
        back in one batch, and re-adopted into the device prefix cache so
        the next sharer hits on the device."""
        k = len(shared)
        entries: list = []
        digests: list = []
        while k + len(entries) < min(len(hashes), len(pages)):
            h = hashes[k + len(entries)]
            if not self.host_pool.contains(h):
                break
            e = self.host_pool.take_restored(h)
            self._prefetched.discard(h)   # consumed (or dropped corrupt)
            if e is None:   # corrupt: detected, dropped, the chain ends
                break
            entries.append(e)
            digests.append(h)
        if not entries:
            return 0
        t0 = time.monotonic()
        targets = pages[k:k + len(entries)]
        restore_pages(self.cache, targets, entries)
        self.restore_seconds += time.monotonic() - t0
        if self.prefix_cache is not None:
            adopted = self.prefix_cache.adopt(digests, targets)
            if adopted:
                # the cache owns them; the request holds one ref until
                # it finishes
                self.allocator.detach(req.id, adopted)
                self._shared_pages.setdefault(req.id, []).extend(adopted)
        return len(entries)

    def _restore_filestore_prefix(self, req: Request, hashes: list, k: int,
                                  pages: list) -> int:
        """Promote the filestore-resident continuation of the prefix chain
        (digests past position ``k``) into this request's fresh device
        pages, as ``_restore_host_prefix`` does for the host tier: every
        blob is checksum-verified by ``KVFilestore.get`` before the pool
        is touched, a missing or corrupt one ends the chain, and the
        restored pages re-adopt into the device prefix cache so the next
        sharer hits on the device."""
        entries: list = []
        digests: list = []
        while k + len(entries) < min(len(hashes), len(pages)):
            h = hashes[k + len(entries)]
            e = self.kv_filestore.get(h)
            if e is None:   # a miss or a corrupt blob: the chain ends
                break
            entries.append(e)
            digests.append(h)
        if not entries:
            return 0
        t0 = time.monotonic()
        targets = pages[k:k + len(entries)]
        restore_pages(self.cache, targets, entries)
        self.restore_seconds += time.monotonic() - t0
        self.filestore_restored_pages += len(entries)
        if self.prefix_cache is not None:
            adopted = self.prefix_cache.adopt(digests, targets)
            if adopted:
                self.allocator.detach(req.id, adopted)
                self._shared_pages.setdefault(req.id, []).extend(adopted)
        return len(entries)

    def _prefetch_host_prefix(self, req: Request) -> None:
        """Queue the uploads of the waiting head's host-resident prefix
        pages while it waits for a slot or pages, so the eventual restore
        finds them on the device.  One chain at a time: a new head
        releases the previous head's uploads (they borrow device memory
        from a pool that is short of it)."""
        if self.host_pool is None or self.prefix_cache is None:
            return
        hashes = self._prompt_hashes(req)
        k = self.prefix_cache.match_len(hashes)
        chain = []
        while k < len(hashes) and self.host_pool.contains(hashes[k]):
            chain.append(hashes[k])
            k += 1
        for stale in self._prefetched - set(chain):
            self.host_pool.release_device(stale)
        self._prefetched = set()
        for h in chain:
            if not self.host_pool.prefetch(h):
                break
            self._prefetched.add(h)

    def _admit(self, emitted) -> None:
        # Long prompts that cannot start THIS step (another chunked prefill
        # in flight) are set aside so shorter prompts behind them still
        # admit; they go back at the queue head afterwards.
        if any(r.finished for r in self.waiting):
            self.waiting[:] = [r for r in self.waiting if not r.finished]
        deferred: list[Request] = []
        pending: list = []   # (batch, first-token tensor) per wave
        try:
            self._admit_inner(deferred, pending, emitted)
        finally:
            if pending:
                self._finish_packed_admissions(pending, emitted)
            if deferred:
                self.waiting[:0] = deferred
        if self.preempted:
            # parked decoders resume AFTER the wait queue had its chance
            # at the freed pages (they were preempted for that queue)
            self._try_resume()
        if not self.waiting and self._prefetched:
            # the queue emptied without consuming the prefetched chain
            for h in self._prefetched:
                self.host_pool.release_device(h)
            self._prefetched = set()

    def _admit_inner(self, deferred: list, pending: list, emitted) -> None:
        while self.waiting:
            if self._budget_left is not None and self._budget_left <= 0:
                # the step's prefill-admission budget is spent: decode
                # keeps running and the next step gets a fresh budget.  It
                # starts >= 1, so a step's first admission always proceeds
                return
            req = self.waiting[0]
            if req.finished:
                self.waiting.pop(0)
                continue
            if not self._adapter_ready(req):
                # cold adapter: its prefetch was just (re-)kicked; set it
                # aside like a blocked long prompt, so everything behind
                # it keeps admitting and no step waits on the load
                deferred.append(self.waiting.pop(0))
                continue
            needs_chunking = len(req.prompt_tokens) > self.cfg.max_prefill_len
            if self.model_cfg.mrope_sections is not None:
                # VL prompts (validated <= max_prefill_len) prefill alone,
                # single-shot, never from the prefix cache
                table = self._try_claim(req, use_cache=False)
                if table is None:
                    return   # resource wait; decode will free pages
                self.waiting.pop(0)
                self._admit_vl(req, table, emitted)
                continue
            if not needs_chunking:
                # short prompts — cold and prefix-cache hits — pack into
                # ONE ragged prefill segment per wave
                if not self._admit_wave(pending):
                    # resource wait (decode frees pages): overlap it with
                    # the uploads the eventual claim will consume
                    self._prefetch_host_prefix(req)
                    return
                continue
            if self._chunking is not None:
                deferred.append(self.waiting.pop(0))
                continue
            table = self._try_claim(req, use_cache=True)
            if table is None:
                self._prefetch_host_prefix(req)
                return
            self.waiting.pop(0)
            # one chunk per engine step; the slot stays inactive until the
            # prompt is fully cached.  A prefix hit starts past the
            # resident pages.
            self._chunking = {
                "req": req, "table": table, "next": req.cached_tokens,
                "key": self._request_key(req), "slot": req.slot,
            }
            self._state_dirty = True
            self._changed_slots.add(req.slot)

    def _admit_vl(self, req: Request, table, emitted) -> None:
        """Prefill one admitted VL prompt and activate its slot (a VL
        engine admits nothing through waves)."""
        slot = req.slot
        first_token = self._prefill(req, table, slot)
        req.first_token_time = time.monotonic()
        self.recent_ttfts.append(req.first_token_time - req.submit_time)
        self._positions[slot] = len(req.prompt_tokens)
        self._mrope_delta[slot] = req.mrope_delta
        self._last_token[slot] = first_token
        self._state_dirty = True
        self._changed_slots.add(slot)
        self._emit(req, first_token, emitted)

    def _prefill(self, req: Request, table, slot: int) -> int:
        """VL (mrope) single-shot prefill (the reference's ``_prefill``
        with ``_build_prefill_fn_mrope``): the prompt padded to a
        power-of-two bucket of at most ``max_prefill_len``, its embeddings
        with the image rows spliced in, one forward whose attention is
        kernel K2 (causal by sequence index, a validity segment masking
        the padding), the K/V scattered into the slot's pages and the
        first token sampled with the request's key split.  Returns the
        token (one host fetch)."""
        ps = self.cache_cfg.page_size
        plen = len(req.prompt_tokens)
        bucket = _bucket(max(plen, ps), ps, self.cfg.max_prefill_len)
        dev = self.device
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :plen] = req.prompt_tokens
        self.num_prefill_padding_tokens += bucket - plen
        carry, sub = _host_split(self._request_key(req))
        self._slot_keys[slot] = carry
        pos3 = np.zeros((3, 1, bucket), np.int64)
        if req.positions3 is not None:
            pos3[:, 0, :plen] = np.asarray(req.positions3)[:, :plen]
        else:
            pos3[:, 0, :plen] = np.arange(plen)[None]
        tokens_t = upload(tokens, dev)
        embeds = self._splice_embeds(req, tokens_t, bucket)
        pos = torch.arange(bucket, device=dev)[None]
        valid = pos < plen
        seg = valid.to(torch.int32)
        (kacc, vacc), = self._kv_buffers(1, bucket)

        def attn_fn(q, k, v, carry_cache, p):
            cache, lyr = carry_cache
            kacc[lyr].copy_(k)
            vacc[lyr].copy_(v)
            out = attention(q, k, v, causal=True, q_positions=p,
                            kv_positions=p, q_segment_ids=seg,
                            kv_segment_ids=seg,
                            backend=self.cfg.attn_backend)
            return out, cache

        from helix_tpu_torch.models.qwen2_vl import text_forward_mrope

        h, _ = text_forward_mrope(
            self.params, self.model_cfg, tokens_t, upload(pos3, dev),
            attn_fn=attn_fn, carry_caches=self.cache, input_embeds=embeds,
            seq_positions=pos, return_hidden=True)
        table_t = upload(np.asarray(table, np.int32)[None], dev)
        pages, offsets = slot_to_page_offset(pos, table_t, ps)
        write_kv(self.cache, kacc, vacc, pages, offsets, valid)
        last = project_logits(self.params, self.model_cfg, h[0, plen - 1:plen])
        if self.logits_hook is not None:
            self.logits_hook("prefill", last)
        sampling = SamplingState.from_params([req.sampling], device=dev)
        token = sample(last, sampling, np.asarray([sub], np.uint32))
        self.num_device_calls += 1
        self.num_prefill_tokens += plen
        return int(self._fetch(Fetch([token]))[0][0])

    def _splice_embeds(self, req: Request, tokens_t, bucket: int):
        """The prompt's embeddings ``[1, bucket, E]`` with the image rows
        written at ``image_positions``.  As the reference's ``mode="drop"``
        scatter, an index past the bucket writes nothing: out-of-range
        rows are masked out, never wrapped."""
        cfg = self.model_cfg
        emb = embed_lookup(self.params["embed"], tokens_t,
                           torch_dtype(cfg.dtype))
        if req.image_embeds is None:
            return emb
        img = torch.as_tensor(req.image_embeds).to(device=self.device,
                                                   dtype=emb.dtype)
        idx = np.asarray(req.image_positions, np.int64)[: img.shape[0]]
        keep = np.nonzero((idx >= 0) & (idx < bucket))[0]
        if len(keep) < img.shape[0]:
            img = img.index_select(0, upload(keep, self.device))
        emb[0].index_copy_(0, upload(idx[keep], self.device), img)
        return emb

    def _admit_wave(self, pending: list) -> int:
        """Claim as many waiting short prompts as fit one ragged prefill
        segment and prefill each wave in ONE step.  Returns requests
        admitted (0 = blocked on resources)."""
        C_cap = self.cfg.max_prefill_len
        ps = self.cache_cfg.page_size
        maxP = self.cache_cfg.max_pages_per_seq
        B = self.cfg.max_decode_batch
        # MoE: one request per call (the experts' capacity is shared by
        # the call's tokens); the calls still go out in one wave with one
        # batched token fetch
        max_pack = 1 if self.model_cfg.num_experts > 0 else B
        plan = PrefillPlan(ps, maxP, B)
        batch: list = []
        waves: list = []
        adapter_deferred: list = []

        def flush():
            nonlocal plan, batch
            if batch:
                waves.append((plan, batch))
            plan = PrefillPlan(ps, maxP, B)
            batch = []

        admitted_any = False
        while self.waiting:
            req = self.waiting[0]
            if req.finished:
                self.waiting.pop(0)
                continue
            if not self._adapter_ready(req):
                # cold adapter mid-wave: defer (prefetch kicked), keep
                # packing the rest of the queue
                adapter_deferred.append(self.waiting.pop(0))
                continue
            plen = len(req.prompt_tokens)
            if plen > C_cap:
                break   # long prompt: the outer admission loop chunks it
            if len(batch) >= max_pack:
                flush()
            if (admitted_any and self._budget_left is not None
                    and self._budget_left <= 0):
                # budget spent mid-wave: close with what fit (a step's
                # first claim is always admitted)
                break
            cache_match = self._cached_prefix_pages(req)
            table = self._try_claim(req, use_cache=cache_match > 0)
            if table is None:
                break
            self.waiting.pop(0)
            admitted_any = True
            start = req.cached_tokens
            rem = plen - start
            if batch and not plan.fits(rem, C_cap):
                flush()
            carry, sub = _host_split(self._request_key(req))
            self._slot_keys[req.slot] = carry
            plan.add(req, table, start, rem, req.prompt_tokens[start:plen],
                     sub, req.sampling,
                     adapter=int(self._slot_adapters[req.slot]))
            batch.append(req)
        if adapter_deferred:
            # back at the queue head, in order; the next admission pass
            # checks them again
            self.waiting[:0] = adapter_deferred
        flush()
        for wave_plan, wave_batch in waves:
            first, _, _, _ = self._ragged_step(
                plan=wave_plan, draft_len=self._inert_rows
            )
            pending.append((wave_batch, first))
        return sum(len(b) for _, b in waves)

    def _finish_packed_admissions(self, pending: list, emitted) -> None:
        """Fetch every admission wave's first tokens in ONE host round
        trip and complete the per-request bookkeeping."""
        flat = self._fetch(Fetch(
            [torch.cat([t[: len(b)] for b, t in pending])]))[0]
        self._drain_moe_drops()   # the fetch above synced the device
        now = time.monotonic()
        i = 0
        for batch, _ in pending:
            for req in batch:
                first_token = int(flat[i])
                i += 1
                slot = req.slot
                req.first_token_time = now
                self.recent_ttfts.append(now - req.submit_time)
                self._positions[slot] = len(req.prompt_tokens)
                self._last_token[slot] = first_token
                self._state_dirty = True
                self._changed_slots.add(slot)
                self.num_prefill_tokens += (
                    len(req.prompt_tokens) - req.cached_tokens
                )
                self._adopt_prompt_pages(req, self._page_tables[slot])
                self._emit(req, first_token, emitted)

    def _drain_moe_drops(self) -> None:
        """Fold the queued drop counts into ``moe_dropped_tokens`` in one
        copy.  Called right after a fetch has waited for the device, so
        the copy waits for nothing."""
        if not self._moe_drop_handles:
            return
        handles, self._moe_drop_handles = self._moe_drop_handles, []
        n = int(Fetch([torch.stack(handles).sum()]).wait()[0])
        if n <= 0:
            return
        self._moe_dropped += n
        logging.getLogger(__name__).info(
            "moe prefill dropped %d routing assignments to capacity "
            "overflow (engine total %d)", n, self._moe_dropped)

    @property
    def moe_dropped_tokens(self) -> int:
        """MoE prefill routing assignments dropped to expert capacity, as
        of the last drain (a plain int: the metrics thread reads it)."""
        return self._moe_dropped

    def _chunk_plan(self, st) -> tuple:
        """ONE ragged row for the in-flight long prefill's next chunk; its
        history length is the chunk start."""
        req: Request = st["req"]
        plen = len(req.prompt_tokens)
        start = st["next"]
        end = min(start + self.cfg.max_prefill_len, plen)
        rem = end - start
        st["key"], sub = _host_split(st["key"])
        plan = PrefillPlan(
            self.cache_cfg.page_size, self.cache_cfg.max_pages_per_seq, 1
        )
        plan.add(req, st["table"], start, rem, req.prompt_tokens[start:end],
                 sub, req.sampling,
                 adapter=int(self._slot_adapters[st["slot"]]))
        return plan, rem, end

    def _finish_chunk(self, st, first_token, emitted) -> None:
        """Prompt fully cached: activate the slot with its first token.

        ``first_token`` is a host int (the mixed step fetched it with its
        decode tokens) or the chunk step's [R] device tensor: then the
        fetch DEFERS -- ``_sync_state`` seeds the slot's device state from
        the tensor and the emit rides the next decode or verify fetch."""
        req: Request = st["req"]
        self._adopt_prompt_pages(req, st["table"])
        slot = st["slot"]
        self._chunking = None
        req.first_token_time = time.monotonic()
        self.recent_ttfts.append(req.first_token_time - req.submit_time)
        self._positions[slot] = len(req.prompt_tokens)
        self._slot_keys[slot] = _host_split(st["key"])[0]
        self._state_dirty = True
        self._changed_slots.add(slot)
        if isinstance(first_token, (int, np.integer)):
            self._last_token[slot] = first_token
            self._drain_moe_drops()   # the caller's fetch synced the device
            self._emit(req, int(first_token), emitted)
            return
        # deferred: placeholder mirror, device-side patch at the next
        # _sync_state, emit at the next fetch
        self._last_token[slot] = 0
        self._pending_token_patches[slot] = first_token[:1]
        self._pending_first.append((req, first_token))
        self._pending_first_ids.add(req.id)

    def _chunk_dispatch(self) -> None:
        """ONE chunk of the in-flight long prefill, decode rows sitting
        out (the mixed step is off or nothing decodes).  Fetches nothing:
        a final chunk's first token defers (``_finish_chunk``)."""
        st = self._chunking
        req: Request = st["req"]
        plan, rem, end = self._chunk_plan(st)
        first, _, _, _ = self._ragged_step(plan=plan,
                                           draft_len=self._inert_rows)
        self.num_prefill_tokens += rem
        st["next"] = end
        if end >= len(req.prompt_tokens):
            self._finish_chunk(st, first, None)

    def _mixed_dispatch(self) -> PendingStep:
        """ONE device step advances every active decode slot one token
        AND the in-flight long prefill one chunk."""
        st = self._chunking
        req: Request = st["req"]
        if self._state_dirty or self._dstate is None:
            self._sync_state()
        self._check_headroom(1)
        rows = [
            (i, r) for i, r in enumerate(self.slots)
            if r is not None and self._slot_active(i)
        ]
        plan, rem, end = self._chunk_plan(st)
        first, sampled, _, _ = self._ragged_step(plan=plan,
                                                 draft_len=self._zero_rows)
        self.num_mixed_steps += 1
        self.num_decode_device_steps += 1
        self.num_decode_slot_steps += len(rows)
        self.num_prefill_tokens += rem
        st["next"] = end
        final = end >= len(req.prompt_tokens)
        # a deferred first token re-queued by a failed step can cross
        # into a mixed step: it rides THIS fetch, or its request would
        # emit token #2 before token #1
        pf = self._take_pending_first()
        return PendingStep(
            kind="mixed", rows=rows, st=st, final=final, pending_first=pf,
            fetch=Fetch([sampled[:, 0], first[:1]]
                        + [t[:1] for _r, t in pf]),
        )

    def _mixed_complete(self, p: PendingStep, emitted) -> None:
        next_np, tok_np, *first_np = self._fetch(p.fetch)
        for (req, _t), t_np in zip(p.pending_first, first_np):
            self._finish_first_emit(req, int(t_np[0]), emitted)
        if p.pending_first:
            self._drain_moe_drops()   # the fetch above synced the device
        # decode emissions first (the chunking slot is still parked here)
        for i, r in p.rows:
            if self.slots[i] is not r or r.finished:
                continue
            self._positions[i] += 1
            self._last_token[i] = next_np[i]
            self.num_decode_tokens += 1
            self._emit(r, int(next_np[i]), emitted)
        if p.final:
            self._finish_chunk(p.st, int(tok_np[0]), emitted)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _sync_state(self) -> None:
        """Upload the host mirrors after the slot set changed; surviving
        slots keep their device histograms and evolved keys."""
        B = self.cfg.max_decode_batch
        V = self.model_cfg.vocab_size
        dev = self.device
        active = np.array(
            [self._slot_active(i) for i in range(B)], bool
        )
        keep = np.array(
            [s is not None and i not in self._changed_slots
             for i, s in enumerate(self.slots)], bool
        )
        greedy = SamplingParams(temperature=0.0)
        sampling = SamplingState.from_params(
            [s.sampling if s is not None else greedy for s in self.slots],
            device=dev,
        )
        if self._dstate is None:
            counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        else:
            counts = self._dstate.token_counts
        counts.index_fill_(0, upload(np.nonzero(~keep)[0], dev), 0)
        # fresh slots start their histogram with the prefill-sampled first
        # token (it is output token #1 for penalty purposes)
        seed = (~keep & active).astype(np.int32)
        if seed.any():
            counts.scatter_add_(1, upload(self._last_token[:, None], dev),
                                upload(seed[:, None], dev))
        self._dkeys = np.where(keep[:, None], self._dkeys, self._slot_keys)
        self._active = active
        self._dstate = DecodeState(
            last_token=upload(self._last_token, dev),
            positions=upload(self._positions, dev),
            page_tables=upload(self._page_tables, dev),
            active=upload(active.astype(np.int64), dev),
            token_counts=counts,
            sampling=sampling,
            adapter_slots=upload(self._slot_adapters.astype(np.int64), dev),
            mrope_delta=upload(self._mrope_delta, dev),
        )
        self._changed_slots.clear()
        self._state_dirty = False
        # resumed slots: the saved histogram replaces the fresh-slot seed
        for slot, saved in sorted(self._slot_count_overrides.items()):
            counts[slot].copy_(upload(saved, dev))
        self._slot_count_overrides.clear()
        # deferred chunk-final first tokens: the mirror seeded the slot
        # with a placeholder 0; move that count to the real token and set
        # the last token from the device tensor
        for slot, tok in sorted(self._pending_token_patches.items()):
            counts[slot, 0] -= 1
            counts[slot].scatter_add_(
                0, tok.long(), torch.ones(1, dtype=torch.int32, device=dev))
            self._dstate.last_token[slot:slot + 1] = tok
        self._pending_token_patches.clear()

    def _decode_window(self) -> int:
        """Fused decode steps before the next host sync: 1 while
        admission/chunking work is pending, with few streams, or near a
        slot's token budget / page room; else the largest power of two
        <= decode_steps_per_sync every active slot can absorb.  Tokens in
        flight count against budget and room."""
        n_max = self.cfg.decode_steps_per_sync
        if n_max <= 1 or self._chunking is not None or self._cold_active():
            # tiered steps stay single-token, as in the reference
            return 1
        n_active = sum(
            1 for i in range(len(self.slots)) if self._slot_active(i)
        )
        if n_active <= self.cfg.adaptive_sync_max_streams:
            return 1
        cap = n_max
        if self.waiting:
            cap = min(cap, 4)
        for i, req in enumerate(self.slots):
            if req is None or not self._slot_active(i):
                continue
            pend = self._pending_out(req)
            budget = req.sampling.max_tokens - len(req.output_tokens) - pend
            room = ((req.max_len or self.cache_cfg.max_seq_len)
                    - req.num_tokens - pend)
            cap = min(cap, budget, room)
        if cap <= 1:
            return 1
        n = 1
        while n * 2 <= cap:
            n *= 2
        return n

    def _check_headroom(self, n: int) -> None:
        """The KV write clamps its page-table index, so a slot reaching
        table capacity inside the window would corrupt its last page
        instead of failing; the window logic must make that impossible."""
        table_cap = self.cache_cfg.max_pages_per_seq * self.cache_cfg.page_size
        for i in range(len(self.slots)):
            if self._slot_active(i) and self._positions[i] + n > table_cap:
                raise RuntimeError(
                    f"decode window overruns page-table capacity: slot {i} "
                    f"at position {self._positions[i]} + {n} steps > "
                    f"{table_cap} — headroom invariant violated"
                )


    # ------------------------------------------------------------------
    # tiered KV residency: the streamed cold middle
    # ------------------------------------------------------------------

    @property
    def kv_cold_pages(self) -> int:
        """Demoted cold-middle pages held in the host tier across all
        tiered slots."""
        return sum(led["hi"] - led["lo"] for led in self._tiered.values())

    def _cold_active(self) -> bool:
        """True when a tiered slot has a non-empty demoted span."""
        return any(led["hi"] > led["lo"] for led in self._tiered.values())

    def _ensure_tiered_pages(self, slot: int, led: dict,
                             upto_tokens: int) -> None:
        """Grow a tiered slot's table to cover ``upto_tokens`` written
        positions: fresh pages at the high-water mark, in the ledger's
        aliased table and the engine's mirror."""
        ps = self.cache_cfg.page_size
        need = min(self.allocator.pages_needed(upto_tokens, ps),
                   self.cache_cfg.max_pages_per_seq)
        if need <= led["top"]:
            return
        n_new = need - led["top"]
        if not self._ensure_pages(n_new):
            raise MemoryError(
                f"tiered slot {slot} cannot grow its page table by "
                f"{n_new} page(s) -- device pool exhausted even after "
                "cold demotion")
        for i, pg in enumerate(self.allocator.allocate(led["rid"], n_new)):
            led["table"][led["top"] + i] = pg
            self._page_tables[slot][led["top"] + i] = pg
        led["top"] = need
        # tables re-upload; the slot is NOT marked changed, so its device
        # key stream and histogram survive
        self._state_dirty = True

    def _demote_slot(self, slot: int, led: dict, written: int) -> None:
        """Move the pages wholly below ``written - ctx_hot_pages *
        page_size`` to the host tier (pinned: they are the only copy) and
        zero their table entries.  The gather queues after every step
        that wrote them, and the freed pages are written only by steps
        queued after it."""
        ps = self.cache_cfg.page_size
        target = min(written // ps - self.cfg.ctx_hot_pages,
                     self.cache_cfg.max_pages_per_seq)
        if target <= led["hi"]:
            return
        idxs = list(range(led["hi"], target))
        page_ids = [int(led["table"][i]) for i in idxs]
        arrays = gather_pages(self.cache, page_ids)
        for idx, page, page_arrays in zip(idxs, page_ids, arrays):
            if not self.host_pool.put(("ctx", led["rid"], idx), page_arrays,
                                      pinned=True):
                break   # host budget full: keep the rest resident
            self.allocator.detach(led["rid"], [page])
            self.allocator.give_back([page])
            led["table"][idx] = 0
            self._page_tables[slot][idx] = 0
            led["hi"] = idx + 1
            self.num_ctx_demoted_pages += 1
            self._state_dirty = True

    def _tiered_written(self, slot: int) -> int:
        """KV positions written for a tiered slot: the chunk cursor while
        it prefills, else its position mirror."""
        st = self._chunking
        if st is not None and st["slot"] == slot:
            return int(st["next"])
        return int(self._positions[slot])

    def _tiered_prep(self, n_extra: int) -> None:
        """The residency pass of one dispatch: demote what fell behind
        each tiered slot's hot tail, then grow its table over this step's
        writes (demotion first frees the pages growth claims)."""
        for slot in sorted(self._tiered):
            req = self.slots[slot]
            if req is None:
                continue
            led = self._tiered[slot]
            written = self._tiered_written(slot)
            st = self._chunking
            if st is not None and st["slot"] == slot:
                upto = min(len(req.prompt_tokens),
                           written + self.cfg.max_prefill_len)
            else:
                upto = written + self._spec_width() + int(n_extra)
            upto = min(upto, req.max_len or self.cache_cfg.max_seq_len,
                       self.cache_cfg.max_seq_len)
            self._demote_slot(slot, led, written)
            self._ensure_tiered_pages(slot, led, upto)

    def _cold_spans(self) -> list:
        """``(slot, rid, lo, hi)`` of every tiered slot with a demoted
        span, ascending by slot: the staging order, so the chunk fold is
        deterministic."""
        return [(slot, led["rid"], led["lo"], led["hi"])
                for slot, led in sorted(self._tiered.items())
                if led["hi"] > led["lo"] and self.slots[slot] is not None]

    def _refresh_cold_staged(self) -> Optional[dict]:
        """The staged cold slab of the current demoted spans, rebuilt
        when they changed: every span's pages read back from the host
        tier (each checksum verified; a corrupt or missing page raises
        ``ColdPageError``), packed into ``[L, nC, Ct, KVH, D]`` chunks of
        ``ctx_stream_pages`` pages in pinned memory and uploaded in one
        queued copy.  The pinned buffers stay alive
        until an event behind the copy has passed."""
        spans = self._cold_spans()
        if not spans:
            self._retire_cold_staged()
            return None
        key = tuple((rid, lo, hi) for _s, rid, lo, hi in spans)
        staged = self._cold_staged
        if staged is not None and staged["key"] == key:
            return staged
        t_start = time.monotonic()
        self._retire_cold_staged()
        sp = self.cfg.ctx_stream_pages
        ps = self.cache_cfg.page_size
        chunks = []   # (rid, [page keys]) per chunk
        for _slot, rid, lo, hi in spans:
            for c0 in range(lo, hi, sp):
                chunks.append((rid, [("ctx", rid, i)
                                     for i in range(c0, min(c0 + sp, hi))]))
        keys = [k for _rid, ks in chunks for k in ks]
        got = [self.host_pool.get(k) for k in keys]
        t_verified = time.monotonic()
        for k, e in zip(keys, got):
            if e is None:
                raise ColdPageError(
                    f"cold KV page {k[2]} of request {k[1]} failed "
                    "checksum verification on restore -- refusing to "
                    "attend corrupt history")
        pages = dict(zip(keys, got))
        cuda = self.device.type == "cuda"
        fields = ["k", "v"] + (["k_scale", "v_scale"]
                               if self.cache_cfg.quantized else [])
        first = {f: torch.as_tensor(got[0][f]) for f in fields}
        nC, Ct = len(chunks), sp * ps
        host = {f: torch.empty((t.shape[0], nC, Ct) + tuple(t.shape[2:]),
                               dtype=t.dtype, pin_memory=cuda)
                for f, t in first.items()}

        # each span's chunks are consecutive: one [L, tokens, ...] view of
        # them per field, its pages stacked into it in order by one numpy
        # copy (their bytes: bf16 has no numpy type), the tail zeroed
        c0 = 0
        for _slot, rid, lo, hi in spans:
            n_ch = -(-(hi - lo) // sp)
            for f, slab in host.items():
                region = slab[:, c0:c0 + n_ch].flatten(1, 2)
                dst = region[:, :(hi - lo) * ps].unflatten(1, (hi - lo, ps))
                np.stack([torch.as_tensor(pages[("ctx", rid, idx)][f])
                          .contiguous().view(torch.uint8).numpy()
                          for idx in range(lo, hi)], axis=1,
                         out=dst.view(torch.uint8).numpy())
                region[:, (hi - lo) * ps:].zero_()
            c0 += n_ch
        t_filled = time.monotonic()
        dev = {f: t.to(self.device, non_blocking=True)
               for f, t in host.items()}
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        self._cold_staged = {
            "key": key, "owners": tuple(rid for rid, _ks in chunks),
            "lens": np.array([len(ks) * ps for _rid, ks in chunks],
                             np.int32),
            "host": host, "event": event, "k": dev["k"], "v": dev["v"],
            "ks": dev.get("k_scale"), "vs": dev.get("v_scale"),
        }
        t_end = time.monotonic()
        self.num_ctx_restages += 1
        self.ctx_restage_bytes += nbytes
        self.ctx_restage_seconds += t_end - t_start
        self.ctx_restage_log.append(
            (nC, nbytes, t_end - t_start, t_verified - t_start,
             t_filled - t_verified))
        return self._cold_staged

    def _retire_cold_staged(self) -> None:
        """Drop the staged slab; its pinned host buffers are kept until
        the event behind their upload has passed."""
        self._cold_retired = [(h, ev) for h, ev in self._cold_retired
                              if not ev.query()]
        staged, self._cold_staged = self._cold_staged, None
        if staged is not None and staged["event"] is not None:
            self._cold_retired.append((staged["host"], staged["event"]))

    def _finalize_cold(self, staged: dict, plan) -> Optional[tuple]:
        """Bind the staged slab to this dispatch's two row axes: each
        chunk's owner as a prefill-plan row and as a state row (its slot),
        and each row's demoted token span.  A chunk owned by neither keeps
        row -1.  Returns ``(prefill_cold, state_cold)`` keyword dicts for
        the op, or None when nothing in this dispatch attends cold
        history."""
        ps = self.cache_cfg.page_size
        B = len(self.slots)
        n_rows = plan.max_rows if plan is not None and plan.rows else 0
        rid_prow = ({r.req.id: j for j, r in enumerate(plan.rows)
                     if r.req is not None} if n_rows else {})
        nC = len(staged["owners"])
        prow = np.full((nC,), -1, np.int32)
        srow = np.full((nC,), -1, np.int32)
        p_lo = np.zeros((n_rows,), np.int32)
        p_hi = np.zeros((n_rows,), np.int32)
        s_lo = np.zeros((B,), np.int32)
        s_hi = np.zeros((B,), np.int32)
        slot_of = {}
        for slot, rid, lo, hi in self._cold_spans():
            slot_of[rid] = slot
            j = rid_prow.get(rid)
            if j is not None:
                p_lo[j], p_hi[j] = lo * ps, hi * ps
            if self._slot_active(slot):
                s_lo[slot], s_hi[slot] = lo * ps, hi * ps
        for c, rid in enumerate(staged["owners"]):
            slot = slot_of.get(rid)
            if slot is None:
                continue
            j = rid_prow.get(rid)
            if j is not None:
                prow[c] = j
            if self._slot_active(slot):
                srow[c] = slot
        if not (prow >= 0).any() and not (srow >= 0).any():
            return None
        self.num_ctx_stream_chunks += nC
        dev = self.device
        slab = dict(cold_k=staged["k"], cold_v=staged["v"],
                    cold_k_scale=staged["ks"], cold_v_scale=staged["vs"],
                    cold_len=upload(staged["lens"], dev))
        p_cold = (dict(slab, cold_row=upload(prow, dev),
                       span_lo=upload(p_lo, dev), span_hi=upload(p_hi, dev))
                  if (prow >= 0).any() else None)
        s_cold = (dict(slab, cold_row=upload(srow, dev),
                       span_lo=upload(s_lo, dev), span_hi=upload(s_hi, dev))
                  if (srow >= 0).any() else None)
        return p_cold, s_cold

    def prefetch_cold(self) -> None:
        """Demote and stage for the NEXT dispatch while the current step
        is in flight (``step`` and the loop call it between dispatch and
        complete): the gathers queue behind the step on the stream."""
        if not self._tiered:
            return
        for slot in sorted(self._tiered):
            if self.slots[slot] is not None:
                self._demote_slot(slot, self._tiered[slot],
                                  self._tiered_written(slot))
        self._refresh_cold_staged()

    # ------------------------------------------------------------------
    # preemption by swap
    # ------------------------------------------------------------------

    def _settled(self, req: Request) -> bool:
        """True when the host mirrors of the request's slot are exact:
        no dispatched step of it is unreconciled and no deferred first
        token is on its way.  ``preempt`` and ``export_request`` read
        ``_positions`` / ``_last_token`` and run only then (the caller
        reconciles an in-flight step first)."""
        return (req.id not in self._inflight_out
                and req.id not in self._pending_first_ids)

    def _slot_sampler_state(self, slot: int) -> tuple:
        """The slot's evolved key (host) and output-token histogram
        (fetched from the device), after making the device state
        current."""
        if self._state_dirty or self._dstate is None:
            self._sync_state()
        key = np.array(self._dkeys[slot], np.uint32)
        counts = self._dstate.token_counts[slot].to("cpu").numpy()
        return key, counts.astype(np.int32)

    def preempt(self, req_id: str) -> bool:
        """Swap a running decoder out to host RAM and park it for exact
        resume: its private pages and its evolved sampler state (key and
        histogram) move to the host tier, the slot and pages free, and
        the request joins ``preempted``.  Shared prefix pages stay on the
        device with their refcounts held.  False when the request cannot
        be preempted now (no host tier; unknown, finished, queued or
        mid-chunk; an unreconciled step or deferred first token) or the
        host budget cannot take all its pages: then nothing changed."""
        if self.host_pool is None:
            return False
        req = self._requests.get(req_id)
        if req is None or req.finished or req.slot is None:
            return False
        slot = req.slot
        if not self._slot_active(slot) or not self._settled(req):
            return False
        if slot in self._tiered:
            # its cold pages already live in the host tier under ("ctx",
            # ...) keys: a swap would spill twice and a resume could not
            # rebuild the demoted table; the ladder sheds instead
            return False
        key, counts = self._slot_sampler_state(slot)
        shared = self._shared_pages.get(req_id, [])
        owned = self.allocator.seq_pages(req_id)
        n_pages = len(owned) + len(shared)
        table = np.array(self._page_tables[slot][:n_pages])
        private = set(owned)
        private_pos = [i for i in range(n_pages) if int(table[i]) in private]
        page_ids = [int(table[i]) for i in private_pos]
        put_keys = []
        for pos, arrays in zip(private_pos, gather_pages(self.cache,
                                                         page_ids)):
            k = ("seq", req_id, pos)
            # pinned: prefix spills must never evict a parked decoder's
            # pages before its resume
            if not self.host_pool.put(k, arrays, pinned=True):
                for kk in put_keys:   # roll back: the swap is whole
                    self.host_pool.discard(kk)
                return False
            put_keys.append(k)
        self.preempted.append(PreemptedSeq(
            req=req, table=table, private_pos=private_pos,
            position=int(self._positions[slot]),
            last_token=int(self._last_token[slot]),
            mrope_delta=int(self._mrope_delta[slot]), key=key, counts=counts,
        ))
        if self.allocator.owns(req_id):
            self.allocator.free(req_id)
        self.slots[slot] = None
        # the adapter ref stays parked with the request (re-acquired as
        # the same slot at resume)
        self._slot_adapters[slot] = 0
        req.slot = None
        self._state_dirty = True
        self._changed_slots.add(slot)
        self.num_preemptions += 1
        logging.getLogger(__name__).info(
            "preempted request %s: %d private page(s) swapped to host, "
            "%d shared prefix page(s) kept resident",
            req_id, len(private_pos), len(shared))
        return True

    def reap_stuck(self, max_queue_seconds: float = 600.0) -> list:
        """Abort requests stuck in the wait queue beyond a budget (page
        starvation under a long-running batch).  Returns the aborted
        requests."""
        now = time.monotonic()
        stuck = [r for r in list(self.waiting)
                 if now - r.submit_time > max_queue_seconds]
        for r in stuck:
            self._finish(r, FinishReason.ABORT)
        return stuck

    def preempt_for_pressure(self) -> Optional[str]:
        """Pick and preempt the degradation ladder's victim: through
        ``victim_policy`` when one is set, else the NEWEST admission,
        ties to the largest page footprint.  Requests swapped twice
        already are exempt.  Returns the preempted id, or None."""
        cands = [
            (req, i) for i, req in enumerate(self.slots)
            if req is not None and self._slot_active(i)
            and req.preempt_count < 2
        ]
        if self.victim_policy is not None and cands:
            try:
                ordered = list(self.victim_policy([r for r, _i in cands]))
            except Exception:  # noqa: BLE001 — a policy bug degrades, not kills
                logging.getLogger(__name__).exception(
                    "victim_policy failed; falling back to builtin pick")
                ordered = []
            for req in ordered:
                if req.finished or req.slot is None:
                    continue
                if self.preempt(req.id):
                    req.preempt_count += 1
                    return req.id
            if ordered:
                return None
        while cands:
            req, i = max(cands, key=lambda c: (
                c[0].admitted_time or 0.0,
                len(self.allocator.seq_pages(c[0].id))
                + len(self._shared_pages.get(c[0].id, ())),
            ))
            if self.preempt(req.id):
                req.preempt_count += 1
                return req.id
            cands.remove((req, i))
        return None

    def _discard_preempted(self, st: PreemptedSeq) -> None:
        st.entries = None
        if self.host_pool is None:
            return   # an imported park: nothing lives in the pool
        for pos in st.private_pos:
            self.host_pool.discard(("seq", st.req.id, pos))

    def _try_resume(self) -> None:
        """Swap parked decoders back in, FIFO, while a slot and pages are
        free.  Restored pages are the spilled bytes (checksummed both
        ways) and the key and histogram rejoin the device state, so a
        greedy or seeded continuation is the unpreempted one, token for
        token.  A page that fails its checksum aborts the request with
        ``kv_restore_corrupt`` (``drain_resume_failures``)."""
        while self.preempted:
            st = self.preempted[0]
            req = st.req
            if req.finished:   # aborted while parked
                self.preempted.pop(0)
                self._discard_preempted(st)
                continue
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            n_private = len(st.private_pos)
            # _ensure_pages: refcount-0 prefix pages evict (and spill)
            # for a resume as for an admission
            if not free_slots or not self._ensure_pages(n_private):
                return
            resume_adapter = 0
            if req.adapter:
                # a preempted request's ref is still parked (the same
                # slot comes back); an imported one pins its adapter
                # here, and a cold one keeps the park waiting while the
                # prefetch loads it
                got = self._acquire_adapter(req)
                if got is None:
                    self._adapter_ready(req)   # (re-)kick the prefetch
                    return
                resume_adapter = got
            t0 = time.monotonic()
            if st.entries is not None:
                entries = st.entries
            else:
                # claim + verify every host copy BEFORE touching the
                # allocator: one corrupt page aborts the whole resume
                entries = []
                for pos in st.private_pos:
                    e = self.host_pool.take_restored(("seq", req.id, pos))
                    if e is None:
                        break
                    entries.append(e)
                if len(entries) != n_private:
                    self.preempted.pop(0)
                    self._discard_preempted(st)
                    self._resume_failures.append((
                        req, "kv_restore_corrupt: a swapped-out page failed "
                        "checksum verification on resume"))
                    self._finish(req, FinishReason.ABORT)
                    continue
            new_pages = self.allocator.allocate(req.id, n_private)
            # an imported snapshot ships only the written head of its
            # table: the rest of the fresh pages is written before read
            restore_pages(self.cache, new_pages[: len(entries)], entries)
            st.entries = None
            table = np.array(st.table)
            for pos, pg in zip(st.private_pos, new_pages):
                table[pos] = pg
            slot = free_slots[0]
            self.slots[slot] = req
            req.slot = slot
            self._slot_adapters[slot] = resume_adapter
            row = np.zeros((self.cache_cfg.max_pages_per_seq,), np.int32)
            row[: len(table)] = table
            self._page_tables[slot] = row
            self._positions[slot] = st.position
            self._mrope_delta[slot] = st.mrope_delta
            self._last_token[slot] = st.last_token
            # the key goes back through the host mirror (a changed slot
            # takes its key from _slot_keys), the histogram through the
            # override applied at the next _sync_state
            self._slot_keys[slot] = st.key
            self._slot_count_overrides[slot] = st.counts
            self._state_dirty = True
            self._changed_slots.add(slot)
            self.num_resumes += 1
            self.restore_seconds += time.monotonic() - t0
            self.preempted.pop(0)
            logging.getLogger(__name__).info(
                "resumed request %s into slot %d (%d page(s) restored)",
                req.id, slot, len(entries))

    def drain_resume_failures(self) -> list:
        """(request, reason) pairs of resumes that failed verification;
        the engine loop turns them into error events."""
        out, self._resume_failures = self._resume_failures, []
        return out

    # ------------------------------------------------------------------
    # portable request snapshots
    # ------------------------------------------------------------------

    def _snapshot_pages(self, table, n_pages: int, private_pos=(),
                        req_id: str = "") -> Optional[tuple]:
        """The sequence's pages as host tensors in table order, with
        their checksums: ``private_pos`` pages from the host pool (a
        parked decoder's, verified at get), the rest gathered from the
        device.  None when a host copy failed verification."""
        private = set(private_pos)
        device_pos = [i for i in range(n_pages) if i not in private]
        gathered = {}
        arrays = gather_pages(self.cache, [int(table[i]) for i in device_pos])
        for pos, page in zip(device_pos, arrays):
            gathered[pos] = {f: None if a is None else a.to("cpu")
                             for f, a in page.items()}
        for pos in sorted(private):
            host = self.host_pool.get(("seq", req_id, pos))
            if host is None:
                return None
            gathered[pos] = host
        pages = [gathered[i] for i in range(n_pages)]
        return pages, [page_checksum(p).hex() for p in pages]

    def _snapshot_base(self, req: Request) -> dict:
        return {
            "version": SNAPSHOT_VERSION,
            "model": self.model_cfg.name,
            "request_id": req.id,
            "prompt_tokens": [int(t) for t in req.prompt_tokens],
            "output_tokens": [int(t) for t in req.output_tokens],
            "sampling": dataclasses.asdict(req.sampling),
            "stop_token_ids": [int(t) for t in req.stop_token_ids],
            "tenant": req.tenant,
            "trace_id": req.trace_id,
            "sched_class": req.sched_class,
            "adapter": req.adapter,
            "max_len": req.max_len,
            "preempt_count": req.preempt_count,
            "page_size": self.cache_cfg.page_size,
            "num_layers": self.model_cfg.num_layers,
            "kv_heads": self.model_cfg.num_kv_heads,
            "head_dim": self.model_cfg.head_dim,
            "kv_dtype": self.cache_cfg.dtype,
        }

    def export_request(self, req_id: str) -> Optional[RequestSnapshot]:
        """A portable snapshot of one live request; mutates nothing
        (refused on a mesh, ROADMAP A15b).

        - decoding in a slot: every page holding written KV, gathered
          with checksums, and the evolved key and histogram;
        - parked: private pages from the host pool, shared ones from the
          device (or the inline pages of an imported park);
        - queued or mid-chunk: no KV, replayed from the prompt.

        None when the request cannot be exported (unknown, finished, VL
        -- its image state is bound to this engine, as in the reference --,
        an unreconciled step or deferred first token, a parked page that
        failed verification)."""
        if self.mesh is not None:
            raise NotImplementedError(_EXPORT_ON_MESH)
        req = self._requests.get(req_id)
        if req is None or req.finished:
            return None
        if req.image_embeds is not None or req.positions3 is not None:
            return None
        if req.slot is not None and req.slot in self._tiered:
            # its demoted pages are in this engine's host tier only: a
            # snapshot gathered from the device table would carry holes
            return None
        base = self._snapshot_base(req)
        parked = next((st for st in self.preempted if st.req is req), None)
        if parked is not None:
            if parked.entries is not None:
                pages = list(parked.entries)
                checksums = [page_checksum(p).hex() for p in pages]
            else:
                snapped = self._snapshot_pages(
                    parked.table, len(parked.table),
                    private_pos=parked.private_pos, req_id=req.id)
                if snapped is None:
                    return None
                pages, checksums = snapped
            base["total_pages"] = len(parked.table)
            counts = parked.counts
            state = dict(position=int(parked.position),
                         last_token=int(parked.last_token),
                         mrope_delta=int(parked.mrope_delta),
                         key=[int(parked.key[0]), int(parked.key[1])])
        elif req.slot is not None and self._slot_active(req.slot):
            if not self._settled(req):
                return None
            slot = req.slot
            key, counts = self._slot_sampler_state(slot)
            n_alloc = len(self.allocator.seq_pages(req.id)) + len(
                self._shared_pages.get(req.id, ()))
            # only pages holding written KV (slots 0..num_tokens-2: the
            # newest token's KV lands in the next step) ship
            ps = self.cache_cfg.page_size
            n_resident = min(n_alloc, -(-req.num_tokens // ps))
            pages, checksums = self._snapshot_pages(
                self._page_tables[slot], n_resident)
            base["total_pages"] = n_alloc
            state = dict(position=int(self._positions[slot]),
                         last_token=int(self._last_token[slot]),
                         mrope_delta=int(self._mrope_delta[slot]),
                         key=[int(key[0]), int(key[1])])
        else:
            # queued or mid-chunk: no token emitted, replay is exact
            base["output_tokens"] = []
            pages, checksums, counts = [], [], None
            state = dict(position=None, last_token=None, mrope_delta=0,
                         key=None)
        sparse: dict = {}
        if counts is not None:
            sparse = {int(i): int(counts[i]) for i in np.nonzero(counts)[0]}
        self.num_snapshots_exported += 1
        return RequestSnapshot(**base, **state, token_counts=sparse,
                               pages=pages, page_checksums=checksums)

    def export_prefill(self, req_id: str) -> Optional[RequestSnapshot]:
        """The disaggregated prefill handoff: a snapshot of a request
        whose prefill has completed (its first token sampled, every
        prompt page written), for a decode peer to import and continue
        exactly.  None when the prefill has not finished (a peer replaying
        the prompt would be cheaper than shipping), when the request
        cannot be exported now (``export_request``: an unreconciled step
        or deferred first token; the loop reconciles before it calls
        this), or when the export carries no KV.  Mutates nothing: the
        caller aborts the local request only once the ship is confirmed,
        so a failed transfer degrades to local decode."""
        req = self._requests.get(req_id)
        if req is None or req.finished or not req.output_tokens:
            return None
        snap = self.export_request(req_id)
        if snap is None or not snap.has_kv:
            return None
        self.num_prefill_exports += 1
        return snap

    def import_request(self, snap: RequestSnapshot) -> Request:
        """Re-admit a snapshot on this engine.  Validation comes strictly
        before mutation: version, KV geometry (page size, layers, heads,
        head dim, storage dtype), then every page checksum over the
        stored bytes.  A KV-carrying snapshot parks on ``preempted`` with
        its pages inline and resumes through ``_try_resume``; one without
        KV joins the wait queue.  Raises ``SnapshotError`` and touches
        nothing on any failure."""
        if self.mesh is not None:
            raise NotImplementedError(_EXPORT_ON_MESH)
        if snap.version != SNAPSHOT_VERSION:
            raise SnapshotError(
                f"snapshot version {snap.version} != engine version "
                f"{SNAPSHOT_VERSION}", code="snapshot_unsupported")
        existing = self._requests.get(snap.request_id)
        if existing is not None and not existing.finished:
            raise SnapshotError(
                f"request {snap.request_id!r} is already live here",
                code="snapshot_duplicate")
        samp = dict(snap.sampling)
        samp["stop"] = tuple(samp.get("stop", ()) or ())
        req = Request(
            id=snap.request_id, prompt_tokens=list(snap.prompt_tokens),
            sampling=SamplingParams(**samp),
            stop_token_ids=tuple(snap.stop_token_ids),
            output_tokens=list(snap.output_tokens), trace_id=snap.trace_id,
            tenant=snap.tenant, sched_class=snap.sched_class,
            adapter=snap.adapter or "",
            preempt_count=int(snap.preempt_count),
        )
        err = self.validate_request(req)
        if err:
            raise SnapshotError(err, code="snapshot_invalid")
        if not snap.has_kv:
            if snap.output_tokens:
                raise SnapshotError(
                    "snapshot carries emitted tokens but no KV state; it "
                    "cannot be continued exactly", code="snapshot_corrupt")
            self._requests[req.id] = req
            self.waiting.append(req)
            self.num_snapshots_imported += 1
            return req
        entries, counts, n_total = self._validate_snapshot_kv(snap, req)
        limit = min(n_total * self.cache_cfg.page_size, self.max_context_len)
        req.max_len = min(int(snap.max_len or limit), limit)
        st = PreemptedSeq(
            req=req, table=np.zeros((n_total,), np.int32),
            private_pos=list(range(n_total)), position=int(snap.position),
            last_token=int(snap.last_token),
            mrope_delta=int(snap.mrope_delta),
            key=np.asarray(snap.key, np.uint32), counts=counts,
            entries=entries,
        )
        self._requests[req.id] = req
        self.preempted.append(st)
        self.num_snapshots_imported += 1
        return req

    def _validate_snapshot_kv(self, snap: RequestSnapshot,
                              req: Request) -> tuple:
        """Geometry, coverage and every page checksum of a KV-carrying
        snapshot; returns (entries, histogram, table pages)."""
        cc = self.cache_cfg
        mc = self.model_cfg
        for field, theirs, ours in (
            ("page_size", snap.page_size, cc.page_size),
            ("num_layers", snap.num_layers, mc.num_layers),
            ("kv_heads", snap.kv_heads, mc.num_kv_heads),
            ("head_dim", snap.head_dim, mc.head_dim),
            ("kv_dtype", snap.kv_dtype, cc.dtype),
        ):
            if theirs != ours:
                raise SnapshotError(
                    f"KV geometry mismatch on {field}: snapshot has "
                    f"{theirs!r}, this engine has {ours!r}",
                    code="snapshot_incompatible")
        n = len(snap.pages)
        if n != len(snap.page_checksums) or n == 0:
            raise SnapshotError("page/checksum count mismatch",
                                code="snapshot_corrupt")
        n_total = max(n, int(snap.total_pages or n))
        cap = min(cc.max_pages_per_seq, cc.num_pages - 1)
        if n_total > cap:
            raise SnapshotError(
                f"snapshot needs {n_total} pages; this engine caps a "
                f"sequence at {cap}", code="snapshot_incompatible")
        # the shipped pages must cover every written KV slot
        written = max(0, req.num_tokens - 1)
        if n * cc.page_size < written:
            raise SnapshotError(
                f"{n} shipped page(s) cannot cover {written} written KV "
                "slot(s)", code="snapshot_corrupt")
        kshape = (mc.num_layers, cc.page_size, mc.num_kv_heads, mc.head_dim)
        pool_dtype = self.cache.k_pages.dtype
        entries = []
        for arrays, digest in zip(snap.pages, snap.page_checksums):
            entry = {f: arrays.get(f) for f in PAGE_FIELDS}
            if entry["k"] is None or entry["v"] is None:
                raise SnapshotError("page missing k/v buffers",
                                    code="snapshot_corrupt")
            if tuple(entry["k"].shape) != kshape \
                    or tuple(entry["v"].shape) != kshape:
                raise SnapshotError(
                    f"page shape {tuple(entry['k'].shape)} != pool page "
                    f"shape {kshape}", code="snapshot_incompatible")
            if cc.quantized != (entry["k_scale"] is not None):
                raise SnapshotError(
                    "snapshot storage mode does not match the pool (int8 "
                    "scales present/absent)", code="snapshot_incompatible")
            if any(isinstance(entry[f], torch.Tensor)
                   and entry[f].dtype != pool_dtype for f in ("k", "v")):
                raise SnapshotError(
                    f"page dtype {entry['k'].dtype} != pool dtype "
                    f"{pool_dtype}", code="snapshot_incompatible")
            if page_checksum(entry).hex() != digest:
                raise SnapshotError(
                    "page failed checksum verification; refusing to "
                    "restore corrupt KV", code="snapshot_corrupt")
            entries.append(entry)
        V = mc.vocab_size
        counts = np.zeros((V,), np.int32)
        for tok, cnt in snap.token_counts.items():
            t = int(tok)
            if not 0 <= t < V:
                raise SnapshotError(
                    f"histogram token id {t} outside vocab {V}",
                    code="snapshot_incompatible")
            counts[t] = int(cnt)
        if snap.key is None or len(snap.key) != 2:
            raise SnapshotError("missing sampler key",
                                code="snapshot_corrupt")
        return entries, counts, n_total

    # ------------------------------------------------------------------
    # speculative decoding (engine/spec.py)
    # ------------------------------------------------------------------

    @property
    def spec_acceptance_ratio(self) -> float:
        """Lifetime accepted/drafted ratio (0.0 before any draft)."""
        d = self.num_spec_drafted_tokens
        return self.num_spec_accepted_tokens / d if d else 0.0

    def spec_disabled_slots(self) -> int:
        """Live requests currently EMA-disabled from speculating."""
        return self.spec.disabled_count() if self.spec is not None else 0

    def _spec_width(self) -> int:
        """Verify-row token width: spec_tokens + 1 (the bonus position)
        with speculation on, else 1.  Plain decode and mixed steps run
        their state rows 1 wide either way: the reference's one width is
        a compile-time shape, and an eager step has no reason to pay for
        ``W - 1`` dead positions per row."""
        return 1 if self.spec is None else self.cfg.spec_tokens + 1

    def _spec_extra_steps(self) -> int:
        """Fused tail after a verify call: starts from
        ``_decode_window()`` and halves while any active slot lacks room
        for ``spec_tokens + 1`` verify positions plus the tail."""
        n = self._decode_window()
        if n <= 1:
            return 0
        k1 = self.cfg.spec_tokens + 1
        table_cap = (
            self.cache_cfg.max_pages_per_seq * self.cache_cfg.page_size
        )
        for i, req in enumerate(self.slots):
            if req is None or not self._slot_active(i):
                continue
            pend = self._pending_out(req)
            h = min(
                req.sampling.max_tokens - len(req.output_tokens) - pend,
                (req.max_len or self.cache_cfg.max_seq_len)
                - req.num_tokens - pend,
                table_cap - int(self._positions[i]),
            )
            while n > 1 and k1 + n - 1 > h:
                n //= 2
            if n <= 1:
                return 0
        return n - 1

    def _spec_dispatch(self) -> Optional[PendingStep]:
        """One speculative step: draft per slot on the host, then verify
        every slot's drafts in ONE device call.  None when no slot drafted
        anything (the caller then runs the plain fused window)."""
        k = self.cfg.spec_tokens
        ps = self.cache_cfg.page_size
        B = self.cfg.max_decode_batch
        table_cap = self.cache_cfg.max_pages_per_seq * ps
        drafts = np.zeros((B, self._spec_width() - 1), np.int32)
        draft_len = np.zeros((B,), np.int32)
        for i, req in enumerate(self.slots):
            if req is None or not self._slot_active(i):
                continue
            if req.id in self._pending_first_ids:
                # its host-visible sequence lags the device by the
                # deferred first token: a draft would condition on the
                # wrong suffix
                continue
            pos = int(self._positions[i])
            # the verify call writes KV at pos..pos+L: the draft must fit
            # the slot's pages and its remaining token budget
            pend = self._pending_out(req)
            budget = req.sampling.max_tokens - len(req.output_tokens) - pend
            room = ((req.max_len or self.cache_cfg.max_seq_len)
                    - req.num_tokens - pend)
            cap = min(k, budget - 1, room - 1, table_cap - pos - 1)
            if cap <= 0:
                continue
            toks = self.spec.draft(
                req.id, req.prompt_tokens + req.output_tokens, cap
            )
            if not toks:
                continue
            # rejected drafts' KV lands only in the slot's PRIVATE page
            # tail past the last prompt token: the prefix cache shares
            # only full pages strictly below it, so a rejected draft can
            # never corrupt KV another request reads
            plen = len(req.prompt_tokens)
            n_shared = len(self._shared_pages.get(req.id, ()))
            assert pos >= plen and n_shared * ps <= max(plen - 1, 0), (
                f"speculative KV write would touch shared pages: slot "
                f"{i} at position {pos}, prompt {plen} tokens, "
                f"{n_shared} shared pages of {ps}"
            )
            drafts[i, : len(toks)] = toks
            draft_len[i] = len(toks)
        if not draft_len.any():
            return None
        return self._spec_dispatch_tail(drafts, draft_len)

    def _spec_dispatch_tail(self, drafts, draft_len) -> PendingStep:
        """The device half of a spec step: the verify call plus its fused
        tail, and the fetch of both."""
        rows = [
            (i, r) for i, r in enumerate(self.slots)
            if r is not None and self._slot_active(i)
        ]
        n_extra = self._spec_extra_steps()
        _, sampled, emit, extra = self._ragged_step(
            drafts=drafts, draft_len=draft_len, n_extra=n_extra,
        )
        self.num_spec_steps += 1
        # ONE device call for verify + tail: with accepted drafts,
        # decode tokens per device step exceeds 1 per slot
        self.num_decode_device_steps += 1 + n_extra
        self.num_decode_slot_steps += (1 + n_extra) * len(rows)
        pf = self._take_pending_first()
        return PendingStep(
            kind="spec", rows=rows, n_extra=n_extra, draft_len=draft_len,
            pending_first=pf,
            fetch=Fetch([sampled, emit, *extra] + [t[:1] for _r, t in pf]),
        )

    def _spec_complete(self, p: PendingStep, emitted) -> None:
        fetched = self._fetch(p.fetch)
        sampled_np, emit_np = fetched[0], fetched[1]
        extra_np = fetched[2:2 + p.n_extra]
        for (req, _t), tok_np in zip(p.pending_first,
                                     fetched[2 + p.n_extra:]):
            self._finish_first_emit(req, int(tok_np[0]), emitted)
        for i, req in p.rows:
            if self.slots[i] is not req:
                continue
            e = int(emit_np[i])
            L = int(p.draft_len[i])
            if L:
                acc = min(e - 1, L)
                self.num_spec_drafted_tokens += L
                self.num_spec_accepted_tokens += acc
                self.spec.observe(req.id, L, acc)
            for j in range(e):
                if self.slots[i] is not req or req.finished:
                    break   # finished mid-verify: discard the overrun
                self._positions[i] += 1
                self._last_token[i] = sampled_np[i, j]
                self.num_decode_tokens += 1
                self._emit(req, int(sampled_np[i, j]), emitted)
        # fused-window tail tokens (finished slots discard the overrun)
        for s in range(p.n_extra):
            for i, req in p.rows:
                if self.slots[i] is not req or req.finished:
                    continue
                self._positions[i] += 1
                self._last_token[i] = extra_np[s][i]
                self.num_decode_tokens += 1
                self._emit(req, int(extra_np[s][i]), emitted)

    # ------------------------------------------------------------------
    # plain decode
    # ------------------------------------------------------------------

    def _decode_dispatch(self) -> PendingStep:
        n = self._decode_window()
        self._check_headroom(n)
        rows = [
            (i, r) for i, r in enumerate(self.slots)
            if r is not None and self._slot_active(i)
        ]
        # plain decode IS the unified step without drafts (1-wide rows)
        _, sampled, _, extra = self._ragged_step(draft_len=self._zero_rows,
                                                 n_extra=n - 1)
        self.num_decode_device_steps += n
        self.num_decode_slot_steps += n * len(rows)
        # predicted advance: the device moves every dispatched row the
        # full window, so the position mirror advances now; this is what
        # lets the async loop build step N+1 before step N's tokens land
        for i, r in rows:
            self._positions[i] += n
            self._inflight_out[r.id] = self._inflight_out.get(r.id, 0) + n
        pf = self._take_pending_first()
        return PendingStep(
            kind="decode", rows=rows, n=n, pending_first=pf,
            fetch=Fetch([sampled[:, 0], *extra] + [t[:1] for _r, t in pf]),
        )

    def _decode_complete(self, p: PendingStep, emitted) -> None:
        fetched = self._fetch(p.fetch)
        toks = fetched[:p.n]
        for (req, _t), tok_np in zip(p.pending_first, fetched[p.n:]):
            self._finish_first_emit(req, int(tok_np[0]), emitted)
        if p.pending_first:
            self._drain_moe_drops()   # the fetch above synced the device
        for _i, r in p.rows:
            left = self._inflight_out.get(r.id, 0) - p.n
            if left > 0:
                self._inflight_out[r.id] = left
            else:
                self._inflight_out.pop(r.id, None)
        for s in range(p.n):
            for i, r in p.rows:
                if self.slots[i] is not r or r.finished:
                    continue   # finished mid-window: discard the overrun
                self._last_token[i] = toks[s][i]
                self.num_decode_tokens += 1
                self._emit(r, int(toks[s][i]), emitted)

    # ------------------------------------------------------------------
    # the unified ragged device step
    # ------------------------------------------------------------------

    def _paged_attn(self, cache, q, k, v, lyr, t0, q_len, hist, tables,
                    cold: Optional[dict] = None):
        """One ragged-op call from inside a forward on ``cache`` (the
        pool, or a shard's): flatten the token grid onto the op's flat
        row axis (int8 pools bring their scale pools, tiered rows their
        demoted spans and the staged cold slab, as the reference's
        ``_ragged_attn_call``)."""
        Bq, Sq, H, D = q.shape
        KVH = k.shape[-2]
        out = ragged_paged_attention(
            q.reshape(Bq * Sq, H, D), k.reshape(Bq * Sq, KVH, D),
            v.reshape(Bq * Sq, KVH, D), cache.k_pages,
            cache.v_pages, lyr, t0, q_len, hist, tables,
            backend=self.cfg.attn_backend, k_scale=cache.k_scale,
            v_scale=cache.v_scale, **(cold or {}),
        )
        return out.reshape(Bq, Sq, H, D)

    def _kv_buffers(self, B: int, S: int) -> list:
        """A forward's fresh K/V, ``[L, B, S, KVH, D]`` twice, per shard
        (one pair on one device; a shard's own KV heads on its device)."""
        cfg = self.model_cfg
        dt = torch_dtype(cfg.dtype)
        out = []
        for cache in self.caches:
            shape = (cfg.num_layers, B, S, cache.k_pages.shape[3],
                     cfg.head_dim)
            dev = cache.k_pages.device
            out.append((torch.empty(shape, dtype=dt, device=dev),
                        torch.empty(shape, dtype=dt, device=dev)))
        return out

    def _replicas(self, tensors: dict) -> list:
        """``tensors`` (on the engine's device) once per shard, each dict
        on its shard's device: the step's metadata reaching every card
        (one dict where there is one device)."""
        if self.mesh is None:
            return [tensors]
        return [tensors if torch.device(d) == self.device else
                {k: t.to(d, non_blocking=True) for k, t in tensors.items()}
                for d in self.mesh.devices]

    def _forward(self, tokens, pos, attn_fns: list, **kw):
        """The model forward with one attention function per shard:
        ``models.llama.forward`` on one device (the pool as its carry),
        ``forward_sharded`` over a mesh (the hidden state or the logits
        on the first device)."""
        if self.mesh is None:
            return forward(self._graft_params(), self.model_cfg, tokens,
                           pos, attn_fn=attn_fns[0],
                           carry_caches=self.caches[0], **kw)
        return forward_sharded(self.params, self.model_cfg, tokens, pos,
                               attn_fns=attn_fns, carry_caches=self.caches,
                               mesh=self.mesh, **kw)

    def _project(self, h):
        """Final-norm hidden rows -> float32 logits (gathered on the
        first device over a mesh)."""
        if self.mesh is None:
            return project_logits(self.params, self.model_cfg, h)
        return project_logits_sharded(self.params, self.model_cfg, h,
                                      self.mesh)

    def _prefill_segment(self, plan: PrefillPlan,
                         cold: Optional[dict] = None) -> torch.Tensor:
        """Forward the plan's rows on one flat token axis, persist their
        K/V, sample each row's first token.  Returns [R] int64."""
        if self.model_cfg.mrope_sections is not None:
            raise ValueError(
                "mrope prompts prefill through the VL single-shot path "
                "(Engine._prefill), never the ragged prefill segment")
        rung = bucket_tokens(plan.used, self._token_ladder)
        self.num_prefill_padding_tokens += max(0, rung - plan.used)
        a = plan.finalize_device(rung, self.device)
        has_hist = plan.has_hist or cold is not None
        self.attn_forwards["k1" if has_hist else "k2"] += 1
        bufs = self._kv_buffers(1, rung)
        metas = self._replicas({k: a[k] for k in (
            "t0", "qlen", "hist", "tables", "seg", "pages", "offsets")})

        def p_attn_of(kacc, vacc, m):
            def p_attn(q, k, v, carry, pos):
                cache, lyr = carry
                kacc[lyr].copy_(k)
                vacc[lyr].copy_(v)
                if has_hist:
                    out = self._paged_attn(cache, q, k, v, lyr, m["t0"],
                                           m["qlen"], m["hist"],
                                           m["tables"], cold)
                else:
                    # cold rows only: packed self-attention, no pool reads
                    out = attention(
                        q, k, v, causal=True, q_positions=pos,
                        kv_positions=pos, q_segment_ids=m["seg"],
                        kv_segment_ids=m["seg"],
                        backend=self.cfg.attn_backend,
                    )
                return out, cache
            return p_attn

        attn_fns = [p_attn_of(*kv, m) for kv, m in zip(bufs, metas)]
        # the MoE capacity follows the whole bucket, padding included;
        # padding takes none of it (the reference's moe_token_mask)
        valid = a["seg"] > 0
        kw = {}
        if self.mesh is None:
            kw = dict(adapter_ids=a["aids"] if plan.has_adapter else None,
                      moe_token_mask=valid,
                      return_moe_stats=self.model_cfg.num_experts > 0)
        h, _, *stats = self._forward(a["tokens"], a["pos"], attn_fns,
                                     return_hidden=True, **kw)
        if stats:
            # queued unread: a read here would wait for the call
            self._moe_drop_handles.append(stats[0]["dropped"])
        # pools updated in place (the reference's donated scatter)
        for cache, (kacc, vacc), m in zip(self.caches, bufs, metas):
            write_kv(cache, kacc, vacc, m["pages"], m["offsets"],
                     m["seg"] > 0)
        last = self._project(h[0, a["ends"].long()])          # [R, V]
        if self.logits_hook is not None:
            self.logits_hook("prefill", last[: len(plan.rows)])
        greedy = SamplingParams(temperature=0.0)
        sampling = SamplingState.from_params(
            [r.sampling for r in plan.rows]
            + [greedy] * (plan.max_rows - len(plan.rows)),
            device=self.device,
        )
        return sample(last, sampling, a["keys"])

    def _state_rows(self, W: int, draft_len, drafts=None,
                    cold: Optional[dict] = None):
        """The state segment at width ``W``: every slot is a ``W``-token
        row over its paged history, its last token followed by
        ``drafts [B, W-1]``; positions ``0..draft_len[b]`` are live
        (``draft_len`` -1: the row sits out, q_len 0).  Samples every live
        position with the histogram carried along the drafted prefix,
        keeps the longest prefix agreeing with the drafts and rolls the
        device state back past it.  ``draft_len`` is host int32 ``[B]``
        (already -1 where the slot is not active).  Returns ``(sampled
        [B, W], emit [B])``: emit = accepted drafts + 1 (0 off-row)."""
        st = self._dstate
        dev = self.device
        B = len(draft_len)
        live = np.arange(W)[None, :] <= draft_len[:, None]       # [B, W]
        dl_t = upload(draft_len.astype(np.int64), dev)
        offs = self._offsets[W]
        live_t = offs[None, :] <= dl_t[:, None]
        q_len = torch.where(dl_t >= 0, W, 0).to(torch.int32)
        hist = (st.positions * st.active).to(torch.int32)
        tokens = st.last_token[:, None]
        if W > 1:
            drafts_t = upload(drafts.astype(np.int64), dev)
            tokens = torch.cat([tokens, drafts_t], dim=1)
        pos = st.positions[:, None] + offs[None, :]
        self.attn_forwards["k1"] += 1
        bufs = self._kv_buffers(B, W)
        pages, page_offs = slot_to_page_offset(pos, st.page_tables,
                                               self.cache_cfg.page_size)
        metas = self._replicas({
            "t0": self._row_t0[W], "qlen": q_len, "hist": hist,
            "tables": st.page_tables, "pages": pages, "offsets": page_offs,
            "live": live_t})

        def s_attn_of(kacc, vacc, m):
            def s_attn(q, k, v, carry, _pos):
                cache, lyr = carry
                kacc[lyr].copy_(k)
                vacc[lyr].copy_(v)
                out = self._paged_attn(cache, q, k, v, lyr, m["t0"],
                                       m["qlen"], m["hist"], m["tables"],
                                       cold)
                return out, cache
            return s_attn

        # every state row carries its slot's adapter (verify rows and the
        # fused tail alike); no delta when no live row has one
        aids = None
        if (self._slot_adapters[draft_len >= 0] != 0).any():
            aids = st.adapter_slots[:, None].expand(B, W)
        # past the prompt a VL row's three M-RoPE streams advance together
        # at its constant offset from the sequence index
        pos3 = None
        if self.model_cfg.mrope_sections is not None:
            pos3 = (pos + st.mrope_delta[:, None])[None].expand(3, B, W)
        attn_fns = [s_attn_of(*kv, m) for kv, m in zip(bufs, metas)]
        kw = {}
        if self.mesh is None:
            kw = dict(adapter_ids=aids, positions3=pos3,
                      moe_token_mask=live_t)
        logits, _ = self._forward(tokens, pos, attn_fns, **kw)
        for cache, (kacc, vacc), m in zip(self.caches, bufs, metas):
            write_kv(cache, kacc, vacc, m["pages"], m["offsets"], m["live"])
        if self.logits_hook is not None:
            self.logits_hook("decode", logits[:, 0])
            if W > 1:
                self.logits_hook("verify", logits)
        # position by position: penalties see the drafted prefix as
        # emitted; a key split is spent only at live positions (a plain
        # step advances each key once) and is NOT rolled back below
        counts = st.token_counts
        keys = self._dkeys
        toks = []
        for j in range(W):
            lj = live_t[:, j]
            pen = apply_penalties(logits[:, j], counts,
                                  st.sampling.presence, st.sampling.frequency)
            carry, step = split_keys(keys)
            tok = torch.where(lj, sample(pen, st.sampling, step), 0)
            keys = np.where(live[:, j, None], carry, keys)
            counts.scatter_add_(1, tok[:, None], lj[:, None].to(counts.dtype))
            toks.append(tok)
        self._dkeys = keys
        sampled = torch.stack(toks, dim=1)                        # [B, W]
        if W > 1:
            # acceptance: the longest prefix of draws agreeing with the
            # drafts
            in_draft = offs[None, : W - 1] < dl_t[:, None]
            agree = torch.where(in_draft, sampled[:, : W - 1] == drafts_t,
                                True)
            prefix = torch.cumprod(agree.to(torch.int64), dim=1)
            n_acc = (prefix * in_draft).sum(dim=1)
            emit = torch.where(live_t[:, 0], n_acc + 1, 0)
            # roll back past the accepted length: the histogram loses the
            # discarded draws (pad positions drew token 0 and added 0)
            discard = (offs[None, :] >= emit[:, None]) & live_t
            counts.scatter_add_(1, sampled, -discard.to(counts.dtype))
            new_last = sampled.gather(
                1, (emit - 1).clamp(min=0)[:, None])[:, 0]
        else:
            emit = live_t[:, 0].to(torch.int64)
            new_last = sampled[:, 0]
        st.last_token = torch.where(emit > 0, new_last, st.last_token)
        st.positions = st.positions + emit
        return sampled, emit

    def _ragged_step(self, plan=None, drafts=None, draft_len=None,
                     n_extra: int = 0):
        """ONE unified device step, queued: the optional prefill plan's
        rows, the decode-state segment (rows with ``draft_len`` >= 0, at
        width ``W = drafts.shape[1] + 1``, 1 without drafts) and a fused
        tail of ``n_extra`` plain decode steps.  Returns ``(p_first [R] or
        None, sampled [B, W] or None, emit [B] or None, extra list of
        [B])`` device tensors.  Tiered rows first run the residency pass
        (before the state upload, so the tables it changes go up) and
        bind the staged cold slab."""
        if self._tiered:
            self._tiered_prep(n_extra)
        if self._state_dirty or self._dstate is None:
            self._sync_state()
        p_cold = s_cold = None
        if self._tiered:
            staged = self._refresh_cold_staged()
            if staged is not None:
                bound = self._finalize_cold(staged, plan)
                if bound is not None:
                    p_cold, s_cold = bound
        W = 1 if drafts is None else drafts.shape[1] + 1
        if draft_len is None:
            draft_len = self._inert_rows
        self.num_device_calls += 1
        p_first = None
        if plan is not None and plan.rows:
            p_first = self._prefill_segment(plan, p_cold)
        dl = np.where(self._active, draft_len, -1).astype(np.int32)
        self._note_adapter_rows(plan, dl)
        sampled = emit = None
        if (dl >= 0).any():
            sampled, emit = self._state_rows(W, dl, drafts, s_cold)
        tail_dl = np.where(self._active, 0, -1).astype(np.int32)
        extra = [self._state_rows(1, tail_dl, cold=s_cold)[0][:, 0]
                 for _ in range(n_extra)]
        return p_first, sampled, emit, extra

    # ------------------------------------------------------------------
    # completion
    # ------------------------------------------------------------------

    def _emit(self, req: Request, token: int, emitted: list) -> None:
        req.output_tokens.append(token)
        self.num_generated_tokens += 1
        emitted.append((req, token))
        stop_ids = set(req.stop_token_ids) | set(self.cfg.eos_token_ids)
        if token in stop_ids:
            self._finish(req, FinishReason.STOP)
        elif len(req.output_tokens) >= req.sampling.max_tokens:
            self._finish(req, FinishReason.LENGTH)
        elif req.num_tokens >= (req.max_len or self.cache_cfg.max_seq_len):
            self._finish(req, FinishReason.LENGTH)

    def _adopt_prompt_pages(self, req: Request, table) -> None:
        """Hand a fully resident prompt's fresh full pages to the prefix
        cache (detached from the allocator so teardown cannot free them
        from under a later sharer).  Not for a tiered row: its prompt
        pages may already be in the host tier."""
        if self.prefix_cache is None or req.slot in self._tiered:
            return
        hashes = self._prompt_hashes(req)
        ps = self.cache_cfg.page_size
        k_shared = req.cached_tokens // ps
        fresh_hashes = hashes[k_shared:]
        if not fresh_hashes:
            return
        fresh_pages = [int(table[i]) for i in range(k_shared, len(hashes))]
        adopted = self.prefix_cache.adopt(fresh_hashes, fresh_pages)
        if adopted:
            self.allocator.detach(req.id, adopted)
            self._shared_pages.setdefault(req.id, []).extend(adopted)
        if self.kv_filestore is not None:
            # write-through to the persistent rung: freshly prefilled full
            # pages persist, so a restarted node (or a decode node on the
            # shared directory) serves this prefix without prefilling it
            self._store_filestore_pages(req, fresh_hashes, fresh_pages)

    def _store_filestore_pages(self, req: Request, hashes: list,
                               pages: list) -> None:
        """Persist freshly prefilled full prefix pages: one gather of the
        not-yet-stored subset into fresh buffers, queued on the current
        stream after the prefill that wrote them, and an event recorded
        behind it; the store's writer thread waits on the event, then
        copies, checksums, encodes and writes (``put_async``)."""
        want = [(h, p) for h, p in zip(hashes, pages)
                if not self.kv_filestore.contains(h)]
        if not want:
            return
        try:
            arrays = gather_pages(self.cache, [p for _h, p in want])
            ready = None
            if self.cache.k_pages.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(
                    self.cache.k_pages.device))
            for (h, _p), page_arrays in zip(want, arrays):
                self.kv_filestore.put_async(h, page_arrays,
                                            tenant=req.tenant, ready=ready)
        except Exception:  # noqa: BLE001 — the tier degrades, never fails
            logging.getLogger(__name__).exception(
                "KV filestore write-through failed for request %s", req.id)

    def _finish(self, req: Request, reason: FinishReason) -> None:
        req.finished = True
        req.finish_reason = reason
        if req.slot is not None:
            led = self._tiered.pop(req.slot, None)
            if led is not None:
                # its cold pages and any slab holding them go
                for idx in range(led["lo"], led["hi"]):
                    self.host_pool.discard(("ctx", led["rid"], idx))
                self._retire_cold_staged()
            self.slots[req.slot] = None
            self._slot_adapters[req.slot] = 0
            # a deferred first token's seed, or a resumed histogram, must
            # not reach the slot's next occupant
            self._pending_token_patches.pop(req.slot, None)
            self._slot_count_overrides.pop(req.slot, None)
            self._state_dirty = True
            self._changed_slots.add(req.slot)
            req.slot = None
        if req in self.waiting:
            self.waiting.remove(req)
        for st in list(self.preempted):   # aborted while parked
            if st.req is req:
                self.preempted.remove(st)
                self._discard_preempted(st)
        self._requests.pop(req.id, None)
        shared = self._shared_pages.pop(req.id, None)
        if shared and self.prefix_cache is not None:
            self.prefix_cache.release(shared)
        if self.spec is not None:
            self.spec.forget(req.id)
        self._release_adapter(req)
        self._adapter_hashes.pop(req.id, None)
        if self.allocator.owns(req.id):
            self.allocator.free(req.id)
