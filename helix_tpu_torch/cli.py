"""Command line of the port: ``python -m helix_tpu_torch serve-node``
and ``python -m helix_tpu_torch sft``.

The counterpart of ``helix-tpu serve-node``: a profile entry with a
``checkpoint:`` directory serves that HF safetensors checkpoint (its
``config.json``, its weights streamed onto the device by
``models.loader.load_params``, its ``tokenizer.json`` read by the port's
own ``HFTokenizer``, whose end-of-turn tokens stop generation); any other
model is a catalog architecture (or the tiny test config for unknown
names) with random weights made on the device from a seed and the
``ByteTokenizer``.  Either is served over the OpenAI HTTP surface.

    python -m helix_tpu_torch serve-node \\
        --model meta-llama/Meta-Llama-3-8B-Instruct --port 8000 \\
        [--device cuda] [--engine max_prefill_len=512 ...]
    python -m helix_tpu_torch serve-node --profile profile.json
    python -m helix_tpu_torch serve-node --runner-id a \\
        --control-plane http://cp:8080 [--heartbeat-interval 30] \\
        [--advertise http://this-node:8000]
    python -m helix_tpu_torch serve-node --runner-id a --tunnel \\
        --control-plane http://cp:8080 [--unix-socket /run/helix.sock]
    python -m helix_tpu_torch sft --data chats.jsonl \\
        --model meta-llama/Meta-Llama-3-8B-Instruct --output ckpt/ \\
        [--checkpoint hf-dir] [--steps 100] [--device cuda]

``sft`` is the reference's ``helix-tpu sft`` on one device: LoRA
adapters (rank ``--rank``, alpha ``--alpha``, on wq, wk, wv and wo) on a
frozen base, the checkpoint's weights and tokenizer or the catalog
architecture with random weights from seed 0 and the byte tokenizer,
trained on the JSONL rows (``{"messages": [...]}`` or ``{"prompt",
"completion"}``) packed into ``--batch-size`` x ``--seq-len`` batches
(``training.sft.SFTTrainer``), one JSON line every ``--log-every``
steps, an adapter checkpoint under ``--output`` every ``--save-every``
steps and at the end (``--resume`` continues from its latest).  It runs
on the card unless ``--device cpu`` is given.  ``--coordinator``,
``--num-hosts`` and ``--host-rank`` (training over several hosts) are
refused (ROADMAP A15b).  A saved checkpoint serves without a restart
through ``POST /v1/adapters`` (the multi-LoRA pool, ``model@name``) or
merged at profile-apply time by an entry's ``adapter:`` field.

The node is run by the node agent (``control.node_agent.NodeAgent``),
which owns the registry: ``--profile`` (or ``--model``) is applied at
start; with ``--control-plane`` the agent heartbeats its inventory,
profile state and saturation there, and without a profile it waits for
one to be assigned (the assignment poll; a drain request there drains the
node to a peer and ends the process).  SIGTERM and SIGINT drain every
engine for ``HELIX_DRAIN_SECONDS``, ship the survivors to a peer the
control plane names, and exit 0.  ``--tunnel`` serves a node behind
NAT: no TCP listener, the OpenAI surface on a unix socket (``--unix-socket``,
else ``openai.sock`` in a new ``helix-node-*`` temporary directory), an
outbound reverse tunnel to ``--control-plane`` (``control.tunnel``) that
carries the control plane's requests to it, and a heartbeat that
advertises no address; the tunnel stays up through the drain and closes
after it.

A profile is JSON (or YAML when ``yaml`` is importable) with a ``models``
list of ``{name, kind, quantization, engine, model_overrides,
context_length, mesh, slo}`` entries, the reference's profile fields,
and an optional top-level ``residency: {hbm_budget_bytes}`` block.
``quantization: int8`` serves int8 weights (the reference node agent's
``quantize_params`` values, made on the device as each weight is drawn);
an int8 KV pool is
``engine: {kv_cache_dtype: int8}``.  Every ``engine:`` field goes to
``EngineConfig`` as it is, so ``enable_spec_decode``, ``spec_tokens``,
``enable_async_loop``, ``host_pool_bytes``, ``adapter_pool_slots`` and
``adapter_rank`` work as in the reference (adapters are addressed as
``model@adapter``).  An entry's ``slo`` block is served as the reference
node agent serves it: its targets (``ttft_p95_seconds``,
``queue_wait_p95_seconds``, ``goodput_floor_tps``) drive the loop's burn
rates, and its ``sched`` sub-block (``serving.sched.SchedConfig.
from_profile``, with the ``HELIX_SCHED_*`` overrides) picks the
scheduler: FIFO, or WFQ with strict interactive-over-batch priority,
per-tenant weights, a per-tenant queue bound and the adaptive prefill
budget.

With ``residency`` the node serves its models through an
``engine.residency.ResidencyManager`` (the reference node agent's
``_apply_residency``): nothing is built at start, a model loads on its
first request and evicts the least recently used idle model when the
budget (``hbm_budget_bytes``, else the card's memory) would overflow;
``POST /admin/prefetch`` stages one in the background.  Without it every
entry is built at start.

An entry with ``kind: vision`` serves Qwen2-VL chats (the reference
node agent's build): the text tower through the engine and loop as a
chat entry, the vision tower beside it in a
``serving.vision.VisionRunner`` that the server runs on image parts; a
Qwen2-VL checkpoint (``models.qwen2_vl.load_qwen2_vl``), else the
reference's tiny mrope text tower (``mrope_sections (2, 3, 3)``) and tiny
vision tower with random weights from ``--seed`` and ``--seed + 1``.  The
image token ids are the tokenizer's ``<|image_pad|>``,
``<|vision_start|>`` and ``<|vision_end|>``, else the reference's 264,
265 and 266.  ``kind: vision-embedding`` pools the same towers behind
``/v1/embeddings`` (``models.vision_embed``), with no engine loop.

An entry with ``kind: embedding`` is an encoder (``models.bge``) behind
``/v1/embeddings``: its checkpoint's weights and ``tokenizer.json`` (the
byte tokenizer without one), else the reference's tiny encoder with
random weights from ``--seed``, in float32, ``engine: {max_batch}`` rows
per forward; it has no engine loop.  A profile entry's ``engine:
{attn_backend: reference}`` (the reference's switch to its attention
without Pallas, for the CPU) is dropped with a log line: the port's
served path always goes through the kernels' wrappers, which run their
plain versions on CPU tensors.

``--random-weights`` serves a ``checkpoint:`` entry with random weights
from ``--seed`` in place of its files.  A checkpoint directory that is
missing, whose config the port cannot compute (a ``rope_scaling``
other than ``llama3`` or mrope: ROADMAP C; an unknown activation) or
that disagrees with the entry's ``model_overrides`` is refused at start.
A Mixtral entry (``num_local_experts`` in its checkpoint's config, or
the catalog's ``mistralai/Mixtral-8x7B-Instruct-v0.1``) is a chat entry
like any other: its engine takes the reference's MoE rules.  An entry's
``mesh: {ep: e, tp: n, device_offset: k}`` is realised over the node's
devices ``k .. k + e n - 1`` (``device.mesh.build_mesh``; the
reference's ``ValueError`` when fewer are visible): a chat entry on more
than one device is served tensor (and, over ``ep``, expert) parallel by
one engine over those devices (its random weights drawn a layer at a
time on the first and copied into the shards by ``parallel.sharding``'s
rules, its checkpoint loaded shard by shard), any other entry is
committed to the slice's first device.  What is not ported yet is
refused at start too, before any weights are made, naming its ROADMAP
item: a mesh axis other than ``tp`` and ``ep`` above 1, and on a mesh a
vision entry, an adapter and the engine options of
``engine.engine.mesh_refusals`` (A15b's later parts), and a
``multihost`` block (A15b).  A profile assigned by
the control plane with such an entry fails its apply with that text
(``status: failed``).  A chat or vision entry's ``adapter:`` (a
``sft --output`` directory) is restored and grafted into its weights at
build (``training.lora.merge_lora_into_params``), applied at
``adapter_scale`` or else the scale it was trained at; an embedding
entry's is ignored with a log line, as the reference node agent ignores
it.

The node's operator overrides, as the reference node agent reads them:
``HELIX_KV_HOST_POOL_BYTES`` replaces every engine's ``host_pool_bytes``
(0 turns the host tier off), ``HELIX_SPEC_TOKENS``,
``HELIX_ASYNC_LOOP``, ``HELIX_MAX_PAGES_PER_SEQ`` and
``HELIX_CTX_HOT_PAGES`` replace the engine fields they name (see
``_operator_overrides``), an entry's ``context_length`` caps its requests
(``max_model_len``, with the page tables to hold it),
``HELIX_PREEMPT_STALL_SECONDS`` arms
preemption by swap after admission has stalled that long,
``HELIX_ADMISSION_TIMEOUT`` sheds requests that waited that long for KV
pages with a typed ``kv_exhausted`` 503,
``HELIX_ADAPTER_POOL_SLOTS`` replaces every engine's
``adapter_pool_slots`` (0 turns the adapter pool off),
``HELIX_MAX_QUEUE_DEPTH`` and ``HELIX_MAX_QUEUED_TOKENS`` bound each
loop's admission (a 429 ``queue_full`` past them; unbounded when unset)
and ``HELIX_TENANT_TOP_K`` sets how many tenants get their own series.

A profile's ``role`` (``prefill | decode | mixed``; ``HELIX_POOL_ROLE``
beats it) goes out in the heartbeat, where the control plane reads it: a
prefill node is sent streamed prompts marked for the disaggregated
handoff (``X-Helix-Disagg``) and ships each request's KV to the decode
node the request names as soon as its first token exists
(``OpenAIServer``).  ``HELIX_FILESTORE_KV_DIR`` arms every chat engine's
persistent KV tier (``serving.kv_filestore``): full prefix pages are
written through to that directory and restored from it, across restarts
and across the nodes that share it (``HELIX_FILESTORE_KV_QUOTA_BYTES``
caps each tenant's writes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time

import torch

from helix_tpu_torch.control.profile import ProfileModel, ServingProfile
from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from helix_tpu_torch.engine.adapters import adapter_pool_slots_env
from helix_tpu_torch.engine.engine import Engine, EngineConfig
from helix_tpu_torch.engine.residency import estimate_model_bytes
from helix_tpu_torch.models.common import CATALOG, ModelConfig
from helix_tpu_torch.models.bge import EmbeddingRunner
from helix_tpu_torch.models.llama import init_params
from helix_tpu_torch.models.loader import (
    load_config,
    load_params,
    read_hf_config,
)
from helix_tpu_torch.serving.engine_loop import EngineLoop
from helix_tpu_torch.serving.kv_filestore import (
    filestore_for_engine,
    kv_filestore_dir,
)
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ServedModel
from helix_tpu_torch.serving.sched import SchedConfig
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer

log = logging.getLogger("helix_tpu_torch")

# the reference node agent's image token ids without a tokenizer that
# names them (``helix_tpu/control/node_agent.py:126-130``)
IMAGE_PAD_ID, VISION_START_ID, VISION_END_ID = 260 + 4, 260 + 5, 260 + 6
KINDS = ("chat", "embedding", "vision", "vision-embedding")

# the reference node agent's flat reservation for an embedding entry
# (``helix_tpu/control/node_agent.py:648``): below bge-base's own 435.6 MB
# of float32 weights, kept as the reference has it (ROADMAP C)
EMBEDDING_ESTIMATE_BYTES = 1 << 28


def model_config(name: str, overrides: dict | None = None) -> ModelConfig:
    """The catalog architecture for ``name`` (tiny test config for an
    unknown name), with ``overrides`` applied."""
    overrides = overrides or {}
    cfg = CATALOG.get(name)
    if cfg is None:
        return ModelConfig.tiny(name=name, **overrides)
    return dataclasses.replace(cfg, **overrides)


def checkpoint_config(checkpoint: str, name: str,
                      overrides: dict | None = None) -> ModelConfig:
    """The config of a checkpoint directory, served as ``name``; raises
    if the directory is missing, the port cannot compute the config
    (``NotImplementedError``, naming the ROADMAP item) or a
    ``model_overrides`` field disagrees with it (``ValueError``: a
    checkpoint's architecture is fixed by its ``config.json``)."""
    cfg = load_config(checkpoint, name=name)
    wrong = {k: (v, getattr(cfg, k, None))
             for k, v in (overrides or {}).items()
             if getattr(cfg, k, object()) != v}
    if wrong:
        raise ValueError(
            f"{name}: model_overrides disagree with {checkpoint}/config.json "
            "(a checkpoint's architecture is fixed by its config): "
            + ", ".join(f"{k} {v!r} != {c!r}" for k, (v, c) in wrong.items()))
    return cfg


def build_served_model(
    name: str, *, device=DEFAULT_DEVICE, engine: dict | None = None,
    model_overrides: dict | None = None, seed: int = 0,
    context_length: int | None = None, warmup: bool = True,
    quantization: str | None = None, checkpoint: str | None = None,
    slo: dict | None = None, kind: str = "chat", adapter: str | None = None,
    adapter_scale: float | None = None, mesh=None,
) -> ServedModel:
    """An ``Engine`` and a started ``EngineLoop`` for one model: the
    weights of ``checkpoint`` (an HF safetensors directory, with its
    ``tokenizer.json`` when it has one) or random-init weights from
    ``seed``, on ``device`` (int8 weights with ``quantization="int8"``,
    quantized as each weight lands or is drawn).  ``build_seconds`` holds
    the time of each stage (init or load with its quantization, engine,
    warmup), ``load_stats`` the load's bytes and read / upload seconds.
    ``slo``: the entry's ``slo`` block (targets and ``sched``).  The
    served path always takes the kernels: ``attn_backend`` is refused
    here.  ``kind="embedding"`` builds an encoder instead
    (``build_embedding_model``), ``kind="vision-embedding"`` the vision
    pooling worker (``build_vision_embedding_model``); ``kind="vision"``
    is a chat entry whose weights are a Qwen2-VL model's, its vision
    tower served beside the engine (``ServedModel.vision``).  ``adapter``
    (a LoRA training checkpoint directory) is merged into the weights
    (``merge_adapter``).  ``mesh`` (a ``device.mesh.Mesh``, as the node
    agent realises an entry's ``mesh:`` block): a chat entry over more
    than one device is served tensor and expert parallel over it, any
    other entry on its first device (``device`` is then not read)."""
    if mesh is not None and (mesh.size == 1 or kind != "chat"):
        device, mesh = mesh.devices[0], None
    if kind == "embedding":
        return build_embedding_model(
            name, device=device, engine=engine, seed=seed,
            checkpoint=checkpoint, context_length=context_length)
    if kind == "vision-embedding":
        return build_vision_embedding_model(
            name, device=device, seed=seed, checkpoint=checkpoint,
            context_length=context_length)
    if kind not in ("chat", "vision"):
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    if "attn_backend" in (engine or {}):
        raise ValueError(
            "attn_backend is for comparisons only; a served model always "
            "runs the attention kernels"
        )
    if quantization not in (None, "int8"):
        raise ValueError(
            f"quantization {quantization!r}: expected None or 'int8'"
        )
    dev = resolve_device(device)
    if checkpoint:
        # config, overrides and tokenizer before any weights are made
        cfg = checkpoint_config(checkpoint, name, model_overrides)
        tok = load_tokenizer(checkpoint, name)
    else:
        cfg = model_config(name, model_overrides)
        tok = ByteTokenizer()
    if kind == "vision" and not checkpoint:
        # the reference's tiny mrope text tower (its overrides unread)
        cfg = ModelConfig.tiny(name=name, attention_bias=True,
                               mrope_sections=(2, 3, 3),
                               vocab_size=max(tok.vocab_size, 512))
    eng_kw = {"eos_token_ids": tok.eos_ids, **(engine or {})}
    eng_kw["eos_token_ids"] = tuple(eng_kw["eos_token_ids"])
    if context_length and "max_model_len" not in eng_kw:
        # the profile's context_length caps requests there, and one
        # sequence's page table must be able to hold it
        eng_kw["max_model_len"] = context_length
        need = -(-context_length // eng_kw.get("page_size", 16))
        if eng_kw.get("max_pages_per_seq", 128) < need:
            eng_kw["max_pages_per_seq"] = need
        if eng_kw.get("num_pages", 2048) < need + 1:
            eng_kw["num_pages"] = need + 1
    _operator_overrides(eng_kw)
    # the engine block is checked before the weights are made: an option
    # not ported yet raises at once, not after minutes of init
    ecfg = EngineConfig(**eng_kw)
    devs = mesh.devices if mesh is not None else (dev,)
    stamps = [_stamp(*devs)]
    # int8: each weight quantized as it lands or is drawn, so the build
    # never holds the bf16 model (quantize_params of the same weights, to
    # the byte)
    load_stats = {} if checkpoint else None
    vision = None
    if kind == "vision":
        cfg, params, vision = _vision_weights(
            cfg, tok, checkpoint, dev, seed, quantization, load_stats)
    elif checkpoint:
        cfg, params = load_params(checkpoint, cfg, device=dev,
                                  quantization=quantization,
                                  stats=load_stats, mesh=mesh)
    elif mesh is not None:
        params = init_sharded(cfg, seed, mesh, quantization)
    else:
        params = init_params(cfg, seed, device=dev,
                             quantization=quantization)
    if adapter:
        params = merge_adapter(params, adapter, adapter_scale, dev)
    stamps.append(_stamp(*devs))
    eng = Engine(cfg, params, ecfg, mesh=mesh, rng_seed=seed, device=dev)
    stamps.append(_stamp(*devs))
    if warmup:
        eng.warmup()
    stamps.append(_stamp(*devs))
    fs_dir = kv_filestore_dir()
    if fs_dir and mesh is not None:
        log.warning("%s: the KV filestore is not armed on a mesh (ROADMAP "
                    "A15b: export / import on a mesh)", name)
    elif fs_dir:
        # the persistent KV tier, the ladder's bottom rung (the reference
        # node agent arms it whenever the variable is set): full prefix
        # pages persist across restarts and are shared with the nodes on
        # the same directory
        eng.kv_filestore = filestore_for_engine(fs_dir, cfg, eng.cache_cfg)
    loop = make_engine_loop(eng, name, slo)
    split = dict(zip(("load" if checkpoint else "init", "engine", "warmup"),
                     (b - a for a, b in zip(stamps, stamps[1:]))))
    return ServedModel(name=name, loop=loop, tokenizer=tok, kind=kind,
                       context_length=context_length or eng.max_context_len,
                       build_seconds=split, load_stats=load_stats,
                       vision=vision)


def init_sharded(cfg: ModelConfig, seed: int, mesh, quantization=None):
    """Random weights of ``seed`` sharded over ``mesh``: one tree per
    shard (``parallel.sharding.shard_params`` by ``param_logical_axes``,
    int8 by ``quantized_logical_axes``), the shards joined equal to
    ``init_params(cfg, seed)`` byte for byte.  Drawn a layer at a time on
    the mesh's first device, each layer's blocks copied straight into
    the shards (``init_params(mesh=)``): neither the whole model nor its
    bf16 form exists on any card."""
    return init_params(cfg, seed, mesh=mesh, quantization=quantization)


def merge_adapter(params: dict, adapter: str, scale, device) -> dict:
    """The profile's merge-at-apply adapter (the reference node agent's
    ``adapter:`` branch): the latest step of the LoRA checkpoint under
    ``adapter`` grafted into ``params`` on ``device``, at ``scale`` or
    else the checkpoint's (``training.checkpoint.restore_adapter``)."""
    from helix_tpu_torch.training.checkpoint import restore_adapter
    from helix_tpu_torch.training.lora import merge_lora_into_params

    lora, scale = restore_adapter(adapter, scale, device=device)
    return merge_lora_into_params(params, lora, scale)


def _special(tok, token: str, default: int) -> int:
    """The tokenizer's id of a special token, else ``default`` (the
    reference node agent's ``special``)."""
    fn = getattr(tok, "_special", None)
    v = fn(token) if fn else None
    return v if v is not None else default


def _vision_weights(cfg: ModelConfig, tok, checkpoint, dev, seed: int,
                    quantization, stats) -> tuple:
    """``(cfg, text params, VisionRunner)`` of a ``kind: vision`` entry:
    both towers of ``checkpoint`` on ``dev`` (the text tower quantized as
    it lands with ``quantization="int8"``), else ``cfg``'s text tower and
    the tiny vision tower with random weights from ``seed`` and ``seed +
    1``."""
    from helix_tpu_torch.models.qwen2_vl import (
        VisionConfig,
        init_vision_params,
        load_qwen2_vl,
    )
    from helix_tpu_torch.serving.vision import VisionRunner

    if checkpoint:
        loaded, vcfg, params = load_qwen2_vl(
            checkpoint, device=dev, quantization=quantization, stats=stats)
        cfg = dataclasses.replace(loaded, name=cfg.name)
        vparams = params.pop("visual")
    else:
        params = init_params(cfg, seed, device=dev,
                             quantization=quantization)
        vcfg = VisionConfig.tiny(hidden_size=cfg.hidden_size)
        vparams = init_vision_params(vcfg, seed + 1, device=dev)
    runner = VisionRunner(
        vcfg, vparams,
        image_pad_id=_special(tok, "<|image_pad|>", IMAGE_PAD_ID),
        vision_start_id=_special(tok, "<|vision_start|>", VISION_START_ID),
        vision_end_id=_special(tok, "<|vision_end|>", VISION_END_ID))
    return cfg, params, runner


def build_vision_embedding_model(
    name: str, *, device=DEFAULT_DEVICE, seed: int = 0,
    checkpoint: str | None = None, context_length: int | None = None,
) -> ServedModel:
    """A ``kind: vision-embedding`` entry (the reference node agent's
    build): a ``models.vision_embed.VisionEmbeddingRunner`` on
    ``device``, both towers of a Qwen2-VL ``checkpoint`` or the tiny
    ones with random weights from ``seed``; no engine loop."""
    from helix_tpu_torch.models.vision_embed import VisionEmbeddingRunner

    dev = resolve_device(device)
    tok = load_tokenizer(checkpoint, name)
    t0 = _stamp(dev)
    entry = ProfileModel(name=name, kind="vision-embedding",
                         checkpoint=checkpoint)
    embedder = VisionEmbeddingRunner.build(entry, tok, device=dev, seed=seed)
    return ServedModel(name=name, loop=None, tokenizer=tok,
                       kind="vision-embedding", embedder=embedder,
                       context_length=context_length,
                       build_seconds={"load" if checkpoint else "init":
                                      _stamp(dev) - t0})


def build_embedding_model(
    name: str, *, device=DEFAULT_DEVICE, engine: dict | None = None,
    seed: int = 0, checkpoint: str | None = None,
    context_length: int | None = None,
) -> ServedModel:
    """An embedding entry (the reference node agent's ``kind:
    embedding`` build): a ``models.bge.EmbeddingRunner`` on ``device``,
    from ``checkpoint`` (with its ``tokenizer.json``) or the tiny
    encoder with random weights from ``seed``; no engine loop."""
    dev = resolve_device(device)
    tok = load_tokenizer(checkpoint, name)
    t0 = _stamp(dev)
    entry = ProfileModel(name=name, kind="embedding", checkpoint=checkpoint,
                         engine=dict(engine or {}))
    embedder = EmbeddingRunner.build(entry, tok, device=dev, seed=seed)
    return ServedModel(name=name, loop=None, tokenizer=tok, kind="embedding",
                       embedder=embedder, context_length=context_length,
                       build_seconds={"load" if checkpoint else "init":
                                      _stamp(dev) - t0})


def _operator_overrides(eng_kw: dict) -> None:
    """The node operator's engine knobs, which beat every profile entry
    (the reference node agent's): ``HELIX_SPEC_TOKENS`` (>0 turns
    speculation on with that many drafts, 0 off), ``HELIX_ASYNC_LOOP``
    (truthy on, 0 / false / no / off off), ``HELIX_MAX_PAGES_PER_SEQ``,
    ``HELIX_CTX_HOT_PAGES`` (tiered context: the hot tail in pages, 0
    off),
    ``HELIX_KV_HOST_POOL_BYTES`` (0 turns the host tier off) and
    ``HELIX_ADAPTER_POOL_SLOTS`` (0 turns the adapter pool off)."""
    env = os.environ.get
    if env("HELIX_SPEC_TOKENS", ""):
        n = int(env("HELIX_SPEC_TOKENS"))
        eng_kw["spec_tokens"] = max(n, 1)
        eng_kw["enable_spec_decode"] = n > 0
    if env("HELIX_ASYNC_LOOP", ""):
        eng_kw["enable_async_loop"] = env("HELIX_ASYNC_LOOP").strip() \
            .lower() not in ("0", "false", "no", "off")
    if env("HELIX_MAX_PAGES_PER_SEQ", ""):
        eng_kw["max_pages_per_seq"] = max(1, int(env(
            "HELIX_MAX_PAGES_PER_SEQ")))
    if env("HELIX_CTX_HOT_PAGES", ""):
        eng_kw["ctx_hot_pages"] = max(0, int(env("HELIX_CTX_HOT_PAGES")))
    slots_env = adapter_pool_slots_env()
    if slots_env is not None:
        eng_kw["adapter_pool_slots"] = slots_env
    if env("HELIX_KV_HOST_POOL_BYTES", ""):
        eng_kw["host_pool_bytes"] = int(env("HELIX_KV_HOST_POOL_BYTES"))


def make_engine_loop(eng: Engine, name: str,
                     slo: dict | None = None) -> EngineLoop:
    """The started ``EngineLoop`` of one served engine (the reference
    node agent's ``_make_engine_loop``): the admission bounds and the
    KV-pressure ladder are operator knobs (``HELIX_MAX_QUEUE_DEPTH``,
    ``HELIX_MAX_QUEUED_TOKENS``, ``HELIX_ADMISSION_TIMEOUT``,
    ``HELIX_PREEMPT_STALL_SECONDS``; unbounded / off unless set), the SLO
    targets and scheduler come from the entry's ``slo`` block
    (``HELIX_SCHED_*`` beat it; ``HELIX_SLO_BURN_WINDOWS`` is read inside
    ``obs.slo``) and ``HELIX_TENANT_TOP_K`` bounds the tenant series."""
    return EngineLoop(
        eng, name=name,
        max_queue_depth=_env_bound("HELIX_MAX_QUEUE_DEPTH"),
        max_queued_tokens=_env_bound("HELIX_MAX_QUEUED_TOKENS"),
        admission_timeout=_env_bound("HELIX_ADMISSION_TIMEOUT", float),
        preempt_stall_seconds=_env_bound("HELIX_PREEMPT_STALL_SECONDS",
                                         float),
        slo_targets=slo,
        tenant_top_k=_env_bound("HELIX_TENANT_TOP_K"),
        sched_config=SchedConfig.from_profile(slo),
    ).start()


def _stamp(*devs) -> float:
    """A monotonic time once the devices have finished the queued work."""
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return time.monotonic()


def _env_bound(name: str, cast=int):
    """An operator knob read as the reference node agent reads it: unset
    or empty is None."""
    v = os.environ.get(name, "")
    return cast(v) if v else None


def _parse_kv(items) -> dict:
    out = {}
    for item in items or ():
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--engine expects key=value, got {item!r}")
        try:
            out[key] = json.loads(raw)
        except ValueError:
            out[key] = raw
    return out


def _load_profile(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise SystemExit(
                f"{path}: not JSON, and PyYAML is not installed for YAML"
            ) from None
        doc = yaml.safe_load(text)
    if isinstance(doc, dict) and "name" not in doc:
        # a profile file without a name is named after the file
        doc["name"] = os.path.splitext(os.path.basename(path))[0]
    return doc


def _refusals(m: ProfileModel, engine: dict, random_weights: bool) -> list:
    """What of profile entry ``m`` is not ported yet, each naming its
    ROADMAP item (empty: the entry is served)."""
    out = []
    if m.kind not in KINDS:
        out.append(f"kind {m.kind!r} is not served (known: "
                   f"{', '.join(KINDS)})")
    if m.checkpoint and not random_weights and m.kind in (
            "chat", "vision", "vision-embedding"):
        try:
            checkpoint_config(m.checkpoint, m.name, m.model_overrides)
        except (OSError, ValueError, NotImplementedError) as e:
            out.append(str(e))
    if m.checkpoint and not random_weights and m.kind == "embedding" \
            and not os.path.isfile(os.path.join(m.checkpoint,
                                                "config.json")):
        out.append(f"{m.checkpoint}/config.json: no such file")
    if m.mesh.num_devices > 1 and m.kind == "chat":
        out += _mesh_refusals(m, engine, random_weights)
    elif m.mesh.num_devices > 1 and m.kind == "vision":
        out.append("a vision entry on a mesh (its text tower sharded, its "
                   "vision tower whole on the first device) is not ported "
                   "yet (ROADMAP A15b: vision on a mesh)")
    if m.multihost:
        out.append(f"multihost {m.multihost} serving is not ported yet "
                   "(ROADMAP A15b)")
    if m.kind in ("chat", "vision"):
        try:
            EngineConfig(**engine)
        except NotImplementedError as e:
            out.append(str(e))
    return out


def _mesh_refusals(m: ProfileModel, engine: dict,
                   random_weights: bool) -> list:
    """What of a chat entry's ``mesh`` is not served yet (an adapter
    merged at apply, the engine options and models of
    ``engine.engine.mesh_refusals``)."""
    from helix_tpu_torch.engine.engine import mesh_refusals

    out = []
    if m.adapter:
        out.append("an adapter merged at apply on a mesh is not ported "
                   "yet (ROADMAP A15b: adapters on a mesh)")
    try:
        ecfg = EngineConfig(**engine)
        cfg = (checkpoint_config(m.checkpoint, m.name, m.model_overrides)
               if m.checkpoint and not random_weights
               else model_config(m.name, m.model_overrides))
    except (OSError, TypeError, ValueError, NotImplementedError):
        return out      # reported by the engine block's or checkpoint's check
    return out + mesh_refusals(ecfg, cfg, m.mesh)


def model_specs(profile: ServingProfile, engine: dict | None = None,
                random_weights: bool = False, seed: int = 0) -> list[dict]:
    """One ``build_served_model`` keyword set per model of ``profile``
    (``engine``: ``EngineConfig`` fields that beat every entry's);
    raises ``NotImplementedError`` listing every unported block of every
    entry before anything is built."""
    engine = engine or {}
    specs, refused = [], []
    for m in profile.models:
        eng = dict(m.engine)
        if m.kind in ("chat", "vision") \
                and eng.get("attn_backend") == "reference":
            # the reference's CPU switch: the port's wrappers already run
            # their plain versions on CPU tensors, the kernels on the card
            log.info("%s: engine.attn_backend 'reference' is not applied: "
                     "the served path runs the kernels' wrappers", m.name)
            del eng["attn_backend"]
        eng.update(engine)
        why = _refusals(m, eng, random_weights)
        if why:
            refused.append(f"{m.name}: " + "; ".join(why))
            continue
        checkpoint = m.checkpoint
        if checkpoint and random_weights:
            log.warning("%s: serving random weights (seed %d) in place of "
                        "checkpoint %s", m.name, seed, checkpoint)
            checkpoint = None
        if m.adapter and m.kind in ("embedding", "vision-embedding"):
            log.warning("%s: adapter %s is not applied to a %s entry (as "
                        "the reference node agent)", m.name, m.adapter,
                        m.kind)
        # the entry's device slice, realised by the node agent at build
        placed = ({"mesh": m.mesh.to_dict()}
                  if m.mesh.num_devices > 1 or m.mesh.device_offset > 0
                  else {})
        if m.kind == "embedding":
            specs.append(dict(name=m.name, kind="embedding", engine=eng,
                              context_length=m.context_length,
                              checkpoint=checkpoint, **placed))
            continue
        if m.kind == "vision-embedding":
            specs.append(dict(name=m.name, kind="vision-embedding",
                              engine=eng, context_length=m.context_length,
                              checkpoint=checkpoint, **placed))
            continue
        specs.append(dict(
            name=m.name, quantization=m.quantization, engine=eng,
            model_overrides=dict(m.model_overrides),
            context_length=m.context_length, checkpoint=checkpoint,
            slo=dict(m.slo) or None, **placed,
        ))
        if m.kind == "vision":
            specs[-1]["kind"] = "vision"
        if m.adapter:
            specs[-1].update(adapter=m.adapter,
                             adapter_scale=m.adapter_scale)
    if refused:
        raise NotImplementedError("; ".join(refused))
    return specs


def _model_specs(args, profile=None) -> list[dict]:
    """``model_specs`` of the command line: ``--model`` names, or the
    profile (a ``ServingProfile``, a profile document, or
    ``--profile``'s file)."""
    engine = _parse_kv(args.engine)
    if profile is None and args.profile:
        profile = _load_profile(args.profile)
    if profile is None:
        if not args.model:
            raise SystemExit("serve-node needs --model or --profile")
        return [dict(name=n, engine=engine) for n in args.model]
    if not isinstance(profile, ServingProfile):
        profile = ServingProfile.from_dict(profile)
    return model_specs(profile, engine,
                       getattr(args, "random_weights", False),
                       getattr(args, "seed", 0))


def spec_bytes(spec: dict) -> int:
    """The residency estimate of one spec: the checkpoint's
    ``config.json`` (else the catalog config of the name), the entry's
    engine block and its quantization, as the reference node agent's."""
    if spec.get("kind") == "embedding":
        return EMBEDDING_ESTIMATE_BYTES
    name = spec["name"]
    if spec.get("kind") in ("vision", "vision-embedding"):
        # the reference's figure: its plain load_config of the text tower
        # (bf16, no bias), the catalog or tiny config without a
        # checkpoint; the vision tower is not counted (ROADMAP C)
        cfg = (ModelConfig.from_hf_config(read_hf_config(
            spec["checkpoint"]), name=name) if spec.get("checkpoint")
            else model_config(name))
    else:
        cfg = (load_config(spec["checkpoint"], name=name)
               if spec.get("checkpoint") else model_config(name))
    return estimate_model_bytes(cfg, spec["engine"], spec.get("quantization"))


def make_node(args, build_model=None):
    """The node ``serve-node`` runs, not yet serving: (agent, HTTP
    server).  The agent (``control.node_agent.NodeAgent``) owns the
    registry; ``--profile`` (or ``--model`` names) is applied now, after
    every entry's refusals were checked (``NotImplementedError`` before
    anything is built); with ``--control-plane`` the heartbeat starts,
    polling for an assigned profile when none was given.  The server
    answers ``GET /api/v1/state`` with the agent's heartbeat body.
    ``build_model``: the agent's builder of one profile entry, with
    ``build_served_model``'s keywords (the default).  With ``--tunnel``
    the server is a unix-socket server (``--unix-socket``, else
    ``openai.sock`` in a new ``helix-node-*`` temporary directory) and the
    agent advertises no address: the control plane reaches the node
    through the tunnel (``make_tunnel``)."""
    from helix_tpu_torch.control.node_agent import NodeAgent

    resolve_device(args.device)
    engine = _parse_kv(args.engine)
    profile = None
    if args.profile:
        profile = ServingProfile.from_dict(_load_profile(args.profile))
    elif args.model:
        profile = ServingProfile(
            name="serve-node",
            models=tuple(ProfileModel(name=n) for n in args.model))
    if profile is not None:
        model_specs(profile, engine, args.random_weights, args.seed)
    agent = NodeAgent(
        args.runner_id, build_model=build_model,
        heartbeat_url=args.control_plane,
        heartbeat_interval=args.heartbeat_interval,
        device=args.device, seed=args.seed, warmup=not args.no_warmup,
        random_weights=args.random_weights, engine=engine)
    server = OpenAIServer(agent.registry, state=agent.heartbeat_payload)
    if getattr(args, "tunnel", False):
        path = getattr(args, "unix_socket", None) or os.path.join(
            tempfile.mkdtemp(prefix="helix-node-"), "openai.sock")
        httpd = server.make_unix_server(path)
        # the control plane dispatches through the reverse tunnel
        agent.address = ""
    else:
        httpd = server.make_http_server(args.host, args.port)
        agent.address = (args.advertise
                         or f"http://127.0.0.1:{httpd.server_address[1]}")
    if profile is not None:
        agent.apply_profile(profile)
    if args.control_plane and agent.state.status != "failed":
        agent.start_heartbeat(poll_assignment=profile is None)
    return agent, httpd


def make_tunnel(args, agent, httpd):
    """The reverse tunnel of a ``--tunnel`` node (not started): dials
    ``--control-plane`` as ``--runner-id`` with the agent's runner token
    and carries its requests to the unix socket ``httpd`` serves."""
    from helix_tpu_torch.control.tunnel import TunnelAgent

    return TunnelAgent(args.runner_id, args.control_plane,
                       unix_socket=httpd.server_address,
                       runner_token=agent.runner_token)


def _close_server(httpd) -> None:
    httpd.server_close()
    if isinstance(httpd.server_address, str):
        try:
            os.unlink(httpd.server_address)
        except OSError:
            pass


def _cmd_serve_node(args) -> int:
    if args.tunnel and not args.control_plane:
        print("serve-node: --tunnel requires --control-plane (the tunnel "
              "dials out to it)", file=sys.stderr)
        return 2
    agent, httpd = make_node(args)
    if agent.state.status == "failed":
        _close_server(httpd)
        agent.stop()
        if agent.apply_exception is not None:
            raise agent.apply_exception
        print(f"profile apply failed: {agent.state.error}", file=sys.stderr)
        return 1
    shutdown: list = []
    tunnel = make_tunnel(args, agent, httpd) if args.tunnel else None

    def graceful():
        # drain on this thread (through the tunnel, still up), then stop
        # the tunnel and the server: shutdown() from the thread that
        # runs serve_forever would deadlock
        try:
            agent.graceful_shutdown()
        finally:
            if tunnel is not None:
                tunnel.stop()
            httpd.shutdown()

    def on_signal(signum, frame):
        if not shutdown:
            t = threading.Thread(target=graceful, name="helix-shutdown",
                                 daemon=True)
            shutdown.append(t)
            t.start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, on_signal)
        except ValueError:
            pass   # not the main thread (embedded use)
    # a drain the control plane asked for ends the process as SIGTERM does
    agent.on_drain = lambda: os.kill(os.getpid(), signal.SIGTERM)
    if tunnel is not None:
        where = (f"on unix socket {httpd.server_address}; tunnelling to "
                 f"{args.control_plane}")
        tunnel.start()
    else:
        where = f"on http://{args.host}:{httpd.server_address[1]}"
    print("helix_tpu_torch node", args.runner_id, "serving",
          agent.registry.names(), where, flush=True)
    try:
        httpd.serve_forever()
    finally:
        for t in shutdown:
            t.join()
        if tunnel is not None:
            tunnel.stop(join=True)
        _close_server(httpd)
        agent.stop()
    return 0


def _cmd_sft(args) -> int:
    """LoRA SFT on one device: the reference's ``helix-tpu sft``
    (``helix_tpu/cli.py`` ``_cmd_sft``), its flags and JSON lines."""
    from helix_tpu_torch.training.checkpoint import (
        resume_trainer,
        save_checkpoint,
    )
    from helix_tpu_torch.training.data import load_jsonl, pack_examples
    from helix_tpu_torch.training.lora import LoraConfig
    from helix_tpu_torch.training.sft import SFTConfig, SFTTrainer

    multi = [f"--{n.replace('_', '-')}" for n in
             ("coordinator", "num_hosts", "host_rank")
             if getattr(args, n) is not None]
    if multi:
        raise SystemExit(f"sft: {', '.join(multi)}: training over several "
                         "hosts is not ported yet (ROADMAP A15b)")
    dev = resolve_device(args.device)
    tokenizer = load_tokenizer(args.checkpoint, args.model)
    if args.checkpoint:
        model_cfg, params = load_params(args.checkpoint, device=dev)
    else:
        model_cfg = CATALOG.get(args.model) or ModelConfig.tiny(
            name=args.model)
        params = init_params(model_cfg, 0, device=dev)
    cfg = SFTConfig(
        lora=LoraConfig(rank=args.rank, alpha=args.alpha),
        learning_rate=args.lr,
        total_steps=args.steps,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
    )
    trainer = SFTTrainer(model_cfg, params, cfg)
    if args.resume and args.output:
        if resume_trainer(trainer, args.output):
            print(f"resumed from step {trainer.step_num}")
    examples = load_jsonl(args.data, tokenizer)
    print(f"loaded {len(examples)} examples")

    def batches():
        epoch = 0
        while True:
            yield from pack_examples(examples, cfg.batch_size, cfg.seq_len,
                                     shuffle_seed=epoch)
            epoch += 1

    def on_log(m):
        print(json.dumps(m), flush=True)

    def on_step(step):
        if args.output and step % args.save_every == 0:
            save_checkpoint(args.output, trainer.step_num,
                            trainer.lora_params, trainer.opt_state,
                            lora_scaling=trainer.cfg.lora.scaling)

    trainer.train(batches(), log_every=args.log_every, on_log=on_log,
                  on_step=on_step)
    if args.output:
        save_checkpoint(args.output, trainer.step_num, trainer.lora_params,
                        trainer.opt_state,
                        lora_scaling=trainer.cfg.lora.scaling)
        print(f"saved adapters to {args.output}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="helix_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    n = sub.add_parser("serve-node", help="serve models over OpenAI HTTP")
    n.add_argument("--model", action="append",
                   help="catalog model name (repeatable)")
    n.add_argument("--profile", help="profile file (JSON, or YAML) to "
                                     "apply at start")
    n.add_argument("--runner-id", default="node-0")
    n.add_argument("--host", default="0.0.0.0")
    n.add_argument("--port", type=int, default=8000)
    n.add_argument("--control-plane", help="control plane base URL")
    n.add_argument("--heartbeat-interval", type=float, default=30.0)
    n.add_argument("--advertise",
                   help="address the control plane dials back")
    n.add_argument("--tunnel", action="store_true",
                   help="no listening TCP port: serve on a unix socket and "
                        "dial an outbound reverse tunnel to the control "
                        "plane (NAT'd nodes)")
    n.add_argument("--unix-socket", help="socket path for --tunnel mode")
    n.add_argument("--device", default=DEFAULT_DEVICE)
    n.add_argument("--engine", action="append", metavar="KEY=VALUE",
                   help="EngineConfig field override (repeatable)")
    n.add_argument("--seed", type=int, default=0)
    n.add_argument("--no-warmup", action="store_true")
    n.add_argument("--random-weights", action="store_true",
                   help="serve profile entries that name a checkpoint "
                        "with random weights from --seed")
    n.set_defaults(fn=_cmd_serve_node)
    t = sub.add_parser("sft", help="LoRA supervised fine-tune from JSONL")
    t.add_argument("--data", required=True, help="JSONL dataset path")
    t.add_argument("--model", default="tiny", help="catalogue model name")
    t.add_argument("--checkpoint",
                   help="HF checkpoint dir (weights+tokenizer)")
    t.add_argument("--output", help="adapter checkpoint dir")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--rank", type=int, default=16)
    t.add_argument("--alpha", type=float, default=32.0)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--seq-len", type=int, default=1024)
    t.add_argument("--save-every", type=int, default=50)
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--device", default=DEFAULT_DEVICE)
    t.add_argument("--coordinator", default=None,
                   help="refused: several hosts are ROADMAP A15b")
    t.add_argument("--num-hosts", type=int, default=None)
    t.add_argument("--host-rank", type=int, default=None)
    t.set_defaults(fn=_cmd_sft)
    args = p.parse_args(argv)
    return args.fn(args)
