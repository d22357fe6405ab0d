"""Command line of the port: ``python -m helix_tpu_torch serve-node``.

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
missing, whose config the port cannot compute (mixture-of-experts: A15;
mrope: A17b; a ``rope_scaling`` other than ``llama3``: ROADMAP C; an
unknown activation) or that disagrees with the entry's
``model_overrides`` is refused at start.  What is not ported yet is
refused there too, before any weights are made, naming its ROADMAP
item: a ``vision`` or ``vision-embedding`` kind (A17b), a profile ``role:
prefill`` or ``HELIX_POOL_ROLE=prefill`` (the disaggregated prefill
handoff, A12), a ``mesh`` with an axis above 1
(A15; ``{tp: 1}`` is the one device), a ``multihost`` block (A15), an
``adapter`` merged into the weights at apply time (it restores a training
checkpoint: A18), and engine fields of unported modules
(``ctx_hot_pages``: A14).  A profile assigned by the control plane with
such an entry fails its apply with that text (``status: failed``).

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

from helix_tpu_torch.control.profile import (
    ProfileModel, ServingProfile, pool_role)
from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from helix_tpu_torch.engine.adapters import adapter_pool_slots_env
from helix_tpu_torch.engine.engine import Engine, EngineConfig
from helix_tpu_torch.engine.residency import estimate_model_bytes
from helix_tpu_torch.models.common import CATALOG, ModelConfig
from helix_tpu_torch.models.bge import EmbeddingRunner
from helix_tpu_torch.models.llama import init_params
from helix_tpu_torch.models.loader import load_config, load_params
from helix_tpu_torch.serving.engine_loop import EngineLoop
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ServedModel
from helix_tpu_torch.serving.sched import SchedConfig
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer

log = logging.getLogger("helix_tpu_torch")

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
    slo: dict | None = None, kind: str = "chat",
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
    (``build_embedding_model``)."""
    if kind == "embedding":
        return build_embedding_model(
            name, device=device, engine=engine, seed=seed,
            checkpoint=checkpoint, context_length=context_length)
    if kind != "chat":
        raise ValueError(f"kind {kind!r}: expected 'chat' or 'embedding'")
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
    stamps = [_stamp(dev)]
    # int8: each weight quantized as it lands or is drawn, so the build
    # never holds the bf16 model (quantize_params of the same weights, to
    # the byte)
    load_stats = None
    if checkpoint:
        load_stats = {}
        cfg, params = load_params(checkpoint, cfg, device=dev,
                                  quantization=quantization,
                                  stats=load_stats)
    else:
        params = init_params(cfg, seed, device=dev,
                             quantization=quantization)
    stamps.append(_stamp(dev))
    eng = Engine(cfg, params, ecfg, rng_seed=seed, device=dev)
    stamps.append(_stamp(dev))
    if warmup:
        eng.warmup()
    stamps.append(_stamp(dev))
    loop = make_engine_loop(eng, name, slo)
    split = dict(zip(("load" if checkpoint else "init", "engine", "warmup"),
                     (b - a for a, b in zip(stamps, stamps[1:]))))
    return ServedModel(name=name, loop=loop, tokenizer=tok,
                       context_length=context_length or eng.max_context_len,
                       build_seconds=split, load_stats=load_stats)


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
    ``HELIX_CTX_HOT_PAGES`` (tiered context, A14: refused above 0),
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


def _stamp(dev) -> float:
    """A monotonic time once the device has finished the queued work."""
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
    if m.kind not in ("chat", "embedding"):
        out.append(f"kind {m.kind!r} is not ported yet (ROADMAP A17b)")
    if m.checkpoint and not random_weights and m.kind == "chat":
        try:
            checkpoint_config(m.checkpoint, m.name, m.model_overrides)
        except (OSError, ValueError, NotImplementedError) as e:
            out.append(str(e))
    if m.checkpoint and not random_weights and m.kind == "embedding" \
            and not os.path.isfile(os.path.join(m.checkpoint,
                                                "config.json")):
        out.append(f"{m.checkpoint}/config.json: no such file")
    if m.adapter:
        out.append("an adapter merged into the weights at apply time is "
                   "not ported yet: it restores a training checkpoint "
                   "(ROADMAP A18); serve adapters through "
                   "engine.adapter_pool_slots")
    mesh = {k: v for k, v in m.mesh.to_dict().items()
            if v != (0 if k == "device_offset" else 1)}
    if m.mesh.num_devices > 1 or m.mesh.device_offset > 0:
        out.append(f"mesh {mesh} spans more than one device: tensor, "
                   "sequence, expert and pipeline parallel are not ported "
                   "yet (ROADMAP A15)")
    if m.multihost:
        out.append(f"multihost {m.multihost} serving is not ported yet "
                   "(ROADMAP A15)")
    if m.kind == "chat":
        try:
            EngineConfig(**engine)
        except NotImplementedError as e:
            out.append(str(e))
    return out


def role_refusal(profile_role: str) -> str:
    """The refusal of a pool role the port does not serve ("" when
    served), read as the node agent reads it (``profile.pool_role``)."""
    if pool_role(profile_role) == "prefill":
        return ("role 'prefill': the disaggregated prefill handoff (the "
                "snapshot shipped to a decode peer) is not ported yet "
                "(ROADMAP A12); serve the node as decode or mixed")
    return ""


def model_specs(profile: ServingProfile, engine: dict | None = None,
                random_weights: bool = False, seed: int = 0) -> list[dict]:
    """One ``build_served_model`` keyword set per model of ``profile``
    (``engine``: ``EngineConfig`` fields that beat every entry's);
    raises ``NotImplementedError`` listing every unported block of every
    entry before anything is built."""
    engine = engine or {}
    specs, refused = [], []
    role = role_refusal(profile.role)
    if role:
        refused.append(role)
    for m in profile.models:
        eng = dict(m.engine)
        if m.kind == "chat" and eng.get("attn_backend") == "reference":
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
        if m.kind == "embedding":
            specs.append(dict(name=m.name, kind="embedding", engine=eng,
                              context_length=m.context_length,
                              checkpoint=checkpoint))
            continue
        specs.append(dict(
            name=m.name, quantization=m.quantization, engine=eng,
            model_overrides=dict(m.model_overrides),
            context_length=m.context_length, checkpoint=checkpoint,
            slo=dict(m.slo) or None,
        ))
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
    args = p.parse_args(argv)
    return args.fn(args)
