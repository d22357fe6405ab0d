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

``--random-weights`` serves a ``checkpoint:`` entry with random weights
from ``--seed`` in place of its files.  A checkpoint directory that is
missing, whose config the port cannot compute (mixture-of-experts: A15;
mrope: A17; a ``rope_scaling`` other than ``llama3``: ROADMAP C; an
unknown activation) or that disagrees with the entry's
``model_overrides`` is refused at start.  What is not ported yet is
refused there too, before any weights are made, naming its ROADMAP
item: a kind other than ``chat`` (A17), a ``mesh`` with an axis above 1
(A15; ``{tp: 1}`` is the one device), an ``adapter`` merged into the
weights at apply time (it restores a training checkpoint: A18, with the
node agent, A7b), and engine fields of unported modules
(``ctx_hot_pages``: A14).

The node's operator overrides, as the reference node agent reads them:
``HELIX_KV_HOST_POOL_BYTES`` replaces every engine's ``host_pool_bytes``
(0 turns the host tier off), ``HELIX_PREEMPT_STALL_SECONDS`` arms
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
import time

import torch

from helix_tpu_torch.device import (
    DEFAULT_DEVICE,
    resolve_device,
    total_device_bytes,
)
from helix_tpu_torch.engine.adapters import adapter_pool_slots_env
from helix_tpu_torch.engine.engine import Engine, EngineConfig
from helix_tpu_torch.engine.residency import (
    ResidencyManager,
    estimate_model_bytes,
)
from helix_tpu_torch.models.common import CATALOG, ModelConfig
from helix_tpu_torch.models.llama import init_params
from helix_tpu_torch.models.loader import load_config, load_params
from helix_tpu_torch.serving.engine_loop import EngineLoop
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import (
    DelegatingRegistry,
    ModelRegistry,
    ServedModel,
)
from helix_tpu_torch.serving.sched import SchedConfig
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer

log = logging.getLogger("helix_tpu_torch")


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
    slo: dict | None = None,
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
    here."""
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
    host_env = os.environ.get("HELIX_KV_HOST_POOL_BYTES", "")
    if host_env:
        # operator beats profile; 0 turns the host tier off
        eng_kw["host_pool_bytes"] = int(host_env)
    slots_env = adapter_pool_slots_env()
    if slots_env is not None:
        # operator beats profile; 0 turns the adapter pool off
        eng_kw["adapter_pool_slots"] = slots_env
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
    loop = EngineLoop(
        eng, name=name,
        # admission bounds and the KV-pressure ladder: operator knobs,
        # unbounded / off unless set
        max_queue_depth=_env_bound("HELIX_MAX_QUEUE_DEPTH"),
        max_queued_tokens=_env_bound("HELIX_MAX_QUEUED_TOKENS"),
        admission_timeout=_env_bound("HELIX_ADMISSION_TIMEOUT", float),
        preempt_stall_seconds=_env_bound("HELIX_PREEMPT_STALL_SECONDS",
                                         float),
        # the profile's SLO targets and scheduler; HELIX_SCHED_* beat the
        # profile, HELIX_SLO_BURN_WINDOWS is read inside obs.slo
        slo_targets=slo,
        tenant_top_k=_env_bound("HELIX_TENANT_TOP_K"),
        sched_config=SchedConfig.from_profile(slo),
    ).start()
    split = dict(zip(("load" if checkpoint else "init", "engine", "warmup"),
                     (b - a for a, b in zip(stamps, stamps[1:]))))
    return ServedModel(name=name, loop=loop, tokenizer=tok,
                       context_length=context_length or eng.max_context_len,
                       build_seconds=split, load_stats=load_stats)


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
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:
        raise SystemExit(
            f"{path}: not JSON, and PyYAML is not installed for YAML"
        ) from None
    return yaml.safe_load(text)


def _refusals(m: dict, engine: dict, random_weights: bool) -> list:
    """What of profile entry ``m`` is not ported yet, each naming its
    ROADMAP item (empty: the entry is served)."""
    out = []
    if m.get("checkpoint") and not random_weights:
        try:
            checkpoint_config(m["checkpoint"], m["name"],
                              m.get("model_overrides"))
        except (OSError, ValueError, NotImplementedError) as e:
            out.append(str(e))
    if m.get("kind", "chat") != "chat":
        out.append(f"kind {m.get('kind')!r} is not ported yet (ROADMAP A17)")
    if m.get("adapter"):
        out.append("an adapter merged into the weights at apply time is "
                   "not ported yet: it restores a training checkpoint "
                   "(ROADMAP A18, with the node agent, A7b); serve "
                   "adapters through engine.adapter_pool_slots")
    mesh = m.get("mesh") or {}
    if any(int(v) > 1 for v in mesh.values()):
        out.append(f"mesh {mesh} spans more than one device: tensor, "
                   "sequence, expert and pipeline parallel are not ported "
                   "yet (ROADMAP A15)")
    try:
        EngineConfig(**engine)
    except NotImplementedError as e:
        out.append(str(e))
    return out


def _model_specs(args, profile: dict | None = None) -> list[dict]:
    """One ``build_served_model`` keyword set per model; raises
    ``NotImplementedError`` listing every unported block of every entry
    before anything is built."""
    engine = _parse_kv(args.engine)
    if profile is None and args.profile:
        profile = _load_profile(args.profile)
    if profile is None:
        if not args.model:
            raise SystemExit("serve-node needs --model or --profile")
        return [dict(name=n, engine=engine) for n in args.model]
    random_weights = getattr(args, "random_weights", False)
    specs, refused = [], []
    for m in profile.get("models", []):
        eng = {**m.get("engine", {}), **engine}
        why = _refusals(m, eng, random_weights)
        if why:
            refused.append(f"{m['name']}: " + "; ".join(why))
            continue
        checkpoint = m.get("checkpoint")
        if checkpoint and random_weights:
            log.warning("%s: serving random weights (seed %d) in place of "
                        "checkpoint %s", m["name"], getattr(args, "seed", 0),
                        checkpoint)
            checkpoint = None
        specs.append(dict(
            name=m["name"], quantization=m.get("quantization"), engine=eng,
            model_overrides=m.get("model_overrides", {}),
            context_length=m.get("context_length"), checkpoint=checkpoint,
            slo=m.get("slo"),
        ))
    if refused:
        raise NotImplementedError("; ".join(refused))
    return specs


def build_registry(specs: list, residency: dict | None = None, *,
                   device=DEFAULT_DEVICE, seed: int = 0, warmup: bool = True,
                   build=build_served_model) -> DelegatingRegistry:
    """The node's registry.  Without ``residency`` every spec is built now
    (``build(name=..., device=..., seed=..., warmup=..., **spec)``); with
    it a ``ResidencyManager`` registers every name and builds nothing yet.
    Its budget is ``hbm_budget_bytes`` or the card's memory, and its
    estimate takes the checkpoint's ``config.json`` (else the catalog
    config of the name), the entry's engine block and its quantization,
    as the reference node agent's does."""
    if not residency:
        inner = ModelRegistry()
        for spec in specs:
            inner.register(build(device=device, seed=seed, warmup=warmup,
                                 **spec))
            log.info("serving %s on %s", spec["name"], device)
        return DelegatingRegistry(inner)
    by_name = {spec["name"]: spec for spec in specs}
    budget = int(residency.get("hbm_budget_bytes")
                 or total_device_bytes(device))

    def build_one(name: str) -> ServedModel:
        log.info("loading %s on %s", name, device)
        return build(device=device, seed=seed, warmup=warmup,
                     **by_name[name])

    def estimate(name: str) -> int:
        spec = by_name[name]
        cfg = (load_config(spec["checkpoint"], name=name)
               if spec.get("checkpoint") else model_config(name))
        return estimate_model_bytes(cfg, spec["engine"],
                                    spec.get("quantization"))

    mgr = ResidencyManager(budget, build_one, estimate=estimate)
    for name in by_name:
        mgr.register_name(name)
    return DelegatingRegistry(mgr)


def _cmd_serve_node(args) -> int:
    profile = _load_profile(args.profile) if args.profile else None
    specs = _model_specs(args, profile)
    registry = build_registry(
        specs, (profile or {}).get("residency"), device=args.device,
        seed=args.seed, warmup=not args.no_warmup,
    )
    httpd = OpenAIServer(registry).make_http_server(args.host, args.port)
    print("helix_tpu_torch serving", registry.names(),
          f"on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        for name in registry.names():
            registry.unregister(name)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="helix_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    n = sub.add_parser("serve-node", help="serve models over OpenAI HTTP")
    n.add_argument("--model", action="append",
                   help="catalog model name (repeatable)")
    n.add_argument("--profile", help="profile file (JSON, or YAML)")
    n.add_argument("--host", default="0.0.0.0")
    n.add_argument("--port", type=int, default=8000)
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
