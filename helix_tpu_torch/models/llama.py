"""Llama-family decoder in PyTorch over a parameter dictionary.

Port of ``helix_tpu/models/llama.py``.  Covers Llama-3, Phi-3 (MHA),
Qwen-2 (attention bias) and Qwen-3 (qk-norm) through ``ModelConfig``
switches.  Weights keep the reference's stacked layout (every layer weight
has a leading ``num_layers`` dim, projections are ``[in, out]`` and used
as ``x @ W``), so converting a JAX parameter tree is a plain copy
(``params_from_jax``).

- A Python loop over layers takes the place of ``lax.scan``.
- Attention is injected (``attn_fn``) under the reference's two cache
  protocols: ``layer_caches`` hands each layer its per-layer views,
  ``carry_caches`` threads the whole pool and the attention function
  mutates it in place (jit donation in the reference).
- A mixture-of-experts config (Mixtral) replaces the dense FFN by a
  router ``[L, E, X]`` and expert stacks ``[L, X, E, F]`` / ``[L, X, F,
  E]`` (``models.moe``); ``forward`` takes the reference's
  ``moe_token_mask`` and returns the drop count with
  ``return_moe_stats``.  An mrope config (the Qwen2-VL text tower) runs
  only with its three position streams (``positions3``,
  ``models.qwen2_vl.text_forward_mrope``).
- ``forward_sharded`` is the Megatron tensor-parallel forward over a
  ``device.mesh.Mesh``: one parameter tree per shard
  (``parallel.sharding.shard_params`` by ``param_logical_axes``), each
  card computing its own heads, FFN columns and vocabulary rows, two
  float32 sums per layer (``parallel.collectives``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.ops.norms import rms_norm
from helix_tpu_torch.ops.quant import (
    embed_lookup,
    matmul_f32,
    maybe_dequant_dense,
    quantize_rows,
    quantize_tensor,
)
from helix_tpu_torch.ops.rope import apply_rope, rope_frequencies
from helix_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    replicate,
)

Params = dict
AttnFn = Callable[..., Any]


# the HF ``hidden_act`` names the forward computes (every gelu form is
# the tanh approximation, as in the reference)
ACTIVATIONS = ("silu", "gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_tanh")


def _act(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name in ACTIVATIONS:
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def init_params(cfg: ModelConfig, seed: int = 0, *, device=DEFAULT_DEVICE,
                dtype=None, quantization=None) -> Params:
    """Random-init the stacked-layer parameter dict ON ``device``: normal
    x 0.02 for projections and embeddings, ones for norms, zeros for
    biases (``llama.py:73-112``).  Draws come from one ``torch.Generator``
    seeded with ``seed`` on that device, layer by layer, so a full-width
    model never exists in float32 at once.

    ``quantization="int8"`` gives ``quantize_params`` of that dict, equal
    to the byte, with each weight quantized as soon as it is drawn: the
    model never exists in ``dtype`` at once either (Llama-3-8B's int8
    build then peaks near its int8 footprint, not at its bf16 one)."""
    if quantization not in (None, "int8"):
        raise ValueError(
            f"quantization {quantization!r}: expected None or 'int8'")
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, E, H, KVH, D, F, V = (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
    )

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(0.02).to(dt)

    def normal(shape, stacked=False):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if stacked else (out,)):
            part.copy_(draw(part.shape))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def dense(shape, stacked=True):
        if quantization is None:
            return {"weight": normal(shape, stacked)}
        if not stacked:
            return quantize_tensor(normal(shape))
        # layer by layer: the stack never exists in ``dt`` at once (an
        # expert stack of Mixtral is 30 GB in bf16)
        q = torch.empty(shape, dtype=torch.int8, device=dev)
        s = torch.empty((*shape[:-2], 1, shape[-1]), dtype=torch.float32,
                        device=dev)
        for i in range(shape[0]):
            qd = quantize_tensor(draw(shape[1:]))
            q[i], s[i] = qd["weight"], qd["scale"]
        return {"weight": q, "scale": s}

    def embed():
        w = normal((V, E))
        if quantization is None:
            return {"weight": w}
        q, scale = quantize_rows(w)
        return {"weight": q, "embed_scale": scale}

    params = {
        "embed": embed(),
        "layers": {
            "attn_norm": {"weight": ones((L, E))},
            "mlp_norm": {"weight": ones((L, E))},
            "wq": dense((L, E, H * D)),
            "wk": dense((L, E, KVH * D)),
            "wv": dense((L, E, KVH * D)),
            "wo": dense((L, H * D, E)),
        },
        "final_norm": {"weight": ones((E,))},
    }
    layers = params["layers"]
    if cfg.num_experts > 0:
        # Mixtral: a router and expert-stacked SwiGLU in place of the
        # dense FFN, in the reference's layout (``llama.py:91-103``)
        X = cfg.num_experts
        layers["router"] = dense((L, E, X))
        layers["experts"] = {
            "w_gate": dense((L, X, E, F)),
            "w_up": dense((L, X, E, F)),
            "w_down": dense((L, X, F, E)),
        }
    else:
        layers["w_gate"] = dense((L, E, F))
        layers["w_up"] = dense((L, E, F))
        layers["w_down"] = dense((L, F, E))
    if cfg.attention_bias:
        for nm, width in (("wq", H * D), ("wk", KVH * D), ("wv", KVH * D)):
            params["layers"][nm]["bias"] = torch.zeros(
                (L, width), dtype=dt, device=dev
            )
    if cfg.qk_norm:
        params["layers"]["q_norm"] = {"weight": ones((L, D))}
        params["layers"]["k_norm"] = {"weight": ones((L, D))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((E, V), stacked=False)
    return params


def param_logical_axes(cfg: ModelConfig) -> Any:
    """Tree of logical-axis tuples matching ``init_params`` (copied from
    ``helix_tpu/models/llama.py:115-159``): the leading stacked-layer
    axis is "layers" on every weight; column-parallel projections (wq,
    wk, wv, w_gate, w_up) shard their output axis, row-parallel ones
    (wo, w_down) their input axis, the embedding and ``lm_head`` their
    vocabulary."""
    lax_ = {
        "attn_norm": {"weight": ("layers", None)},
        "mlp_norm": {"weight": ("layers", None)},
        "wq": {"weight": ("layers", "embed", "heads")},
        "wk": {"weight": ("layers", "embed", "kv_heads")},
        "wv": {"weight": ("layers", "embed", "kv_heads")},
        "wo": {"weight": ("layers", "heads", "embed")},
        "w_gate": {"weight": ("layers", "embed", "mlp")},
        "w_up": {"weight": ("layers", "embed", "mlp")},
        "w_down": {"weight": ("layers", "mlp", "embed")},
    }
    if cfg.num_experts > 0:
        del lax_["w_gate"], lax_["w_up"], lax_["w_down"]
        lax_["router"] = {"weight": ("layers", "embed", None)}
        lax_["experts"] = {
            "w_gate": {"weight": ("layers", "expert", "embed", "mlp")},
            "w_up": {"weight": ("layers", "expert", "embed", "mlp")},
            "w_down": {"weight": ("layers", "expert", "mlp", "embed")},
        }
    if cfg.attention_bias:
        lax_["wq"]["bias"] = ("layers", "heads")
        lax_["wk"]["bias"] = ("layers", "kv_heads")
        lax_["wv"]["bias"] = ("layers", "kv_heads")
    if cfg.qk_norm:
        lax_["q_norm"] = {"weight": ("layers", None)}
        lax_["k_norm"] = {"weight": ("layers", None)}
    axes = {
        "embed": {"weight": ("vocab", "embed")},
        "layers": lax_,
        "final_norm": {"weight": (None,)},
    }
    if not cfg.tie_word_embeddings:
        axes["lm_head"] = {"weight": ("embed", "vocab")}
    return axes


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)   # a writable copy: device_get may hand back views
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: torch.from_numpy refuses it, but the bits
        # are torch.bfloat16's — reinterpret, no float32 round trip
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree) -> Params:
    """Convert a JAX parameter tree (after ``jax.device_get``: nested dicts
    of numpy arrays) into the port's parameter dict of CPU tensors with
    the same keys, shapes and dtypes; a ``quantize_params`` tree keeps its
    int8 weights and float32 ``scale`` / ``embed_scale`` leaves.  Move it
    with ``params_to``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _to_tensor(tree)


def lora_from_jax(tree) -> dict:
    """A JAX LoRA tree (``helix_tpu.training.lora.init_lora_params``'s
    ``{target: {"lora_a", "lora_b"}}``, after ``jax.device_get``) as the
    port's adapter dict of CPU tensors, dtypes kept: so the port's
    trainer and the reference's start from the same adapter."""
    return {t: {"lora_a": _to_tensor(f["lora_a"]),
                "lora_b": _to_tensor(f["lora_b"])}
            for t, f in tree.items()}


def params_to(params: Params, device) -> Params:
    """The parameter dict with every tensor moved to ``device``."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    return params.to(dev)


def _layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s slice of every stacked weight (nested: the experts)."""
    if isinstance(layers, dict):
        return {k: _layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _layer(h, p: Params, layer_cache, cfg: ModelConfig, positions, inv_freq,
           attn_fn: AttnFn, adapter_ids=None, positions3=None,
           moe_token_mask=None):
    """One decoder block. h: [B, S, E].  Returns ``(h, (k, v),
    new_cache, moe_dropped)``; ``new_cache`` is what a carry-protocol
    ``attn_fn`` returned alongside its output (None for plain attn_fns),
    ``moe_dropped`` the MoE layer's int32 drop count (None for a dense
    FFN).  ``adapter_ids [B, S]`` names each token's multi-LoRA pool slot
    for every projection (None: no adapter row; an MoE FFN takes none).
    ``positions3 [3, B, S]`` rotates q / k with M-RoPE (mrope configs);
    ``positions`` still reach the attention.  ``moe_token_mask [B, S]``:
    the tokens the router may place (``models.moe.moe_ffn``)."""
    B, S, E = h.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(x, w):
        return maybe_dequant_dense(x, w, adapter_ids=adapter_ids)

    x = rms_norm(h, p["attn_norm"]["weight"], cfg.rms_norm_eps, cfg.norm_offset)
    q = dense(x, p["wq"]).reshape(B, S, H, D)
    k = dense(x, p["wk"]).reshape(B, S, KVH, D)
    v = dense(x, p["wv"]).reshape(B, S, KVH, D)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    if positions3 is not None:
        from helix_tpu_torch.models.qwen2_vl import apply_mrope

        q = apply_mrope(q, positions3, inv_freq, cfg.mrope_sections)
        k = apply_mrope(k, positions3, inv_freq, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    res = attn_fn(q, k, v, layer_cache, positions)
    new_cache = None
    if isinstance(res, tuple):
        attn_out, new_cache = res
    else:
        attn_out = res
    h = h + dense(attn_out.reshape(B, S, H * D), p["wo"])
    x = rms_norm(h, p["mlp_norm"]["weight"], cfg.rms_norm_eps, cfg.norm_offset)
    act = _act(cfg.hidden_act)
    if cfg.num_experts > 0:
        from helix_tpu_torch.models.moe import moe_ffn

        router = p["router"]["weight"]
        if router.dtype == torch.int8:
            # dequantised in float32: rounding the router through bf16
            # could flip a near-tied top-k choice (``llama.py:210-216``)
            router = router.float() * p["router"]["scale"].float()
        out, dropped = moe_ffn(x, router, p["experts"], cfg, act,
                               token_mask=moe_token_mask,
                               return_dropped=True)
        return h + out, (k, v), new_cache, dropped
    gate = dense(x, p["w_gate"])
    up = dense(x, p["w_up"])
    h = h + dense(act(gate) * up, p["w_down"])
    return h, (k, v), new_cache, None


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, scaling, device) -> torch.Tensor:
    """Rotary inverse frequencies on ``device``, uploaded once per
    configuration (an upload per forward would be a synchronising copy
    in every device step)."""
    return torch.from_numpy(rope_frequencies(head_dim, theta, scaling)).to(
        device)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens,              # [B, S] integer
    positions,           # [B, S] integer (absolute, ragged-aware)
    *,
    attn_fn: AttnFn,
    layer_caches=None,   # tuple of tensors with a leading num_layers dim
    carry_caches=None,   # anything; threaded through every layer
    return_hidden: bool = False,
    adapter_ids=None,    # [B, S] integer: multi-LoRA pool slot per token
    positions3=None,     # [3, B, S] integer: M-RoPE streams (mrope configs)
    input_embeds=None,   # [B, S, E]: in place of the token embeddings
    moe_token_mask=None,     # [B, S] bool: tokens the MoE router places
    return_moe_stats: bool = False,  # also {"dropped": int32 over layers}
):
    """Run the decoder.

    - ``layer_caches`` (or no cache): ``attn_fn(q, k, v, layer_cache,
      pos)`` gets layer i's views (``tuple(c[i] for c in layer_caches)``,
      or None) and returns the attention output; returns ``(logits, kv)``
      with ``kv = (k, v)`` stacked ``[L, B, S, KVH, D]``.
    - ``carry_caches``: ``attn_fn(q, k, v, (caches, i), pos)`` returns
      ``(out, caches)`` — in place, the same pool object comes back — and
      the call returns ``(logits, caches)``.

    Logits are float32 (``project_logits``); ``return_hidden`` returns
    the final-norm hidden states instead.  ``adapter_ids`` reach every
    projection (``ops.quant.maybe_dequant_dense``'s pool form, with the
    ``lora_pool_*`` entries an ``AdapterPool`` grafts into the layers).
    An mrope config needs ``positions3`` (the reference's
    ``text_forward_mrope``, which also takes ``input_embeds``: the image
    splice).  An MoE config routes only the tokens of ``moe_token_mask``
    (padding and rows sitting out take no expert capacity);
    ``return_moe_stats`` appends ``{"dropped": ...}``, the int32 device
    sum of every layer's capacity drops (0 for a dense model).
    """
    if (cfg.mrope_sections is None) != (positions3 is None):
        raise ValueError(
            f"{cfg.name}: mrope configs rotate by positions3 "
            "(models.qwen2_vl.text_forward_mrope), other configs never")
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         tokens.device)
    if input_embeds is None:
        h = embed_lookup(params["embed"], tokens.long(),
                         torch_dtype(cfg.dtype))
    else:
        h = input_embeds.to(torch_dtype(cfg.dtype))
    caches = carry_caches
    ks, vs, drops = [], [], []
    for i in range(cfg.num_layers):
        if carry_caches is not None:
            lc = (caches, i)
        elif layer_caches is not None:
            lc = tuple(c[i] for c in layer_caches)
        else:
            lc = None
        h, (k, v), new, dropped = _layer(
            h, _layer_params(params["layers"], i), lc, cfg, positions,
            inv_freq, attn_fn, adapter_ids=adapter_ids,
            positions3=positions3, moe_token_mask=moe_token_mask,
        )
        if dropped is not None:
            drops.append(dropped)
        if carry_caches is not None:
            caches = new
        else:
            ks.append(k)
            vs.append(v)
    h = rms_norm(h, params["final_norm"]["weight"], cfg.rms_norm_eps,
                 cfg.norm_offset)
    out_cache = caches if carry_caches is not None else (
        torch.stack(ks), torch.stack(vs)
    )
    out = (h if return_hidden else project_logits(params, cfg, h),
           out_cache)
    if return_moe_stats:
        dropped = (torch.stack(drops).sum(dtype=torch.int32) if drops
                   else torch.zeros((), dtype=torch.int32, device=h.device))
        out += ({"dropped": dropped},)
    return out


def project_logits(params: Params, cfg: ModelConfig, h):
    """Final-norm hidden states -> float32 logits over the vocab: the
    product accumulated in float32 (never rounded to the compute dtype),
    times the int8 scale in float32 where the table is quantized (tied:
    ``embed_scale``, untied: ``lm_head.scale``), as
    ``helix_tpu/models/llama.py:330-344``."""
    if cfg.tie_word_embeddings:
        w_out = params["embed"]["weight"].T
        out_scale = params["embed"].get("embed_scale")   # [V, 1]
    else:
        w_out = params["lm_head"]["weight"]
        out_scale = params["lm_head"].get("scale")       # [1, V]
    if w_out.dtype == torch.int8:
        w_out = w_out.to(h.dtype)
    logits = matmul_f32(h, w_out)
    if out_scale is not None:
        logits = logits * out_scale.reshape(-1)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return logits


def _embed_part(p: dict, tokens, index: int) -> torch.Tensor:
    """Shard ``index``'s float32 share of the embedding lookup: its own
    vocabulary rows looked up, zeros for tokens another shard holds (the
    sum over shards is then exact: one term is not zero)."""
    w = p["weight"]
    rows = w.shape[0]
    local = tokens - index * rows
    mine = (local >= 0) & (local < rows)
    at = local.clamp(0, rows - 1)
    emb = w[at].float()
    if w.dtype == torch.int8:
        emb = emb * p["embed_scale"][at]
    return torch.where(mine[..., None], emb, 0.0)


def _row_partial(x, p: dict) -> torch.Tensor:
    """A row-parallel shard's float32 product ``x @ W_shard``, never
    rounded: the int8 scale and the bias apply after the sum."""
    w = p["weight"]
    if w.dtype == torch.int8:
        w = w.to(x.dtype)
    return matmul_f32(x, w)


def _row_epilogue(p: dict):
    """The float32 epilogue of a row-parallel projection's sum on the
    first device: that shard's copy of the (whole) output-channel scale
    and bias, as ``maybe_dequant_dense`` applies them; None when there
    is neither."""
    scale, bias = p.get("scale"), p.get("bias")
    if scale is None and bias is None:
        return None

    def epilogue(acc):
        if scale is not None:
            acc = acc * scale.reshape(-1)
        if bias is not None:
            acc = acc + bias.float()
        return acc

    return epilogue


def forward_sharded(
    shards: list,
    cfg: ModelConfig,
    tokens,              # [B, S] integer, on the mesh's first device
    positions,           # [B, S] integer
    *,
    attn_fns: list,
    carry_caches: list,
    mesh,
    return_hidden: bool = False,
):
    """The decoder tensor parallel over ``mesh`` (Megatron layout), the
    carry protocol of ``forward`` per shard.

    - ``shards[i]``: shard i's parameter tree on ``mesh.devices[i]``
      (``shard_params(params, mesh, param_logical_axes(cfg))``).
    - The embedding lookup is vocabulary-sharded: each shard looks up
      its own rows, zeros elsewhere, and the float32 shares are summed.
    - Column-parallel wq / wk / wv / w_gate / w_up: shard i computes its
      ``H / n`` query heads, ``KVH / n`` KV heads and ``F / n`` FFN
      columns.  ``attn_fns[i](q, k, v, (carry_caches[i], layer), pos)``
      returns ``(out, cache)`` on shard i's heads.
    - Row-parallel wo / w_down: each shard's product stays float32, the
      partials are summed in shard order and rounded once to the compute
      dtype (``parallel.collectives.all_reduce``), the int8 scale and
      bias applied to the sum.  The hidden state is the same on every
      shard.
    - The logits are vocabulary-sharded float32 products gathered on the
      first device (``project_logits_sharded``); ``return_hidden``
      returns the first device's final-norm hidden states instead.

    Returns ``(logits or hidden, caches)``.  Dense Llama-family configs
    only: an MoE or mrope config is refused (ROADMAP A15b)."""
    if cfg.num_experts > 0 or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts and mrope (VL) models on a "
            "mesh are not ported yet (ROADMAP A15b)")
    devs = list(mesh.devices)
    n = len(devs)
    dt = torch_dtype(cfg.dtype)
    Hs, KVHs, D = cfg.num_heads // n, cfg.num_kv_heads // n, cfg.head_dim
    toks = replicate(tokens.long(), devs)
    pos = replicate(positions, devs)
    inv = [_inv_freq(D, cfg.rope_theta, cfg.rope_scaling, d) for d in devs]
    eps, off = cfg.rms_norm_eps, cfg.norm_offset
    act = _act(cfg.hidden_act)
    h = all_reduce([_embed_part(shards[i]["embed"], toks[i], i)
                    for i in range(n)], devs, dt)
    caches = list(carry_caches)
    for lyr in range(cfg.num_layers):
        ps = [_layer_params(t["layers"], lyr) for t in shards]
        parts = []
        for i, p in enumerate(ps):
            B, S, _ = h[i].shape
            x = rms_norm(h[i], p["attn_norm"]["weight"], eps, off)
            q = maybe_dequant_dense(x, p["wq"]).reshape(B, S, Hs, D)
            k = maybe_dequant_dense(x, p["wk"]).reshape(B, S, KVHs, D)
            v = maybe_dequant_dense(x, p["wv"]).reshape(B, S, KVHs, D)
            if cfg.qk_norm:
                q = rms_norm(q, p["q_norm"]["weight"], eps)
                k = rms_norm(k, p["k_norm"]["weight"], eps)
            q = apply_rope(q, pos[i], inv[i])
            k = apply_rope(k, pos[i], inv[i])
            out, caches[i] = attn_fns[i](q, k, v, (caches[i], lyr), pos[i])
            parts.append(_row_partial(out.reshape(B, S, Hs * D), p["wo"]))
        o = all_reduce(parts, devs, dt, _row_epilogue(ps[0]["wo"]))
        h = [a + b for a, b in zip(h, o)]
        parts = []
        for i, p in enumerate(ps):
            x = rms_norm(h[i], p["mlp_norm"]["weight"], eps, off)
            gate = maybe_dequant_dense(x, p["w_gate"])
            up = maybe_dequant_dense(x, p["w_up"])
            parts.append(_row_partial(act(gate) * up, p["w_down"]))
        o = all_reduce(parts, devs, dt, _row_epilogue(ps[0]["w_down"]))
        h = [a + b for a, b in zip(h, o)]
    h = [rms_norm(x, t["final_norm"]["weight"], eps, off)
         for x, t in zip(h, shards)]
    if return_hidden:
        return h[0], caches
    return project_logits_sharded(shards, cfg, h, mesh), caches


def project_logits_sharded(shards: list, cfg: ModelConfig, h, mesh):
    """Final-norm hidden states -> float32 logits over the vocabulary,
    on the mesh's first device: each shard projects onto its own
    vocabulary rows (``project_logits`` of its tree), the shards'
    float32 logits concatenated.  ``h``: one tensor per shard, or one
    tensor on the first device (copied to the others)."""
    hs = h if isinstance(h, list) else replicate(h, mesh.devices)
    return all_gather([project_logits(t, cfg, x)
                       for t, x in zip(shards, hs)], dim=-1)


def prefill_attn_fn(q, k, v, layer_cache, positions, *, segment_ids=None,
                    backend=None, soft_cap=None):
    """Self-attention over the freshly computed K/V (no history): kernel
    K2 on the card."""
    from helix_tpu_torch.ops.attention import attention

    return attention(
        q, k, v,
        causal=True,
        q_positions=positions,
        kv_positions=positions,
        q_segment_ids=segment_ids,
        kv_segment_ids=segment_ids,
        logits_soft_cap=soft_cap,
        backend=backend,
    )
