"""Weight-only int8 quantization, int8 KV codecs, dense projections and
the embedding lookup (port of ``helix_tpu/ops/quant.py``).

- ``quantize_kv`` / ``dequantize_kv``: symmetric int8 KV with one f32
  scale per (token slot, KV head), absmax over head_dim.
- ``quantize_tensor`` / ``quantize_params``: per-output-channel int8
  weights (reduced over the input axis only, so stacked ``[L, in, out]``
  layers keep their own scales), per-row scales for the embedding, norms
  and biases untouched.  Both work one layer (or one column block) at a
  time on the tensors' device, so no float32 copy of a whole stack
  exists.
- ``maybe_dequant_dense``: every projection accumulates in float32,
  multiplies by the int8 scale, adds a single grafted LoRA adapter or
  the batched multi-LoRA pool's per-token delta and the bias in float32,
  and rounds once to the compute dtype, as the reference's
  ``dot_general`` with ``preferred_element_type=float32`` does.
- ``expert_dense``: the MoE layer's batched product over stacked
  ``[X, in, out]`` expert weights, float32 out, per-expert int8 scales.
"""

from __future__ import annotations

import torch

# Floor on KV quantization scales: keeps all-zero (never-written) page
# slots exactly representable and the dequant multiply finite.
KV_SCALE_EPS = 1e-8
_W_SCALE_EPS = 1e-8
# float32 elements one quantization step may hold (256 MiB)
_CHUNK_ELEMS = 1 << 26


def quantize_kv(x: torch.Tensor):
    """``x [..., KVH, D]`` -> (int8 ``[..., KVH, D]``, f32 ``[..., KVH]``):
    absmax over the trailing head_dim axis only."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=KV_SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the per-head scale broadcast over
    head_dim), computed in float32 and cast to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def _quantize_columns(wf: torch.Tensor, axis: int):
    """Codes and scale of a float32 block, absmax reduced over ``axis``."""
    scale = torch.clamp(wf.abs().amax(dim=axis, keepdim=True) / 127.0,
                        min=_W_SCALE_EPS)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tensor(w: torch.Tensor) -> dict:
    """Symmetric int8 with per-output-channel (last axis) scales, reduced
    over the input axis (``ndim - 2``) only.  Returns ``{"weight": int8,
    "scale": f32}`` with the scale's input axis kept as 1."""
    lead = w.shape[:-2]
    n_in, n_out = w.shape[-2:]
    w3 = w.reshape(-1, n_in, n_out)
    q3 = torch.empty(w3.shape, dtype=torch.int8, device=w.device)
    s3 = torch.empty((w3.shape[0], 1, n_out), dtype=torch.float32,
                     device=w.device)
    cols = max(1, _CHUNK_ELEMS // max(n_in, 1))
    for i in range(w3.shape[0]):
        for c0 in range(0, n_out, cols):
            c1 = min(n_out, c0 + cols)
            q3[i, :, c0:c1], s3[i, :, c0:c1] = _quantize_columns(
                w3[i, :, c0:c1].float(), 0)
    return {"weight": q3.reshape(w.shape),
            "scale": s3.reshape(*lead, 1, n_out)}


def quantize_rows(w: torch.Tensor):
    """Per-row int8 for the embedding table: ``(codes, scale [V, 1])``."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], 1), dtype=torch.float32,
                        device=w.device)
    rows = max(1, _CHUNK_ELEMS // max(w.shape[-1], 1))
    for r0 in range(0, w.shape[0], rows):
        r1 = min(w.shape[0], r0 + rows)
        q[r0:r1], scale[r0:r1] = _quantize_columns(w[r0:r1].float(), -1)
    return q, scale


def quantize_params(params: dict) -> dict:
    """Quantize every matmul weight of a parameter dict (the reference's
    ``quantize_params`` walk): ``{"weight"}`` of two or more dims outside
    a norm becomes ``{"weight": int8, "scale": f32}``; the embedding gets
    per-row ``embed_scale [V, 1]``.  Returns a new dict; tensors that are
    not quantized are shared with the input."""

    def walk(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if (k == "weight" and isinstance(v, torch.Tensor)
                    and v.ndim >= 2
                    and not any("norm" in p for p in path)):
                if path and path[-1] == "embed":
                    out["weight"], out["embed_scale"] = quantize_rows(v)
                else:
                    qd = quantize_tensor(v)
                    out["weight"], out["scale"] = qd["weight"], qd["scale"]
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(params)


def quantized_logical_axes(axes_tree):
    """A logical-axes tree of the float layout (``models.llama.
    param_logical_axes``) as one matching ``quantize_params``' output
    (copied from ``helix_tpu/ops/quant.py:110-146``): each quantized
    ``weight`` gains a ``scale`` whose contraction axes are replicated
    and whose output-channel axis keeps the weight's sharding (a
    column-parallel scale shards with its columns, a row-parallel one is
    whole on every shard and applies after the sum); the embedding
    gains a per-row ``embed_scale`` sharded like the vocabulary."""

    def walk(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if (k == "weight" and isinstance(v, tuple) and len(v) >= 2
                    and not any("norm" in p for p in path)):
                out["weight"] = v
                if path and path[-1] == "embed":
                    out["embed_scale"] = (v[0], None)
                else:
                    out["scale"] = tuple(a if i == len(v) - 1 else None
                                         for i, a in enumerate(v))
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(axes_tree)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., in] @ w [in, out]`` accumulated and returned in float32,
    the product never rounded to ``x``'s dtype.  On the card a bf16 GEMM
    with a float32 output (``torch.mm(..., out_dtype=float32)``); on the
    CPU a float32 matmul of the upcast operands."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MatmulF32Fn.apply(x, w)
        return _mm_f32(x, w)
    return torch.matmul(x.float(), w.float())


def _mm_f32(x, w):
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class _MatmulF32Fn(torch.autograd.Function):
    """``matmul_f32`` on the card under autograd (training): the forward
    is the float32-output GEMM, the backward ``_matmul_f32_vjp``.  On the
    CPU autograd differentiates the float32 matmul, which is the same
    formula."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _matmul_f32_vjp(x, w, g, ctx.needs_input_grad)


def _matmul_f32_vjp(x, w, g, needs=(True, True)):
    """``(gx, gw)`` of ``matmul_f32(x, w)`` for the float32 cotangent
    ``g``, as JAX transposes ``dot_general(x, w,
    preferred_element_type=float32)``: ``g`` stays float32 (where the
    output feeds float32 arithmetic, as the logits do the loss, it is not
    a bf16 value), each gradient is a float32 GEMM of it with the other
    operand upcast, rounded once to that operand's dtype."""
    gx = gw = None
    if needs[0]:
        gx = torch.matmul(g, w.float().T).to(x.dtype)
    if needs[1]:
        gw = (x.reshape(-1, x.shape[-1]).float().T
              @ g.reshape(-1, g.shape[-1])).to(w.dtype)
    return gx, gw


def expert_dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The per-expert product over stacked weights (the reference's
    ``models/moe.py`` ``_expert_dense``): ``x [X, C, in] @ p["weight"]
    [X, in, out]``, float or int8, accumulated and returned in float32,
    times the int8 output-channel scale ``p["scale"] [X, 1, out]`` in
    float32.  The result is never rounded to ``x``'s dtype.  On the card a
    batched GEMM with a float32 output (``torch.bmm(..., out_dtype=
    float32)``); on the CPU a float32 product of the upcast operands."""
    w = p["weight"]
    if w.dtype == torch.int8:
        # int8 codes are exact in bf16 and float32
        w = w.to(x.dtype)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        out = torch.bmm(x, w)
    elif x.is_cuda and x.dtype == w.dtype:
        out = torch.bmm(x, w, out_dtype=torch.float32)
    else:
        out = torch.bmm(x.float(), w.float())
    scale = p.get("scale")
    if scale is not None:
        out = out * scale.float()
    return out


def maybe_dequant_dense(x, p: dict, adapter_ids=None, compute_dtype=None):
    """``x @ p["weight"]`` with weights stored ``[in, out]``, float or int8
    (with ``p["scale"]``), plus the LoRA forms and ``p["bias"]``; one
    rounding to the compute dtype.

    - single LoRA (``lora_a [in, r]``, ``lora_b [r, out]``,
      ``lora_scale``): ``scale * (x @ a) @ b``, the low-rank product
      rounded once to the compute dtype between the two GEMMs;
    - the multi-LoRA pool (``lora_pool_a [in, N, r]``, ``lora_pool_b
      [N, r, out]``, ``lora_pool_scale [N]``, slot 0 the zero identity;
      ``engine.adapters.AdapterPool``): two dense GEMMs over all N slots,
      as the reference's einsums.  ``low = x @ a`` viewed ``[in, N r]``
      in float32; every slot's column block but the token's own
      (``adapter_ids [..., S]``) zeroed; rounded once; times ``b`` viewed
      ``[N r, out]`` in float32; times the token's slot scale.  The slot
      stack is read once per projection, not once per token.  Rows of
      slot 0 add an exact ``+0.0``.  ``adapter_ids`` None skips the
      delta (the caller knows no row carries an adapter), not the
      float32 base product: a pool-grafted projection takes that one
      GEMM for every row.

    A float projection without bias or LoRA is one GEMM in the compute
    dtype, which accumulates in float32 and rounds once by itself."""
    compute_dtype = compute_dtype or x.dtype
    w = p["weight"]
    scale = p.get("scale")
    b = p.get("bias")
    lora = "lora_a" in p or "lora_pool_a" in p
    if w.dtype == torch.int8:
        # int8 codes are exact in bf16 and float32
        w = w.to(x.dtype)
    elif w.dtype != x.dtype:
        # mixed operands (the vision tower's float32 activations on bf16
        # weights) promote as the reference's dot_general does: both to
        # the wider type, the result in the activations' dtype
        wide = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(wide), w.to(wide)
    if w.dtype != torch.int8 and scale is None and b is None and not lora:
        return torch.matmul(x, w).to(compute_dtype)
    out = matmul_f32(x, w)
    if scale is not None:
        out = out * scale.reshape(-1)
    if "lora_a" in p:
        low = matmul_f32(x, p["lora_a"].to(compute_dtype))
        out = out + p["lora_scale"] * matmul_f32(
            low.to(compute_dtype), p["lora_b"].to(compute_dtype))
    if adapter_ids is not None and "lora_pool_a" in p:
        out = out + _pool_delta(x, p, adapter_ids, compute_dtype)
    if b is not None:
        out = out + b.float()
    return out.to(compute_dtype)


def _pool_delta(x, p: dict, adapter_ids, compute_dtype) -> torch.Tensor:
    """``scale[g] * (x @ A[g]) @ B[g]`` per token, in float32, from the
    stacked slots (the BGMV of ``maybe_dequant_dense``'s pool form)."""
    pa = p["lora_pool_a"].to(compute_dtype)     # [in, N, r]
    pb = p["lora_pool_b"].to(compute_dtype)     # [N, r, out]
    fan_in, n_slots, r = pa.shape
    ids = adapter_ids.long()
    # one-hot by comparison: torch's one_hot checks its range on the
    # host, a synchronising read on the card
    onehot = (ids[..., None] == torch.arange(n_slots, device=ids.device)
              ).to(torch.float32)                                  # [.., S, N]
    low = matmul_f32(x, pa.reshape(fan_in, n_slots * r))
    low = (low.unflatten(-1, (n_slots, r)) * onehot[..., None]).flatten(-2)
    delta = matmul_f32(low.to(compute_dtype),
                       pb.reshape(n_slots * r, pb.shape[-1]))
    tok_scale = p["lora_pool_scale"].float()[ids]                  # [.., S]
    return tok_scale[..., None] * delta


def embed_lookup(p: dict, tokens, compute_dtype):
    """Embedding lookup through a float or row-quantized table."""
    w = p["weight"]
    emb = w[tokens]
    if w.dtype == torch.int8:
        emb = emb.float() * p["embed_scale"][tokens]
    return emb.to(compute_dtype)
