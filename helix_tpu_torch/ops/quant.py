"""Dense projections and embedding lookup (port of the float forms of
``helix_tpu/ops/quant.py``).

Only float weights are served in this slice.  The int8 weight-only form,
the single-LoRA graft and the batched multi-LoRA pool raise
``NotImplementedError`` (ROADMAP A13).
"""

from __future__ import annotations

import torch

_LORA_KEYS = ("scale", "lora_a", "lora_pool_a")


def maybe_dequant_dense(x, p: dict, adapter_ids=None, compute_dtype=None):
    """``x @ p["weight"] (+ p["bias"])`` with weights stored ``[in, out]``.

    In float32 this matches the reference exactly: one f32 product, the
    bias added in f32, one rounding.  In bf16 the product ``x @ W`` rounds
    to bf16 (accumulating in f32 inside the GEMM) BEFORE the bias is added
    in f32 and rounded again — one extra bf16 rounding over the reference,
    which accumulates, adds the bias and rounds once.  Only bias-carrying
    configs (Qwen2) see it; ``tests/test_torch_model.py`` states the bf16
    tolerance.
    """
    if adapter_ids is not None or any(k in p for k in _LORA_KEYS):
        raise NotImplementedError(
            "int8 weights and LoRA adapters are not ported yet (ROADMAP A13)"
        )
    compute_dtype = compute_dtype or x.dtype
    w = p["weight"]
    if w.dtype == torch.int8:
        raise NotImplementedError(
            "int8 weights are not ported yet (ROADMAP A13)"
        )
    out = torch.matmul(x, w)
    b = p.get("bias")
    if b is not None:
        out = out.float() + b.float()
    return out.to(compute_dtype)


def embed_lookup(p: dict, tokens, compute_dtype):
    """Embedding lookup through a float table."""
    w = p["weight"]
    if w.dtype == torch.int8:
        raise NotImplementedError(
            "row-quantized embeddings are not ported yet (ROADMAP A13)"
        )
    return w[tokens].to(compute_dtype)
