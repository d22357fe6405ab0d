"""Mixture-of-experts FFN: GShard-style top-k dispatch with a static
per-expert capacity (port of ``helix_tpu/models/moe.py``).

- router: float32 logits per token over the experts, top-k (ties to the
  lower expert index, as ``jax.lax.top_k``), a softmax over the k values;
- capacity: each expert takes at most ``C = factor * T * k / X`` of the
  call's ``T = B * S`` tokens (padding counts), ``C = T`` for decode
  shapes (``S == 1``: dropless).  Assignments rank choice-major: every
  first choice of the call ahead of every second choice, then by token;
  an assignment past ``C`` is dropped (its combine weight is zero, the
  token rides the residual stream);
- dispatch / combine: where the reference moves tokens with one-hot
  ``[T, X, C]`` einsums, the port scatters each kept assignment's token
  index into its ``(expert, slot)`` and gathers: each slot holds one
  token either way, so the buffers are the same numbers;
- the experts: one batched SwiGLU over the ``[X, C, E]`` buffers and the
  stacked ``[X, E, F]`` weights (``ops.quant.expert_dense``, float32
  outputs), ``act(gate) * up`` rounded once to the compute dtype before
  ``w_down``, the combine in float32 and one rounding at the end.

Nothing here reads a device value on the host: ``C`` comes from shapes,
and the drop count is returned as a device scalar.
"""

from __future__ import annotations

import torch

from helix_tpu_torch.ops.quant import expert_dense


def top_k_lower_index(logits: torch.Tensor, k: int) -> tuple:
    """``(values, indices)`` of the ``k`` largest entries of the last
    axis, largest first, equal values in increasing index order (the
    order ``jax.lax.top_k`` gives; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, router_p, experts_p, cfg, act, token_mask=None,
            return_dropped=False):
    """``x [B, S, E]`` -> ``[B, S, E]`` in ``x``'s dtype (with
    ``return_dropped``: ``(out, dropped)``, ``dropped`` the int32 device
    count of valid (token, choice) assignments past their expert's
    capacity).

    ``router_p [E, X]`` (float; the caller dequantises an int8 router);
    ``experts_p``: ``{"w_gate" / "w_up": {"weight": [X, E, F][,
    "scale": [X, 1, F]]}, "w_down": {...}}``, float or int8.
    ``token_mask [B, S]``: False tokens take no capacity and count no
    drop (their output is the combine of nothing, zero)."""
    B, S, E = x.shape
    X, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    dev = x.device
    xf = x.reshape(T, E)

    logits = torch.matmul(xf.float(), router_p.float())           # [T, X]
    top_vals, top_idx = top_k_lower_index(logits, k)               # [T, k]
    top_w = torch.softmax(top_vals, dim=-1)

    # slots per expert: dropless for decode shapes
    C = T if S == 1 else max(int(cfg.expert_capacity_factor * T * k / X), 1)
    # choice-major: row j * T + t is token t's j-th choice; masked tokens
    # go to the sentinel expert X
    flat_idx = top_idx.t().reshape(-1)                             # [kT]
    if token_mask is not None:
        valid = token_mask.reshape(T).to(torch.bool).repeat(k)
        flat_idx = torch.where(valid, flat_idx, X)
    onehot = (flat_idx[:, None] == torch.arange(X, device=dev)).to(
        torch.int32)                                               # [kT, X]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    real = flat_idx < X
    keep = (pos < C) & real
    dropped = (real & ~keep).sum(dtype=torch.int32)

    # slot of each kept assignment; the rest aim at a scratch slot X * C
    slot = torch.where(keep, flat_idx * C + pos, X * C)            # [kT]
    token = torch.arange(T, device=dev).repeat(k)
    src = torch.full((X * C + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot, token)   # kept slots are distinct
    x_pad = torch.cat([xf, xf.new_zeros((1, E))])
    expert_in = x_pad[src[:X * C]].reshape(X, C, E)

    gate = expert_dense(expert_in, experts_p["w_gate"])
    up = expert_dense(expert_in, experts_p["w_up"])
    h = expert_dense((act(gate) * up).to(x.dtype), experts_p["w_down"])

    h_pad = torch.cat([h.reshape(X * C, E), h.new_zeros((1, E))])
    w = top_w.t().reshape(-1) * keep                               # [kT]
    out = (h_pad[slot] * w[:, None]).reshape(k, T, E).sum(dim=0)
    out = out.reshape(B, S, E).to(x.dtype)
    if return_dropped:
        return out, dropped
    return out
