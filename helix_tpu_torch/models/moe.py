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

Over an ``{ep, tp}`` mesh (``moe_ffn_shard``) every shard routes the
same replicated tokens over every expert, so the top-k, the positions and
the drops are the same numbers on every card (no copy of the indices);
each shard runs only its own experts' slots through its block of the FFN
columns and returns its float32 share of the combine, which the caller
sums over the whole mesh and rounds once.
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


def route(xf, router_p, cfg, S: int, token_mask=None) -> tuple:
    """The call's routing over every expert, the same on every shard of a
    mesh (the same ``xf`` and router give the same bits): ``(flat_idx,
    pos, keep, weight, C, dropped)``, each ``[k T]`` in choice-major
    order (row ``j * T + t`` is token t's j-th choice): the expert (``X``
    for a masked token), the position in it, whether it holds a slot,
    the softmax weight; ``C`` the slots per expert from the call's global
    ``T = B * S`` and ``X`` (``T`` for decode shapes), ``dropped`` the
    int32 device count of valid assignments past their expert's
    capacity."""
    T = xf.shape[0]
    X, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.matmul(xf.float(), router_p.float())           # [T, X]
    top_vals, top_idx = top_k_lower_index(logits, k)               # [T, k]
    top_w = torch.softmax(top_vals, dim=-1)

    # slots per expert: dropless for decode shapes
    C = T if S == 1 else max(int(cfg.expert_capacity_factor * T * k / X), 1)
    # choice-major: masked tokens go to the sentinel expert X
    flat_idx = top_idx.t().reshape(-1)                             # [kT]
    if token_mask is not None:
        valid = token_mask.reshape(T).to(torch.bool).repeat(k)
        flat_idx = torch.where(valid, flat_idx, X)
    onehot = (flat_idx[:, None] == torch.arange(X, device=xf.device)).to(
        torch.int32)                                               # [kT, X]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    real = flat_idx < X
    keep = (pos < C) & real
    dropped = (real & ~keep).sum(dtype=torch.int32)
    return flat_idx, pos, keep, top_w.t().reshape(-1), C, dropped


def _own_experts(p: dict, x0: int, n: int) -> dict:
    """A projection's weights for experts ``x0 .. x0 + n``: the weight as
    held (a shard's stack holds only its own experts), the int8 scale cut
    to them where it holds every expert (``quantized_logical_axes``
    replicates a scale's expert axis)."""
    scale = p.get("scale")
    if scale is None or scale.shape[0] == n:
        return p
    return {**p, "scale": scale[x0:x0 + n]}


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
    share, dropped = moe_ffn_shard(x, router_p, experts_p, cfg, act, 0,
                                   token_mask)
    out = share.to(x.dtype)
    if return_dropped:
        return out, dropped
    return out


def moe_ffn_shard(x, router_p, experts_p, cfg, act, ep_index: int,
                  token_mask=None) -> tuple:
    """One shard's part of ``moe_ffn`` over an ``{ep, tp}`` mesh:
    ``(share, dropped)``, ``share [B, S, E]`` float32, never rounded.

    Every shard routes the same replicated ``x`` over all ``X`` experts
    with the global ``T`` (``route``).  Shard ``ep_index`` of the ep axis
    holds experts ``x0 = ep_index * n .. x0 + n`` (``experts_p``' stacks
    ``[n, E, F / tp]`` / ``[n, F / tp, E]``, the int8 scales of
    ``quantized_logical_axes``): their ``[n, C, E]`` slots gathered, the
    SwiGLU over its columns (``expert_dense``, float32 out; ``act(gate) *
    up`` rounded once to ``x``'s dtype), each held assignment's output
    times its weight, summed over its choices.  An assignment another
    shard holds adds an exact zero, and a block of the FFN columns gives
    its float32 partial of the ``w_down`` product (the int8 scale, per
    expert and channel, applied to it).  The shares summed over every
    shard of the mesh, rounded once to ``x``'s dtype, are ``moe_ffn``'s
    output; ``dropped`` is the same on every shard (the caller counts it
    once)."""
    B, S, E = x.shape
    T = B * S
    xf = x.reshape(T, E)
    flat_idx, pos, keep, weight, C, dropped = route(xf, router_p, cfg, S,
                                                    token_mask)
    k = flat_idx.numel() // T
    n = experts_p["w_gate"]["weight"].shape[0]
    x0 = ep_index * n
    dev = xf.device
    local = flat_idx - x0
    mine = keep & (local >= 0) & (local < n)
    # slot of each assignment held here; the rest aim at a scratch slot
    slot = torch.where(mine, local * C + pos, n * C)               # [kT]
    token = torch.arange(T, device=dev).repeat(k)
    src = torch.full((n * C + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot, token)   # held slots are distinct
    x_pad = torch.cat([xf, xf.new_zeros((1, E))])
    expert_in = x_pad[src[:n * C]].reshape(n, C, E)

    gate = expert_dense(expert_in, _own_experts(experts_p["w_gate"], x0, n))
    up = expert_dense(expert_in, _own_experts(experts_p["w_up"], x0, n))
    h = expert_dense((act(gate) * up).to(x.dtype),
                     _own_experts(experts_p["w_down"], x0, n))

    h_pad = torch.cat([h.reshape(n * C, E), h.new_zeros((1, E))])
    w = weight * mine                                              # [kT]
    share = (h_pad[slot] * w[:, None]).reshape(k, T, E).sum(dim=0)
    return share.reshape(B, S, E), dropped
