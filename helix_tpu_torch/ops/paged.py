"""Ragged paged attention: the op every device-step caller goes through.

Port of ``helix_tpu/ops/paged.py``.  The contract is the
reference's: a flat query axis ``[T, H, D]`` carved into rows by
``t0``/``q_len``, each row attending its pages-resident history
``[0, hist[r])`` (through ``tables[r]``, pool layer ``layer``) plus its own
fresh tokens causally; rows never see each other.

- ``ragged_paged_attention`` — the dispatcher; the default backend is the
  kernel K1 wrapper (``ops/paged_kernel.py``).
- ``ragged_paged_attention_reference`` — the oracle (gather + one masked
  softmax), shared with K1's plain version.
- ``paged_decode_attention_reference`` — the decode-shaped oracle kept for
  tests.

Int8 pools pass their float32 scale pools as ``k_scale``/``v_scale``:
history is dequantized in float32 and attended at the compute dtype,
fresh K/V raw.  Tiered residency passes each row's demoted history span
``span_lo``/``span_hi`` and the staged cold chunks ``cold_*``: the span
leaves the hot gather and the chunks' online-softmax stats merge in (on
the card, K1's cold form).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from helix_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from helix_tpu_torch.ops.paged_kernel import (
    TIERED_ARGS,
    _row_of_tokens,  # noqa: F401  (re-exported: the reference's home)
    ragged_paged_attention as ragged_paged_attention_kernel,
    ragged_paged_attention_plain,
)

_TIERED = TIERED_ARGS + ("cold_k_scale", "cold_v_scale")


def _tiered_kw(kw: dict) -> dict:
    """The tiered keyword arguments; any other name is refused."""
    unknown = sorted(k for k in kw if k not in _TIERED)
    if unknown:
        raise TypeError(f"ragged_paged_attention: unknown arguments "
                        f"{unknown}")
    return kw


def paged_decode_attention_reference(
    q,            # [B, H, D]
    k_pages,      # [N, P, KVH, D] — ONE layer's pages
    v_pages,
    page_tables,  # [B, maxP]
    lengths,      # [B] — past tokens in cache
    k_new=None,   # [B, KVH, D] current token's K
    v_new=None,
    *,
    scale: Optional[float] = None,
    k_scale=None,  # [N, P, KVH] f32 — ONE layer's scale pool (int8 pages)
    v_scale=None,
):
    B, H, D = q.shape
    N, P, KVH, _ = k_pages.shape
    maxP = page_tables.shape[1]
    group = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    T = maxP * P
    tables = page_tables.long()
    kg = k_pages[tables].float()
    vg = v_pages[tables].float()
    if k_scale is not None:
        kg = kg * k_scale[tables].float()[..., None]
        vg = vg * v_scale[tables].float()[..., None]
    kg = kg.reshape(B, T, KVH, D).transpose(1, 2)
    vg = vg.reshape(B, T, KVH, D).transpose(1, 2)
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    if k_new is not None:
        kg = torch.cat([kg, k_new[:, :, None, :].float()], dim=2)
        vg = torch.cat([vg, v_new[:, :, None, :].float()], dim=2)
        valid = torch.cat(
            [valid, torch.ones((B, 1), dtype=torch.bool, device=q.device)],
            dim=1,
        )
    qg = q.reshape(B, KVH, group, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, kg) * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, vg)
    return out.reshape(B, H, D).to(q.dtype)


def ragged_paged_attention_reference(
    q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist, tables,
    *, scale: Optional[float] = None, k_scale=None, v_scale=None,
    **tiered,
):
    """Oracle for the ragged contract: gather every row's pages, one
    segment-masked softmax over the R histories + the fresh tokens
    (tiered rows: the cold chunks' stats first, then that block's, one
    combine).  Masked positions sit at ``DEFAULT_MASK_VALUE`` so the
    fixed ``maxP`` gather width cannot perturb live sums."""
    return ragged_paged_attention_plain(
        q, k_new, v_new, k_pages, v_pages, int(layer), t0, q_len, hist,
        tables, scale=scale, k_scale=k_scale, v_scale=v_scale,
        **_tiered_kw(tiered),
    )


def ragged_paged_attention(
    q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist, tables,
    *, scale: Optional[float] = None, backend: Optional[str] = None,
    k_scale=None, v_scale=None, **tiered,
):
    """THE paged-attention entry point.  Returns ``out [T, H, D]``.

    ``backend`` ``None``: the K1 wrapper (the CUDA kernel on the card, its
    cold form for tiered calls, its plain version on the CPU).
    ``"reference"``: the plain version on any device, for comparisons."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_new, v_new, k_pages, v_pages, int(layer), t0, q_len, hist,
            tables)
    kw = dict(scale=scale, k_scale=k_scale, v_scale=v_scale,
              **_tiered_kw(tiered))
    if backend is None:
        return ragged_paged_attention_kernel(*args, **kw)
    if backend == "reference":
        return ragged_paged_attention_plain(*args, **kw)
    raise ValueError(f"unknown paged attention backend {backend!r}")
