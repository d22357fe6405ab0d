"""Kernel K1: ragged paged attention, wrapper + plain version.

``ragged_paged_attention`` launches ``csrc/ragged_paged_attention.cu``
(the Hopper replacement of the Pallas ``ragged_paged_attention_tpu``) on a
CUDA tensor and runs ``ragged_paged_attention_plain`` on a CPU tensor.
Contract (``helix_tpu/ops/paged.py``): flat queries ``q [T, H, D]`` and
fresh ``k_new``/``v_new [T, KVH, D]`` carved into rows by ``t0``/``q_len``;
token t of row r sits at position ``hist[r] + (t - t0[r])`` and attends the
row's pages-resident history ``[0, hist[r])`` of pool layer ``layer`` plus
the row's fresh tokens up to and including itself.  Output ``[T, H, D]``;
tokens outside every row are left unspecified (the kernel never writes
them), so callers read live tokens only.

Int8 pools come with float32 scale pools ``k_scale``/``v_scale [L, N, P,
KVH]`` (the Pallas kernel's ``quantized=True`` form): history is
dequantized in float32 as ``code * scale``; fresh K/V are attended raw.
The kernel launches its int8 entry point for them and counts those
launches apart, on ``K1_INT8``.

On the card the history is split over blocks in spans of whole pages
(``_k1_split``, from host-known shapes only) and the partial softmax
states are merged in float32; the wrapper allocates that scratch.

Tiered rows (``span_lo``/``span_hi`` and the staged cold slab
``cold_*``, the reference's tiered arguments) launch K1's cold form,
counted on ``K1_COLD`` / ``K1_INT8_COLD``.  bf16 queries run
``csrc/ragged_paged_attention_cold.cu`` on the tensor cores: a pre-pass
lists each row's live work on the device (``k1_cold_worklist`` is its
plain version), the main kernel attends one (query tile, item, KV head)
unit at a time and a merge combines a row's ``_k1_cold_slots`` slots.
float32 queries run the CUDA-core cold form of K1's own source, where the
demoted span leaves the hot history and the slab's chunks are
``_k1_cold_parts`` more parts of the same merge.  The Pallas kernel has
no such form (the reference runs its XLA oracle for tiered calls); the
port never runs the plain version on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from helix_tpu_torch.kernels.build import Kernel, KernelForm
from helix_tpu_torch.ops.attention import (
    DEFAULT_MASK_VALUE,
    SUPPORTED_HEAD_DIMS,
    mha_reference,
)

K1 = Kernel("ragged_paged_attention", "ragged_paged_attention.cu")
K1_INT8 = KernelForm("ragged_paged_attention_int8", K1)
# the cold form: its bf16 entry points are this source's; float32 calls
# launch the CUDA-core form in K1's source and count here too
K1_COLD = Kernel("ragged_paged_attention_cold",
                 "ragged_paged_attention_cold.cu")
K1_INT8_COLD = KernelForm("ragged_paged_attention_int8_cold", K1_COLD)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_K1_ARGS = [_P] * 12 + [_I] * 11 + [ctypes.c_float, _I, _P]
_K1_INT8_ARGS = [_P] * 14 + [_I] * 11 + [ctypes.c_float, _I, _P]
_K1_INFO_ARGS = [_I] * 8 + [_P]
_K1_COLD_ARGS = [_P] * 18 + [_I] * 14 + [ctypes.c_float, _I, _P]
_K1_INT8_COLD_ARGS = [_P] * 22 + [_I] * 14 + [ctypes.c_float, _I, _P]
_K1C_BF16_ARGS = [_P] * 19 + [_I] * 13 + [ctypes.c_float, _P]
_K1C_INT8_ARGS = [_P] * 23 + [_I] * 13 + [ctypes.c_float, _P]
_K1C_WORKLIST_ARGS = [_P] * 6 + [_I] * 7 + [_P]
_K1C_INFO_ARGS = [_I] * 3 + [_P]
# the tiered arguments every tiered call carries (int8 pools add the
# cold scales)
TIERED_ARGS = ("span_lo", "span_hi", "cold_k", "cold_v", "cold_row",
               "cold_len")
# history tokens per split block: enough pages to keep a block's copies in
# flight, few enough that decode rows of 1000-4000 tokens spread over
# several blocks each
SPAN_TOKENS = 512


def _k1_split(maxP: int, P: int) -> tuple:
    """``(pages_per_split, n_splits)``: the history axis ``[0, maxP * P)``
    cut into ``n_splits`` spans of ``pages_per_split`` whole pages (the
    last may be shorter), from shapes alone -- no look at the row
    metadata, which would cost a host sync per layer."""
    pps = max(1, min(maxP, SPAN_TOKENS // P))
    return pps, -(-maxP // pps)


def _k1_cold_parts(nC: int, maxP: int, P: int) -> int:
    """Cold parts of a tiered call: part j folds the chunks ``c = j (mod
    n)`` its row owns.  Enough parts that a row's full table of cold
    tokens spreads at about ``SPAN_TOKENS`` a part, never more than
    chunks; shapes alone decide."""
    return max(1, min(nC, -(-maxP * P // SPAN_TOKENS)))


# a cold part's chunks, at most (the kernel's window of pages / chunks)
_K1C_WINDOW = 128
# the pre-pass's item kinds
COLD_FRESH, COLD_HOT, COLD_CHUNKS = 0, 1, 2


def _k1_cold_slots(maxP: int, P: int) -> int:
    """Scratch slots per (token, head) of the bf16 cold form: a bound on a
    row's work items whatever its layout -- the fresh part, the hot
    ranges' pieces (at most ``maxP P / SPAN_TOKENS + 2``) and at least one
    cold part -- from shapes alone."""
    return -(-maxP * P // SPAN_TOKENS) + 4


def k1_cold_worklist(hist, span_lo, span_hi, cold_row, cold_len, maxP: int,
                     P: int, Ct: int) -> list:
    """The plain version of the bf16 cold form's pre-pass: per row, its
    items ``(kind, a, b)`` in slot order and its owned chunks.

    Slot 0 is the fresh part (``COLD_FRESH``); then the hot keys ``[0,
    lo)`` and ``[hi, h)`` (``h`` = hist clamped to the table's ``maxP P``
    keys, the demoted span clamped into ``[0, h)``, empty when ``lo >=
    hi``), each cut into equal pieces of at most ``SPAN_TOKENS`` keys
    (``COLD_HOT``, key range ``[a, b)``); then the row's chunks with
    ``cold_len > 0``, ascending, in parts of ``SPAN_TOKENS // Ct`` of them
    (more if the row would pass its ``_k1_cold_slots`` slots;
    ``COLD_CHUNKS``, ``[a, b)`` into the owned list)."""
    K = _k1_cold_slots(maxP, P)
    cpp = max(1, min(SPAN_TOKENS // Ct, _K1C_WINDOW))
    rows = []
    for r in range(len(hist)):
        owned = [c for c in range(len(cold_row))
                 if int(cold_row[c]) == r and int(cold_len[c]) > 0]
        h = min(max(int(hist[r]), 0), maxP * P)
        lo, hi = int(span_lo[r]), int(span_hi[r])
        if lo >= hi:
            lo = hi = h
        else:
            lo = min(max(lo, 0), h)
            hi = min(max(hi, lo), h)
        items = [(COLD_FRESH, 0, 0)]
        for a, b in ((0, lo), (hi, h)):
            n = -(-(b - a) // SPAN_TOKENS)
            items += [(COLD_HOT, a + (b - a) * i // n,
                       a + (b - a) * (i + 1) // n) for i in range(n)]
        if owned:
            per = max(cpp, -(-len(owned) // (K - len(items))))
            items += [(COLD_CHUNKS, p, min(len(owned), p + per))
                      for p in range(0, len(owned), per)]
        rows.append((items, owned))
    return rows


def k1_cold_worklist_device(hist, span_lo, span_hi, cold_row, cold_len,
                            maxP: int, P: int, Ct: int) -> list:
    """The bf16 cold form's pre-pass alone on the card, read back in
    ``k1_cold_worklist``'s form (for the card tests)."""
    R, nC = hist.shape[0], cold_row.shape[0]
    K = _k1_cold_slots(maxP, P)
    work = torch.full((4 * R * K + R + R * nC + 1,), -1, dtype=torch.int32,
                      device=hist.device)
    fn = K1_COLD.symbol("helix_ragged_paged_attention_cold_worklist",
                        _K1C_WORKLIST_ARGS)
    with torch.cuda.device(hist.device):
        err = fn(hist.data_ptr(), span_lo.data_ptr(), span_hi.data_ptr(),
                 cold_row.data_ptr(), cold_len.data_ptr(), work.data_ptr(),
                 R, P, maxP, nC, Ct, K, SPAN_TOKENS,
                 torch.cuda.current_stream(hist.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cold work list: cuda error {err}")
    w = work.cpu().tolist()
    row_n = w[4 * R * K:4 * R * K + R]
    chunks = w[4 * R * K + R:]
    rows = []
    for r in range(R):
        items = [tuple(w[4 * (r * K + k):4 * (r * K + k) + 3])
                 for k in range(row_n[r])]
        n_own = max([b for kind, _a, b in items if kind == COLD_CHUNKS],
                    default=0)
        rows.append((items, chunks[r * nC:r * nC + n_own]))
    return rows


def ragged_kernel_info(T: int, H: int, KVH: int, D: int, P: int, maxP: int,
                       dtype=torch.bfloat16, quantized: bool = False,
                       cold: bool = False, R: int = 16) -> dict:
    """Launch resources of K1's split kernel (``cold``: of its cold form;
    in bf16 the tensor-core kernel's main pass for ``R`` rows) at these
    shapes (needs the card): shared memory per block, registers, blocks
    per SM, spills."""
    info = (ctypes.c_int * 4)()
    if cold and dtype == torch.bfloat16:
        fn = K1_COLD.symbol("helix_ragged_paged_attention_cold_bf16_info",
                            _K1C_INFO_ARGS)
        err = fn(D, int(quantized), R, ctypes.addressof(info))
    else:
        fn = K1.symbol("helix_ragged_paged_attention_info", _K1_INFO_ARGS)
        err = fn(T, H, KVH, D, _k1_split(maxP, P)[0], _KERNEL_DTYPES[dtype],
                 int(quantized), int(cold), ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention info: cuda error {err}")
    return dict(smem_bytes=info[0], regs=info[1], blocks_per_sm=info[2],
                spill_bytes=info[3])


def _row_of_tokens(t0, q_len, T: int):
    """Per-token row assignment from ascending disjoint row extents.

    Returns ``(row, q_off)``: ``row[t]`` is the owning row id or -1 for
    tokens outside every row; ``q_off[t]`` the token's offset within its
    row (garbage where ``row < 0``)."""
    t = torch.arange(T, device=t0.device)
    cand = (t[:, None] >= t0[None, :]).sum(dim=1) - 1
    cand = cand.clamp(0, t0.shape[0] - 1)
    start = t0[cand]
    in_row = (t >= start) & (t < start + q_len[cand])
    return torch.where(in_row, cand, torch.full_like(cand, -1)), t - start


def _merge_stats(m1, l1, a1, m2, l2, a2):
    """Combine two online-softmax states ``(m, l, acc)`` (the reference's
    ``helix_tpu/parallel/ring_attention.py::_merge_stats``)."""
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    return m, l1 * e1 + l2 * e2, a1 * e1 + a2 * e2


def _cold_chunk_stats(q, row, cold_k, cold_v, cold_row, cold_len, *,
                      scale, k_scale=None, v_scale=None):
    """Online-softmax stats of the flat queries against ONE layer's staged
    cold chunks ``cold_k``/``cold_v [nC, Ct, KVH, D]`` (int8 codes with
    ``k_scale``/``v_scale [nC, Ct, KVH]``), folded in ascending chunk
    order (the reference's ``_cold_chunk_stats``).  Chunk c is seen only
    by tokens of row ``cold_row[c]`` (-1: nobody), over its first
    ``cold_len[c]`` tokens, with no causal mask: cold tokens precede
    every query.  Returns float32 ``(m, l [H, T, 1], acc [H, T, D])``."""
    T, H, D = q.shape
    KVH = cold_k.shape[2]
    qf = q.float()
    acc = torch.zeros((H, T, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((H, T, 1), dtype=torch.float32, device=q.device)
    m = torch.full_like(l, -math.inf)
    key = torch.arange(cold_k.shape[1], device=q.device)
    for c in range(cold_k.shape[0]):
        ck, cv = cold_k[c], cold_v[c]
        if k_scale is not None:
            ck = ck.float() * k_scale[c][..., None]
            cv = cv.float() * v_scale[c][..., None]
        ck = ck.to(q.dtype).float().repeat_interleave(H // KVH, dim=1)
        cv = cv.to(q.dtype).float().repeat_interleave(H // KVH, dim=1)
        s = torch.einsum("qhd,khd->hqk", qf, ck) * scale
        ok = (row[:, None] == cold_row[c]) & (row[:, None] >= 0)
        ok = ok & (key[None, :] < cold_len[c])
        s = torch.where(ok[None], s, torch.full_like(s, DEFAULT_MASK_VALUE))
        bm = s.amax(dim=-1, keepdim=True)
        bp = torch.exp(s - bm)
        bl = bp.sum(dim=-1, keepdim=True)
        bacc = torch.einsum("hqk,khd->hqd", bp, cv)
        m, l, acc = _merge_stats(m, l, acc, bm, bl, bacc)
    return m, l, acc


def ragged_paged_attention_plain(
    q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist, tables,
    *, scale: Optional[float] = None, k_scale=None, v_scale=None,
    span_lo=None, span_hi=None, cold_k=None, cold_v=None, cold_row=None,
    cold_len=None, cold_k_scale=None, cold_v_scale=None,
):
    """K1's plain PyTorch version: the gather-and-mask form of the
    reference oracle.  Gathers every row's full page table, masks history
    past ``hist[r]``, appends the fresh tokens and runs one segment-masked
    softmax (row identity as segment, absolute positions for causality).
    Int8 history is dequantized in float32 and then cast to the compute
    dtype, as the reference does (``helix_tpu/ops/paged.py:242-246``).

    Tiered rows (``helix_tpu/ops/paged.py:188-310``): history tokens in
    ``[span_lo[r], span_hi[r])`` leave the hot mask (their table entries
    point at page 0) and are attended from the staged cold chunks
    ``cold_k``/``cold_v [L, nC, Ct, KVH, D]`` instead: the chunks' stats
    first, in ascending order, then the hot + fresh block, one combine."""
    T, H, D = q.shape
    R, maxP = tables.shape
    _, N, P, KVH, _ = k_pages.shape
    Hs = maxP * P
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    t0, q_len, hist = t0.long(), q_len.long(), hist.long()
    tables = tables.long()
    row, q_off = _row_of_tokens(t0, q_len, T)
    q_pos = torch.where(row >= 0, hist[row.clamp(min=0)] + q_off,
                        torch.zeros_like(row))
    kh = k_pages[layer][tables]                    # [R, maxP, P, KVH, D]
    vh = v_pages[layer][tables]
    if k_scale is not None:
        kh = kh.float() * k_scale[layer][tables][..., None]
        vh = vh.float() * v_scale[layer][tables][..., None]
    kh = kh.to(q.dtype).reshape(1, R * Hs, KVH, D)
    vh = vh.to(q.dtype).reshape(1, R * Hs, KVH, D)
    hist_tok = torch.arange(Hs, device=q.device)
    resident = hist_tok[None, :] < hist[:, None]                 # [R, Hs]
    if span_lo is not None:
        cold = ((hist_tok[None, :] >= span_lo.long()[:, None])
                & (hist_tok[None, :] < span_hi.long()[:, None]))
        resident = resident & ~cold
    kv_seg_h = torch.where(
        resident, torch.arange(1, R + 1, device=q.device)[:, None], 0
    ).reshape(1, R * Hs)
    kv_pos_h = hist_tok[None, :].expand(R, Hs).reshape(1, R * Hs)
    k_all = torch.cat([kh, k_new.to(q.dtype)[None]], dim=1)
    v_all = torch.cat([vh, v_new.to(q.dtype)[None]], dim=1)
    seg_fresh = torch.where(row >= 0, row + 1, torch.zeros_like(row))
    kv_seg = torch.cat([kv_seg_h, seg_fresh[None]], dim=1)
    kv_pos = torch.cat([kv_pos_h, q_pos[None]], dim=1)
    # masked slots weigh exactly 0, but 0 * NaN garbage (pages past the
    # history, tokens outside every row) would still poison the sum
    v_all = torch.where((kv_seg > 0)[..., None, None], v_all,
                        torch.zeros_like(v_all))
    if cold_k is None:
        out = mha_reference(
            q[None], k_all, v_all, causal=True, q_positions=q_pos[None],
            kv_positions=kv_pos, q_segment_ids=seg_fresh[None],
            kv_segment_ids=kv_seg, scale=scale,
        )
        return out[0]
    cm, cl, cacc = _cold_chunk_stats(
        q, row, cold_k[layer], cold_v[layer], cold_row.long(),
        cold_len.long(), scale=scale,
        k_scale=None if cold_k_scale is None else cold_k_scale[layer],
        v_scale=None if cold_v_scale is None else cold_v_scale[layer],
    )
    kf = k_all[0].float().repeat_interleave(H // KVH, dim=1)
    vf = v_all[0].float().repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), kf) * scale
    mask = (q_pos[:, None] >= kv_pos) & (seg_fresh[:, None] == kv_seg)
    s = torch.where(mask[None], s, torch.full_like(s, DEFAULT_MASK_VALUE))
    hm = s.amax(dim=-1, keepdim=True)
    hp = torch.exp(s - hm)
    m, l, acc = _merge_stats(cm, cl, cacc, hm, hp.sum(dim=-1, keepdim=True),
                             torch.einsum("hqk,khd->hqd", hp, vf))
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).transpose(0, 1).to(q.dtype)


def ragged_paged_attention(
    q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist, tables,
    *, scale: Optional[float] = None, k_scale=None, v_scale=None,
    span_lo=None, span_hi=None, cold_k=None, cold_v=None, cold_row=None,
    cold_len=None, cold_k_scale=None, cold_v_scale=None,
):
    """K1 wrapper.  ``layer`` is a Python int; ``t0``/``q_len``/``hist``
    ``[R]`` and ``tables [R, maxP]`` are int32 tensors on q's device;
    ``k_scale``/``v_scale`` come with int8 pools, and the tiered
    arguments (``span_lo``/``span_hi [R]``, ``cold_k``/``cold_v [L, nC,
    Ct, KVH, D]``, ``cold_row``/``cold_len [nC]``, with int8 pools
    ``cold_k_scale``/``cold_v_scale [L, nC, Ct, KVH]``) all together or
    not at all.  CUDA tensors launch the kernel (its cold form for tiered
    calls) on the current stream and raise on anything it does not take;
    CPU tensors run the plain version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("ragged_paged_attention: k_scale and v_scale "
                         "come together")
    cold = dict(zip(TIERED_ARGS, (span_lo, span_hi, cold_k, cold_v,
                                  cold_row, cold_len)))
    tiered = any(x is not None for x in cold.values())
    cold_scales = (cold_k_scale, cold_v_scale)
    if tiered and (
        any(x is None for x in cold.values())
        or any((x is None) != (k_scale is None) for x in cold_scales)
    ):
        raise ValueError(
            "ragged_paged_attention: the tiered arguments come together "
            "(span_lo, span_hi, cold_k, cold_v, cold_row, cold_len, and "
            "cold_k_scale / cold_v_scale with int8 pools)")
    if not tiered and any(x is not None for x in cold_scales):
        raise ValueError("ragged_paged_attention: cold scales without a "
                         "cold slab")
    if not q.is_cuda:
        return ragged_paged_attention_plain(
            q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist,
            tables, scale=scale, k_scale=k_scale, v_scale=v_scale,
            span_lo=span_lo, span_hi=span_hi, cold_k=cold_k, cold_v=cold_v,
            cold_row=cold_row, cold_len=cold_len, cold_k_scale=cold_k_scale,
            cold_v_scale=cold_v_scale,
        )
    T, H, D = q.shape
    L, N, P, KVH, Dp = k_pages.shape
    R, maxP = tables.shape
    if (
        k_new.shape != (T, KVH, D) or v_new.shape != k_new.shape
        or v_pages.shape != k_pages.shape or Dp != D or H % KVH
        or t0.shape != (R,) or q_len.shape != (R,) or hist.shape != (R,)
    ):
        raise ValueError(
            "ragged_paged_attention: inconsistent shapes "
            f"q{tuple(q.shape)} k_new{tuple(k_new.shape)} "
            f"pool{tuple(k_pages.shape)} tables{tuple(tables.shape)}"
        )
    dt = q.dtype
    quantized = k_scale is not None
    pool_dt = torch.int8 if quantized else dt
    if dt not in _KERNEL_DTYPES or any(
        x.dtype != dt for x in (k_new, v_new)
    ) or any(x.dtype != pool_dt for x in (k_pages, v_pages)):
        raise TypeError(
            "ragged_paged_attention kernel takes float32 or bfloat16 "
            "queries and fresh K/V, with pools of that dtype or int8 pools "
            "with their scale pools"
        )
    if quantized and (
        k_scale.shape != (L, N, P, KVH) or v_scale.shape != k_scale.shape
        or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
    ):
        raise ValueError(
            "ragged_paged_attention: scale pools must be float32 "
            f"[L, N, P, KVH] = {(L, N, P, KVH)}, got "
            f"{tuple(k_scale.shape)} {k_scale.dtype} / "
            f"{tuple(v_scale.shape)} {v_scale.dtype}"
        )
    if any(x.dtype != torch.int32 for x in (t0, q_len, hist, tables)):
        raise TypeError("ragged_paged_attention: row metadata must be int32")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"ragged_paged_attention: head_dim {D} unsupported")
    if not 0 <= int(layer) < L:
        raise ValueError(f"ragged_paged_attention: layer {layer} not in [0, {L})")
    tensors = (q, k_new, v_new, k_pages, v_pages, t0, q_len, hist, tables)
    if quantized:
        tensors += (k_scale, v_scale)
    if tiered:
        _check_cold(cold, cold_scales, quantized, pool_dt, R, L, KVH, D)
        tensors += tuple(cold.values())
        if quantized:
            tensors += cold_scales
    if any(not x.is_cuda or x.device != q.device for x in tensors):
        raise ValueError("ragged_paged_attention: all tensors on one CUDA device")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("ragged_paged_attention: tensors must be contiguous")
    out = torch.empty_like(q)
    pps, n_splits = _k1_split(maxP, P)
    sc = float(scale if scale is not None else 1.0 / math.sqrt(D))
    # the C launcher sets its shared-memory limit on, and sizes its
    # grid for, the current device: make q's card current
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tiered:
            return _launch_cold(q, k_new, v_new, k_pages, v_pages,
                                k_scale, v_scale, t0, q_len, hist, tables,
                                cold, cold_scales, out, int(layer), pps,
                                n_splits, sc, stream)
        part_ml = torch.empty((n_splits + 1, T, H, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((n_splits + 1, T, H, D), dtype=torch.float32,
                               device=q.device)
        pools = [k_pages.data_ptr(), v_pages.data_ptr()]
        if quantized:
            form = K1_INT8
            fn = form.symbol("helix_ragged_paged_attention_int8",
                             _K1_INT8_ARGS)
            pools += [k_scale.data_ptr(), v_scale.data_ptr()]
        else:
            form = K1
            fn = form.symbol("helix_ragged_paged_attention", _K1_ARGS)
        err = fn(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), *pools,
            t0.data_ptr(), q_len.data_ptr(), hist.data_ptr(),
            tables.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), T, H, KVH, D, N, P, R, maxP, int(layer),
            pps, n_splits, sc,
            _KERNEL_DTYPES[dt], stream,
        )
        if err != 0:
            raise RuntimeError(
                f"{form.name} kernel launch failed: cuda error {err}"
            )
        form.launches += 1
        return out


def _check_cold(cold: dict, cold_scales: tuple, quantized: bool, pool_dt,
                R: int, L: int, KVH: int, D: int) -> None:
    """Shapes and dtypes of the tiered arguments the cold form takes."""
    ck = cold["cold_k"]
    if ck.dim() != 5:
        raise ValueError("ragged_paged_attention: cold_k must be [L, nC, "
                         f"Ct, KVH, D], got {tuple(ck.shape)}")
    nC, Ct = ck.shape[1], ck.shape[2]
    if (
        tuple(ck.shape) != (L, nC, Ct, KVH, D)
        or cold["cold_v"].shape != ck.shape
        or any(cold[k].shape != (R,) for k in ("span_lo", "span_hi"))
        or any(cold[k].shape != (nC,) for k in ("cold_row", "cold_len"))
        or nC < 1 or Ct < 1
    ):
        raise ValueError(
            "ragged_paged_attention: inconsistent tiered shapes "
            + str({k: tuple(v.shape) for k, v in cold.items()}))
    if any(cold[k].dtype != torch.int32
           for k in ("span_lo", "span_hi", "cold_row", "cold_len")):
        raise TypeError("ragged_paged_attention: tiered row metadata must "
                        "be int32")
    if ck.dtype != pool_dt or cold["cold_v"].dtype != pool_dt:
        raise TypeError("ragged_paged_attention: the cold slab has the "
                        "pool's dtype")
    if quantized and any(
        x.shape != (L, nC, Ct, KVH) or x.dtype != torch.float32
        for x in cold_scales
    ):
        raise ValueError("ragged_paged_attention: cold scales must be "
                         f"float32 [L, nC, Ct, KVH] = {(L, nC, Ct, KVH)}")


def _launch_cold(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, t0,
                 q_len, hist, tables, cold: dict, cold_scales: tuple, out,
                 layer: int, pps: int, n_splits: int, scale: float,
                 stream) -> torch.Tensor:
    """Launch K1's cold form (checked by the caller): the tensor-core form
    for bf16 queries, else the CUDA-core form's scratch for the history,
    fresh and cold parts, then the entry point of the pool's type."""
    T, H, D = q.shape
    _, N, P, KVH, _ = k_pages.shape
    R, maxP = tables.shape
    nC, Ct = cold["cold_k"].shape[1:3]
    if q.dtype == torch.bfloat16:
        return _launch_cold_bf16(q, k_new, v_new, k_pages, v_pages, k_scale,
                                 v_scale, t0, q_len, hist, tables, cold,
                                 cold_scales, out, layer, scale, stream)
    n_cold = _k1_cold_parts(nC, maxP, P)
    parts = n_splits + 1 + n_cold
    part_ml = torch.empty((parts, T, H, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((parts, T, H, D), dtype=torch.float32,
                           device=q.device)
    ptr = {k: v.data_ptr() for k, v in cold.items()}
    head = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr()]
    rows = [t0.data_ptr(), q_len.data_ptr(), hist.data_ptr(),
            tables.data_ptr(), ptr["span_lo"], ptr["span_hi"],
            ptr["cold_k"], ptr["cold_v"]]
    if k_scale is not None:
        form = K1_INT8_COLD
        fn = K1.symbol("helix_ragged_paged_attention_int8_cold",
                       _K1_INT8_COLD_ARGS)
        args = (head + [k_scale.data_ptr(), v_scale.data_ptr()] + rows
                + [x.data_ptr() for x in cold_scales])
    else:
        form = K1_COLD
        fn = K1.symbol("helix_ragged_paged_attention_cold", _K1_COLD_ARGS)
        args = head + rows
    err = fn(
        *args, ptr["cold_row"], ptr["cold_len"], out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), T, H, KVH, D, N, P, R,
        maxP, layer, pps, n_splits, nC, Ct, n_cold, scale,
        _KERNEL_DTYPES[q.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{form.name} kernel launch failed: cuda error {err}"
        )
    form.launches += 1
    return out


def _launch_cold_bf16(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale,
                      t0, q_len, hist, tables, cold: dict, cold_scales: tuple,
                      out, layer: int, scale: float, stream) -> torch.Tensor:
    """Launch the tensor-core cold form: ``_k1_cold_slots`` slots of
    (m, l, acc) per (token, head) and the pre-pass's int32 work list
    (items, per-row counts, owned chunks, the unit counter) as scratch."""
    T, H, D = q.shape
    _, N, P, KVH, _ = k_pages.shape
    R, maxP = tables.shape
    nC, Ct = cold["cold_k"].shape[1:3]
    K = _k1_cold_slots(maxP, P)
    part_ml = torch.empty((K, T, H, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((K, T, H, D), dtype=torch.float32,
                           device=q.device)
    work = torch.empty((4 * R * K + R + R * nC + 1,), dtype=torch.int32,
                       device=q.device)
    ptr = {k: v.data_ptr() for k, v in cold.items()}
    head = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr()]
    rows = [t0.data_ptr(), q_len.data_ptr(), hist.data_ptr(),
            tables.data_ptr(), ptr["span_lo"], ptr["span_hi"],
            ptr["cold_k"], ptr["cold_v"]]
    if k_scale is not None:
        form = K1_INT8_COLD
        fn = form.symbol("helix_ragged_paged_attention_int8_cold_bf16",
                         _K1C_INT8_ARGS)
        args = (head + [k_scale.data_ptr(), v_scale.data_ptr()] + rows
                + [x.data_ptr() for x in cold_scales])
    else:
        form = K1_COLD
        fn = form.symbol("helix_ragged_paged_attention_cold_bf16",
                         _K1C_BF16_ARGS)
        args = head + rows
    err = fn(
        *args, ptr["cold_row"], ptr["cold_len"], out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), work.data_ptr(), T, H, KVH,
        D, N, P, R, maxP, layer, nC, Ct, K, SPAN_TOKENS, scale, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{form.name} kernel launch failed: cuda error {err}"
        )
    form.launches += 1
    return out
