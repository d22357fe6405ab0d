"""K1's cold form on the tensor cores
(``csrc/ragged_paged_attention_cold.cu``), on the CPU: its work list and
its numerics.

- ``k1_cold_worklist``, the plain version of the kernel's pre-pass (the
  card tests hold the device's list to it): on random layouts and on
  edge layouts (a span from key 0 that leaves only the hot tail, chunks
  with ``cold_len`` 0 or past ``Ct``, rows that own no chunk, padding
  chunks, spans past the history, a row that would outgrow its slots),
  every live key of every row is attended exactly once -- the hot keys
  outside ``[span_lo, span_hi)`` below ``hist``, each owned chunk up to
  ``cold_len`` -- and no padding chunk; the order is fixed (slot 0 the
  fresh part, hot pieces ascending, cold parts ascending).
- An emulation of the kernel's arithmetic (bf16 operands, f32 products
  and sums, the online softmax per warp over 16 keys of each 64-key
  stage, P split into ``bf16(P)`` and ``bf16(P - bf16(P))``, int8 codes
  with the K scale on the score and the V scale folded into P, the warps
  and the slots merged in f32, one rounding) on phase 3d's layout of
  ``chip_smoke.py`` at narrow heads and full-length histories (6000-8000
  keys), held to ``ragged_paged_attention_plain`` under K1's one-ulp
  limit (``1e-5 + 2**-7 |plain|`` per element); the same with P rounded
  to bf16 once, as FA2 does, breaks that limit, which is why the kernel
  splits P.
- The emulation against the JAX package's
  ``ragged_paged_attention_reference`` on a small tiered case.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.ops import paged as jpaged
from helix_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from helix_tpu_torch.ops.paged_kernel import (
    COLD_CHUNKS,
    COLD_FRESH,
    COLD_HOT,
    SPAN_TOKENS,
    _k1_cold_slots,
    k1_cold_worklist,
    ragged_paged_attention_plain,
)
from helix_tpu_torch.ops.quant import quantize_kv

ATOL, RTOL = 1e-5, 2.0 ** -7     # K1's one-ulp limit
KEYS, WARPS = 64, 4              # keys per stage, warps per block


# ---------------------------------------------------------------------------
# the work list
# ---------------------------------------------------------------------------


def _check_worklist(hist, span_lo, span_hi, cold_row, cold_len, maxP, P, Ct):
    """Every live key of every row once, in the fixed order."""
    rows = k1_cold_worklist(hist, span_lo, span_hi, cold_row, cold_len,
                            maxP, P, Ct)
    K = _k1_cold_slots(maxP, P)
    tok = np.arange(maxP * P)
    for r, (items, owned) in enumerate(rows):
        assert 1 <= len(items) <= K
        assert items[0] == (COLD_FRESH, 0, 0)
        assert all(kind != COLD_FRESH for kind, _a, _b in items[1:])
        kinds = [kind for kind, _a, _b in items]
        assert kinds == sorted(kinds)             # fresh, hot, then cold
        # hot: the plain version's resident mask, each key once
        want = (tok < hist[r]) & ~((tok >= span_lo[r]) & (tok < span_hi[r]))
        seen = np.zeros(maxP * P, int)
        hot = [(a, b) for kind, a, b in items if kind == COLD_HOT]
        for a, b in hot:
            assert 0 < b - a <= SPAN_TOKENS
            seen[a:b] += 1
        np.testing.assert_array_equal(seen, want.astype(int))
        assert hot == sorted(hot)
        # cold: the row's chunks with keys, ascending, each once, in
        # contiguous parts; never a padding chunk or an empty one
        mine = [c for c in range(len(cold_row))
                if cold_row[c] == r and cold_len[c] > 0]
        assert owned == mine
        parts = [(a, b) for kind, a, b in items if kind == COLD_CHUNKS]
        flat = [c for a, b in parts for c in owned[a:b]]
        assert flat == mine
        assert all(b > a for a, b in parts)
    return rows


def _random_layout(rng):
    P = int(rng.choice([4, 16]))
    maxP = int(rng.integers(2, 80))
    Ct = int(rng.choice([P, 4 * P, 64]))
    R = int(rng.integers(1, 9))
    hist = rng.integers(0, maxP * P + 40, size=R)       # past the table too
    lo = rng.integers(-8, maxP * P, size=R)
    hi = lo + rng.integers(-20, maxP * P, size=R)       # empty spans too
    kind = rng.integers(0, 4, size=R)
    lo = np.where(kind == 0, 0, lo)                     # from key 0
    hi = np.where(kind == 1, lo, hi)                    # resident
    nC = int(rng.integers(1, 40))
    cold_row = rng.integers(-1, R, size=nC)             # padding chunks
    cold_len = rng.integers(0, Ct + 8, size=nC)         # 0 and past Ct
    return hist, lo, hi, cold_row, cold_len, maxP, P, Ct


@pytest.mark.parametrize("seed", range(12))
def test_worklist_attends_every_live_key_once(seed):
    _check_worklist(*_random_layout(np.random.default_rng(seed)))


def test_worklist_edge_layouts():
    """Row 0: a span from key 0 leaving only the hot tail; row 1: owns no
    chunk; row 2: resident; row 3: its span past its history; row 4: owns
    chunks of cold_len 0 only; chunk 7 pads (owner -1)."""
    P, maxP, Ct = 16, 32, 64
    hist = [500, 300, 200, 100, 90]
    span_lo = [0, 64, 0, 32, 16]
    span_hi = [448, 128, 0, 400, 48]
    cold_row = [0, 0, 0, 0, 0, 0, 0, -1, 0, 3, 4, 4]
    cold_len = [64, 64, 64, 64, 64, 64, 64, 64, 0, 64, 0, 0]
    rows = _check_worklist(hist, span_lo, span_hi, cold_row, cold_len, maxP,
                           P, Ct)
    assert rows[0][0] == [(COLD_FRESH, 0, 0), (COLD_HOT, 448, 500),
                          (COLD_CHUNKS, 0, 7)]
    assert rows[0][1] == [0, 1, 2, 3, 4, 5, 6]
    assert rows[1][1] == [] and rows[4][1] == []
    assert [k for k, _a, _b in rows[2][0]] == [COLD_FRESH, COLD_HOT]
    assert rows[3][0][1:] == [(COLD_HOT, 0, 32), (COLD_CHUNKS, 0, 1)]
    # the same layout gives the same list
    assert rows == k1_cold_worklist(hist, span_lo, span_hi, cold_row,
                                    cold_len, maxP, P, Ct)


def test_worklist_row_outgrowing_its_slots():
    """A row owning far more chunks than its table holds keys still fits
    its slots: its parts grow instead."""
    maxP, P, Ct = 4, 4, 8
    K = _k1_cold_slots(maxP, P)
    rows = _check_worklist([16], [4], [12], [0] * 300, [8] * 300, maxP, P,
                           Ct)
    items = rows[0][0]
    assert len(items) == K
    assert sum(b - a for k, a, b in items if k == COLD_CHUNKS) == 300


# ---------------------------------------------------------------------------
# the numerics
# ---------------------------------------------------------------------------


def _emulate_item(qt, keys, vals, live, ks, vs, sl2, causal, split):
    """One unit's (m, l, acc) [ntok, H] as the kernel forms them: keys in
    64-key stages, warp w taking keys [16 w, 16 w + 16) of each with its
    own running max; P = exp2(x - m) (x V-scaled for int8) as one or two
    bf16 terms against bf16 V; the warps merged in f32.  ``causal``: the
    fresh part's limit per token, else None."""
    ntok, H, D = qt.shape
    n = keys.shape[0]
    group = H // keys.shape[1]
    pad = -n % KEYS
    nst = (n + pad) // KEYS

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    keys, vals = padded(keys), padded(vals)
    live = torch.cat([live, live.new_zeros(pad)])
    ks, vs = padded(ks), padded(vs)
    kh = keys.repeat_interleave(group, 1)                 # [n, H, D]
    vh = vals.repeat_interleave(group, 1)
    s = torch.einsum("thd,nhd->thn", qt, kh)
    s = s * ks.repeat_interleave(group, 1).T[None] * sl2
    ok = live[None, None, :].expand(ntok, 1, -1)
    if causal is not None:
        ok = ok & (torch.arange(n + pad)[None, None, :]
                   <= causal[:, None, None])
    x = torch.where(ok, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    x = x.reshape(ntok, H, nst, WARPS, 16)
    m_run = torch.cummax(x.amax(-1), dim=2).values        # [t, H, s, w]
    p = torch.exp2(x - m_run[..., None])
    l_st = p.sum(-1)
    p = p * vs.repeat_interleave(group, 1).T.reshape(H, nst, WARPS, 16)
    hi = p.bfloat16().float()
    terms = [hi, (p - hi).bfloat16().float()] if split else [hi]
    vr = vh.reshape(nst, WARPS, 16, H, D)
    contrib = sum(torch.einsum("thswk,swkhd->thswd", t, vr) for t in terms)
    m_w = m_run[:, :, -1]                                  # [t, H, w]
    resc = torch.exp2(m_run - m_w[:, :, None])
    acc_w = (contrib * resc[..., None]).sum(2)
    l_w = (l_st * resc).sum(2)
    m = m_w.amax(-1)
    wt = torch.exp2(m_w - m[..., None])
    return m, (l_w * wt).sum(-1), (acc_w * wt[..., None]).sum(2)


def emulate_cold(q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist,
                 tables, *, span_lo, span_hi, cold_k, cold_v, cold_row,
                 cold_len, k_scale=None, v_scale=None, cold_k_scale=None,
                 cold_v_scale=None, split=True):
    """The bf16 cold form's output, computed as the kernel computes it:
    the pre-pass's items per row (``k1_cold_worklist``), each attended by
    ``_emulate_item`` for every query tile, a row's slots merged in f32 in
    list order and rounded once."""
    T, H, D = q.shape
    _, N, P, KVH, _ = k_pages.shape
    R, maxP = tables.shape
    Ct = cold_k.shape[2]
    group = H // KVH
    qb = 1 if group >= 32 else 32 // group
    sl2 = math.log2(math.e) / math.sqrt(D)
    quant = k_scale is not None
    as_np = [np.asarray(x) for x in (hist, span_lo, span_hi, cold_row,
                                     cold_len)]
    work = k1_cold_worklist(*as_np, maxP, P, Ct)
    ones = torch.ones(1, KVH)
    out = torch.zeros((T, H, D))
    for r in range(R):
        items, owned = work[r]
        base, n = int(t0[r]), int(q_len[r])
        for tok0 in range(0, n, qb):
            ntok = min(qb, n - tok0)
            qt = q[base + tok0:base + tok0 + ntok].float()
            stats = []
            for kind, a, b in items:
                causal = None
                if kind == COLD_FRESH:
                    kend = tok0 + ntok
                    keys = k_new[base:base + kend].float()
                    vals = v_new[base:base + kend].float()
                    live = torch.ones(kend, dtype=torch.bool)
                    ks = vs = ones.expand(kend, KVH)
                    causal = torch.arange(tok0, tok0 + ntok)
                else:
                    if kind == COLD_HOT:
                        pages = tables[r, a // P:(b - 1) // P + 1].long()
                        kp = k_pages[layer][pages].reshape(-1, KVH, D)
                        vp = v_pages[layer][pages].reshape(-1, KVH, D)
                        pos = (a // P) * P + torch.arange(kp.shape[0])
                        live = (pos >= a) & (pos < b)
                        if quant:
                            ks = k_scale[layer][pages].reshape(-1, KVH)
                            vs = v_scale[layer][pages].reshape(-1, KVH)
                    else:
                        chunks = torch.tensor(owned[a:b])
                        kp = cold_k[layer][chunks].reshape(-1, KVH, D)
                        vp = cold_v[layer][chunks].reshape(-1, KVH, D)
                        off = torch.arange(Ct).repeat(len(chunks))
                        live = off < cold_len[chunks].repeat_interleave(Ct)
                        if quant:
                            ks = cold_k_scale[layer][chunks].reshape(-1, KVH)
                            vs = cold_v_scale[layer][chunks].reshape(-1, KVH)
                    keys = torch.where(live[:, None, None], kp.float(), 0.0)
                    vals = torch.where(live[:, None, None], vp.float(), 0.0)
                    if quant:
                        ks = torch.where(live[:, None], ks, 0.0)
                        vs = torch.where(live[:, None], vs, 0.0)
                    else:
                        ks = vs = ones.expand(len(live), KVH)
                stats.append(_emulate_item(qt, keys, vals, live, ks, vs, sl2,
                                           causal, split))
            m = torch.stack([s[0] for s in stats])        # [items, t, H]
            mx = m.amax(0)
            w = torch.exp2(m - mx)
            lsum = (torch.stack([s[1] for s in stats]) * w).sum(0)
            acc = (torch.stack([s[2] for s in stats]) * w[..., None]).sum(0)
            out[base + tok0:base + tok0 + ntok] = acc / lsum[..., None]
    return out.bfloat16()


def _ratio(got, want, live):
    got, want = got.float()[live], want.float()[live]
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


COLD_STREAM_PAGES = 4


@functools.lru_cache(maxsize=None)
def _phase3d_case(int8: bool):
    """``chip_smoke.py`` phase 3d's layout (4 decode and 4 verify rows of
    5 tiered at histories 6000-8000 with ~5000 demoted keys each in
    chunks of 4 pages, beside 8 resident decode rows at 1000-8000, a
    padding chunk) at narrow heads (H 4, KVH 1, D 32), bf16 or int8
    pools: (args, kwargs, the plain version rounded to bf16, live)."""
    rng = np.random.default_rng(14 if int8 else 13)
    P, maxP, N, H, KVH, D = 16, 512, 8192, 4, 1, 32
    q_lens = np.array([1] * 4 + [5] * 4 + [1] * 8, np.int32)
    hists = np.concatenate([rng.integers(6000, 8000, 8),
                            rng.integers(1000, 8000, 8)]).astype(np.int32)
    R, T = len(q_lens), int(q_lens.sum())
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    walked = -(-(hists + q_lens) // P)
    perm = rng.permutation(np.arange(1, N))
    full = np.zeros((R, maxP), np.int32)
    for r, (n, a) in enumerate(zip(walked, np.cumsum(walked) - walked)):
        full[r, :n] = perm[a:a + n]
    lo = np.zeros(R, np.int32)
    hi = np.zeros(R, np.int32)
    lo[:8] = rng.integers(8, 32, 8) * P
    hi[:8] = lo[:8] + (5000 // P) * P
    tiered = full.copy()
    owners, lens, pages = [], [], []
    for r in range(8):
        tiered[r, lo[r] // P:hi[r] // P] = 0
        for c0 in range(lo[r] // P, hi[r] // P, COLD_STREAM_PAGES):
            pg = list(full[r, c0:min(c0 + COLD_STREAM_PAGES, hi[r] // P)])
            owners.append(r)
            lens.append(len(pg) * P)
            pages.append(pg + [0] * (COLD_STREAM_PAGES - len(pg)))
    owners.append(-1)
    lens.append(COLD_STREAM_PAGES * P)
    pages.append(list(perm[-COLD_STREAM_PAGES:]))
    nC, Ct = len(owners), COLD_STREAM_PAGES * P
    idx = torch.from_numpy(np.asarray(pages, np.int64))
    g = torch.Generator().manual_seed(int(int8))
    kp = torch.randn((1, N, P, KVH, D), generator=g)
    vp = torch.randn((1, N, P, KVH, D), generator=g)
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()

    def slab(pool):
        out = pool[:, idx].reshape((1, nC, Ct) + tuple(pool.shape[3:]))
        for c, n in enumerate(lens):
            out[:, c, n:] = 0
        return out.contiguous()

    cold = dict(span_lo=torch.from_numpy(lo), span_hi=torch.from_numpy(hi),
                cold_k=slab(kp), cold_v=slab(vp),
                cold_row=torch.tensor(owners, dtype=torch.int32),
                cold_len=torch.tensor(lens, dtype=torch.int32))
    if int8:
        cold.update(cold_k_scale=slab(kw["k_scale"]),
                    cold_v_scale=slab(kw["v_scale"]))
    q, kn, vn = (torch.randn(s, generator=g).bfloat16()
                 for s in ((T, H, D), (T, KVH, D), (T, KVH, D)))
    meta = [torch.from_numpy(x) for x in (t0, q_lens, hists)]
    args = (q, kn, vn, kp, vp, 0, *meta, torch.from_numpy(tiered))
    # int8: the plain version evaluated in f32, rounded once (the card's
    # cold form, like the resident K1-int8, never rounds dequantized
    # history to bf16)
    want = ragged_paged_attention_plain(
        q.float(), kn.float(), vn.float(), *args[3:], **kw,
        **cold).bfloat16()
    live = torch.from_numpy(np.concatenate(
        [np.arange(s, s + n) for s, n in zip(t0, q_lens)]))
    return args, {**kw, **cold}, want, live


@functools.lru_cache(maxsize=None)
def _emulated_ratio(int8: bool, split: bool) -> float:
    args, kw, want, live = _phase3d_case(int8)
    return _ratio(emulate_cold(*args, **kw, split=split), want, live)


@pytest.mark.parametrize("int8", [False, True])
def test_emulation_within_one_ulp_at_full_histories(int8):
    """P split into two bf16 terms: within K1's limit on phase 3d's
    layout, at most a one-ulp difference after the rounding (0.91x of
    the limit with bf16 pools, 0.56x with int8, when written)."""
    assert _emulated_ratio(int8, True) <= 1.0


@pytest.mark.parametrize("int8", [False, True])
def test_single_bf16_rounding_of_p_breaks_the_limit(int8):
    """P rounded to bf16 once, as FA2 does: beyond K1's limit on the same
    layout (5.7x with bf16 pools, 12.1x with int8, when written) -- the
    kernel's second P term is needed, and the limit is not to be loosened
    for it."""
    assert _emulated_ratio(int8, False) > 1.0
    assert _emulated_ratio(int8, False) > 2 * _emulated_ratio(int8, True)


@pytest.mark.parametrize("int8", [False, True])
def test_emulation_sees_planted_faults(int8):
    """A chunk's owner moved to another row, or a span one page late, is
    another answer under the same limit."""
    args, kw, want, live = _phase3d_case(int8)
    moved = kw["cold_row"].clone()
    moved[0] = 1
    late = kw["span_lo"].clone()
    late[:8] += 16
    for bad in (dict(kw, cold_row=moved), dict(kw, span_lo=late)):
        assert _ratio(emulate_cold(*args, **bad), want, live) > 1.0


def test_emulation_matches_the_jax_reference():
    """A small tiered case (every row kind, chunks shorter than Ct, a
    parked row, a padding chunk) with bf16-exact values: the emulation
    against ``helix_tpu.ops.paged.ragged_paged_attention_reference``
    evaluated in float32, under the same limit."""
    rng = np.random.default_rng(5)
    L, N, P, KVH, D, H, maxP, Ct = 2, 160, 4, 2, 16, 8, 24, 8

    def bf(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float().numpy()

    kp, vp = bf((L, N, P, KVH, D)), bf((L, N, P, KVH, D))
    q_len = np.array([1, 3, 0, 1, 5, 2], np.int32)
    hist = np.array([70, 60, 20, 40, 90, 33], np.int32)
    R, T = len(q_len), int(q_len.sum())
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    tables = rng.permutation(np.arange(1, N))[:R * maxP].reshape(R, maxP)
    tables = tables.astype(np.int32)
    span_lo = np.array([8, 0, 0, 0, 0, 0], np.int32)
    span_hi = np.array([48, 40, 0, 0, 64, 0], np.int32)
    owners, lens, src = [], [], []
    for r in range(R):
        for a in range(span_lo[r], span_hi[r], Ct - 2):
            b = min(a + Ct - 2, span_hi[r])
            owners.append(r)
            lens.append(b - a)
            src.append((r, a, b))
    owners.append(-1)
    lens.append(Ct)
    nC = len(owners)
    ck, cv = bf((L, nC, Ct, KVH, D)), bf((L, nC, Ct, KVH, D))
    for c, (r, a, b) in enumerate(src):
        for j, tok in enumerate(range(a, b)):
            ck[:, c, j] = kp[:, tables[r, tok // P], tok % P]
            cv[:, c, j] = vp[:, tables[r, tok // P], tok % P]
    tiered = tables.copy()
    for r in range(R):
        tiered[r, span_lo[r] // P:span_hi[r] // P] = 0
    q, kn, vn = bf((T, H, D)), bf((T, KVH, D)), bf((T, KVH, D))
    cold = dict(span_lo=span_lo, span_hi=span_hi, cold_k=ck, cold_v=cv,
                cold_row=np.array(owners, np.int32),
                cold_len=np.array(lens, np.int32))
    layer = 1
    want = np.asarray(jpaged.ragged_paged_attention_reference(
        q, kn, vn, kp, vp, jnp.int32(layer), jnp.asarray(t0),
        jnp.asarray(q_len), jnp.asarray(hist), jnp.asarray(tiered),
        **{k: jnp.asarray(v) for k, v in cold.items()}))
    t = torch.from_numpy
    got = emulate_cold(
        t(q).bfloat16(), t(kn).bfloat16(), t(vn).bfloat16(), t(kp), t(vp),
        layer, t(t0), t(q_len), t(hist), t(tiered),
        **{k: t(v) for k, v in cold.items()})
    live = torch.from_numpy(np.concatenate(
        [np.arange(s, s + n) for s, n in zip(t0, q_len)]))
    assert _ratio(got, torch.from_numpy(want.copy()).bfloat16(), live) <= 1.0
