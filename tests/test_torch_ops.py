"""Op-level parity of the PyTorch port against the JAX reference.

Inputs are made from a seed with numpy and fed to both sides; JAX runs on
the CPU and its Pallas kernels in interpret mode, as the reference's own
tests run them.  Tolerance: float32, ``atol=1e-5`` unless a test says
otherwise.  Attention kernels are compared on live tokens only: a fully
masked row (padding, or a token outside every ragged row) is unspecified
by contract and differs between the reference functions themselves.

The hand-written kernels themselves run only on the card:
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import kv_cache as jkv
from helix_tpu.ops import attention as jatt
from helix_tpu.ops import norms as jnorms
from helix_tpu.ops import paged as jpaged
from helix_tpu.ops import quant as jquant
from helix_tpu.ops import rope as jrope
from helix_tpu.ops.paged_kernel import ragged_paged_attention_tpu
from helix_tpu_torch.engine import kv_cache as tkv
from helix_tpu_torch.ops import attention as tatt
from helix_tpu_torch.ops import norms as tnorms
from helix_tpu_torch.ops import paged as tpaged
from helix_tpu_torch.ops import paged_kernel as tpk
from helix_tpu_torch.ops import quant as tquant
from helix_tpu_torch.ops import rope as trope

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol
    )


# ---------------------------------------------------------------------------
# norms, rope, dense, embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(tnorms.rms_norm(_t(x), _t(w), 1e-5, offset),
           jnorms.rms_norm(x, w, 1e-5, offset))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    w, b = rng.standard_normal((2, 24)).astype(np.float32)
    _close(tnorms.layer_norm(_t(x), _t(w), _t(b)), jnorms.layer_norm(x, w, b))


@pytest.mark.parametrize("scaling", [None, (
    ("factor", 8.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
    ("original_max_position_embeddings", 8192), ("rope_type", "llama3"),
)])
def test_rope_frequencies_exact(scaling):
    np.testing.assert_array_equal(
        trope.rope_frequencies(128, 500000.0, scaling),
        jrope.rope_frequencies(128, 500000.0, scaling),
    )


def test_apply_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    inv = jrope.rope_frequencies(16, 10000.0)
    _close(trope.apply_rope(_t(x), _t(pos), _t(inv)),
           jrope.apply_rope(x, pos, inv))


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"weight": rng.standard_normal((32, 48)).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal((48,)).astype(np.float32)
    want = jquant.maybe_dequant_dense(jnp.asarray(x), p)
    got = tquant.maybe_dequant_dense(_t(x), {k: _t(v) for k, v in p.items()})
    _close(got, want)


def test_dense_refuses_int8_and_lora():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="A13"):
        tquant.maybe_dequant_dense(
            x, {"weight": torch.zeros(4, 4, dtype=torch.int8)}
        )
    with pytest.raises(NotImplementedError, match="A13"):
        tquant.maybe_dequant_dense(
            x, {"weight": torch.zeros(4, 4), "lora_a": torch.zeros(4, 2)}
        )


def test_embed_lookup():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    got = tquant.embed_lookup({"weight": _t(w)}, _t(tok).long(), torch.float32)
    _close(got, jquant.embed_lookup({"weight": w}, tok, jnp.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _packed_case(seed, B=2, S=16, H=4, KVH=2, D=16):
    """Packed prompts: per batch row, segments of random lengths with
    positions restarting at 0 per segment, trailing padding (segment 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    pos = np.zeros((B, S), np.int32)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        t, s_id = 0, 1
        while t < S - 2:
            n = int(rng.integers(1, 7))
            n = min(n, S - 2 - t)
            pos[b, t:t + n] = np.arange(n)
            seg[b, t:t + n] = s_id
            t += n
            s_id += 1
    return q, k, v, pos, seg


@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_mha_reference(soft_cap):
    q, k, v, pos, seg = _packed_case(5)
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg, logits_soft_cap=soft_cap)
    want = jatt.mha_reference(q, k, v, **kw)
    got = tatt.mha_reference(
        _t(q), _t(k), _t(v),
        **{n: (_t(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()},
    )
    _close(got, want)


@pytest.mark.parametrize("seed", [6, 7])
def test_flash_attention_plain_matches_pallas_and_reference(seed):
    """Live tokens (segment > 0) only: padding rows are fully masked."""
    q, k, v, pos, seg = _packed_case(seed)
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg)
    pallas = jatt.flash_attention(q, k, v, **kw, block_q=8, block_kv=8,
                                  interpret=True)
    ref = jatt.mha_reference(q, k, v, **kw)
    tkw = {n: _t(a) for n, a in kw.items()}
    plain = tatt.flash_attention_plain(_t(q), _t(k), _t(v), **tkw)
    wrapped = tatt.flash_attention(_t(q), _t(k), _t(v), **tkw)
    live = seg > 0
    for got in (plain, wrapped):
        _close(np.asarray(got)[live], np.asarray(pallas)[live])
        _close(np.asarray(got)[live], np.asarray(ref)[live])


def test_attention_dispatcher_backends():
    q, k, v, pos, seg = _packed_case(8)
    kw = dict(q_positions=_t(pos), kv_positions=_t(pos))
    a = tatt.attention(_t(q), _t(k), _t(v), **kw)
    b = tatt.attention(_t(q), _t(k), _t(v), backend="reference", **kw)
    torch.testing.assert_close(a, b)
    for bad in ("pallas", "plain", "kernel"):
        with pytest.raises(ValueError):
            tatt.attention(_t(q), _t(k), _t(v), backend=bad, **kw)


# ---------------------------------------------------------------------------
# ragged paged attention
# ---------------------------------------------------------------------------


def _ragged_case(seed, L=2, N=24, P=4, KVH=2, D=16, H=4, maxP=4, R=5):
    """The random ragged layouts of tests/test_ragged_kernel.py: parked
    rows (q_len 0), decode rows, multi-token rows, rows starting at
    unaligned offsets, shuffled page tables."""
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    v_pages = (k_pages * 0.5 - 0.25).astype(np.float32)
    q_len = rng.integers(0, 6, size=R).astype(np.int32)
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    T = max(int(q_len.sum()), 1)
    hist = rng.integers(0, maxP * P - 8, size=R).astype(np.int32)
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    tables = tables.astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    layer = seed % L
    return (q, k_new, v_new, k_pages, v_pages, layer, t0, q_len, hist,
            tables)


def _live(t0, q_len):
    return np.concatenate(
        [np.arange(s, s + n) for s, n in zip(t0, q_len)] + [np.zeros(0, int)]
    ).astype(int)


@pytest.mark.parametrize("seed", [3, 4, 11, 12])
def test_ragged_plain_matches_jax_reference_and_pallas(seed):
    case = _ragged_case(seed)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist, tables = case
    jargs = (q, k_new, v_new, kp, vp, jnp.int32(layer), jnp.asarray(t0),
             jnp.asarray(q_len), jnp.asarray(hist), jnp.asarray(tables))
    ref = np.asarray(jpaged.ragged_paged_attention_reference(*jargs))
    pallas = np.asarray(ragged_paged_attention_tpu(*jargs, interpret=True))
    targs = (_t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
             _t(q_len), _t(hist), _t(tables))
    live = _live(t0, q_len)
    for got in (
        tpk.ragged_paged_attention_plain(*targs),
        tpk.ragged_paged_attention(*targs),
        tpaged.ragged_paged_attention(*targs),
        tpaged.ragged_paged_attention_reference(*targs),
    ):
        _close(np.asarray(got)[live], ref[live])
        _close(np.asarray(got)[live], pallas[live])


def test_ragged_nan_garbage_does_not_leak():
    """Pages past a row's history and tokens outside every row may hold
    NaN; live outputs must stay finite (the K1 trap the kernel zeroes V
    for)."""
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist, tables = _ragged_case(3)
    kp, vp = kp.copy(), vp.copy()
    kp[:, 0] = np.nan
    vp[:, 0] = np.nan
    tables = tables.copy()
    for r in range(len(hist)):
        used = -(-int(hist[r]) // kp.shape[2])
        tables[r, used:] = 0          # unused table slots: NaN garbage page
    got = tpk.ragged_paged_attention(
        _t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
        _t(q_len), _t(hist), _t(tables),
    )
    assert torch.isfinite(got[_t(_live(t0, q_len))]).all()


def test_paged_decode_reference():
    rng = np.random.default_rng(9)
    N, P, KVH, D, H, B, maxP = 12, 4, 2, 16, 4, 3, 3
    kp = rng.standard_normal((N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((N, P, KVH, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[: B * maxP].reshape(B, maxP)
    tables = tables.astype(np.int32)
    lengths = np.array([0, 5, 11], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    want = jpaged.paged_decode_attention_reference(
        q, kp, vp, tables, lengths, kn, vn
    )
    got = tpaged.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths), _t(kn), _t(vn)
    )
    _close(got, want)


def test_ragged_refuses_tiered_and_int8():
    args = _ragged_case(3)
    targs = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)
    with pytest.raises(NotImplementedError, match="A14"):
        tpaged.ragged_paged_attention(*targs, span_lo=targs[8])
    with pytest.raises(NotImplementedError, match="A9"):
        tpaged.ragged_paged_attention(*targs, k_scale=targs[3])


# ---------------------------------------------------------------------------
# KV writes
# ---------------------------------------------------------------------------


def test_slot_to_page_offset():
    rng = np.random.default_rng(10)
    table = rng.permutation(np.arange(1, 40))[:24].reshape(3, 8)
    table = table.astype(np.int32)
    slots = rng.integers(0, 32, size=(3, 5)).astype(np.int32)
    jp, jo = jkv.slot_to_page_offset(slots, table, 4)
    tp, to = tkv.slot_to_page_offset(_t(slots), _t(table), 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_write_kv_matches_jax_outside_garbage_page():
    rng = np.random.default_rng(11)
    L, N, P, KVH, D, B, S = 2, 10, 4, 2, 8, 2, 6
    kp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    kn = rng.standard_normal((L, B, S, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((L, B, S, KVH, D)).astype(np.float32)
    # distinct (page, offset) destinations per live token
    pages = np.stack([np.arange(1, 1 + S), np.arange(N - S, N)]).astype(
        np.int32)
    offsets = rng.integers(0, P, size=(B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 3:] = False                      # padding -> garbage page 0
    want = jkv.write_kv(
        jkv.PagedKVCache(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp)),
        kn, vn, pages, offsets, valid,
    )
    cache = tkv.PagedKVCache(k_pages=_t(kp.copy()), v_pages=_t(vp.copy()))
    got = tkv.write_kv(cache, _t(kn), _t(vn), _t(pages), _t(offsets),
                       _t(valid))
    assert got.k_pages is cache.k_pages      # written in place
    for g, w in ((got.k_pages, want.k_pages), (got.v_pages, want.v_pages)):
        np.testing.assert_array_equal(g.numpy()[:, 1:],
                                      np.asarray(w)[:, 1:])
