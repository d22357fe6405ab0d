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
from helix_tpu_torch.device import torch_dtype
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


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _from_jax(a):
    from helix_tpu_torch.models.llama import _to_tensor

    return _to_tensor(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["float", "float_bias", "int8",
                                  "int8_bias"])
def test_dense_rounds_once_like_reference(dtype, form):
    """Product in f32, int8 scale and bias in f32, one rounding: equal to
    the reference bit for bit in both dtypes (the bf16 GEMM of the card
    is held to the same form in ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(13)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((4, 7, 64)), jdt)
    w = jnp.asarray(rng.standard_normal((64, 96)) * 0.1, jdt)
    p = jquant.quantize_tensor(w) if form.startswith("int8") else {
        "weight": w}
    if form.endswith("bias"):
        p["bias"] = jnp.asarray(rng.standard_normal((96,)), jdt)
    want = np.asarray(jquant.maybe_dequant_dense(x, p).astype(jnp.float32))
    got = tquant.maybe_dequant_dense(
        _from_jax(x), {k: _from_jax(v) for k, v in p.items()})
    assert got.dtype == torch_dtype(dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dense_refuses_int8_and_lora():
    """LoRA forms (single graft and the pool, over float or int8 weights)
    are served: each adds its delta in float32 before the one rounding
    (``tests/test_torch_adapters.py`` holds them to the reference)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    w8 = {"weight": torch.from_numpy(
              rng.integers(-127, 128, (4, 4)).astype(np.int8)),
          "scale": torch.full((1, 4), 0.01)}
    wf = {"weight": torch.from_numpy(
        rng.standard_normal((4, 4)).astype(np.float32))}
    a = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    for p in (w8, wf):
        base = tquant.maybe_dequant_dense(x, p)
        got = tquant.maybe_dequant_dense(
            x, {**p, "lora_a": a, "lora_b": b, "lora_scale": 0.5})
        torch.testing.assert_close(got, base + 0.5 * (x @ a) @ b,
                                   rtol=0, atol=1e-6)
        pool = {**p, "lora_pool_a": torch.stack(
                    [torch.zeros_like(a), a], dim=1),   # [in, N, r]
                "lora_pool_b": torch.stack([torch.zeros_like(b), b]),
                "lora_pool_scale": torch.tensor([0.0, 0.5])}
        got = tquant.maybe_dequant_dense(
            x, pool, adapter_ids=torch.tensor([0, 1]))
        torch.testing.assert_close(got[0], base[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], (base + 0.5 * (x @ a) @ b)[1],
                                   rtol=0, atol=1e-6)


def test_embed_lookup():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    got = tquant.embed_lookup({"weight": _t(w)}, _t(tok).long(), torch.float32)
    _close(got, jquant.embed_lookup({"weight": w}, tok, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_row_quantized(dtype):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    jp = jquant.quantize_params({"embed": {"weight": jnp.asarray(w)}})
    tp = tquant.quantize_params({"embed": {"weight": _t(w)}})
    tok = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    want = jquant.embed_lookup(jp["embed"], tok, jnp.dtype(dtype))
    got = tquant.embed_lookup(tp["embed"], _t(tok).long(), torch_dtype(dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# int8 codecs
# ---------------------------------------------------------------------------


def test_quantize_kv_matches_jax():
    """Codes and scales equal to JAX's for the same f32 input (both
    divide in f32 and round half to even): no last-bit allowance is
    needed on this input, all-zero slots (scale at KV_SCALE_EPS) and
    values of widely different magnitudes included."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3000, 4, 16)).astype(np.float32)
    x *= rng.random((3000, 4, 1)).astype(np.float32) * 5
    x[0] = 0.0
    x[1, 0] = 1e-12
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = tquant.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tquant.KV_SCALE_EPS == jquant.KV_SCALE_EPS
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_kv(tq, ts).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("over", [{}, {"tie_word_embeddings": True},
                                  {"attention_bias": True, "qk_norm": True}],
                         ids=["untied", "tied", "bias_qknorm"])
def test_quantize_params_matches_jax(dtype, over):
    """Same tree, same int8 codes and f32 scales: per output channel for
    the [L, in, out] stacks (reduced over the input axis only), per row
    for the embedding, norms and biases untouched."""
    import jax

    from helix_tpu.models import llama as jllama
    from helix_tpu.models.common import ModelConfig as JModelConfig
    from helix_tpu_torch.models.llama import params_from_jax

    jcfg = JModelConfig.tiny(dtype=dtype, **over)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    want = jax.device_get(jquant.quantize_params(jp))
    got = tquant.quantize_params(params_from_jax(jax.device_get(jp)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        ref = _from_jax(leaf)
        assert t.dtype == ref.dtype and t.shape == ref.shape, path
        assert torch.equal(t, ref), path
    assert got["layers"]["wq"]["scale"].shape == (
        jcfg.num_layers, 1, jcfg.num_heads * jcfg.head_dim)
    assert got["embed"]["embed_scale"].shape == (jcfg.vocab_size, 1)


def test_quantize_tensor_chunks_give_the_same_codes(monkeypatch):
    """Quantizing in column blocks (how a full-width stack is quantized
    without an f32 copy of it) gives the codes and scales of one pass."""
    rng = np.random.default_rng(8)
    w = _t(rng.standard_normal((3, 40, 24)).astype(np.float32))
    whole = tquant.quantize_tensor(w)
    monkeypatch.setattr(tquant, "_CHUNK_ELEMS", 40 * 5)
    blocks = tquant.quantize_tensor(w)
    for k in ("weight", "scale"):
        assert torch.equal(whole[k], blocks[k])
    want = jquant.quantize_tensor(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(whole["weight"].numpy(),
                                  np.asarray(want["weight"]))
    np.testing.assert_array_equal(whole["scale"].numpy(),
                                  np.asarray(want["scale"]))


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


@pytest.mark.parametrize("D", [16, 64])
def test_flash_error_limit_admits_pallas_bf16_and_catches_a_wrong_key(D):
    """The Pallas kernel in bf16 rounds P to V's dtype before P.V, as K2's
    bf16 form does: its output stays within ``flash_error_limit`` of the
    port's plain version, while dropping each query's own key (row 0 of
    every segment then has no key at all) breaks that limit."""
    q, k, v, pos, seg = _packed_case(20 + D, B=1, S=128, H=4, KVH=2, D=D)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [_from_jax(a) for a in jb]
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg)
    tkw = {n: _t(a) for n, a in kw.items()}
    live = seg > 0
    want = tatt.flash_attention_plain(*tb, **tkw).float().numpy()[live]
    limit = tatt.flash_error_limit(*tb, **tkw).numpy()[live]

    def ratio(kv_positions):
        got = jatt.flash_attention(
            *jb, **{**kw, "kv_positions": kv_positions}, block_q=32,
            block_kv=32, interpret=True)
        got = np.asarray(got.astype(jnp.float32))[live]
        return float((np.abs(got - want) / limit).max())

    assert ratio(pos) <= 1.0
    assert ratio(pos + 1) > 1.0


def test_flash_error_limit_is_one_ulp_plus_p_rounding():
    q, k, v, pos, seg = _packed_case(9)
    args = [_t(a).bfloat16() for a in (q, k, v)]
    kw = dict(q_positions=_t(pos), kv_positions=_t(pos))
    plain = tatt.flash_attention_plain(*args, **kw).float()
    spread = tatt.flash_attention_plain(
        *[a.float() for a in args[:2]], args[2].float().abs(), **kw)
    limit = tatt.flash_error_limit(*args, **kw)
    assert limit.dtype == torch.float32 and limit.shape == plain.shape
    torch.testing.assert_close(
        limit, 1e-5 + 2.0 ** -7 * plain.abs() + 2.0 ** -8 * spread)
    assert bool((spread >= plain.abs() - 1e-2).all())


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


@pytest.mark.parametrize("P", [4, 16])
@pytest.mark.parametrize("maxP", [1, 7, 8, 31, 32, 33, 128, 129, 256, 1000])
def test_k1_split_covers_the_history_in_whole_pages(P, maxP):
    """K1's split, picked from shapes alone: spans of whole pages that tile
    [0, maxP * P) exactly, the last possibly shorter, none empty."""
    pps, n = tpk._k1_split(maxP, P)
    assert 1 <= pps <= maxP and n >= 1
    spans = [(s * pps * P, min((s + 1) * pps * P, maxP * P))
             for s in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == maxP * P
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c
    for a, b in spans:
        assert b > a and a % P == 0 and b % P == 0
    assert pps * P <= max(tpk.SPAN_TOKENS, P)


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
    _paged_decode_case(quantized=False)


def test_paged_decode_reference_int8():
    _paged_decode_case(quantized=True)


def _paged_decode_case(quantized):
    rng = np.random.default_rng(9)
    N, P, KVH, D, H, B, maxP = 12, 4, 2, 16, 4, 3, 3
    kp = rng.standard_normal((N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((N, P, KVH, D)).astype(np.float32)
    kw, tkw = {}, {}
    if quantized:
        (kp, ks), (vp, vs) = (
            [np.array(a) for a in jquant.quantize_kv(jnp.asarray(x))]
            for x in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
        tkw = {n: _t(a) for n, a in kw.items()}
    tables = rng.permutation(np.arange(1, N))[: B * maxP].reshape(B, maxP)
    tables = tables.astype(np.int32)
    lengths = np.array([0, 5, 11], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    want = jpaged.paged_decode_attention_reference(
        q, kp, vp, tables, lengths, kn, vn, **kw
    )
    got = tpaged.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths), _t(kn), _t(vn),
        **tkw
    )
    _close(got, want)


def test_ragged_refuses_tiered_and_int8():
    """Tiered arguments run (the span leaves the hot history, the cold
    chunks merge in) and match the reference's oracle; they come
    together; an int8 scale pool comes with its partner or not at all;
    unknown arguments raise."""
    args = _ragged_case(3)
    targs = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist, tables = args
    rng = np.random.default_rng(3)
    L, _, P, KVH, D = kp.shape
    R = len(hist)
    span_lo = (hist // 4).astype(np.int32)
    span_hi = (hist // 2).astype(np.int32)
    cold = dict(
        span_lo=span_lo, span_hi=span_hi,
        cold_k=rng.standard_normal((L, 3, 8, KVH, D)).astype(np.float32),
        cold_v=rng.standard_normal((L, 3, 8, KVH, D)).astype(np.float32),
        cold_row=np.array([0, -1, R - 1], np.int32),
        cold_len=np.array([8, 8, 5], np.int32))
    want = np.asarray(jpaged.ragged_paged_attention_reference(
        *args[:5], jnp.int32(layer), *args[6:],
        **{k: jnp.asarray(v) for k, v in cold.items()}))
    got = tpaged.ragged_paged_attention(
        *targs, **{k: _t(v) for k, v in cold.items()})
    live = _live(t0, q_len)
    _close(got.numpy()[live], want[live], atol=1e-6)
    with pytest.raises(ValueError, match="together"):
        tpaged.ragged_paged_attention(*targs, span_lo=targs[8])
    with pytest.raises(ValueError, match="together"):
        tpaged.ragged_paged_attention(*targs, k_scale=targs[3][..., 0])
    with pytest.raises(TypeError, match="unknown"):
        tpaged.ragged_paged_attention(*targs, k_scales=targs[3])


def _int8_case(seed, **kw):
    """A ragged case over int8 pools quantized by the reference."""
    case = list(_ragged_case(seed, **kw))
    kq, ks = jquant.quantize_kv(jnp.asarray(case[3]))
    vq, vs = jquant.quantize_kv(jnp.asarray(case[4]))
    case[3], case[4] = np.array(kq), np.array(vq)
    return case, np.array(ks), np.array(vs)


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_ragged_int8_plain_matches_jax_reference(seed):
    case, ks, vs = _int8_case(seed)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist, tables = case
    jargs = (q, k_new, v_new, kp, vp, jnp.int32(layer), jnp.asarray(t0),
             jnp.asarray(q_len), jnp.asarray(hist), jnp.asarray(tables))
    ref = np.asarray(jpaged.ragged_paged_attention_reference(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    targs = (_t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
             _t(q_len), _t(hist), _t(tables))
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    live = _live(t0, q_len)
    for got in (
        tpk.ragged_paged_attention_plain(*targs, **kw),
        tpk.ragged_paged_attention(*targs, **kw),
        tpaged.ragged_paged_attention(*targs, **kw),
        tpaged.ragged_paged_attention(*targs, backend="reference", **kw),
        tpaged.ragged_paged_attention_reference(*targs, **kw),
    ):
        _close(np.asarray(got)[live], ref[live])


def test_ragged_int8_plain_matches_pallas_interpret():
    """The quantized Pallas kernel in interpret mode (as
    ``tests/test_engine.py`` runs it) on a verify-width row plus a decode
    row, f32: in-register dequant of int8 pages equals the port's plain
    version."""
    rng = np.random.default_rng(21)
    KVH, H, D, P, L, N = 2, 4, 128, 4, 3, 16
    k_f = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k_f)))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k_f + 0.5)))
    T = 4
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    tables = np.array([[3, 5, 7, 0], [9, 2, 0, 0]], np.int32)
    t0 = np.array([0, 3], np.int32)
    q_len = np.array([3, 1], np.int32)       # verify row + decode row
    hist = np.array([11, 5], np.int32)
    pallas = ragged_paged_attention_tpu(
        q, k_new, v_new, kq, vq, jnp.int32(1), t0, q_len, hist, tables,
        interpret=True, k_scale=ks, v_scale=vs)
    got = tpk.ragged_paged_attention(
        _t(q), _t(k_new), _t(v_new), _t(kq), _t(vq), 1, _t(t0),
        _t(q_len), _t(hist), _t(tables), k_scale=_t(ks), v_scale=_t(vs))
    _close(got, pallas)


def test_ragged_int8_bf16_rounds_history_like_reference():
    """In bf16 the plain version casts the f32-dequantized history to bf16
    (the reference oracle's rounding point) before the softmax."""
    case, ks, vs = _int8_case(4)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist, tables = case
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k_new, v_new)]
    ref = jpaged.ragged_paged_attention_reference(
        *jb, kp, vp, jnp.int32(layer), jnp.asarray(t0), jnp.asarray(q_len),
        jnp.asarray(hist), jnp.asarray(tables), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = tpk.ragged_paged_attention_plain(
        *[_from_jax(a) for a in jb], _t(kp), _t(vp), layer, _t(t0),
        _t(q_len), _t(hist), _t(tables), k_scale=_t(ks), v_scale=_t(vs))
    live = _live(t0, q_len)
    # one bf16 ulp of the value (two libraries' f32 softmax sums)
    np.testing.assert_allclose(
        got.float().numpy()[live],
        np.asarray(ref.astype(jnp.float32))[live], rtol=2.0 ** -7,
        atol=1e-5)


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


def test_write_kv_int8_pools_byte_equal_to_jax():
    """Quantize on write: int8 codes and the f32 scale rows land at the
    same fused index as in the reference, byte for byte, outside the
    garbage page (padding writes race there)."""
    from helix_tpu.models.common import ModelConfig as JModelConfig
    from helix_tpu_torch.models.common import ModelConfig

    rng = np.random.default_rng(12)
    jcfg = JModelConfig.tiny(dtype="float32")
    cc = dict(num_pages=10, page_size=4, max_pages_per_seq=4, dtype="int8")
    jc = jkv.PagedKVCache.create(jcfg, jkv.CacheConfig(**cc))
    tc = tkv.PagedKVCache.create(ModelConfig.tiny(dtype="float32"),
                                 tkv.CacheConfig(**cc), "cpu")
    assert tc.quantized and tc.k_pages.dtype == torch.int8
    assert tc.k_scale.shape == tuple(jc.k_scale.shape)
    assert len(tc.carry()) == 4
    assert tkv.PagedKVCache.from_carry(tc.carry()).v_scale is tc.v_scale
    L, KVH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    B, S = 2, 6
    kn = rng.standard_normal((L, B, S, KVH, D)).astype(np.float32)
    vn = (kn + 1.0).astype(np.float32)
    table = np.array([[3, 5, 0, 0], [7, 8, 9, 0]], np.int32)
    pos = np.array([np.arange(S), np.arange(2, 2 + S)], np.int32)
    pages, offs = jkv.slot_to_page_offset(pos, table, 4)
    valid = np.ones((B, S), bool)
    valid[0, 4:] = False                     # padding -> garbage page 0
    want = jkv.write_kv(jc, kn, vn, pages, offs, valid)
    got = tkv.write_kv(tc, _t(kn), _t(vn), _t(np.array(pages)),
                       _t(np.array(offs)), _t(valid))
    assert got.k_scale is tc.k_scale          # written in place
    for g, w in ((got.k_pages, want.k_pages), (got.v_pages, want.v_pages),
                 (got.k_scale, want.k_scale), (got.v_scale, want.v_scale)):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])
        assert g.numpy()[:, 1:].tobytes() == np.asarray(w)[:, 1:].tobytes()
