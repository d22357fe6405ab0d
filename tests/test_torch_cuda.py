"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels have
no CPU mode; their arithmetic is covered on the CPU through the plain
versions in ``tests/test_torch_ops.py``).  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: float32 ``atol 1e-4`` (fp32 online softmax vs one fp32
softmax, different summation order); bf16 ``atol 1e-5, rtol 2**-7`` per
element (both sides compute in f32 and round once to bf16, so they may
differ by one bf16 ulp of the value), except K2's bf16 form, which rounds
P to bf16 before P.V as the TPU kernel does and is held to
``flash_error_limit`` (that ulp plus ``2**-8 plain(q, k, |v|)``), and
K2-backward, held to ``flash_backward_error_limit`` (its bf16 form adds
``2**-8`` of each gradient's term magnitudes for rounding P and dS to
bf16 before their products).
Attention outputs are compared on live tokens only.  K1's int8 form
dequantizes history in f32 and never rounds it to bf16; its bf16 cases
are held to the plain version evaluated in f32 (the same arithmetic) and
rounded once, under the same one-ulp limit.
"""

import numpy as np
import pytest
import torch

from helix_tpu_torch.engine import threefry
from helix_tpu_torch.ops import attention as tatt
from helix_tpu_torch.ops import paged_kernel as tpk
from helix_tpu_torch.ops import quant as tquant

TOL = {torch.float32: dict(atol=1e-4, rtol=0),
       torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _packed(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    pos = np.zeros((B, S), np.int32)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        t, s_id = 0, 1
        while t < S - 3:
            n = min(int(rng.integers(1, S // 3 + 2)), S - 3 - t)
            pos[b, t:t + n] = np.arange(n)
            seg[b, t:t + n] = s_id
            t, s_id = t + n, s_id + 1
    shapes = ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))
    qkv = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return qkv, pos, seg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,KVH,S", [(64, 8, 2, 100), (96, 4, 4, 70),
                                       (128, 8, 2, 130)])
def test_flash_kernel_matches_plain(cuda, dtype, D, H, KVH, S):
    (q, k, v), pos, seg = _packed(2, S, H, KVH, D, seed=D + S)
    args = [torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v)]
    kw = dict(q_positions=torch.from_numpy(pos).to(cuda),
              kv_positions=torch.from_numpy(pos).to(cuda),
              q_segment_ids=torch.from_numpy(seg).to(cuda),
              kv_segment_ids=torch.from_numpy(seg).to(cuda))
    before = tatt.K2.launches
    got = tatt.flash_attention(*args, **kw)
    assert tatt.K2.launches == before + 1
    want = tatt.flash_attention_plain(*args, **kw)
    live = torch.from_numpy(seg > 0).to(cuda)
    if dtype == torch.bfloat16:
        _within_flash_limit(got, want, tatt.flash_error_limit(*args, **kw),
                            live)
    else:
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   **TOL[dtype])


def _within_flash_limit(got, want, limit, live=None):
    """K2's bf16 form rounds P to bf16 before P.V (as the TPU kernel
    does): held per element to ``flash_error_limit``."""
    err = (got.float() - want.float()).abs()
    if live is not None:
        err, limit = err[live], limit[live]
    worst = (err / limit).max().item()
    assert worst <= 1.0, f"{worst:.3f}x flash_error_limit"


@pytest.mark.cuda
def test_flash_kernel_causal_soft_cap(cuda):
    (q, k, v), _, _ = _packed(1, 77, 4, 2, 64, seed=3)
    args = [torch.from_numpy(x).to(cuda) for x in (q, k, v)]
    got = tatt.flash_attention(*args, logits_soft_cap=3.0)
    want = tatt.flash_attention_plain(*args, logits_soft_cap=3.0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _straddling(S, H, KVH, D, seed):
    """One batch row whose segments straddle the 64-token tile edges."""
    rng = np.random.default_rng(seed)
    cuts = [c for c in (60, 70, 127, 129, 190, 250) if c < S] + [S]
    pos = np.zeros((1, S), np.int32)
    seg = np.zeros((1, S), np.int32)
    start = 0
    for i, c in enumerate(cuts):
        pos[0, start:c] = np.arange(c - start)
        seg[0, start:c] = i + 1
        start = c
    shapes = ((1, S, H, D), (1, S, KVH, D), (1, S, KVH, D))
    qkv = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return qkv, pos, seg


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KVH,S,cap", [
    (16, 4, 1, 65, None),      # group 4, ragged last tile of one row
    (96, 8, 2, 200, None),     # 192-byte rows, group 4
    (128, 8, 8, 129, None),    # group 1
    (128, 16, 4, 300, 5.0),    # soft cap in bf16
    (32, 4, 4, 64, 3.0),       # exactly one tile
])
def test_flash_kernel_bf16_edges(cuda, D, H, KVH, S, cap):
    """Segments straddling tile edges, Sq not a multiple of the tile,
    every head-dim padding class, group 1 and 4, soft cap: within
    ``flash_error_limit``; positions shifted by one (each query loses its
    own key) break it."""
    (q, k, v), pos, seg = _straddling(S, H, KVH, D, seed=S + D)
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v)]
    t = {n: torch.from_numpy(a).to(cuda) for n, a in
         (("pos", pos), ("seg", seg))}
    kw = dict(q_positions=t["pos"], kv_positions=t["pos"],
              q_segment_ids=t["seg"], kv_segment_ids=t["seg"],
              logits_soft_cap=cap)
    got = tatt.flash_attention(*args, **kw)
    want = tatt.flash_attention_plain(*args, **kw)
    limit = tatt.flash_error_limit(*args, **kw)
    _within_flash_limit(got, want, limit)
    bad = tatt.flash_attention(*args, **{**kw, "kv_positions": t["pos"] + 1})
    assert ((bad.float() - want.float()).abs() > limit).any()


@pytest.mark.cuda
def test_flash_kernel_bf16_causal_no_segments(cuda):
    """Plain causal attention over several tiles (the causal tile skip)
    and no segment ids."""
    (q, k, v), _, _ = _packed(2, 333, 8, 2, 128, seed=12)
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v)]
    got = tatt.flash_attention(*args)
    _within_flash_limit(got, tatt.flash_attention_plain(*args),
                        tatt.flash_error_limit(*args))


def _ragged(seed, L, N, P, KVH, D, H, maxP, R):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    q_len = rng.integers(0, 20, size=R).astype(np.int32)
    q_len[0] = 1
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    T = int(q_len.sum())
    hist = rng.integers(0, maxP * P - 20, size=R).astype(np.int32)
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    live = np.concatenate([np.arange(s, s + n) for s, n in zip(t0, q_len)])
    return (q, kn, vn, kp, vp), (t0, q_len, hist,
                                 tables.astype(np.int32)), live


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,KVH,P", [(64, 8, 2, 4), (96, 4, 4, 16),
                                       (128, 8, 2, 16)])
def test_ragged_kernel_matches_plain(cuda, dtype, D, H, KVH, P):
    L, N, maxP, R = 3, 96, 8, 6
    f, i, live = _ragged(D + P, L, N, P, KVH, D, H, maxP, R)
    f = [torch.from_numpy(x).to(cuda, dtype) for x in f]
    i = [torch.from_numpy(x).to(cuda) for x in i]
    # NaN garbage outside every row's history must not leak (trap 2)
    f[3][:, 0] = float("nan")
    f[4][:, 0] = float("nan")
    before = tpk.K1.launches
    got = tpk.ragged_paged_attention(*f, 1, *i)
    assert tpk.K1.launches == before + 1
    want = tpk.ragged_paged_attention_plain(*f, 1, *i)
    live = torch.from_numpy(live).to(cuda)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_ragged_kernel_writes_only_its_rows(cuda):
    """Blocks run in no order, so a block storing past its row's
    [t0, t0 + q_len) (trap 1) would race with the next row's block: with
    a parked row in the middle, every live token still gets exactly its
    own row's result."""
    f, i, live = _ragged(7, 2, 48, 4, 2, 64, 4, 8, 5)
    f = [torch.from_numpy(x).to(cuda) for x in f]
    i = [torch.from_numpy(x).to(cuda) for x in i]
    t0, q_len = i[0].clone(), i[1].clone()
    q_len[2] = 0                        # a parked row in the middle
    out = tpk.ragged_paged_attention(*f, 0, t0, q_len, i[2], i[3])
    parked = slice(int(t0[2]), int(t0[2]) + int(i[1][2]))   # unspecified
    want = tpk.ragged_paged_attention_plain(*f, 0, t0, q_len, i[2], i[3])
    keep = torch.ones(out.shape[0], dtype=torch.bool, device=cuda)
    keep[parked] = False
    torch.testing.assert_close(out[keep], want[keep], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(4, 4, 48, device=cuda)     # head_dim 48: no instance
    kv = torch.zeros(4, 2, 48, device=cuda)
    pool = torch.zeros(1, 4, 4, 2, 48, device=cuda)
    meta = [torch.zeros(1, dtype=torch.int32, device=cuda)] * 3
    with pytest.raises(ValueError, match="head_dim"):
        tpk.ragged_paged_attention(q, kv, kv, pool, pool, 0, *meta,
                                   torch.zeros(1, 4, dtype=torch.int32,
                                               device=cuda))
    with pytest.raises(TypeError):
        tatt.flash_attention(*(torch.zeros(1, 8, 2, 64, device=cuda,
                                           dtype=torch.float16),) * 3)


def _ragged_int8(seed, dtype, cuda, D=64, H=8, KVH=2, P=16, L=3, N=96,
                 maxP=8, R=6):
    """A ragged case over int8 pools quantized with ``quantize_kv``."""
    f, i, live = _ragged(seed, L, N, P, KVH, D, H, maxP, R)
    q, kn, vn, kp, vp = f
    kq, ks = tquant.quantize_kv(torch.from_numpy(kp))
    vq, vs = tquant.quantize_kv(torch.from_numpy(vp))
    fresh = [torch.from_numpy(x).to(cuda, dtype) for x in (q, kn, vn)]
    pools = [x.to(cuda) for x in (kq, vq)]
    scales = [x.to(cuda) for x in (ks, vs)]
    i = [torch.from_numpy(x).to(cuda) for x in i]
    return fresh, pools, scales, i, torch.from_numpy(live).to(cuda)


def _int8_plain(fresh, pools, scales, i, layer):
    """The plain version in f32 (dequantized history not rounded, like the
    kernel), rounded once to the query dtype."""
    f32 = [x.float() for x in fresh]
    out = tpk.ragged_paged_attention_plain(
        *f32, *pools, layer, *i, k_scale=scales[0], v_scale=scales[1])
    return out.to(fresh[0].dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,KVH,P", [(64, 8, 2, 4), (96, 4, 4, 16),
                                       (128, 8, 2, 16)])
def test_ragged_kernel_int8_matches_plain(cuda, dtype, D, H, KVH, P):
    fresh, pools, scales, i, live = _ragged_int8(D + P + 1, dtype, cuda,
                                                 D=D, H=H, KVH=KVH, P=P)
    # NaN scales on the garbage page outside every history must not leak
    for s in scales:
        s[:, 0] = float("nan")
    before, before_f = tpk.K1_INT8.launches, tpk.K1.launches
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *i,
                                     k_scale=scales[0], v_scale=scales[1])
    assert tpk.K1_INT8.launches == before + 1
    assert tpk.K1.launches == before_f        # counted apart
    want = _int8_plain(fresh, pools, scales, i, 1)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])


def _ragged_edges(P, dtype, cuda, quantized, D=64, H=8, KVH=2):
    """Rows at the split's edges: hist 0, one span exactly, a span + 1,
    maxP * P - 1, a span - 1; a q_len 0 row between live rows; decode and
    multi-token rows."""
    span = tpk._k1_split(1 << 20, P)[0] * P
    maxP = span // P + 8
    hists = [0, span, span + 1, maxP * P - 1, span - 1, 37]
    q_lens = [1, 3, 0, 1, 5, 17]
    R, L = len(hists), 2
    N = R * maxP + 1
    rng = np.random.default_rng(P + D)
    kp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    q_len = np.asarray(q_lens, np.int32)
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    T = int(q_len.sum())
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    fresh = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             .to(cuda, dtype) for sh in ((T, H, D), (T, KVH, D),
                                         (T, KVH, D))]
    meta = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(cuda)
            for x in (t0, q_len, np.asarray(hists), tables)]
    live = torch.from_numpy(np.concatenate(
        [np.arange(a, a + n) for a, n in zip(t0, q_len)])).to(cuda)
    if quantized:
        kq, ks = tquant.quantize_kv(torch.from_numpy(kp))
        vq, vs = tquant.quantize_kv(torch.from_numpy(vp))
        pools = [x.to(cuda) for x in (kq, vq)]
        kw = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    else:
        pools = [torch.from_numpy(x).to(cuda, dtype) for x in (kp, vp)]
        kw = {}
    return fresh, pools, meta, kw, live


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [4, 16])
def test_ragged_kernel_split_edges(cuda, P, dtype, quantized):
    """K1 (both pool forms) at the edges of its split over history pages
    matches the plain version; one history slot too many or too few
    breaks the limit."""
    fresh, pools, meta, kw, live = _ragged_edges(P, dtype, cuda, quantized)
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta, **kw)
    if quantized:
        want = _int8_plain(fresh, pools, (kw["k_scale"], kw["v_scale"]),
                           meta, 1)
    else:
        want = tpk.ragged_paged_attention_plain(*fresh, *pools, 1, *meta)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    for d in (-1, 1):
        bad = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta[:2],
                                         (meta[2] + d).clamp(min=0),
                                         meta[3], **kw)
        assert _breaks_limit(bad[live], want[live], dtype)


def _breaks_limit(got, want, dtype):
    tol = TOL[dtype]
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    return bool(((got.float() - want.float()).abs() > lim).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["hist-1", "hist+1", "scale_roll"])
def test_ragged_kernel_int8_planted_faults_fail(cuda, fault):
    """A slot too few or too many, or scales read from the neighbouring
    slot, must break the per-element limit the kernel is held to."""
    dtype = torch.bfloat16
    fresh, pools, scales, i, live = _ragged_int8(5, dtype, cuda, D=128)
    want = _int8_plain(fresh, pools, scales, i, 1)
    t0, q_len, hist, tables = i
    ks, vs = scales
    if fault == "hist-1":
        hist = (hist - 1).clamp(min=0)
    elif fault == "hist+1":
        hist = hist + 1
    else:
        ks = torch.roll(ks, 1, dims=2).contiguous()
        vs = torch.roll(vs, 1, dims=2).contiguous()
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, t0, q_len, hist,
                                     tables, k_scale=ks, v_scale=vs)
    assert _breaks_limit(got[live], want[live], dtype)


@pytest.mark.cuda
def test_ragged_int8_wrapper_refuses_bad_scales(cuda):
    fresh, pools, scales, i, _ = _ragged_int8(9, torch.float32, cuda)
    ks, vs = scales
    bad = {
        "dtype": (ks.double(), vs.double()),
        "shape": (ks[:, :, :1], vs[:, :, :1]),
        "contiguity": (ks.transpose(2, 3).contiguous().transpose(2, 3),
                       vs.transpose(2, 3).contiguous().transpose(2, 3)),
        "device": (ks.cpu(), vs.cpu()),
    }
    for k, v in bad.values():
        with pytest.raises((TypeError, ValueError)):
            tpk.ragged_paged_attention(*fresh, *pools, 0, *i, k_scale=k,
                                       v_scale=v)
    with pytest.raises(ValueError, match="together"):
        tpk.ragged_paged_attention(*fresh, *pools, 0, *i, k_scale=ks)
    with pytest.raises(TypeError):     # float pools with scales
        tpk.ragged_paged_attention(*fresh, pools[0].float(),
                                   pools[1].float(), 0, *i, k_scale=ks,
                                   v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_dense_rounds_once_on_card(cuda, quantized):
    """bf16 projections with a bias or an int8 scale accumulate in f32
    and round once: equal to the f32 product rounded to bf16 within one
    bf16 ulp (cuBLAS sums in another order than the f32 matmul)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96,)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    p = {"bias": b.to(cuda, torch.bfloat16)}
    if quantized:
        p.update(tquant.quantize_tensor(w.to(cuda)))
        want = (x.float() @ p["weight"].float()) * p["scale"].reshape(-1)
    else:
        p["weight"] = w.to(cuda, torch.bfloat16)
        want = x.float() @ p["weight"].float()
    want = (want + p["bias"].float()).to(torch.bfloat16)
    got = tquant.maybe_dequant_dense(x, p)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def _pool_params(dtype, device, quantized, seed=7, fan_in=256, fan_out=96,
                 n_slots=4, rank=16):
    """A pool-grafted projection (slot 0 the zero identity) and its
    per-token slot ids, made on the CPU from a seed."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((fan_in, fan_out))
                         .astype(np.float32) * 0.05)
    pa = rng.standard_normal((fan_in, n_slots, rank)).astype(np.float32)
    pb = rng.standard_normal((n_slots, rank, fan_out)).astype(np.float32)
    pa[:, 0], pb[0] = 0.0, 0.0
    p = ({**tquant.quantize_tensor(w)} if quantized
         else {"weight": w.to(dtype)})
    p.update(lora_pool_a=torch.from_numpy(pa * 0.05).to(dtype),
             lora_pool_b=torch.from_numpy(pb * 0.05).to(dtype),
             lora_pool_scale=torch.tensor([0.0, 2.0, 0.5, 1.0]))
    x = torch.from_numpy(rng.standard_normal((3, 40, fan_in))
                         .astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, n_slots, (3, 40)))
    return ({k: v.to(device) for k, v in p.items()}, x.to(device),
            ids.to(device), p, x, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_pool_form_on_card_matches_cpu(cuda, dtype, quantized):
    """The multi-LoRA pool form of ``maybe_dequant_dense`` on the card
    against the same op on the CPU (float32 ``atol 1e-4``; bf16 one bf16
    ulp): slot 0 rows equal the pool-less projection bit for bit."""
    p, x, ids, p_cpu, x_cpu, ids_cpu = _pool_params(dtype, cuda, quantized)
    got = tquant.maybe_dequant_dense(x, p, adapter_ids=ids)
    want = tquant.maybe_dequant_dense(x_cpu, p_cpu, adapter_ids=ids_cpu)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL[dtype])
    base = {k: v for k, v in p.items() if not k.startswith("lora_pool")}
    zero = ids == 0
    assert torch.equal(got[zero], tquant.maybe_dequant_dense(x, base)[zero])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 80, 300, 2048])
def test_bf16_gemm_equals_f32_gemm_rounded(cuda, M):
    """What adapter-free bit-identity with the pool on and off rests on in
    bf16: a pool-less float projection is one bf16-output GEMM, a
    pool-grafted one a float32-output GEMM rounded once; cuBLAS gives the
    same bits at Llama-3-8B's projection shapes."""
    g = torch.Generator(device=cuda).manual_seed(M)
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        w = (torch.randn((k, n), generator=g, device=cuda) * 0.02).bfloat16()
        x = torch.randn((1, M, k), generator=g, device=cuda).bfloat16()
        plain = tquant.maybe_dequant_dense(x, {"weight": w})
        pooled = tquant.matmul_f32(x, w).to(torch.bfloat16)
        assert torch.equal(plain, pooled), (M, k, n)


def _adapter_engine(cuda, slots, **extra):
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
        max_prefill_len=32, adapter_pool_slots=slots, adapter_rank=8,
        **extra), device=cuda)
    return cfg, eng


def _lora_tree(cfg, seed):
    from helix_tpu_torch.engine.adapters import target_dims

    rng = np.random.default_rng(seed)
    out = {}
    for t in ("wq", "wk", "wv", "wo"):
        fan_in, fan_out = target_dims(cfg)[t]
        out[t] = {"lora_a": rng.standard_normal(
                      (cfg.num_layers, fan_in, 8)).astype(np.float32) * 0.1,
                  "lora_b": rng.standard_normal(
                      (cfg.num_layers, 8, fan_out)).astype(np.float32) * 0.1}
    return out


@pytest.mark.cuda
def test_adapter_free_tokens_equal_with_pool_on_and_off(cuda):
    """bf16 on the card: adapter-free greedy tokens with the pool on
    (alone, and beside an adapter row) equal the pool-less engine's on
    the same step composition (a base row in the adapter row's place:
    bf16 GEMMs may round a row otherwise at another row count)."""
    from helix_tpu_torch.engine.engine import Request
    from helix_tpu_torch.engine.sampling import SamplingParams

    prompts = [[3 + i, 9, 27, 81 % 50, 5 * i + 1] * (i + 2)
               for i in range(3)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    _, off = _adapter_engine(cuda, 0)
    want = off.generate(prompts, sp)
    cfg, on = _adapter_engine(cuda, 3)
    assert on.generate(prompts, sp) == want
    on.publish_adapter("a1", _lora_tree(cfg, 1), 2.0)

    def run(eng, adapter):
        reqs = [Request(id=f"b{i}", prompt_tokens=p, sampling=sp,
                        adapter=adapter if i == 0 else "")
                for i, p in enumerate([prompts[0]] + prompts)]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        return [r.output_tokens for r in reqs]

    base_rows = run(off, "")
    got = run(on, "a1")
    assert got[1:] == base_rows[1:]
    assert got[0] != base_rows[0]


@pytest.mark.cuda
def test_adapter_load_and_mixed_decode_make_no_synchronising_call(cuda):
    """A pool load (one slot written in place from pinned uploads) and a
    decode dispatch whose rows carry two adapters and none queue their
    work without a synchronising call."""
    from helix_tpu_torch.engine.engine import Request
    from helix_tpu_torch.engine.sampling import SamplingParams

    cfg, eng = _adapter_engine(cuda, 4)
    for i in (1, 2, 3):
        eng.publish_adapter(f"a{i}", _lora_tree(cfg, i), 2.0)
    pool, store = eng.adapter_pool, eng.adapter_store
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slot = pool.acquire("a3", store.get_resident)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert slot is not None and pool.stats()["loads"] == 1
    pool.release("a3")
    for i, aid in enumerate(("a1", "a2", "")):
        eng.add_request(Request(
            id=f"r{i}", prompt_tokens=[3, 4, 5, 6, 7][: 3 + i],
            sampling=SamplingParams(temperature=0.0, max_tokens=40),
            adapter=aid))
    for _ in range(2):
        eng.step()
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            emitted, pend = eng.step_dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pend is not None and pend.kind == "decode"
        eng.step_complete(pend, emitted)
    rows = pool.rows_applied()
    assert rows["a1"] > 0 and rows["a2"] > 0


@pytest.mark.cuda
def test_threefry_on_the_card_matches_cpu(cuda):
    """The sampler's random bits and uniforms do not depend on the
    device (int64 emulation of uint32 arithmetic)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint64)
    keys = threefry.as_keys(keys.astype(np.uint32), "cpu")
    for n in (1, 300):
        np.testing.assert_array_equal(
            threefry.random_bits(keys.to(cuda), n).cpu().numpy(),
            threefry.random_bits(keys, n).numpy())
        torch.testing.assert_close(threefry.uniform(keys.to(cuda), n).cpu(),
                                   threefry.uniform(keys, n), atol=0, rtol=0)


def _verify_rows(hists, dtype, cuda, quantized, D=64, H=8, KVH=2, P=16,
                 W=5, pool_pages=None):
    """The state segment's verify rows as the engine lays them out: row
    b owns tokens [b W, b W + W) (t0 = b W), every row q_len W except one
    that sits the call out with q_len 0, histories ``hists``.  With
    ``pool_pages`` the pool has that many pages and the tables are the
    engine's: distinct pages up to each row's last token, page 0 past
    it."""
    R, L = len(hists), 2
    maxP = -(-(max(hists) + W) // P)
    N = R * maxP + 1 if pool_pages is None else pool_pages
    rng = np.random.default_rng(P + D + len(hists))
    kp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    q_len = np.full((R,), W, np.int32)
    q_len[R // 2] = 0
    t0 = (np.arange(R) * W).astype(np.int32)
    T = R * W
    perm = rng.permutation(np.arange(1, N))
    if pool_pages is None:
        tables = perm[: R * maxP].reshape(R, maxP)
    else:
        tables = np.zeros((R, maxP), np.int64)
        for r in range(R):
            n = -(-(hists[r] + W) // P)
            tables[r, :n] = perm[r * maxP: r * maxP + n]
    fresh = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             .to(cuda, dtype) for sh in ((T, H, D), (T, KVH, D),
                                         (T, KVH, D))]
    meta = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(cuda)
            for x in (t0, q_len, np.asarray(hists), tables)]
    live = torch.from_numpy(np.concatenate(
        [np.arange(a, a + n) for a, n in zip(t0, q_len)])).to(cuda)
    if quantized:
        kq, ks = tquant.quantize_kv(torch.from_numpy(kp))
        vq, vs = tquant.quantize_kv(torch.from_numpy(vp))
        pools = [x.to(cuda) for x in (kq, vq)]
        kw = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    else:
        pools = [torch.from_numpy(x).to(cuda, dtype) for x in (kp, vp)]
        kw = {}
    return fresh, pools, meta, kw, live


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hists,D,H,KVH,pool_pages", [
    ([1000, 1700, 2333, 2900, 3100, 3650, 3999, 1234], 128, 32, 8, None),
    ([511, 512, 513, 1023, 1025, 4091, 0, 1], 128, 32, 8, None),
    ([511, 512, 513, 1023, 1025, 4091, 0, 1], 64, 8, 2, None),
    # the spec cell: 16 slots at its histories on its 3968-page pool
    ([301, 449, 317, 336, 352, 368, 384, 399, 400, 415, 431, 447, 320,
      304, 383, 416], 128, 32, 8, 3968),
])
def test_ragged_kernel_verify_rows(cuda, hists, D, H, KVH, pool_pages,
                                   dtype, quantized):
    """K1 (both pool forms) on speculative verify rows: W = 5 tokens x
    H/KVH query heads per KV head in one query tile, the fresh causal part
    on top of histories at and beside the split's edges, and 16 rows (the
    query tiles are numbered across rows on the device) on an engine-sized
    pool; one history slot too many or too few breaks the limit."""
    fresh, pools, meta, kw, live = _verify_rows(hists, dtype, cuda,
                                                quantized, D=D, H=H, KVH=KVH,
                                                pool_pages=pool_pages)
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta, **kw)
    if quantized:
        want = _int8_plain(fresh, pools, (kw["k_scale"], kw["v_scale"]),
                           meta, 1)
    else:
        want = tpk.ragged_paged_attention_plain(*fresh, *pools, 1, *meta)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    for d in (-1, 1):
        bad = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta[:2],
                                         (meta[2] + d).clamp(min=0),
                                         meta[3], **kw)
        assert _breaks_limit(bad[live], want[live], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_decode_dispatch_makes_no_synchronising_call(cuda, spec):
    """A decode (or verify) step's dispatch half queues its work and its
    one device-to-host copy without a synchronising call: metadata goes up
    from pinned copies (``device.upload``), results come back through
    ``device.Fetch``.  Greedy and seeded sampled rows, so the sampler's
    uploads are covered too."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
        max_prefill_len=32, enable_spec_decode=spec, enable_async_loop=True),
        device=cuda)
    for i, temp in enumerate((0.0, 0.8, 0.0)):
        eng.add_request(Request(
            id=f"s{i}", prompt_tokens=[3, 4, 5, 3, 4, 5, 3, 4][: 5 + i],
            sampling=SamplingParams(temperature=temp, seed=i,
                                    max_tokens=40)))
    for _ in range(3):
        eng.step()
    assert not spec or eng.spec is not None
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            emitted, pend = eng.step_dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pend is not None and pend.kind in ("decode", "spec")
        eng.step_complete(pend, emitted)


# ---------------------------------------------------------------------------
# the host KV tier on the card
# ---------------------------------------------------------------------------


def _fill_pool(cache, seed):
    g = torch.Generator(device=cache.k_pages.device).manual_seed(seed)
    for t in cache.carry():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=t.device))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _page_sums(cache, ids):
    from helix_tpu_torch.engine import kv_cache as tkv

    return [tkv.page_checksum({f: None if a is None else a.cpu()
                               for f, a in p.items()})
            for p in tkv.gather_pages(cache, ids)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_host_tier_round_trip_on_the_card(cuda, kv_dtype):
    """gather -> pinned device-to-host copy (``HostPagePool.put``) ->
    pageable store -> pinned host-to-device copy -> ``restore_pages``:
    the restored pages are the gathered bytes, also when the source pages
    are overwritten right after the spill was queued (the gather is
    ordered before the write), and through ``prefetch``."""
    from helix_tpu_torch.engine import kv_cache as tkv
    from helix_tpu_torch.models.common import ModelConfig

    cfg = ModelConfig.tiny(dtype="bfloat16")
    cc = tkv.CacheConfig(num_pages=32, page_size=16, max_pages_per_seq=8,
                         dtype=kv_dtype)
    cache = tkv.PagedKVCache.create(cfg, cc, cuda)
    _fill_pool(cache, 5)
    ids, targets = [3, 9, 4, 17, 30], [20, 21, 22, 23, 24]
    want = _page_sums(cache, ids)
    pool = tkv.HostPagePool(1 << 26, device=cuda)
    for i, page in zip(ids, tkv.gather_pages(cache, ids)):
        assert pool.put(("p", i), page)
    assert pool.staged_bytes > 0
    idx = torch.tensor(ids, device=cuda)
    for t in cache.carry():
        t.index_fill_(1, idx, 0)   # queued after the copies
    torch.cuda.synchronize()
    pool.drain_pending()
    assert pool.staged_bytes == 0
    entries = [pool.take_restored(("p", i)) for i in ids]
    assert all(not e["k"].is_cuda and not e["k"].is_pinned()
               for e in entries)
    tkv.restore_pages(cache, targets, entries)
    assert _page_sums(cache, targets) == want
    # through prefetch: the upload is queued at prefetch time
    for i, page in zip(targets, tkv.gather_pages(cache, targets)):
        assert pool.put(("q", i), page)
    for i in targets:
        assert pool.prefetch(("q", i))
    entries = [pool.take_restored(("q", i)) for i in targets]
    assert all(e["k"].is_cuda for e in entries)
    tkv.restore_pages(cache, ids, entries)
    assert _page_sums(cache, ids) == want
    assert pool.corrupt_pages == 0 and pool.pages == 0


@pytest.mark.cuda
def test_spill_step_makes_no_synchronising_call(cuda):
    """The dispatch in which an admission evicts prefix pages to the host
    tier, and the next one, which finalizes the landed copies, make no
    synchronising call: the gather, the pinned staging copies and their
    events are all queued."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=4, page_size=16, num_pages=12, max_pages_per_seq=8,
        max_prefill_len=32, host_pool_bytes=1 << 26), device=cuda)

    def req(rid, prompt, n):
        return Request(id=rid, prompt_tokens=prompt, sampling=SamplingParams(
            temperature=0.0, max_tokens=n))

    eng.add_request(req("a", [(7 * i) % 200 + 4 for i in range(40)], 2))
    while eng.has_work():
        eng.step()
    assert eng.prefix_cache.stats["pages"] == 2
    eng.add_request(req("b", [5] * 10, 60))
    eng.step()
    eng.step()
    # a chunked prompt that needs one page more than is free
    eng.add_request(req("c", [(11 * i) % 200 + 4 for i in range(40)], 40))
    spilled = eng.host_pool.spilled_pages
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            emitted, pend = eng.step_dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pend is not None and pend.kind == "mixed"
        eng.step_complete(pend, emitted)
    assert eng.host_pool.spilled_pages > spilled
    assert eng.host_pool.staged_bytes == 0   # finalized in dispatch two
    while eng.has_work():
        eng.step()


@pytest.mark.cuda
def test_k1_int8_on_restored_pages_equals_the_originals(cuda):
    """K1-int8 over pages that went to the host tier and came back into
    other pool pages gives, bit for bit, its output over the originals."""
    from helix_tpu_torch.engine import kv_cache as tkv

    fresh, pools, scales, i, _live = _ragged_int8(41, torch.bfloat16, cuda,
                                                  R=5)
    cache = tkv.PagedKVCache(k_pages=pools[0], v_pages=pools[1],
                             k_scale=scales[0], v_scale=scales[1])
    kw = dict(k_scale=scales[0], v_scale=scales[1])
    before = tpk.K1_INT8.launches
    want = tpk.ragged_paged_attention(*fresh, *pools, 1, *i, **kw)
    tables = i[3].cpu().numpy()
    used = sorted(set(int(p) for p in tables.reshape(-1)))
    free = [p for p in range(1, pools[0].shape[1]) if p not in set(used)]
    assert len(free) >= len(used)
    pool = tkv.HostPagePool(1 << 28, device=cuda)
    for p, page in zip(used, tkv.gather_pages(cache, used)):
        assert pool.put(p, page)
    entries = [pool.take_restored(p) for p in used]
    tkv.restore_pages(cache, free[: len(used)], entries)
    remap = dict(zip(used, free))
    moved = torch.from_numpy(np.vectorize(remap.get)(tables).astype(
        np.int32)).to(cuda)
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *i[:3], moved, **kw)
    assert tpk.K1_INT8.launches == before + 2
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the filestore tier and the prefill handoff on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_filestore_writer_reads_the_gathered_bytes(cuda, tmp_path, kv_dtype):
    """The engine's write-through: pages gathered on the engine's stream,
    an event recorded behind the gather, the writer thread waiting on it
    before its device-to-host copy.  The pages are overwritten on the
    card right after (queued behind the gather, before the writer reads):
    every blob holds the pre-overwrite bytes."""
    from helix_tpu_torch.engine import kv_cache as tkv
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.serving.kv_filestore import KVFilestore

    cfg = ModelConfig.tiny(dtype="bfloat16")
    cc = tkv.CacheConfig(num_pages=32, page_size=16, max_pages_per_seq=8,
                         dtype=kv_dtype)
    cache = tkv.PagedKVCache.create(cfg, cc, cuda)
    _fill_pool(cache, 11)
    ids = [2, 7, 13, 29]
    want = _page_sums(cache, ids)
    fs = KVFilestore(str(tmp_path), "card")
    gathered = tkv.gather_pages(cache, ids)
    ready = torch.cuda.Event()
    ready.record()
    # a long kernel keeps the stream busy so the overwrite is still
    # queued when the writer starts
    torch.cuda._sleep(50_000_000)
    idx = torch.tensor(ids, device=cuda)
    for t in cache.carry():
        t.index_fill_(1, idx, 0)
    for i, page in zip(ids, gathered):
        fs.put_async(f"{i:032x}", page, tenant="t", ready=ready)
    fs.flush(60)
    assert fs.stores == len(ids)
    got = [tkv.page_checksum(fs.get(f"{i:032x}")) for i in ids]
    assert got == want
    assert _page_sums(cache, ids) != want   # the overwrite did land


@pytest.mark.cuda
def test_export_prefill_on_an_int8_pool_imports_on_a_second_engine(cuda):
    """``export_prefill`` at the first token on the card (int8 weights and
    KV), through the wire, imported by a second engine on the card: the
    checksums the export stamped verify there, and the imported request
    continues to its end."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.kv_cache import page_checksum
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.serving import migration

    cfg = ModelConfig.tiny(dtype="bfloat16")
    params = init_params(cfg, 0, device=cuda, quantization="int8")
    ecfg = EngineConfig(max_decode_batch=4, page_size=16, num_pages=64,
                        max_pages_per_seq=16, max_prefill_len=64,
                        kv_cache_dtype="int8")
    a, b = (Engine(cfg, params, ecfg, device=cuda) for _ in range(2))
    req = Request(id="h", prompt_tokens=[(5 * i) % 200 + 4 for i in range(90)],
                  sampling=SamplingParams(temperature=0.0, max_tokens=12))
    a.add_request(req)
    while not req.output_tokens:
        a.step()
    snap = a.export_prefill("h")
    assert snap is not None and snap.has_kv and a.num_prefill_exports == 1
    wire = migration.snapshot_to_wire(snap)
    back = migration.wire_to_snapshot(wire)
    assert [page_checksum(p).hex() for p in back.pages] == \
        snap.page_checksums
    cont = b.import_request(back)
    while not cont.finished:
        b.step()
    assert cont.output_tokens[:len(snap.output_tokens)] == snap.output_tokens
    assert len(cont.output_tokens) == 12
    assert b.num_snapshots_imported == 1


# Phi-3-mini's attention widths: group 1 (a K1 query tile holds 32 tokens
# of one head), head dim 96 (K2 pads it to 128 for its wgmma tiles)


@pytest.mark.cuda
def test_ragged_kernel_int8_at_phi3_heads(cuda):
    """K1-int8 at D 96, H = KVH = 32, short histories and multi-token
    rows, against the plain version evaluated in f32 (one bf16 ulp)."""
    fresh, pools, scales, i, live = _ragged_int8(
        96, torch.bfloat16, cuda, D=96, H=32, KVH=32, P=16, L=2, N=64)
    before = tpk.K1_INT8.launches
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *i,
                                     k_scale=scales[0], v_scale=scales[1])
    assert tpk.K1_INT8.launches == before + 1
    want = _int8_plain(fresh, pools, scales, i, 1)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernel_bf16_at_phi3_heads(cuda):
    """K2's bf16 form at D 96, H = KVH = 32 on packed segments, held to
    ``flash_error_limit`` on live tokens."""
    (q, k, v), pos, seg = _packed(1, 200, 32, 32, 96, seed=96)
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v)]
    kw = dict(q_positions=torch.from_numpy(pos).to(cuda),
              kv_positions=torch.from_numpy(pos).to(cuda),
              q_segment_ids=torch.from_numpy(seg).to(cuda),
              kv_segment_ids=torch.from_numpy(seg).to(cuda))
    got = tatt.flash_attention(*args, **kw)
    live = torch.from_numpy(seg > 0).to(cuda)
    _within_flash_limit(got, tatt.flash_attention_plain(*args, **kw),
                        tatt.flash_error_limit(*args, **kw), live)


@pytest.mark.cuda
def test_eviction_returns_device_memory(cuda):
    """A tiny served model (int8 weights and KV, a host tier) built and
    evicted through the ResidencyManager: after the eviction
    ``memory_allocated()`` is back at its level before the build.  The
    first cycle fills what stays cached across builds (the rotary
    frequencies); the second is held to the byte."""
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.engine.residency import ResidencyManager

    engine = dict(max_decode_batch=2, page_size=16, num_pages=64,
                  max_pages_per_seq=8, max_prefill_len=64,
                  kv_cache_dtype="int8", host_pool_bytes=1 << 24)
    mgr = ResidencyManager(1 << 40, build=lambda name: build_served_model(
        name, device=cuda, engine=engine, quantization="int8"))
    mgr.register_name("tiny-evict")
    for _ in range(2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        served = mgr.acquire("tiny-evict")
        assert torch.cuda.memory_allocated() > before
        assert served.loop.engine.cache.quantized
        mgr.evict("tiny-evict")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    assert after == before, (before, after)
    assert served.loop.stopped and served.loop.engine.params is None


def _tiny_checkpoint(tmp_path, fused=False):
    """A small bf16 HF checkpoint (4 layers, vocab 3072) written from a
    CPU draw: (dir, config, the tree written)."""
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    cfg = ModelConfig.tiny(num_layers=4, vocab_size=3072, hidden_size=256,
                           num_heads=4, num_kv_heads=4 if fused else 2,
                           head_dim=64, intermediate_size=512)
    params = init_params(cfg, 5, device="cpu")
    d = str(tmp_path / "ckpt")
    write_checkpoint(d, cfg, params, fused=fused,
                     model_type="phi3" if fused else "llama",
                     max_shard_bytes=2_000_000)
    return d, cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_int8_load_equals_quantize_on_card(cuda, tmp_path, monkeypatch,
                                           fused):
    """Each weight quantized as it lands on the card (staging blocks cut
    small, so a projection spans several) equals ``quantize_tensor`` /
    ``quantize_rows`` of the bf16 load, byte for byte; the bf16 load
    equals the tree written."""
    from helix_tpu_torch.models import loader

    monkeypatch.setattr(loader, "STAGE_BYTES", 96 << 10)
    d, cfg, params = _tiny_checkpoint(tmp_path, fused)
    _, bf16 = loader.load_params(d, device=cuda)
    stats = {}
    _, q8 = loader.load_params(d, device=cuda, quantization="int8",
                               stats=stats)
    assert stats["blocks"] > 4 * cfg.num_layers and stats["bytes"] > 0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        want = tquant.quantize_tensor(bf16["layers"][k]["weight"])
        assert torch.equal(q8["layers"][k]["weight"], want["weight"]), k
        assert torch.equal(q8["layers"][k]["scale"], want["scale"]), k
        assert torch.equal(bf16["layers"][k]["weight"].cpu(),
                           params["layers"][k]["weight"]), k
    codes, scale = tquant.quantize_rows(bf16["embed"]["weight"])
    assert torch.equal(q8["embed"]["weight"], codes)
    assert torch.equal(q8["embed"]["embed_scale"], scale)
    want = tquant.quantize_tensor(bf16["lm_head"]["weight"])
    assert torch.equal(q8["lm_head"]["weight"], want["weight"])


@pytest.mark.cuda
def test_load_makes_no_sync_call_per_layer(cuda, tmp_path, monkeypatch):
    """A load under ``set_sync_debug_mode("warn")``: the staging ring
    waits on events (one per block, the copy it needs), and nothing else
    synchronises; the count of synchronising calls is printed."""
    import warnings

    from helix_tpu_torch.models import loader

    monkeypatch.setattr(loader, "STAGE_BYTES", 96 << 10)
    d, cfg, _ = _tiny_checkpoint(tmp_path)
    loader.load_params(d, device=cuda, quantization="int8")   # warm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stats = {}
            loader.load_params(d, device=cuda, quantization="int8",
                               stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    print(f"synchronising calls in a load of {cfg.num_layers} layers, "
          f"{stats['blocks']} blocks: {len(syncs)}")
    assert len(syncs) == 0, [str(w.message) for w in syncs]


@pytest.mark.cuda
def test_truncated_shard_fails_before_any_upload(cuda, tmp_path):
    import os

    from helix_tpu_torch.models import loader
    from helix_tpu_torch.models.st_format import FormatError

    d, _cfg, _ = _tiny_checkpoint(tmp_path)
    shard = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))[1]
    path = os.path.join(d, shard)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-1])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with pytest.raises(FormatError, match="truncated"):
        loader.load_params(d, device=cuda, quantization="int8")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# the scheduler, the prefill budget and the SLO notes on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_sched_pass_dispatch_and_slo_notes_make_no_synchronising_call(
        cuda, spec):
    """With WFQ, a prefill budget and the SLO observer on, the engine
    loop's scheduler pass, a decode (or verify) dispatch and the SLO
    notes of an emitted batch queue no synchronising call."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.serving.engine_loop import EngineLoop

    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
        max_prefill_len=32, enable_spec_decode=spec, enable_async_loop=True,
        kv_cache_dtype="int8"), device=cuda)
    slo = {"ttft_p95_seconds": 2.0, "queue_wait_p95_seconds": 1.0,
           "sched": {"policy": "wfq", "prefill_budget_tokens": 64,
                     "prefill_budget_min_tokens": 16,
                     "max_tenant_queue_depth": 8}}
    loop = EngineLoop(eng, "sync", slo_targets=slo, sched_config=slo)
    for i, (tenant, cls) in enumerate((("a", "batch"), ("b", "interactive"),
                                       ("a", "interactive"))):
        loop.submit(Request(
            id=f"s{i}", prompt_tokens=[3, 4, 5, 3, 4, 5, 3, 4][: 5 + i],
            sampling=SamplingParams(temperature=0.0, max_tokens=40),
            tenant=tenant, sched_class=cls), lambda ev: None)
    loop._drain_inbox()
    delivered = 0
    for _ in range(3):
        loop._sched_pass()
        events = loop._snapshot_events(eng.step())
        loop._deliver(events)
        delivered += len(events)
    assert eng.prefill_budget == 64 and not eng.waiting
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop._sched_pass()
            emitted, pend = eng.step_dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pend is not None and pend.kind in ("decode", "spec")
        eng.step_complete(pend, emitted)
        events = loop._snapshot_events(emitted)
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop._deliver(events)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        delivered += len(events)
    notes = loop.slo.stats()
    assert notes["requests"] == 3
    assert notes["generated_tokens"] == delivered > 3
    assert loop.sched_passes == 7


@pytest.mark.cuda
def test_one_page_budget_admits_one_request_per_step(cuda):
    """A prefill budget of one page still admits one request per step (the
    step's first claim always admits).  The budget's shorter waves run
    K2 on cold waves and K1-int8 on the mixed steps of a chunked prompt,
    and the tokens equal the plain versions' under the same budget."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(dtype="float32", vocab_size=512)
    params = init_params(cfg, 2, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(2, 500, size=n)]
               for n in (40, 23, 200, 37, 16)]
    runs = []
    for backend in (None, "reference"):
        eng = Engine(cfg, params, EngineConfig(
            max_decode_batch=4, page_size=16, num_pages=256,
            max_pages_per_seq=32, max_prefill_len=64,
            kv_cache_dtype="int8", attn_backend=backend), device=cuda)
        eng.prefill_budget = 16
        reqs = [Request(id=f"b{i}", prompt_tokens=p, sampling=SamplingParams(
            temperature=0.0, max_tokens=12)) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        tpk.K1_INT8.launches = tatt.K2.launches = 0
        per_step = []
        while eng.has_work():
            a0 = eng.num_admitted
            eng.step()
            per_step.append(eng.num_admitted - a0)
        runs.append(([r.output_tokens for r in reqs], per_step,
                     tpk.K1_INT8.launches, tatt.K2.launches,
                     eng.num_mixed_steps))
    (toks, per_step, k1, k2, mixed), (ptoks, *_rest) = runs
    assert max(per_step) == 1 and sum(per_step) == len(prompts)
    assert k1 > 0 and k2 > 0 and mixed > 0
    assert toks == ptoks


# ---------------------------------------------------------------------------
# the node agent on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_detect_accelerators_on_the_card(cuda):
    from helix_tpu_torch.device import detect_accelerators, total_device_bytes

    recs = detect_accelerators()
    assert [a.index for a in recs] == list(range(torch.cuda.device_count()))
    a = recs[0]
    _free, total = torch.cuda.mem_get_info(0)
    assert a.vendor == "nvidia"
    assert a.device_kind == torch.cuda.get_device_name(0)
    assert a.total_memory_bytes == total
    assert a.used_memory_bytes + a.free_memory_bytes == total
    assert a.driver == f"cuda-{torch.version.cuda}"
    if "H100" in a.device_kind:
        assert a.arch == "h100"
    assert total_device_bytes() == total
    assert a.to_dict()["coords"] is None


@pytest.mark.cuda
def test_heartbeat_payload_makes_no_synchronising_call(cuda):
    """The agent's heartbeat body, built while a step of a live engine
    (WFQ, an adapter pool, int8 KV) is in flight, queues no
    synchronising call: the saturation, tenant and adapter blocks are
    host counters and the inventory is ``cudaMemGetInfo``."""
    from helix_tpu_torch.control.node_agent import NodeAgent
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.obs.flight import SATURATION_KEYS
    from helix_tpu_torch.serving.engine_loop import EngineLoop
    from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
    from helix_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=16, page_size=16, num_pages=256,
        max_pages_per_seq=8, max_prefill_len=64, kv_cache_dtype="int8",
        adapter_pool_slots=3, adapter_rank=8), device=cuda)
    slo = {"ttft_p95_seconds": 2.0, "sched": {"policy": "wfq"}}
    loop = EngineLoop(eng, "hb", slo_targets=slo, sched_config=slo)
    reg = ModelRegistry()
    reg.register(ServedModel(name="hb", loop=loop, tokenizer=ByteTokenizer()))
    agent = NodeAgent("card", registry=reg, device=cuda)
    for i in range(16):
        loop.submit(Request(
            id=f"h{i}", prompt_tokens=[3 + i, 4, 5, 6, 7],
            sampling=SamplingParams(temperature=0.0, max_tokens=64),
            tenant=f"t{i % 3}"), lambda ev: None)
    loop._drain_inbox()
    for _ in range(3):
        loop._sched_pass()
        loop._deliver(loop._snapshot_events(eng.step()))
    emitted, pend = eng.step_dispatch()
    assert pend is not None
    torch.cuda.set_sync_debug_mode("error")
    try:
        body = agent.heartbeat_payload()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng.step_complete(pend, emitted)
    assert list(body["saturation"]) == list(SATURATION_KEYS)
    assert body["saturation"]["slots_busy"] == 16
    assert body["accelerators"][0]["vendor"] == "nvidia"
    assert {e["tenant"] for e in body["tenants"]["top"]} == {"t0", "t1",
                                                             "t2"}


@pytest.mark.cuda
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_encoder_on_the_card_equals_its_cpu_path(cuda, pooling):
    """``models.bge.forward`` on the card against the same weights on the
    CPU, float32 (TF32 off: the default): max abs <= 1e-5 per component
    of the unit vectors, ragged rows padded under the mask."""
    from helix_tpu_torch.models import bge

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = bge.EncoderConfig(num_layers=2, pooling=pooling)
    params = bge.init_params(cfg, seed=4, device="cpu")
    on_card = bge.EmbeddingRunner(cfg, params, None,
                                  max_batch=8).to(cuda)
    on_cpu = bge.EmbeddingRunner(cfg, params, None, max_batch=8)
    rng = np.random.default_rng(5)
    rows = [list(rng.integers(0, cfg.vocab_size, n))
            for n in (8, 33, 100, 512, 700, 1, 64, 250, 17)]
    got, want = on_card.embed_tokens(rows), on_cpu.embed_tokens(rows)
    assert got.shape == want.shape == (9, 768)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.cuda
def test_unix_server_and_tunnel_round_trip_on_the_card(cuda, tmp_path):
    """A tiny chat model and a tiny encoder on the card behind the unix
    server and the port's tunnel, driven through the stand-in control
    plane: an SSE chat's frames equal a direct chat's, the embeddings
    equal the encoder's own output, and a dropped tunnel re-dials."""
    import json
    import threading
    import time

    from helix_tpu_torch.control.tunnel import TunnelAgent, UnixHTTPConnection
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.models import bge
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.serving.engine_loop import EngineLoop
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
    from helix_tpu_torch.serving.tokenizer import ByteTokenizer
    from helix_tpu_torch.testing.control_stub import ControlStub

    tok = ByteTokenizer()
    cfg = ModelConfig.tiny(dtype="bfloat16")
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        max_decode_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
        max_prefill_len=64, eos_token_ids=tok.eos_ids), device=cuda)
    loop = EngineLoop(eng, "chat").start()
    ecfg = bge.EncoderConfig.tiny()
    embedder = bge.EmbeddingRunner(
        ecfg, bge.init_params(ecfg, seed=1, device=cuda), tok, max_batch=4)
    reg = ModelRegistry()
    reg.register(ServedModel(name="chat", loop=loop, tokenizer=tok))
    reg.register(ServedModel(name="enc", loop=None, tokenizer=tok,
                             kind="embedding", embedder=embedder))
    path = str(tmp_path / "node.sock")
    httpd = OpenAIServer(reg).make_unix_server(path)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    stub = ControlStub().start()
    agent = TunnelAgent("card", stub.url, unix_socket=path,
                        reconnect_delay=0.2).start()
    body = {"model": "chat", "max_tokens": 8, "temperature": 0,
            "stream": True, "messages": [{"role": "user", "content": "hi"}]}

    def frames(raw):
        return [{k: v for k, v in json.loads(x[6:]).items()
                 if k not in ("id", "created")}
                for x in raw.split(b"\n\n") if x.startswith(b"data: {")]

    try:
        status, _h, chunks = stub.tunnel_request(
            "card", "POST", "/v1/chat/completions", {},
            json.dumps(body).encode())
        tunneled = b"".join(chunks)
        conn = UnixHTTPConnection(path)
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode())
        direct = conn.getresponse().read()
        conn.close()
        assert status == 200 and frames(tunneled) == frames(direct)
        status, _h, chunks = stub.tunnel_request(
            "card", "POST", "/v1/embeddings", {},
            json.dumps({"model": "enc", "input": ["a", "bc"]}).encode())
        doc = json.loads(b"".join(chunks))
        want = embedder.embed_texts(["a", "bc"])
        got = np.array([d["embedding"] for d in doc["data"]])
        assert status == 200 and np.abs(got - want).max() == 0.0
        stub.drop_tunnel("card")
        deadline = time.monotonic() + 10
        while agent.connects < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        status, _h, chunks = stub.tunnel_request(
            "card", "POST", "/v1/chat/completions", {},
            json.dumps(body).encode())
        assert status == 200 and frames(b"".join(chunks)) == frames(direct)
        assert agent.connects == 2
    finally:
        agent.stop(join=True)
        stub.stop()
        httpd.shutdown()
        httpd.server_close()
        loop.stop(join=True)


# ---------------------------------------------------------------------------
# K1's cold form and tiered residency on the card
# ---------------------------------------------------------------------------


def _cold_case(seed, dtype, quantized, L=2, N=512, P=16, KVH=2, D=128, H=8,
               maxP=64, Ct=64, edge=False):
    """Tiered decode and verify rows beside resident ones, page-aligned
    spans (one from page 0, leaving only the hot tail), a chunk owned by
    no row: the tiered call's arguments and the resident call's tables on
    the same values.  ``edge``: also chunks with ``cold_len`` 0 among the
    others (one of them a resident row's, which owns no live chunk) and a
    tiered row whose chunks are all empty."""
    rng = np.random.default_rng(seed)
    q_len = np.array([1, 5, 1, 3, 1, 5], np.int32)
    hist = np.array([900, 700, 400, 1000, 600, 850], np.int32)
    spans = [(64, 640), (0, 480), (0, 0), (160, 896), (0, 0), (32, 96)]
    R = len(q_len)
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    T = int(q_len.sum())
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    tables = tables.astype(np.int32)
    dev = torch.device("cuda")
    kp = torch.from_numpy(rng.standard_normal((L, N, P, KVH, D))).float()
    vp = torch.from_numpy(rng.standard_normal((L, N, P, KVH, D))).float()
    kw = {}
    if quantized:
        (kp, ks), (vp, vs) = tquant.quantize_kv(kp), tquant.quantize_kv(vp)
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    kp, vp = kp.to(dev), vp.to(dev)
    owners, lens, idx = [], [], []
    tiered = tables.copy()
    for r, (lo, hi) in enumerate(spans):
        tiered[r, lo // P:hi // P] = 0
        for a in range(lo // P, hi // P, Ct // P):
            pg = tables[r, a:min(a + Ct // P, hi // P)]
            owners.append(r)
            lens.append(len(pg) * P)
            idx.append(np.pad(pg, (0, Ct // P - len(pg))))
    owners.append(-1)
    lens.append(Ct)
    idx.append(tables[2, :Ct // P])
    if edge:
        # empty chunks: row 0's among its own, row 2 (resident), and
        # row 5's only chunk emptied -- its span then holds no keys at all
        for at, r in ((3, 0), (len(owners) - 1, 2)):
            owners.insert(at, r)
            lens.insert(at, 0)
            idx.insert(at, tables[r, :Ct // P])
        lens[owners.index(5)] = 0
    nC = len(owners)
    gather = torch.from_numpy(np.stack(idx).astype(np.int64)).to(dev)

    def slab(pool):
        out = pool[:, gather].reshape((L, nC, Ct) + tuple(pool.shape[3:]))
        for c, n in enumerate(lens):
            out[:, c, n:] = 0
        return out.contiguous()

    up = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)  # noqa: E731
    cold = dict(span_lo=up([s[0] for s in spans]),
                span_hi=up([s[1] for s in spans]), cold_k=slab(kp),
                cold_v=slab(vp), cold_row=up(owners), cold_len=up(lens))
    if quantized:
        cold.update(cold_k_scale=slab(kw["k_scale"]),
                    cold_v_scale=slab(kw["v_scale"]))
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s)).to(dev, dtype)
                 for s in ((T, H, D), (T, KVH, D), (T, KVH, D)))
    head = (q, kn, vn, kp, vp, 1, up(t0), up(q_len), up(hist))
    live = torch.from_numpy(np.concatenate(
        [np.arange(s, s + n) for s, n in zip(t0, q_len)])).to(dev)
    return head, up(tiered), up(tables), kw, cold, live


def _check_cold_form(dtype, quantized, D=128, H=8, KVH=2, edge=False):
    """K1's cold form against the plain version (int8: evaluated in f32,
    rounded once) and against the resident call on the same values; a
    chunk's owner moved is caught.  bf16: two launches give the same
    bits, and the pre-pass's work list on the card is the plain one."""
    head, tiered, full, kw, cold, live = _cold_case(
        7, dtype, quantized, D=D, H=H, KVH=KVH, edge=edge)
    form = tpk.K1_INT8_COLD if quantized else tpk.K1_COLD
    before = form.launches
    got = tpk.ragged_paged_attention(*head, tiered, **kw, **cold)
    assert form.launches == before + 1
    if dtype == torch.bfloat16:
        again = tpk.ragged_paged_attention(*head, tiered, **kw, **cold)
        assert torch.equal(got[live], again[live])
        lists = [cold["span_lo"], cold["span_hi"], cold["cold_row"],
                 cold["cold_len"]]
        maxP, P = tiered.shape[1], head[3].shape[2]
        Ct = cold["cold_k"].shape[2]
        want_list = tpk.k1_cold_worklist(
            head[8].cpu().numpy(), *(x.cpu().numpy() for x in lists), maxP,
            P, Ct)
        assert tpk.k1_cold_worklist_device(head[8], *lists, maxP, P,
                                           Ct) == want_list
    if quantized:
        q, kn, vn, *rest = head
        want = tpk.ragged_paged_attention_plain(
            q.float(), kn.float(), vn.float(), *rest, tiered, **kw,
            **cold).to(dtype)
    else:
        want = tpk.ragged_paged_attention_plain(*head, tiered, **kw, **cold)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    resident = tpk.ragged_paged_attention(*head, full, **kw)
    # edge: row 5 (the last 5 tokens) has no staged keys for its span
    same = live[:-5] if edge else live
    torch.testing.assert_close(got[same].float(), resident[same].float(),
                               **TOL[dtype])
    moved = cold["cold_row"].clone()
    moved[0] = 1
    wrong = tpk.ragged_paged_attention(*head, tiered, **kw,
                                       **dict(cold, cold_row=moved))
    assert (wrong[live].float() - want[live].float()).abs().max() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_cold_form(cuda, dtype, quantized):
    """K1's cold form at head dim 128 (the served Llama's)."""
    _check_cold_form(dtype, quantized)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 96])
def test_ragged_kernel_cold_form_head_dims(cuda, head_dim, quantized):
    """K1's cold form at every other head dim the resident form takes."""
    _check_cold_form(torch.bfloat16, quantized, D=head_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,KVH", [(2, 2), (8, 2), (16, 2)])
def test_ragged_kernel_cold_form_edges_and_groups(cuda, H, KVH, quantized):
    """The bf16 cold form at groups 1, 4 and 8 on the edge layouts: empty
    chunks among the live ones, a resident row owning only an empty
    chunk, a tiered row whose chunks are all empty."""
    _check_cold_form(torch.bfloat16, quantized, H=H, KVH=KVH, edge=True)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 96, 128])
def test_ragged_kernel_cold_form_resources(cuda, head_dim, quantized):
    """The bf16 cold form's main kernel spills nothing and fits at least
    one block per SM at every head dim."""
    info = tpk.ragged_kernel_info(8, 32, 8, head_dim, 16, 512,
                                  quantized=quantized, cold=True)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


def _tiered_engines(cuda, kv_dtype):
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params

    # the tiny model's head dim 16: the cold form takes every K1 head dim
    cfg = ModelConfig.tiny(vocab_size=256, dtype="float32")
    params = init_params(cfg, 0, device=cuda)
    geom = dict(max_decode_batch=2, page_size=16, num_pages=128,
                max_pages_per_seq=64, max_prefill_len=64,
                kv_cache_dtype=kv_dtype)
    tier = dict(host_pool_bytes=64 << 20, ctx_hot_pages=2,
                ctx_stream_pages=2)
    return (Engine(cfg, params, EngineConfig(**geom), device=cuda),
            Engine(cfg, params, EngineConfig(**geom, **tier), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_tiered_engine_launches_the_cold_form(cuda, kv_dtype):
    """A tiered engine on the card: the resident engine's tokens, one
    launch of K1's cold form per tiered layer-step (every attention call
    that carries cold chunks), the plain version never; a tiered decode
    step's dispatch makes no synchronising call."""
    from helix_tpu_torch.engine.engine import Request
    from helix_tpu_torch.engine.sampling import SamplingParams

    resident, tiered = _tiered_engines(cuda, kv_dtype)
    prompt = [((i * 37) % 200) + 4 for i in range(600)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    want = resident.generate([prompt], sp)[0]
    form = tpk.K1_INT8_COLD if kv_dtype == "int8" else tpk.K1_COLD
    calls = [0]
    attn = tiered._paged_attn

    def spy(*a, **k):
        if len(a) > 8 and a[8] is not None:
            calls[0] += 1
        return attn(*a, **k)

    tiered._paged_attn = spy
    plain = tpk.ragged_paged_attention_plain
    tpk.ragged_paged_attention_plain = None   # the card never runs it
    before = form.launches
    try:
        req = Request(id="t", prompt_tokens=prompt, sampling=sp)
        tiered.add_request(req)
        while tiered.num_ctx_demoted_pages == 0 or len(req.output_tokens) < 4:
            tiered.step()
        for _ in range(4):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                emitted, pend = tiered.step_dispatch()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert pend is not None and pend.kind == "decode"
            tiered.step_complete(pend, emitted)
        while tiered.has_work():
            tiered.step()
    finally:
        tpk.ragged_paged_attention_plain = plain
    assert req.output_tokens == want
    assert tiered.num_ctx_demoted_pages > 0 and calls[0] > 0
    assert form.launches - before == calls[0]


# ---------------------------------------------------------------------------
# Qwen2-VL: group 7 (H 28, KVH 4), the vision tower, the VL engine
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,valid", [(256, 200), (1024, 640), (2048, 1275)])
def test_flash_kernel_group7_vl_prefill(cuda, dtype, S, valid):
    """K2 as the VL single-shot prefill calls it at Qwen2-VL-7B's widths:
    B 1, H 28 over KVH 4 (group 7), D 128, causal by sequence index, a
    validity segment over the prompt and padding to the bucket; one key
    too few breaks the limit."""
    rng = np.random.default_rng(S + valid)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(cuda, dtype) for sh in ((1, S, 28, 128), (1, S, 4, 128),
                                           (1, S, 4, 128)))
    pos = torch.arange(S, device=cuda)[None]
    seg = (pos < valid).to(torch.int32)
    kw = dict(causal=True, q_positions=pos, kv_positions=pos,
              q_segment_ids=seg, kv_segment_ids=seg)
    got = tatt.flash_attention(q, k, v, **kw)
    want = tatt.flash_attention_plain(q, k, v, **kw)
    if dtype == torch.bfloat16:
        limit = tatt.flash_error_limit(q, k, v, **kw)
        _within_flash_limit(got, want, limit)
    else:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        limit = TOL[dtype]["atol"] + 0 * want.float()
    bad = tatt.flash_attention(q, k, v, **{**kw, "kv_positions": pos + 1})
    assert ((bad.float() - want.float()).abs() > limit).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_group7_matches_plain(cuda, dtype):
    """K1 at group 7 (28 of a query tile's 32 rows: 4 tokens x 7 heads)
    on ragged rows of 0-19 tokens over paged histories."""
    f, i, live = _ragged(77, 2, 160, 16, 4, 128, 28, 16, 8)
    f = [torch.from_numpy(x).to(cuda, dtype) for x in f]
    i = [torch.from_numpy(x).to(cuda) for x in i]
    got = tpk.ragged_paged_attention(*f, 1, *i)
    want = tpk.ragged_paged_attention_plain(*f, 1, *i)
    live = torch.from_numpy(live).to(cuda)
    assert torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 5])
def test_ragged_kernel_group7_decode_and_verify(cuda, dtype, quantized, W):
    """K1 (both pool forms) at group 7 on decode rows (W 1) and verify
    rows (W 5: 4 tokens of 7 heads per query tile, a row across two
    tiles) at histories beside the split's edges; a history slot too
    many or too few breaks the limit."""
    hists = [1300, 511, 512, 513, 2047, 3999, 1, 2600]
    fresh, pools, meta, kw, live = _verify_rows(
        hists, dtype, cuda, quantized, D=128, H=28, KVH=4, W=W)
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta, **kw)
    if quantized:
        want = _int8_plain(fresh, pools, (kw["k_scale"], kw["v_scale"]),
                           meta, 1)
    else:
        want = tpk.ragged_paged_attention_plain(*fresh, *pools, 1, *meta)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    for d in (-1, 1):
        bad = tpk.ragged_paged_attention(*fresh, *pools, 1, *meta[:2],
                                         (meta[2] + d).clamp(min=0),
                                         meta[3], **kw)
        assert _breaks_limit(bad[live], want[live], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_vision_tower_on_card_matches_cpu(cuda, weights):
    """The Qwen2-VL-7B tower at full width and 2 blocks, float32
    activations (TF32 off) on float32 or bf16 weights, two images in one
    call: card against the same code on CPU tensors (float32 summation
    order, atol 1e-4 on values up to ~6)."""
    from helix_tpu_torch.models import qwen2_vl as vl
    from helix_tpu_torch.models.llama import params_to

    assert not torch.backends.cuda.matmul.allow_tf32
    vc = vl.VisionConfig(depth=2)
    vp = vl.init_vision_params(vc, 3, device="cpu", dtype=weights)
    grid = np.array([[1, 16, 20], [1, 8, 8]])
    patches = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (int(grid.prod(axis=1).sum()), vc.patch_dim)).astype(np.float32))
    want = vl.vision_forward(vp, vc, patches, grid)
    got = vl.vision_forward(params_to(vp, cuda), vc, patches.to(cuda), grid)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_vl_engine_on_card_matches_cpu(cuda):
    """A tiny Qwen2-VL text tower (mrope 2/3/3, group 2) in float32 on the
    card and on the CPU: a one-image prompt, a two-image prompt and a
    text-only prompt decode the same greedy ids; K2 ran the single-shot
    prefills and K1 the decode rows."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models import qwen2_vl as vl
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params, params_to

    cfg = ModelConfig.tiny(dtype="float32", attention_bias=True,
                           mrope_sections=(2, 3, 3), vocab_size=300)
    params = init_params(cfg, 5, device="cpu")
    vc = vl.VisionConfig.tiny(hidden_size=cfg.hidden_size)
    vp = vl.init_vision_params(vc, 6, device="cpu")
    rng = np.random.default_rng(7)
    specs = []
    for grid, text in (([[1, 4, 4]], [1, 2]), ([[1, 4, 4], [1, 2, 4]], [3]),
                       (None, [5, 6, 7, 8])):
        ids = list(text)
        if grid is not None:
            for g in grid:
                ids += [265] + [264] * (g[1] * g[2] // 4) + [266]
            n = int(np.prod(np.array(grid), axis=1).sum())
            emb = vl.vision_forward(vp, vc, torch.from_numpy(
                rng.standard_normal((n, vc.patch_dim)).astype(np.float32)),
                np.array(grid))
        else:
            emb = None
        pos3, delta = vl.mrope_positions(ids, None if grid is None
                                         else np.array(grid), 264)
        specs.append(dict(prompt_tokens=ids + [9], positions3=np.concatenate(
            [pos3, pos3[:, -1:] + 1], axis=1), mrope_delta=delta,
            image_embeds=emb, image_positions=None if emb is None else
            [i for i, t in enumerate(ids) if t == 264]))
    ecfg = EngineConfig(max_decode_batch=4, page_size=4, num_pages=64,
                        max_pages_per_seq=16, max_prefill_len=64)
    outs = []
    before = (tpk.K1.launches, tatt.K2.launches)
    for dev, p in (("cpu", params), ("cuda", params_to(params, cuda))):
        eng = Engine(cfg, p, ecfg, device=dev)
        reqs = []
        for i, s in enumerate(specs):
            f = dict(s)
            if f["image_embeds"] is not None:
                f["image_embeds"] = f["image_embeds"].to(dev)
            reqs.append(Request(id=f"r{i}", sampling=SamplingParams(
                temperature=0.0, max_tokens=8), **f))
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert tpk.K1.launches > before[0] and tatt.K2.launches > before[1]



# ---------------------------------------------------------------------------
# mixture of experts (Mixtral): the layer and the engine's dispatch
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quantized", [("float32", False),
                                             ("bfloat16", True)])
def test_moe_layer_on_card_matches_cpu(cuda, dtype, quantized):
    """``moe_ffn`` on the card against its CPU path on the same inputs
    (8 experts, top 2, E 512, F 1024): a prefill shape whose capacity
    factor drops assignments and a decode shape (dropless), drop counts
    equal; float32 (TF32 off) within 1e-5.  int8 experts on bf16
    activations: ``act(gate) * up`` rounds to bf16 before ``w_down``, and
    the card's GEMM sums its float32 product in another order than the
    CPU, so now and then an intermediate lands one bf16 ulp away and
    moves the outputs of its token by up to ``|w_down| * ulp`` (seen:
    1.2e-4 of values up to ~1.3).  They are held to one bf16 ulp of the
    value plus ``2**-10 * max |value|``.  A token masked out takes no
    capacity on either side."""
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.moe import moe_ffn

    X, E, F = 8, 512, 1024
    cfg = ModelConfig.tiny(num_experts=X, expert_capacity_factor=0.75,
                           dtype=dtype)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(13)
    router = torch.from_numpy((rng.standard_normal((E, X)) * 0.05)
                              .astype(np.float32))
    mats = {k: {"weight": torch.from_numpy(
        (rng.standard_normal(s) * 0.03).astype(np.float32)).to(dt)}
        for k, s in (("w_gate", (X, E, F)), ("w_up", (X, E, F)),
                     ("w_down", (X, F, E)))}
    if quantized:
        mats = {k: tquant.quantize_tensor(v["weight"]) for k, v in mats.items()}
    on_card = {k: {kk: vv.to(cuda) for kk, vv in v.items()}
               for k, v in mats.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B, S in ((1, 256), (16, 1)):
            x = torch.from_numpy(rng.standard_normal((B, S, E)).astype(
                np.float32)).to(dt)
            mask = torch.ones((B, S), dtype=torch.bool)
            mask[0, -3:] = False
            act = torch.nn.functional.silu
            want, wd = moe_ffn(x, router, mats, cfg, act, token_mask=mask,
                               return_dropped=True)
            got, gd = moe_ffn(x.to(cuda), router.to(cuda), on_card, cfg,
                              act, token_mask=mask.to(cuda),
                              return_dropped=True)
            assert int(gd) == int(wd)
            assert (int(wd) > 0) == (S > 1)
            tol = (dict(atol=2.0 ** -10 * float(want.float().abs().max()),
                        rtol=2.0 ** -7) if quantized
                   else dict(atol=1e-5, rtol=0))
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       **tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_moe_prefill_and_decode_dispatch_make_no_synchronising_call(cuda):
    """An MoE engine's mixed step (a long prompt's chunk through the
    experts beside decode rows) and its decode steps queue their work
    without a synchronising call: the capacity comes from shapes, the
    drop counts queue as device scalars.  Its ids equal the CPU's
    (float32), and the drops drained at the end are the CPU's."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params, params_to

    cfg = ModelConfig.tiny(num_experts=4, expert_capacity_factor=0.5,
                           dtype="float32")
    params = init_params(cfg, 3, device="cpu")
    ecfg = EngineConfig(max_decode_batch=4, page_size=16, num_pages=64,
                        max_pages_per_seq=8, max_prefill_len=32)
    prompts = [[3, 4, 5, 6, 7], [(i * 7) % 200 + 1 for i in range(90)]]
    outs = []
    for dev, p in (("cpu", params), ("cuda", params_to(params, cuda))):
        eng = Engine(cfg, p, ecfg, device=dev)
        reqs = [Request(id=f"m{i}", prompt_tokens=pr, sampling=SamplingParams(
            temperature=0.0, max_tokens=12)) for i, pr in enumerate(prompts)]
        eng.add_request(reqs[0])
        eng.step()
        eng.add_request(reqs[1])
        kinds = []
        while eng.has_work():
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                emitted, pend = eng.step_dispatch()
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
            if pend is not None:
                kinds.append(pend.kind)
                eng.step_complete(pend, emitted)
        eng._drain_moe_drops()
        assert "mixed" in kinds and "decode" in kinds
        outs.append(([r.output_tokens for r in reqs],
                     eng.moe_dropped_tokens))
    assert outs[1] == outs[0]
    assert outs[0][1] > 0


# ---------------------------------------------------------------------------
# K2-backward, K2's LSE and the autograd Function (training)
# ---------------------------------------------------------------------------


def _bwd_inputs(cuda, dtype, B, S, H, KVH, D, seed, cap=None):
    """Packed rows (positions restart per segment, padding at the end),
    q/k/v/dO in ``dtype`` on the card, and the keywords."""
    (q, k, v), pos, seg = _packed(B, S, H, KVH, D, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    args = [torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v)]
    dout = torch.from_numpy(g).to(cuda, dtype)
    t = {n: torch.from_numpy(a).to(cuda) for n, a in
         (("pos", pos), ("seg", seg))}
    kw = dict(q_positions=t["pos"], kv_positions=t["pos"],
              q_segment_ids=t["seg"], kv_segment_ids=t["seg"],
              logits_soft_cap=cap)
    return args, dout, kw


def _grad_ratios(got, want, limits):
    return [((g.float() - w.float()).abs() / lim).max().item()
            for g, w, lim in zip(got, want, limits)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,KVH,S,cap", [
    (128, 8, 8, 150, None),    # group 1, ragged last tile
    (128, 8, 2, 200, None),    # group 4
    (128, 14, 2, 130, 2.5),    # group 7, soft cap
    (64, 8, 2, 97, None),
    (96, 4, 1, 70, 4.0),       # group 4 at one KV head, padded head dim
    (16, 4, 4, 64, None),      # exactly one tile
    (32, 8, 2, 129, None),
])
def test_flash_backward_matches_plain(cuda, dtype, D, H, KVH, S, cap):
    """K2-backward's dq / dk / dv against autograd through the plain
    version on the same inputs (f32 arithmetic both), per element within
    ``flash_backward_error_limit`` (its docstring derives it: f32
    summation noise, the Delta the kernel takes from K2's own O, one
    rounding)."""
    args, dout, kw = _bwd_inputs(cuda, dtype, 2, S, H, KVH, D,
                                 seed=D + S + H, cap=cap)
    out, lse = tatt.flash_attention_lse(*args, **kw)
    before = tatt.K2B.launches
    got = tatt.flash_attention_backward(*args, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert tatt.K2B.launches == before + 1
    want = tatt.flash_backward_plain(*args, dout, **kw)
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
    ratios = _grad_ratios(got, want, limits)
    assert max(ratios) <= 1.0, dict(zip(("dq", "dk", "dv"), ratios))


def _planted_backward(fault, args, out, lse, dout, kw):
    """K2-backward with one defect planted through its inputs, to be held
    against the plain version of the true inputs: every query head read
    against the next KV head (k and v rolled over their heads), the
    causal mask dropped, Delta left out (O = 0); the cap's derivative,
    which no input can drop, through the wrapper's check-only switch."""
    q, k, v = args
    if fault == "wrong_kv_head":
        k, v = k.roll(1, dims=2), v.roll(1, dims=2)
    if fault == "no_causal":
        kw = {**kw, "causal": False}
    if fault == "no_delta":
        out = torch.zeros_like(out)
    return tatt.flash_attention_backward(
        q, k, v, out, lse, dout, **kw,
        _drop_cap_derivative=fault == "no_cap_derivative")


BACKWARD_FAULTS = ("wrong_kv_head", "no_causal", "no_delta",
                   "no_cap_derivative")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", BACKWARD_FAULTS)
def test_flash_backward_planted_faults_fail(cuda, dtype, fault):
    """Each planted defect breaks the limit the real kernel keeps: a query
    head read against the wrong KV head, the causal mask dropped, Delta
    left out, the cap's derivative dropped."""
    args, dout, kw = _bwd_inputs(cuda, dtype, 2, 160, 8, 2, 128, seed=5,
                                 cap=2.0)
    out, lse = tatt.flash_attention_lse(*args, **kw)
    want = tatt.flash_backward_plain(*args, dout, **kw)
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    good = tatt.flash_attention_backward(*args, out, lse, dout, **kw)
    assert max(_grad_ratios(good, want, limits)) <= 1.0
    bad = _planted_backward(fault, args, out, lse, dout, kw)
    assert max(_grad_ratios(bad, want, limits)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give bit-equal dq, dk and dv: no
    atomics, every sum in a fixed order (the bf16 form recomputes S and dP
    in its dQ kernel rather than accumulate dQ across blocks)."""
    args, dout, kw = _bwd_inputs(cuda, dtype, 2, 200, 8, 2, 128, seed=13,
                                 cap=2.0)
    out, lse = tatt.flash_attention_lse(*args, **kw)
    first = tatt.flash_attention_backward(*args, out, lse, dout, **kw)
    second = tatt.flash_attention_backward(*args, out, lse, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_backward_full_heads(cuda):
    """K2-backward's bf16 form at Llama-3-8B's full head count (B 1, S
    1024, H 32 / KVH 8, D 128, packed rows): within the limit per
    element, as at the smaller shapes."""
    args, dout, kw = _bwd_inputs(cuda, torch.bfloat16, 1, 1024, 32, 8, 128,
                                 seed=17)
    out, lse = tatt.flash_attention_lse(*args, **kw)
    got = tatt.flash_attention_backward(*args, out, lse, dout, **kw)
    want = tatt.flash_backward_plain(*args, dout, **kw)
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    ratios = _grad_ratios(got, want, limits)
    assert max(ratios) <= 1.0, dict(zip(("dq", "dk", "dv"), ratios))


@pytest.mark.cuda
@pytest.mark.parametrize("D", tatt.SUPPORTED_HEAD_DIMS)
def test_flash_backward_kernel_resources(cuda, D):
    """Both kernels of the bf16 form keep every value in registers (0
    spill bytes) and fit an SM at the training length; the float32 form's
    fit too."""
    for dtype in (torch.bfloat16, torch.float32):
        info = tatt.flash_backward_kernel_info(D, dtype, S=1024)
        for which, r in info.items():
            assert r["blocks_per_sm"] >= 1, (dtype, which, r)
            if dtype == torch.bfloat16:
                assert r["spill_bytes"] == 0, (which, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_matches_logsumexp(cuda, dtype):
    """K2's LSE output against ``torch.logsumexp`` of the plain version's
    masked logits (atol 1e-4: an f32 online softmax against one f32
    softmax); a row with no live key is +inf; the output equals the
    serving call's, which writes no LSE."""
    args, _, kw = _bwd_inputs(cuda, dtype, 2, 200, 8, 2, 128, seed=9,
                              cap=None)
    out, lse = tatt.flash_attention_lse(*args, **kw)
    _, want = tatt.flash_attention_lse_plain(*args, **kw)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=0)
    assert torch.equal(out, tatt.flash_attention(*args, **kw))
    # queries placed before every key: rows 0-4 see no live key
    S = args[0].shape[1]
    qpos = torch.arange(S, device=cuda)[None].expand(2, S)
    masked = dict(q_positions=qpos, kv_positions=qpos + 5)
    _, lse2 = tatt.flash_attention_lse(*args, **masked)
    _, want2 = tatt.flash_attention_lse_plain(*args, **masked)
    assert torch.isinf(lse2[:, :, :5]).all()
    assert torch.isinf(want2[:, :, :5]).all()
    torch.testing.assert_close(lse2[:, :, 5:], want2[:, :, 5:], atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_forward_equals_serving_call(cuda, dtype):
    """Under grad, ``flash_attention`` goes through ``FlashAttentionFn``:
    its output is bit-equal to the serving call's, K2 counts one launch
    each, and backward launches K2-backward once with the gradients of
    the direct call."""
    args, dout, kw = _bwd_inputs(cuda, dtype, 2, 150, 8, 2, 128, seed=11)
    with torch.no_grad():
        served = tatt.flash_attention(*args, **kw)
    leaves = [a.clone().requires_grad_() for a in args]
    k2, k2b = tatt.K2.launches, tatt.K2B.launches
    out = tatt.flash_attention(*leaves, **kw)
    assert tatt.K2.launches == k2 + 1 and torch.equal(out, served)
    out.backward(dout)
    assert tatt.K2B.launches == k2b + 1
    o2, lse = tatt.flash_attention_lse(*args, **kw)
    direct = tatt.flash_attention_backward(*args, o2, lse, dout, **kw)
    for leaf, d in zip(leaves, direct):
        assert torch.equal(leaf.grad, d)


@pytest.mark.cuda
def test_matmul_f32_gradients_on_card(cuda):
    """``matmul_f32`` under autograd on bf16 operands: the float32-output
    GEMM forward; the input and weight gradients taken from the float32
    cotangent, as the CPU path and JAX's transpose take them.  The
    cotangent is 256 + N(0, 1), whose bf16 rounding keeps nothing of the
    noise, against x with paired rows and w with paired columns that
    cancel the 256 exactly: the gradients are the noise's alone.  Held to
    float64 products rounded once to bf16, per element within one bf16
    ulp, 1e-5 + 2**-7 |want|, plus the float32 sum's order bound, n u
    sum |terms| <= 2**-16 sum |terms| for n <= 256 terms; the cotangent
    rounded to bf16 first lands far outside that."""
    rng = np.random.default_rng(4)
    xh = rng.standard_normal((60, 256)).astype(np.float32)
    wh = rng.standard_normal((256, 48)).astype(np.float32) * 0.05
    x64 = torch.from_numpy(np.concatenate([xh, -xh])).bfloat16().double()
    w64 = torch.from_numpy(np.concatenate([wh, -wh], 1)).bfloat16().double()
    g = torch.from_numpy(256.0 + rng.standard_normal((120, 96)).astype(
        np.float32))
    x = x64.to(cuda, torch.bfloat16).reshape(3, 40, 256).requires_grad_()
    w = w64.to(cuda, torch.bfloat16).requires_grad_()
    out = tquant.matmul_f32(x, w)
    assert out.dtype == torch.float32
    out.backward(g.to(cuda).reshape(3, 40, 96))
    g64, g16 = g.double(), g.bfloat16().double()
    cases = ((x.grad.reshape(120, 256), g64 @ w64.T,
              g64.abs() @ w64.abs().T, g16 @ w64.T),
             (w.grad, x64.T @ g64, x64.abs().T @ g64.abs(), x64.T @ g16))
    for got, exact, mag, coarse in cases:
        assert got.dtype == torch.bfloat16
        want = exact.to(torch.bfloat16).double()
        limit = 1e-5 + 2.0 ** -7 * want.abs() + 2.0 ** -16 * mag
        assert ((got.double().cpu() - want).abs() <= limit).all()
        assert ((coarse - want).abs() > limit).any()


@pytest.mark.cuda
def test_trainer_steps_on_card_match_cpu(cuda):
    """Three LoRA SFT steps of a 2-layer float32 model on the card (K2 and
    K2-backward through ``FlashAttentionFn``, TF32 off) against the same
    steps on the CPU (autograd through the plain version), as
    ``chip_smoke.py``'s witness holds them: each loss within 1e-6
    relative and the adapters' update within 2% of its L2 norm (Adam's
    first step of an entry is +-lr, so an entry whose gradient lies
    inside the summation noise may step the other way, and the next
    step's gradients see it: no per-element limit holds)."""
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params, params_to
    from helix_tpu_torch.training import sft as tsft
    from helix_tpu_torch.training.data import SFTExample, pack_examples
    from helix_tpu_torch.training.lora import init_lora_params

    cfg = ModelConfig.tiny(dtype="float32", hidden_size=256, num_heads=8,
                           num_kv_heads=2, head_dim=32, intermediate_size=512,
                           vocab_size=512)
    params = init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(8)
    exs = [SFTExample(input_ids=[int(x) for x in rng.integers(4, 500, n)],
                      loss_mask=[int(x) for x in rng.random(n) < 0.7])
           for n in rng.integers(20, 90, 10)]
    batch = next(pack_examples(exs, 2, 160, shuffle_seed=0))
    conf = tsft.SFTConfig(learning_rate=5e-3, warmup_steps=1, total_steps=3,
                          batch_size=2, seq_len=160)
    start = init_lora_params(cfg, conf.lora, 0, device="cpu")
    runs = []
    k2, k2b = tatt.K2.launches, tatt.K2B.launches
    for p, dev in ((params, "cpu"), (params_to(params, cuda), cuda)):
        tr = tsft.SFTTrainer(cfg, p, conf)
        tr.lora_params = {t: {n: x.to(dev).clone() for n, x in f.items()}
                          for t, f in start.items()}
        losses = [tr.train_step(batch) for _ in range(3)]
        runs.append((losses, tr.lora_params))
    assert tatt.K2.launches - k2 == 3 * cfg.num_layers
    assert tatt.K2B.launches - k2b == 3 * cfg.num_layers
    (lc, pc), (lg, pg) = runs
    for a, b in zip(lg, lc):
        assert abs(a - b) <= 1e-6 * abs(b), (lg, lc)
    num = den = 0.0
    for t in pc:
        for n in pc[t]:
            num += float(((pg[t][n].cpu() - pc[t][n]) ** 2).sum())
            den += float(((pc[t][n] - start[t][n]) ** 2).sum())
    assert (num / den) ** 0.5 <= 2e-2


# ---------------------------------------------------------------------------
# tensor parallel: the kernels at a shard's shape on every card, the sums
# ---------------------------------------------------------------------------


def _card(cuda, index):
    n = torch.cuda.device_count()
    if index >= n:
        pytest.skip(f"needs {index + 1} cards: {n} visible")
    return torch.device("cuda", index)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_shard_shape_kernels_on_every_card(cuda, index):
    """K1-int8 and K2 at a tp 4 shard of Llama-3-8B (H 8, KVH 2, D 128,
    bf16) on card ``index`` while the current device stays card 0:
    within their limits, counted, and a planted fault (one history slot
    too many; each query's own key dropped) breaks the limit."""
    card = _card(cuda, index)
    assert torch.cuda.current_device() == 0
    fresh, pools, scales, i, live = _ragged_int8(
        40 + index, torch.bfloat16, card, D=128, H=8, KVH=2)
    before = tpk.K1_INT8.launches
    got = tpk.ragged_paged_attention(*fresh, *pools, 1, *i,
                                     k_scale=scales[0], v_scale=scales[1])
    assert tpk.K1_INT8.launches == before + 1 and got.device == card
    want = _int8_plain(fresh, pools, scales, i, 1)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[torch.bfloat16])
    bad = tpk.ragged_paged_attention(*fresh, *pools, 1, *i[:2], i[2] + 1,
                                     i[3], k_scale=scales[0],
                                     v_scale=scales[1])
    assert _breaks_limit(bad[live], want[live], torch.bfloat16)
    (q, k, v), pos, seg = _packed(2, 300, 8, 2, 128, seed=index)
    args = [torch.from_numpy(x).to(card, torch.bfloat16) for x in (q, k, v)]
    t = {n: torch.from_numpy(a).to(card) for n, a in
         (("pos", pos), ("seg", seg))}
    kw = dict(q_positions=t["pos"], kv_positions=t["pos"],
              q_segment_ids=t["seg"], kv_segment_ids=t["seg"])
    before = tatt.K2.launches
    got = tatt.flash_attention(*args, **kw)
    assert tatt.K2.launches == before + 1 and got.device == card
    want = tatt.flash_attention_plain(*args, **kw)
    limit = tatt.flash_error_limit(*args, **kw)
    live2 = t["seg"] > 0
    _within_flash_limit(got, want, limit, live2)
    bad = tatt.flash_attention(*args, **{**kw, "kv_positions": t["pos"] + 1})
    assert ((bad.float() - want.float()).abs() > limit)[live2].any()
    torch.cuda.synchronize(card)
    assert torch.cuda.current_device() == 0


def _sum_devices(cuda):
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(4)] if n >= 4
            else [torch.device("cuda", 0)] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 4096])
def test_f32_sum_bit_equal_on_every_card(cuda, rows):
    """The row-parallel sum over 4 shards (cards 0-3 when four are
    visible, else card 0 four times): every card gets the same bf16
    bits, those of the float32 partials added in shard order and rounded
    once."""
    from helix_tpu_torch.parallel import collectives

    devs = _sum_devices(cuda)
    gen = torch.Generator().manual_seed(rows)
    host = [torch.randn((rows, 512), generator=gen) for _ in devs]
    parts = [h.to(d) for h, d in zip(host, devs)]
    got = collectives.all_reduce(parts, devs, torch.bfloat16)
    want = (((host[0] + host[1]) + host[2]) + host[3]).bfloat16()
    for g, d in zip(got, devs):
        assert g.device == d
        assert torch.equal(g.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_tp4_engine_greedy_equals_tp1_on_card(cuda):
    """A 2-layer float32 engine at tp 4 (cards 0-3, else card 0 four
    times) gives the tp 1 engine's greedy ids on the card (TF32 off),
    with K1 and K2 launched once per shard per layer per forward."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import (
        init_params,
        param_logical_axes,
    )
    from helix_tpu_torch.parallel.sharding import shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(dtype="float32", hidden_size=512, num_heads=16,
                           num_kv_heads=4, head_dim=32, intermediate_size=1024,
                           vocab_size=1024)
    params = init_params(cfg, 3, device=cuda)
    ecfg = dict(max_decode_batch=8, page_size=16, num_pages=256,
                max_pages_per_seq=16, max_prefill_len=64)
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(4, 1000, n)]
               for n in (5, 40, 90, 17, 130, 3, 64, 77)]
    s = SamplingParams(temperature=0.0, max_tokens=12)
    one = Engine(cfg, params, EngineConfig(**ecfg), device=cuda)
    want = one.generate(prompts, s)
    mesh = build_mesh(MeshSpec(tp=4), _sum_devices(cuda))
    tp = Engine(cfg, shard_params(params, mesh, param_logical_axes(cfg)),
                EngineConfig(**ecfg), mesh=mesh)
    k1, k2 = tpk.K1.launches, tatt.K2.launches
    got = tp.generate(prompts, s)
    assert got == want
    calls = tp.attn_forwards
    assert tpk.K1.launches - k1 == 4 * cfg.num_layers * calls["k1"]
    assert tatt.K2.launches - k2 == 4 * cfg.num_layers * calls["k2"]


@pytest.mark.cuda
@pytest.mark.parametrize("quantization", [None, "int8"])
def test_checkpoint_loads_shard_by_shard_on_card(cuda, tmp_path,
                                                 quantization):
    """``load_params(..., mesh=)`` on the card (cards 0-3, else card 0
    four times): every shard equals ``shard_params`` of the whole load
    on the card, byte for byte, and lies on its shard's card."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params, param_logical_axes
    from helix_tpu_torch.models.loader import load_params
    from helix_tpu_torch.parallel.sharding import shard_params
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    cfg = ModelConfig.tiny(dtype="bfloat16", num_heads=8, num_kv_heads=4)
    write_checkpoint(str(tmp_path), cfg, init_params(cfg, 4, device="cpu"),
                     max_shard_bytes=40_000)
    lcfg, whole = load_params(str(tmp_path), device=cuda,
                              quantization=quantization)
    mesh = build_mesh(MeshSpec(tp=4), _sum_devices(cuda))
    _, shards = load_params(str(tmp_path), quantization=quantization,
                            mesh=mesh)
    axes = param_logical_axes(lcfg)
    if quantization:
        axes = tquant.quantized_logical_axes(axes)
    want = shard_params(whole, mesh, axes)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    for i, dev in enumerate(mesh.devices):
        got = dict(leaves(shards[i]))
        for path, t in leaves(want[i]):
            assert got[path].device == dev, path
            assert torch.equal(got[path].view(torch.uint8) if
                               got[path].dtype == torch.bfloat16
                               else got[path],
                               t.view(torch.uint8) if t.dtype ==
                               torch.bfloat16 else t), path


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2])
def test_checkpoint_loads_onto_a_later_card(cuda, tmp_path, monkeypatch, tp):
    """A checkpoint loaded onto a slice that starts at card 1 (``tp`` 1:
    the card a tp 1 entry at ``device_offset: 1`` loads onto; ``tp`` 2:
    a mesh over cards 1-2) while card 0 stays current, through many small
    double-buffered staging blocks: each shard equals ``shard_params`` of
    the whole load on card 0, byte for byte."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh
    from helix_tpu_torch.models import loader
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.llama import init_params, param_logical_axes
    from helix_tpu_torch.parallel.sharding import shard_params
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    _card(cuda, tp)                 # cards 0 .. tp must be visible
    monkeypatch.setattr(loader, "STAGE_BYTES", 16 << 10)
    cfg = ModelConfig.tiny(dtype="bfloat16", num_heads=8, num_kv_heads=4,
                           hidden_size=256, intermediate_size=1024,
                           vocab_size=4096)
    write_checkpoint(str(tmp_path), cfg, init_params(cfg, 6, device="cpu"),
                     max_shard_bytes=400_000)
    lcfg, whole = loader.load_params(str(tmp_path), device=cuda)
    mesh = build_mesh(MeshSpec(tp=tp, device_offset=1))
    assert torch.cuda.current_device() == 0
    stats = {}
    if tp == 1:
        _, got = loader.load_params(str(tmp_path), device=mesh.devices[0],
                                    stats=stats)
        shards = [got]
    else:
        _, shards = loader.load_params(str(tmp_path), mesh=mesh,
                                       stats=stats)
    assert torch.cuda.current_device() == 0
    assert stats["blocks"] > 100, stats
    want = shard_params(whole, mesh, param_logical_axes(lcfg))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    for i, dev in enumerate(mesh.devices):
        got = dict(leaves(shards[i]))
        for path, t in leaves(want[i]):
            assert got[path].device == dev, path
            assert torch.equal(got[path].view(torch.uint8),
                               t.view(torch.uint8)), path


# ---------------------------------------------------------------------------
# expert parallel: MoE over an {ep: 2, tp: 2} mesh
# ---------------------------------------------------------------------------


def _ep_mesh(cuda):
    """``{ep: 2, tp: 2}`` over cards 0-3 when four are visible, else card
    0 four times (each entry one shard)."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(ep=2, tp=2), _sum_devices(cuda))


def _moe_cfg(**over):
    from helix_tpu_torch.models.common import ModelConfig

    return ModelConfig.tiny(**{
        "dtype": "float32", "hidden_size": 512, "num_heads": 16,
        "num_kv_heads": 4, "head_dim": 32, "intermediate_size": 1024,
        "vocab_size": 1024, "num_experts": 8, "num_experts_per_tok": 2,
        "expert_capacity_factor": 0.5, **over})


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_mixtral_shard_kernels_on_every_card(cuda, index):
    """K1 (float pool) and K2 at a tp 2 shard of Mixtral-8x7B (H 16, KVH
    4, D 128, bf16) on card ``index`` while card 0 stays current: within
    their limits, counted, and a planted fault (one history slot too
    many; each query's own key dropped) breaks the limit."""
    card = _card(cuda, index)
    f, i, live = _ragged(60 + index, 3, 96, 16, 4, 128, 16, 8, 6)
    f = [torch.from_numpy(x).to(card, torch.bfloat16) for x in f]
    i = [torch.from_numpy(x).to(card) for x in i]
    live = torch.from_numpy(live).to(card)
    before = tpk.K1.launches
    got = tpk.ragged_paged_attention(*f, 1, *i)
    assert tpk.K1.launches == before + 1 and got.device == card
    want = tpk.ragged_paged_attention_plain(*f, 1, *i)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[torch.bfloat16])
    bad = tpk.ragged_paged_attention(*f, 1, *i[:2], i[2] + 1, i[3])
    assert _breaks_limit(bad[live], want[live], torch.bfloat16)
    (q, k, v), pos, seg = _packed(1, 600, 16, 4, 128, seed=index)
    args = [torch.from_numpy(x).to(card, torch.bfloat16) for x in (q, k, v)]
    t = {n: torch.from_numpy(a).to(card) for n, a in
         (("pos", pos), ("seg", seg))}
    kw = dict(q_positions=t["pos"], kv_positions=t["pos"],
              q_segment_ids=t["seg"], kv_segment_ids=t["seg"])
    before = tatt.K2.launches
    got = tatt.flash_attention(*args, **kw)
    assert tatt.K2.launches == before + 1 and got.device == card
    want = tatt.flash_attention_plain(*args, **kw)
    limit = tatt.flash_error_limit(*args, **kw)
    live2 = t["seg"] > 0
    _within_flash_limit(got, want, limit, live2)
    bad = tatt.flash_attention(*args, **{**kw, "kv_positions": t["pos"] + 1})
    assert ((bad.float() - want.float()).abs() > limit)[live2].any()
    torch.cuda.synchronize(card)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_moe_routing_identical_on_every_card(cuda):
    """The same replicated tokens routed on every card of the mesh give
    the same top-k, positions, kept slots and drops, bit for bit (each
    card routes for itself; no indices are copied)."""
    from helix_tpu_torch.models import moe

    cfg = _moe_cfg(hidden_size=4096, num_experts=8)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2048, 4096), generator=gen).bfloat16()
    router = (torch.randn((4096, 8), generator=gen) * 0.02).bfloat16()
    mesh = _ep_mesh(cuda)
    first = None
    for dev in mesh.devices:
        got = moe.route(x.to(dev), router.to(dev).float(), cfg, 2048)
        got = [t.cpu() if torch.is_tensor(t) else t for t in got]
        if first is None:
            first = got
            assert int(got[-1]) > 0      # capacity 0.5 drops
            continue
        for a, b in zip(got, first):
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)


@pytest.mark.cuda
def test_mesh_sum_bit_equal_on_every_card(cuda):
    """The MoE layer's sum over the whole ``{ep: 2, tp: 2}`` mesh and the
    attention's over each tp group: every card gets the bf16 bits of the
    float32 shares added in shard order and rounded once, equal within a
    group, and equal across groups whose partials are equal."""
    from helix_tpu_torch.parallel import collectives

    mesh = _ep_mesh(cuda)
    devs = list(mesh.devices)
    gen = torch.Generator().manual_seed(11)
    host = [torch.randn((512, 4096), generator=gen) for _ in devs]
    got = collectives.all_reduce([h.to(d) for h, d in zip(host, devs)],
                                 devs, torch.bfloat16)
    want = (((host[0] + host[1]) + host[2]) + host[3]).bfloat16()
    for g, d in zip(got, devs):
        assert g.device == d
        assert torch.equal(g.cpu().view(torch.int16), want.view(torch.int16))
    pair = host[:2] * 2
    got = collectives.all_reduce_groups(
        [h.to(d) for h, d in zip(pair, devs)], devs, mesh.groups(("tp",)),
        torch.bfloat16)
    want = (host[0] + host[1]).bfloat16()
    for g in got:
        assert torch.equal(g.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_ep_engine_greedy_and_drops_equal_tp1_on_card(cuda):
    """A 2-layer float32 MoE engine over ``{ep: 2, tp: 2}`` (cards 0-3,
    else card 0 four times) gives the single-device engine's greedy ids
    and prefill drop count on the card (TF32 off, capacity factor 0.5),
    with K1 and K2 launched once per shard per layer per forward."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.llama import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg()
    mesh = _ep_mesh(cuda)
    params = init_params(cfg, 3, device=cuda)
    shards = init_params(cfg, 3, mesh=mesh)
    ecfg = dict(max_decode_batch=8, page_size=16, num_pages=256,
                max_pages_per_seq=16, max_prefill_len=64)
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(4, 1000, n)]
               for n in (5, 40, 90, 17, 130, 3, 64, 77)]
    s = SamplingParams(temperature=0.0, max_tokens=12)
    one = Engine(cfg, params, EngineConfig(**ecfg), device=cuda)
    want = one.generate(prompts, s)
    one._drain_moe_drops()
    ep = Engine(cfg, shards, EngineConfig(**ecfg), mesh=mesh)
    k1, k2 = tpk.K1.launches, tatt.K2.launches
    got = ep.generate(prompts, s)
    ep._drain_moe_drops()
    assert got == want
    assert ep.moe_dropped_tokens == one.moe_dropped_tokens > 0
    calls = ep.attn_forwards
    assert tpk.K1.launches - k1 == 4 * cfg.num_layers * calls["k1"]
    assert tatt.K2.launches - k2 == 4 * cfg.num_layers * calls["k2"]
