"""K2-backward's bf16 limit on the CPU: an emulation of the tensor-core
design against ``flash_backward_error_limit``.

K2-backward's bf16 form (``csrc/flash_attention_bwd.cu``) runs its
products on the tensor cores, which take bf16 operands: it rounds P to
bf16 before dV += P^T dO and dS before dK += dS^T Q and dQ += dS K, and
takes Delta from K2's bf16 output O.  The kernel runs only on the card;
here ``_emulate`` repeats that arithmetic in float32 on the same inputs
(the plain version's arithmetic with only P and dS rounded, Delta from
an O whose P was rounded before P.V as K2's forward rounds it) and shows
three properties of the limit the card tests hold the kernel to:

- the emulation stays within it at the card tests' shapes (groups 1, 4
  and 7, head dims 16 to 128, soft caps 2.0 to 4.0);
- each planted fault breaks it (the wrong KV head at KVH 2: at KVH 1
  rolling the heads changes nothing);
- without its bf16 rounding term the emulation breaks it, so the term is
  needed and is not slack.

And the plain version the limit is built on: its float32 gradients equal
``jax.grad`` of the reference's ``mha_reference`` within
``1e-5 + 1e-5 |want|`` per element (float32 on one CPU, summation order
the only difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.ops import attention as jatt
from helix_tpu_torch.ops import attention as tatt

# the card tests' K2-backward shapes (tests/test_torch_cuda.py): D, H,
# KVH, S, cap of test_flash_backward_matches_plain, then the planted-fault
# case
SHAPES = [
    (128, 8, 8, 150, None),    # group 1, ragged last tile
    (128, 8, 2, 200, None),    # group 4
    (128, 14, 2, 130, 2.5),    # group 7, soft cap
    (64, 8, 2, 97, None),
    (96, 4, 1, 70, 4.0),       # group 4 at one KV head, padded head dim
    (16, 4, 4, 64, None),      # exactly one tile
    (32, 8, 2, 129, None),
    (128, 8, 2, 160, 2.0),     # the planted-fault case
]
FAULTS = ("wrong_kv_head", "no_causal", "no_delta", "no_cap_derivative")


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


def _bf16_inputs(D, H, KVH, S, cap, seed):
    """bf16 q, k, v, dO on the CPU and the keywords, as the card tests
    make them (packed rows, positions restarting per segment)."""
    (q, k, v), pos, seg = _packed(2, S, H, KVH, D, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    dout = torch.from_numpy(g).bfloat16()
    p, s = torch.from_numpy(pos), torch.from_numpy(seg)
    kw = dict(q_positions=p, kv_positions=p, q_segment_ids=s,
              kv_segment_ids=s, logits_soft_cap=cap)
    return args, dout, kw


def _bf16(x):
    return x.bfloat16().float()


def _emulate(q, k, v, dout, fault=None, *, q_positions, kv_positions,
             q_segment_ids, kv_segment_ids, logits_soft_cap):
    """The bf16 design's dq, dk, dv in float32, rounded once to bf16:
    P = exp(cap(scale q.k) - lse), dP = dO v, dS = P (dP - Delta) cap'
    scale from the unrounded P; dV = round(P)^T dO, dK = round(dS)^T q,
    dQ = round(dS) k; Delta = rowsum(dO O) with O = round(P) v rounded to
    bf16.  ``fault`` plants one defect as the card tests do: k and v read
    against the next KV head, the causal mask dropped, Delta left out, the
    cap's derivative dropped."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / np.sqrt(D)
    if fault == "wrong_kv_head":
        k, v = k.roll(1, dims=2), v.roll(1, dims=2)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    kr = kf.repeat_interleave(G, 2)
    vr = vf.repeat_interleave(G, 2)
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    capd = torch.ones_like(x)
    if logits_soft_cap is not None:
        t = torch.tanh(x / logits_soft_cap)
        x = logits_soft_cap * t
        if fault != "no_cap_derivative":
            capd = 1.0 - t * t
    mask = (q_segment_ids[:, None, :, None]
            == kv_segment_ids[:, None, None, :])
    if fault != "no_causal":
        mask = mask & (q_positions[:, None, :, None]
                       >= kv_positions[:, None, None, :])
    lse = torch.logsumexp(x.masked_fill(~mask, -np.inf), -1, keepdim=True)
    p = torch.exp(x - lse) * mask
    out = _bf16(torch.einsum("bhqk,bkhd->bqhd", _bf16(p), vr))
    if fault == "no_delta":
        out = torch.zeros_like(out)
    delta = (gf * out).sum(-1).permute(0, 2, 1)[..., None]    # [B, H, S, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vr)
    ds = p * (dp - delta) * capd * scale

    def group_sum(x):
        return x.reshape(B, S, KVH, G, D).sum(3)

    dv = group_sum(torch.einsum("bhqk,bqhd->bkhd", _bf16(p), gf))
    dk = group_sum(torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qf))
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kr)
    return tuple(g.bfloat16() for g in (dq, dk, dv))


def _ratios(got, want, limits):
    return [float(((g.float() - w.float()).abs() / lim).max())
            for g, w, lim in zip(got, want, limits)]


def _case(shape, seed_of=lambda D, S, H: D + S + H):
    D, H, KVH, S, cap = shape
    args, dout, kw = _bf16_inputs(D, H, KVH, S, cap, seed_of(D, S, H))
    want = tatt.flash_backward_plain(*args, dout, **kw)
    base, rounding = tatt.flash_backward_error_terms(*args, dout, want, **kw)
    return args, dout, kw, want, base, rounding


@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_within_limit(shape):
    """The bf16 design's rounding stays within the limit at every shape
    the card tests hold the kernel to (the worst gradient well below 1:
    the term bounds each rounding by its worst case)."""
    args, dout, kw, want, _, _ = _case(shape)
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    ratios = _ratios(_emulate(*args, dout, **kw), want, limits)
    assert max(ratios) <= 1.0, dict(zip(("dq", "dk", "dv"), ratios))


@pytest.mark.parametrize("shape", SHAPES)
def test_rounding_term_is_needed(shape):
    """Without the bf16 rounding term (the float32 limit's terms alone at
    these inputs) the same emulation breaks the limit: the term carries
    the roundings and is not slack."""
    args, dout, kw, want, base, rounding = _case(shape)
    assert rounding is not None
    assert max(_ratios(_emulate(*args, dout, **kw), want, base)) > 1.0


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_break_limit(fault):
    """Each planted defect, in the emulation at the card's planted-fault
    case (KVH 2, soft cap 2.0), breaks the limit the true arithmetic
    keeps."""
    args, dout, kw, want, _, _ = _case(SHAPES[-1], seed_of=lambda *_: 5)
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    assert max(_ratios(_emulate(*args, dout, **kw), want, limits)) <= 1.0
    bad = _emulate(*args, dout, fault, **kw)
    assert max(_ratios(bad, want, limits)) > 1.0


def test_float32_limit_has_no_rounding_term():
    """The float32 limit is the base terms alone, bit for bit."""
    args, dout, kw = _bf16_inputs(64, 8, 2, 97, None, 3)
    args, dout = [a.float() for a in args], dout.float()
    want = tatt.flash_backward_plain(*args, dout, **kw)
    base, rounding = tatt.flash_backward_error_terms(*args, dout, want, **kw)
    assert rounding is None
    limits = tatt.flash_backward_error_limit(*args, dout, want, **kw)
    for lim, b in zip(limits, base):
        assert torch.equal(lim, b)


@pytest.mark.parametrize("KVH,cap", [(2, None), (2, 2.0), (8, None)])
def test_plain_gradients_match_jax(KVH, cap):
    """``flash_backward_plain`` in float32 (what the limit is built on and
    the card tests compare against) equals ``jax.grad`` of the
    reference's ``mha_reference`` per element, packed segments."""
    (q, k, v), pos, seg = _packed(2, 70, 8, KVH, 32, seed=11)
    dout = np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg, logits_soft_cap=cap)

    def jloss(q, k, v):
        return jnp.sum(jatt.mha_reference(q, k, v, **kw) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    got = tatt.flash_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(dout),
        **tkw)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert ((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all()
