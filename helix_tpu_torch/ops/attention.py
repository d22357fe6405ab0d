"""Attention: plain PyTorch reference + the hand-written CUDA flash kernel.

Port of ``helix_tpu/ops/attention.py``:

- ``mha_reference`` — multi-head attention with GQA, causal and
  packed-segment masking; the numerics oracle.
- ``flash_attention`` — the wrapper of kernel K2
  (``csrc/flash_attention.cu``, replacing the Pallas ``flash_attention``):
  on a CUDA tensor it launches the kernel, on a CPU tensor it runs
  ``flash_attention_plain``.  There is no fallback from the card to the
  plain version.
- ``flash_error_limit`` — the per-element limit K2's bf16 form is held to
  against its plain version (it rounds P to bf16 before P·V, as the
  Pallas kernel does).
- ``flash_attention_lse`` — K2 with each row's log-sum-exp (the kernel
  writes it when asked; ``flash_attention_lse_plain`` beside it).
- ``flash_attention_backward`` — the wrapper of K2-backward
  (``csrc/flash_attention_bwd.cu``; the reference has no Pallas backward:
  JAX differentiates through ``attention``): dq, dk, dv from q, k, v, O,
  the LSE and dO; its bf16 form runs on the tensor cores and rounds P and
  dS to bf16 before their products, its f32 form does not.
  ``flash_backward_error_limit`` is its per-element limit against
  autograd through the plain version.
- ``FlashAttentionFn`` — the ``torch.autograd.Function`` that joins the
  two: ``flash_attention`` takes it on a CUDA tensor whenever grad is on
  and an input requires it (training), and the plain launch otherwise
  (serving, which never pays for the LSE).
- ``attention`` — the ``backend=`` dispatcher.

Layout at every public function: q ``[B, Sq, H, D]``, k/v
``[B, Skv, KVH, D]``, positions and segment ids ``[B, S]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from helix_tpu_torch.kernels.build import Kernel

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

K2 = Kernel("flash_attention", "flash_attention.cu")
K2B = Kernel("flash_attention_backward", "flash_attention_bwd.cu")
SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_K2_ARGS = [_P] * 9 + [_I] * 7 + [_F, _F, _I, _P]
_K2_INFO_ARGS = [_I, _I, _P]
_K2B_ARGS = [_P] * 15 + [_I] * 7 + [_F, _F, _I, _I, _P]
_K2B_INFO_ARGS = [_I, _I, _I, _I, _P]
# per-element limits against the plain version: one bf16 ulp of the value
# (2**-7 relative), f32 summation-order noise near zero, and the rounding
# unit of P's (and K2-backward's dS's) bf16 rounding (2**-8)
BF16_RTOL = 2.0 ** -7
ERR_ATOL = 1e-5
P_ROUNDING = 2.0 ** -8
# float32 gradients: 1e-5 relative; and the f32 noise of a gradient's sum
# taken in another order, per unit of the sum of its terms' magnitudes
F32_RTOL = 1e-5
GRAD_NOISE = 2.0 ** -16


def _repeat_kv(k, num_q_heads):
    """[B, S, KVH, D] -> [B, S, H, D] for GQA in the reference path."""
    kvh = k.shape[-2]
    if kvh == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // kvh, dim=-2)


def _plain_scores(q, k, *, causal=True, q_positions=None, kv_positions=None,
                  q_segment_ids=None, kv_segment_ids=None,
                  logits_soft_cap=None, scale=None):
    """The plain version's float32 logits ``[B, H, Sq, Skv]`` (scaled,
    soft-capped, unmasked), the boolean mask ``[B, 1, Sq, Skv]`` and the
    cap's ``tanh`` (None uncapped)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = _repeat_kv(k, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t = None
    if logits_soft_cap is not None:
        t = torch.tanh(logits / logits_soft_cap)
        logits = logits_soft_cap * t
    mask = torch.ones((B, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qp = (
            q_positions
            if q_positions is not None
            else torch.arange(Sq, device=q.device)[None].expand(B, Sq)
        )
        kp = (
            kv_positions
            if kv_positions is not None
            else torch.arange(Skv, device=q.device)[None].expand(B, Skv)
        )
        mask = mask & (qp[:, None, :, None] >= kp[:, None, None, :])
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask = mask & (
            q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        )
    return logits, mask, t


def mha_reference(
    q,
    k,
    v,
    *,
    causal: bool = True,
    q_positions=None,
    kv_positions=None,
    q_segment_ids=None,
    kv_segment_ids=None,
    logits_soft_cap: Optional[float] = None,
    scale: Optional[float] = None,
):
    """Numerics oracle. q: [B, Sq, H, D]; k/v: [B, Skv, KVH, D]."""
    logits, mask, _ = _plain_scores(
        q, k, causal=causal, q_positions=q_positions,
        kv_positions=kv_positions, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logits_soft_cap=logits_soft_cap,
        scale=scale)
    logits = torch.where(
        mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE)
    )
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(v, q.shape[2])
                       .float())
    return out.to(q.dtype)


def flash_attention_plain(
    q, k, v, *, q_positions=None, kv_positions=None, q_segment_ids=None,
    kv_segment_ids=None, causal: bool = True, scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
):
    """K2's plain PyTorch version: the masked-softmax form of the
    reference (one [B, H, Sq, Skv] score tensor).  A row whose every key
    is masked comes out as the mean of V here and as 0 from the kernel;
    engine callers never read such rows (padding), and comparisons hold
    the two to each other on live tokens only."""
    return mha_reference(
        q, k, v, causal=causal, q_positions=q_positions,
        kv_positions=kv_positions, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, logits_soft_cap=logits_soft_cap,
        scale=scale,
    )


def flash_error_limit(q, k, v, **kw):
    """Per-element limit on |kernel - plain| for K2's bf16 form, float32,
    the shape of the output.  ``kw`` are ``flash_attention``'s keywords.

    The kernel rounds each weight p_j to bf16 before the P·V product, as
    the TPU kernel does (``helix_tpu/ops/attention.py:165-166``), while
    ``l`` sums the unrounded p_j.  A rounded weight is p_j (1 + d_j) with
    |d_j| <= u = 2**-8, so the output moves by at most
    ``u * sum_j p_j |v_j| / l`` -- the plain version run with |v| in place
    of v.  Beside that term: one bf16 ulp of the plain value (both sides
    round once to bf16) and 1e-5 of f32 summation-order noise:
    ``1e-5 + 2**-7 |plain(q, k, v)| + 2**-8 plain(q, k, |v|)``."""
    plain = flash_attention_plain(q, k, v, **kw).float()
    spread = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   **kw)
    return ERR_ATOL + BF16_RTOL * plain.abs() + P_ROUNDING * spread


def flash_kernel_info(D: int, dtype=torch.bfloat16) -> dict:
    """Launch resources of the K2 kernel for head dim D (needs the card):
    shared memory per block, registers, blocks per SM, spills."""
    info = (ctypes.c_int * 4)()
    fn = K2.symbol("helix_flash_attention_info", _K2_INFO_ARGS)
    err = fn(D, _KERNEL_DTYPES[dtype], ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"flash_attention info: cuda error {err}")
    return dict(smem_bytes=info[0], regs=info[1], blocks_per_sm=info[2],
                spill_bytes=info[3])


def _i32(x, shape, device, default):
    if x is None:
        x = default
    return torch.broadcast_to(x.to(device=device, dtype=torch.int32),
                              shape).contiguous()


def _kernel_meta(q, k, v, q_positions, kv_positions, q_segment_ids,
                 kv_segment_ids, name="flash_attention"):
    """Check what K2 and K2-backward take and return their int32 meta:
    ``(qpos, kpos, qseg, kseg)``, contiguous ``[B, S]`` (segments None
    without segment ids)."""
    B, Sq, H, D = q.shape
    Bk, Skv, KVH, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % KVH:
        raise ValueError(
            f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not form [B,Sq,H,D] / [B,Skv,KVH,D]"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {D} unsupported")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError(f"{name}: q, k, v must share one CUDA device")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(f"{name}: pass both segment ids or neither")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    dev = q.device
    qpos = _i32(q_positions, (B, Sq), dev,
                torch.arange(Sq, device=dev)[None])
    kpos = _i32(kv_positions, (B, Skv), dev,
                torch.arange(Skv, device=dev)[None])
    qseg = kseg = None
    if q_segment_ids is not None:
        qseg = _i32(q_segment_ids, (B, Sq), dev, None)
        kseg = _i32(kv_segment_ids, (B, Skv), dev, None)
    return qpos, kpos, qseg, kseg


def _scale_of(scale, D) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(D))


def _launch_k2(q, k, v, meta, causal, scale, logits_soft_cap, want_lse):
    """One launch of K2 (counted on ``K2.launches``): ``(out, lse)``, lse
    f32 ``[B, H, Sq]`` when ``want_lse``, else None (the kernel then
    writes none)."""
    qpos, kpos, qseg, kseg = meta
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    fn = K2.symbol("helix_flash_attention", _K2_ARGS)
    with torch.cuda.device(q.device):   # the launcher's device
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), None if qseg is None else qseg.data_ptr(),
            None if kseg is None else kseg.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, H, KVH, D, int(bool(causal)), _scale_of(scale, D),
            float(logits_soft_cap or 0.0), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cuda error {err}")
    K2.launches += 1
    return out, lse


def _launch_k2_backward(q, k, v, out, lse, dout, meta, causal, scale,
                        logits_soft_cap, drop_cap_derivative=False):
    """One launch of K2-backward (its three kernels, counted once on
    ``K2B.launches``): ``(dq, dk, dv)`` in q's dtype."""
    qpos, kpos, qseg, kseg = meta
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    for nm, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention_backward: {nm} must be a "
                             f"contiguous {q.dtype} tensor of q's shape")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse must be a "
                         "contiguous float32 [B, H, Sq] tensor")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # the bf16 form's tile map: a byte per (query tile, key tile), twice
    tiles = (torch.empty(2 * B * -(-Sq // 64) * -(-Skv // 64),
                         dtype=torch.uint8, device=q.device)
             if q.dtype == torch.bfloat16 else None)
    fn = K2B.symbol("helix_flash_attention_backward", _K2B_ARGS)
    with torch.cuda.device(q.device):   # the launcher's device
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            None if qseg is None else qseg.data_ptr(),
            None if kseg is None else kseg.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if tiles is None else tiles.data_ptr(),
            B, Sq, Skv, H, KVH, D, int(bool(causal)), _scale_of(scale, D),
            float(logits_soft_cap or 0.0), _KERNEL_DTYPES[q.dtype],
            int(drop_cap_derivative),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_backward kernel launch failed: cuda error {err}")
    K2B.launches += 1
    return dq, dk, dv


def flash_attention(
    q, k, v, *, q_positions=None, kv_positions=None, q_segment_ids=None,
    kv_segment_ids=None, causal: bool = True, scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
):
    """Flash attention for prefill. q: [B, Sq, H, D]; k/v: [B, Skv, KVH, D].

    CUDA tensors launch kernel K2 on the current stream (and raise on
    anything it does not take); with grad enabled and an input that
    requires it, through ``FlashAttentionFn`` (K2 with its LSE forward,
    K2-backward backward; q, k, v made contiguous).  CPU tensors run
    ``flash_attention_plain``, which autograd differentiates.  Sequence
    lengths need not be multiples of the kernel's tiles."""
    kw = dict(
        q_positions=q_positions, kv_positions=kv_positions,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        causal=causal, scale=scale, logits_soft_cap=logits_soft_cap,
    )
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(
            q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, causal, scale, logits_soft_cap)
    meta = _kernel_meta(q, k, v, q_positions, kv_positions, q_segment_ids,
                        kv_segment_ids)
    return _launch_k2(q, k, v, meta, causal, scale, logits_soft_cap,
                      want_lse=False)[0]


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd, for training on the card: forward launches K2
    with its LSE and saves q, k, v, O, the LSE and the int32 meta;
    backward launches K2-backward.  It has no CPU form: on the CPU,
    autograd differentiates ``flash_attention_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, q_segment_ids,
                kv_segment_ids, causal, scale, logits_soft_cap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        meta = _kernel_meta(q, k, v, q_positions, kv_positions,
                            q_segment_ids, kv_segment_ids)
        out, lse = _launch_k2(q, k, v, meta, causal, scale, logits_soft_cap,
                              want_lse=True)
        qpos, kpos, qseg, kseg = meta
        ctx.has_seg = qseg is not None
        seg = (qseg, kseg) if ctx.has_seg else ()
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos, *seg)
        ctx.args = (causal, scale, logits_soft_cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos, *seg = ctx.saved_tensors
        meta = (qpos, kpos, *(seg if ctx.has_seg else (None, None)))
        dq, dk, dv = _launch_k2_backward(q, k, v, out, lse,
                                         dout.contiguous(), meta, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_lse_plain(q, k, v, **kw):
    """``(flash_attention_plain(q, k, v), lse)``: each row's log-sum-exp
    of the plain version's masked logits, f32 ``[B, H, Sq]``; +inf for a
    row with no live key (as the kernel writes)."""
    names = ("q_positions", "kv_positions", "q_segment_ids",
             "kv_segment_ids", "causal", "scale", "logits_soft_cap")
    logits, mask, _ = _plain_scores(q, k, **{n: kw[n] for n in names
                                             if n in kw})
    lse = torch.logsumexp(logits.masked_fill(~mask, -math.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse, torch.full_like(lse, math.inf))
    return flash_attention_plain(q, k, v, **kw), lse


def flash_attention_lse(q, k, v, **kw):
    """K2 with each row's log-sum-exp: ``(out, lse)``, lse f32 ``[B, H,
    Sq]``.  CUDA tensors launch K2 with its LSE output (no grad); CPU
    tensors run ``flash_attention_lse_plain``."""
    if not q.is_cuda:
        return flash_attention_lse_plain(q, k, v, **kw)
    causal = kw.get("causal", True)
    meta = _kernel_meta(q, k, v, kw.get("q_positions"),
                        kw.get("kv_positions"), kw.get("q_segment_ids"),
                        kw.get("kv_segment_ids"))
    with torch.no_grad():
        return _launch_k2(q, k, v, meta, causal, kw.get("scale"),
                          kw.get("logits_soft_cap"), want_lse=True)


def flash_attention_backward(q, k, v, out, lse, dout, *, q_positions=None,
                             kv_positions=None, q_segment_ids=None,
                             kv_segment_ids=None, causal: bool = True,
                             scale: Optional[float] = None,
                             logits_soft_cap: Optional[float] = None,
                             _drop_cap_derivative: bool = False):
    """K2-backward: ``(dq, dk, dv)`` of ``flash_attention`` at q, k, v
    for the cotangent ``dout``, given its output ``out`` and ``lse``
    (``flash_attention_lse``).  CUDA tensors launch the kernel on the
    current stream; CPU tensors differentiate ``flash_attention_plain``
    with autograd (``out`` and ``lse`` unread).  ``_drop_cap_derivative``
    plants a defect for the checks that must see it: dS without the cap's
    derivative, which no input can make (P is recomputed from the capped
    scores)."""
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, scale=scale, logits_soft_cap=logits_soft_cap)
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, dout, **kw)
    meta = _kernel_meta(q, k, v, q_positions, kv_positions, q_segment_ids,
                        kv_segment_ids, "flash_attention_backward")
    return _launch_k2_backward(q, k, v, out, lse, dout, meta, causal, scale,
                               logits_soft_cap, _drop_cap_derivative)


def flash_backward_plain(q, k, v, dout, **kw):
    """K2-backward's plain version: autograd through
    ``flash_attention_plain`` evaluated on float32 copies of the inputs,
    each gradient rounded once to the input dtype.  (Autograd of the bf16
    plain version itself would round each query head's share of dk and
    dv to bf16 before summing the group.)"""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, dout.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def flash_backward_error_limit(q, k, v, dout, want, **kw):
    """Per-element limits ``(lq, lk, lv)`` on |kernel - plain| for
    K2-backward's dq, dk, dv (float32, their shapes); ``want`` are the
    plain version's gradients, ``kw`` ``flash_attention``'s keywords.
    Rows with no live key are left out of a comparison (dO zero there):
    the kernel gives them P = 0, the plain version a uniform P.

    Both sides take the same inputs and compute in f32; they differ in:

    - the order of every f32 sum (S, the LSE, dP and the sums over
      queries or keys): at most ``GRAD_NOISE`` (2**-16) times the sum of
      the magnitudes of a gradient's terms, ``mag``: P^T |dO| for dv, and
      for dq / dk the same products of |dS| = P (|dO| |V|^T + |Delta|)
      |cap'| scale with |K| / |Q|;
    - Delta = rowsum(dO O), which the kernel takes from its forward's O
      while the plain version's autograd has the exact one.  That O is
      within ``flash_error_limit`` of the plain output in bf16 (it rounds
      P to bf16 before P.V), ``ERR_ATOL + F32_RTOL |O|`` in f32; so
      Delta_i is off by at most e_i = sum_d |dO_id| limO_id, which moves
      dq_i by scale e_i sum_j P_ij |cap'_ij| |k_j| and dk_j by
      scale sum_i P_ij |cap'_ij| e_i |q_i|;
    - in bf16 only, the rounding of P and dS to bf16 before their
      products (the tensor cores take no f32 operand).  A rounded factor
      is x (1 + d) with |d| <= u = ``P_ROUNDING`` (2**-8), so dV =
      sum_i P_ij dO_i moves by at most u sum_i P_ij |dO_i| = u mag_v, and
      dK_j = sum_i dS_ij q_i by at most u sum_i |dS_ij| |q_i| <= u mag_k
      (|dS| <= P (|dO| |V|^T + |Delta|) |cap'| scale, the triangle
      inequality on dP), dQ likewise by u mag_q.  dS itself is formed in
      f32 from the unrounded P, so the two roundings do not compound;
    - the final rounding: one bf16 ulp (2**-7 |want|) in bf16, and
      ``F32_RTOL |want|`` in f32.

    So ``limit = ERR_ATOL + rtol |want| + GRAD_NOISE mag + delta_term``,
    plus ``P_ROUNDING mag`` in bf16 (``flash_backward_error_terms`` gives
    the two parts apart)."""
    base, rounding = flash_backward_error_terms(q, k, v, dout, want, **kw)
    if rounding is None:
        return base
    return tuple(b + r for b, r in zip(base, rounding))


def flash_backward_error_terms(q, k, v, dout, want, **kw):
    """The two parts of ``flash_backward_error_limit``: ``(base,
    rounding)``, ``base`` the float32 limit's terms at these inputs and
    ``rounding`` the bf16 form's ``P_ROUNDING * (mag_q, mag_k, mag_v)``
    (None for float32 inputs, whose limit is ``base`` alone)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = _scale_of(kw.get("scale"), D)
    names = ("q_positions", "kv_positions", "q_segment_ids",
             "kv_segment_ids", "causal", "scale", "logits_soft_cap")
    logits, mask, t = _plain_scores(q, k, **{n: kw[n] for n in names
                                             if n in kw})
    probs = torch.softmax(logits.masked_fill(~mask, DEFAULT_MASK_VALUE), -1)
    probs = probs * mask
    capd = torch.ones_like(probs) if t is None else (1.0 - t * t).abs()
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    kr, vr = _repeat_kv(kf, H), _repeat_kv(vf, H)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vr)
    delta = (probs * dp).sum(-1, keepdim=True)

    def group_sum(x):   # [B, Skv, H, D] -> [B, Skv, KVH, D]
        return x.reshape(B, x.shape[1], KVH, G, D).sum(3)

    mag_v = group_sum(torch.einsum("bhqk,bqhd->bkhd", probs, gf.abs()))
    ds_abs = probs * (torch.einsum("bqhd,bkhd->bhqk", gf.abs(), vr.abs())
                      + delta.abs()) * capd * scale
    mag_q = torch.einsum("bhqk,bkhd->bqhd", ds_abs, kr.abs())
    mag_k = group_sum(torch.einsum("bhqk,bqhd->bkhd", ds_abs, qf.abs()))
    bf16 = q.dtype == torch.bfloat16
    plain_kw = {n: kw[n] for n in names if n in kw}
    if bf16:
        lim_o = flash_error_limit(q, k, v, **plain_kw)
    else:
        lim_o = ERR_ATOL + F32_RTOL * flash_attention_plain(
            q, k, v, **plain_kw).float().abs()
    e = (gf.abs() * lim_o).sum(-1).permute(0, 2, 1)        # [B, H, Sq]
    pe = probs * capd * scale * e[..., None]
    extra_q = torch.einsum("bhqk,bkhd->bqhd", pe, kr.abs())
    extra_k = group_sum(torch.einsum("bhqk,bqhd->bkhd", pe, qf.abs()))
    rtol = BF16_RTOL if bf16 else F32_RTOL
    dq, dk, dv = (w.float() for w in want)
    base = (ERR_ATOL + rtol * dq.abs() + GRAD_NOISE * mag_q + extra_q,
            ERR_ATOL + rtol * dk.abs() + GRAD_NOISE * mag_k + extra_k,
            ERR_ATOL + rtol * dv.abs() + GRAD_NOISE * mag_v)
    rounding = (tuple(P_ROUNDING * m for m in (mag_q, mag_k, mag_v))
                if bf16 else None)
    return base, rounding


def flash_backward_kernel_info(D: int, dtype=torch.bfloat16,
                               S: int = 1024) -> dict:
    """Launch resources of K2-backward's dK/dV kernel and dQ kernel for
    head dim D at sequence length S (needs the card), as
    ``flash_kernel_info``'s."""
    fn = K2B.symbol("helix_flash_attention_backward_info", _K2B_INFO_ARGS)
    out = {}
    for which, name in ((0, "dkdv"), (1, "dq")):
        info = (ctypes.c_int * 4)()
        err = fn(D, _KERNEL_DTYPES[dtype], which, S, ctypes.addressof(info))
        if err != 0:
            raise RuntimeError(
                f"flash_attention_backward info: cuda error {err}")
        out[name] = dict(smem_bytes=info[0], regs=info[1],
                         blocks_per_sm=info[2], spill_bytes=info[3])
    return out


def attention(q, k, v, *, backend: Optional[str] = None, **kwargs):
    """Dispatch: ``None`` goes through the K2 wrapper (the kernel on the
    card, its plain version on the CPU); ``"reference"`` runs the plain
    version on any device — it exists so that comparisons can call both."""
    if backend is None:
        return flash_attention(q, k, v, **kwargs)
    if backend == "reference":
        return flash_attention_plain(q, k, v, **kwargs)
    raise ValueError(f"unknown attention backend {backend!r}")
