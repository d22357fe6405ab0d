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
SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_K2_ARGS = [_P] * 8 + [_I] * 7 + [_F, _F, _I, _P]
_K2_INFO_ARGS = [_I, _I, _P]
# per-element limits against the plain version: one bf16 ulp of the value
# (2**-7 relative), f32 summation-order noise near zero, and the rounding
# unit of P's bf16 rounding (2**-8)
BF16_RTOL = 2.0 ** -7
ERR_ATOL = 1e-5
P_ROUNDING = 2.0 ** -8


def _repeat_kv(k, num_q_heads):
    """[B, S, KVH, D] -> [B, S, H, D] for GQA in the reference path."""
    kvh = k.shape[-2]
    if kvh == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // kvh, dim=-2)


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
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
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
    logits = torch.where(
        mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE)
    )
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
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


def flash_attention(
    q, k, v, *, q_positions=None, kv_positions=None, q_segment_ids=None,
    kv_segment_ids=None, causal: bool = True, scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
):
    """Flash attention for prefill. q: [B, Sq, H, D]; k/v: [B, Skv, KVH, D].

    CUDA tensors launch kernel K2 on the current stream (and raise on
    anything it does not take); CPU tensors run ``flash_attention_plain``.
    Sequence lengths need not be multiples of the kernel's tiles."""
    kw = dict(
        q_positions=q_positions, kv_positions=kv_positions,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        causal=causal, scale=scale, logits_soft_cap=logits_soft_cap,
    )
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    B, Sq, H, D = q.shape
    Bk, Skv, KVH, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % KVH:
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not form [B,Sq,H,D] / [B,Skv,KVH,D]"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} unsupported")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must share one CUDA device")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: pass both segment ids or neither")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    dev = q.device
    qpos = _i32(q_positions, (B, Sq), dev,
                torch.arange(Sq, device=dev)[None])
    kpos = _i32(kv_positions, (B, Skv), dev,
                torch.arange(Skv, device=dev)[None])
    qseg = kseg = None
    if q_segment_ids is not None:
        qseg = _i32(q_segment_ids, (B, Sq), dev, None)
        kseg = _i32(kv_segment_ids, (B, Skv), dev, None)
    out = torch.empty_like(q)
    fn = K2.symbol("helix_flash_attention", _K2_ARGS)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), None if qseg is None else qseg.data_ptr(),
        None if kseg is None else kseg.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KVH, D, int(bool(causal)),
        float(scale if scale is not None else 1.0 / math.sqrt(D)),
        float(logits_soft_cap or 0.0), _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cuda error {err}")
    K2.launches += 1
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
