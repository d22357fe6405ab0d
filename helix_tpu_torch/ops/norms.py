"""Normalisation ops (port of ``helix_tpu/ops/norms.py``).

Plain PyTorch: accumulation is fp32 even for bf16 activations, and the
result is cast back to the input dtype once.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6, offset: float = 0.0):
    """RMSNorm (Llama/Qwen style). ``offset=1.0`` gives Gemma's (1+w) form."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(dtype)


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * (var + eps) ** -0.5 * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
