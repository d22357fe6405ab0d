"""Rotary position embeddings (port of ``helix_tpu/ops/rope.py``).

``rope_frequencies`` is the reference's numpy code, copied; ``apply_rope``
is the same half-split rotation in fp32 on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 500000.0,
    scaling: dict | None = None,
) -> np.ndarray:
    """Inverse frequencies, with optional Llama-3-style rope scaling.

    ``scaling`` follows HF config ``rope_scaling`` with
    ``rope_type=llama3``: {factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings}.
    """
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if scaling is not None and not isinstance(scaling, dict):
        scaling = dict(scaling)   # configs store it as a sorted item tuple
    if scaling and scaling.get("rope_type", scaling.get("type")) == "llama3":
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig = scaling["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv_freq
        # three bands: high-freq untouched, low-freq divided by factor,
        # middle smoothly interpolated
        smooth = (orig / wavelen - low) / (high - low)
        smooth = np.clip(smooth, 0.0, 1.0)
        scaled = inv_freq / factor
        inv_freq = (1 - smooth) * scaled + smooth * inv_freq
    return inv_freq.astype(np.float32)


def apply_rope(x, positions, inv_freq):
    """Rotate q or k.

    x:         [..., seq, heads, head_dim]
    positions: broadcastable to [..., seq] (integer)
    inv_freq:  [head_dim // 2] float32 tensor on x's device
    """
    angles = positions[..., None].float() * inv_freq   # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]               # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
