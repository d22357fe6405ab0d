"""Threefry-2x32 random bits, as ``jax.random`` draws them.

A standalone port of the counter-based generator behind the reference
sampler (``jax.random`` with ``jax_threefry_partitionable=True``, the
default of the JAX the reference runs), so a seeded request draws the same
tokens here as in the JAX engine:

- ``threefry2x32``: the 20-round hash (``jax/_src/prng.py``,
  ``_threefry2x32_lowering``);
- ``split``: ``jax.random.split(key, 2)`` (``_threefry_split_foldlike``);
- ``random_bits``: ``jax.random.bits`` of 32-bit words over a 1-D shape
  (``_threefry_random_bits_partitionable``: ``bits1 ^ bits2`` over the
  counters ``(0, i)``);
- ``uniform``, ``gumbel`` and ``categorical``: ``jax.random``'s
  ``_uniform``, ``_gumbel`` (mode "low", the default) and
  ``categorical`` (with replacement: ``argmax(gumbel + logits)``).

uint32 arithmetic is emulated in int64 tensors masked to 32 bits, so the
same code runs on CPU and CUDA tensors.  A key is two uint32 words; a
batch of keys is ``[B, 2]`` and row ``b`` of every draw uses key ``b``
(``jax.vmap`` over the keys).
"""

from __future__ import annotations

import numpy as np
import torch

from helix_tpu_torch.device import upload

_M32 = 0xFFFF_FFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD1_1BDA
_TINY_F32 = float(np.finfo(np.float32).tiny)


def as_keys(keys, device) -> torch.Tensor:
    """``[..., 2]`` uint32 key words (numpy or tensor) as int64 on
    ``device``."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return upload(np.asarray(keys, np.uint32).astype(np.int64), device)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under key
    ``(k1, k2)``; int64 tensors holding uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def split(keys: torch.Tensor):
    """``jax.random.split(key, 2)`` for each ``[2]`` key of ``keys
    [..., 2]``: returns ``(first, second)``, each ``[..., 2]``."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    lo = torch.arange(2, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)  # [..., 2]
    return (torch.stack([b1[..., 0], b2[..., 0]], dim=-1),
            torch.stack([b1[..., 1], b2[..., 1]], dim=-1))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: ``[..., n]``
    uint32 values in int64."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    the top 23 bits become the mantissa of a float in [1, 2), minus 1,
    scaled and clamped to ``minval`` in float32."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F80_0000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    # 0-dim host tensors: float32 arithmetic without an upload
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key (mode "low")."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY_F32, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: one draw per row
    of float32 ``logits [B, n]`` with row b's key ``keys[b]``."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
