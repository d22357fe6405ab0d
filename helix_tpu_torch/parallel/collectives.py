"""The two collectives of tensor-parallel serving, as peer copies.

The reference has no such module: XLA inserts the all-reduce and the
all-gather into its compiled step.  Here one process drives every shard,
so a collective is a handful of ``tensor.to(device)`` copies (peer copies
between cards, queued on the streams with the barriers PyTorch puts
around a cross-device copy, no host wait) and adds in a fixed order:

- ``all_reduce``: the sum over the shards of float32 partials, added in
  shard order, then an optional float32 epilogue (the int8 scale, a
  bias), rounded ONCE to the compute dtype: the same bits on every card,
  and the reference's rounding (its ``dot_general`` takes
  ``preferred_element_type=float32`` and XLA all-reduces that float32
  output before the cast).  A bf16 partial rounded before the sum would
  be a different number.
- ``all_gather``: the shards' float32 logits concatenated along the
  vocabulary on the first shard's device.

The sum is leader-centric: the partials go to the first device, are
summed there and the rounded result is copied back to the others
(``n - 1`` copies each way).  A two-shot form (each device sums a block
of rows, then every device gathers the blocks) moves a quarter of the
first card's bytes at four cards, but costs ``n (n - 1)`` copies each
way, each a host call; on four H100s, where a 4096-token prefill chunk
is bound by the host issuing every shard's work, its 64 sums took 119.6
ms against the leader's 73.3 ms (``chip_smoke.py`` phase 4q), so it is
not kept.  Where a device list names one card several times nothing is
copied.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def all_reduce(parts: Sequence[torch.Tensor], devices: Sequence,
               dtype: torch.dtype,
               epilogue: Optional[Callable] = None) -> list:
    """``sum(parts)`` (float32, ``parts[i]`` on ``devices[i]``, added in
    shard order) on the first device, then ``epilogue(sum)`` on the
    float32 sum, rounded once to ``dtype``: one tensor per device, equal
    bits on every device."""
    devices = [torch.device(d) for d in devices]
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} partials for {len(devices)} devices")
    if any(p.dtype != torch.float32 for p in parts):
        raise TypeError("all_reduce sums float32 partials")
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(_to(p, devices[0]))
    if epilogue is not None:
        acc = epilogue(acc)
    out = acc.to(dtype)
    return [_to(out, d) for d in devices]


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1):
    """The shards' tensors concatenated along ``dim`` on the first
    shard's device."""
    dev = parts[0].device
    if len(parts) == 1:
        return parts[0]
    return torch.cat([_to(p, dev) for p in parts], dim=dim)


def replicate(t: torch.Tensor, devices: Sequence) -> list:
    """``t`` on every device (the same tensor where it already lives
    there)."""
    return [_to(t, torch.device(d)) for d in devices]
