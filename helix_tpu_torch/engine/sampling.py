"""Token sampling per batch slot (port of ``helix_tpu/engine/sampling.py``).

The three tiers of the reference, on torch tensors:

1. **Window**: the top ``TOPK_BOUND`` logits (``torch.topk``, exact where
   the reference's TPU path uses ``approx_max_k``), temperature / top-k /
   top-p masking inside the window with probabilities against the
   FULL-vocab ``log_z``, one categorical draw.
2. **Full categorical** (``top_p >= 1`` and ``top_k`` off, when the window
   does not hold ``top_p`` of the mass): a Gumbel-max draw over the vocab.
3. **Sorted nucleus** (``top_p`` past the window's mass, or
   ``top_k > TOPK_BOUND``): full descending sort + exact nucleus prefix.

Tier choice is made per slot on the device (``torch.where``); a tier's
draw is computed only for slots whose parameters can reach it, which the
host knows from ``SamplingParams``.  Greedy (temperature 0) is an exact
argmax.

Randomness: each sampled slot draws from its own ``torch.Generator``
seeded from the slot's key (two uint32 words, the engine's host key
stream).  The draws are NOT threefry's: seeded temperature > 0 streams
match the reference in distribution, not bit for bit (ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

TOPK_BOUND = 64


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Host-side request sampling settings (OpenAI semantics)."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0              # 0 = disabled
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    max_tokens: int = 256
    stop: tuple = ()
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling settings as device tensors, plus the host list
    they came from (tier reachability is decided from it on the host)."""

    temperature: torch.Tensor   # [B] f32 (0 = greedy)
    top_p: torch.Tensor         # [B] f32
    top_k: torch.Tensor         # [B] i64 (0 = disabled)
    presence: torch.Tensor      # [B] f32
    frequency: torch.Tensor     # [B] f32
    params: tuple = ()

    @classmethod
    def from_params(cls, params_list, device="cpu") -> "SamplingState":
        def col(attr, dtype):
            return torch.tensor(
                [getattr(p, attr) for p in params_list], dtype=dtype,
                device=device,
            )

        return cls(
            temperature=col("temperature", torch.float32),
            top_p=col("top_p", torch.float32),
            top_k=col("top_k", torch.int64),
            presence=col("presence_penalty", torch.float32),
            frequency=col("frequency_penalty", torch.float32),
            params=tuple(params_list),
        )


def key_generator(key, device) -> torch.Generator:
    """A torch generator seeded from a [2] uint32 key."""
    seed = (int(key[0]) << 32) | int(key[1])
    return torch.Generator(device=device).manual_seed(seed)


def _gumbel_argmax(logits, gen):
    """One categorical draw per row of ``logits`` [n] via Gumbel-max."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)))


def sample(
    logits: torch.Tensor,           # [B, V] f32
    state: SamplingState,
    keys: Optional[np.ndarray] = None,   # [B, 2] u32 per-slot step keys
) -> torch.Tensor:
    """Draw one token per slot (int64 [B]).  Greedy slots take argmax."""
    B, V = logits.shape
    logits = logits.float()
    exact_greedy = torch.argmax(logits, dim=-1)
    sampled_rows = [b for b, p in enumerate(state.params) if p.temperature > 0]
    if not sampled_rows:
        return exact_greedy
    k = min(TOPK_BOUND, V)
    dev = logits.device
    top_logits, top_idx = torch.topk(logits, k, dim=-1)        # desc
    temp = state.temperature.clamp(min=1e-6)[:, None]
    scaled_full = logits / temp
    log_z = torch.logsumexp(scaled_full, dim=-1, keepdim=True)
    scaled = top_logits / temp
    ranks = torch.arange(k, device=dev)[None, :]
    topk = torch.where(state.top_k[:, None] > 0, state.top_k[:, None], k)
    probs = torch.exp(scaled - log_z)
    cum = torch.cumsum(probs, dim=-1)
    mask = (ranks < topk) & ((cum - probs) < state.top_p[:, None])
    masked = torch.where(mask, scaled, torch.full_like(scaled, -torch.inf))

    nongreedy = state.temperature > 0.0
    topk_in_window = (state.top_k > 0) & (state.top_k <= k)
    full_needed = nongreedy & (cum[:, -1] < state.top_p) & ~topk_in_window
    open_ended = (state.top_p >= 1.0) & (state.top_k == 0)
    cat_needed = full_needed & open_ended
    sort_needed = full_needed & ~open_ended

    out = exact_greedy.clone()
    for b in sampled_rows:
        p = state.params[b]
        gen = key_generator(keys[b], dev)
        tok = top_idx[b, _gumbel_argmax(masked[b], gen)]
        if p.top_p >= 1.0 and p.top_k == 0:
            # tier 2 reachable: exact categorical over the whole vocab
            full = _gumbel_argmax(scaled_full[b], gen)
            tok = torch.where(cat_needed[b], full, tok)
        elif not 0 < p.top_k <= k:
            # tier 3 reachable: full sort + exact nucleus prefix
            s_logits, s_idx = torch.sort(scaled_full[b], descending=True)
            p_s = torch.exp(s_logits - log_z[b])
            cum_s = torch.cumsum(p_s, dim=-1)
            keep = (cum_s - p_s) < state.top_p[b]
            limit = p.top_k if p.top_k > 0 else V
            keep &= torch.arange(V, device=dev) < limit
            m = torch.where(keep, s_logits, torch.full_like(s_logits, -torch.inf))
            full = s_idx[_gumbel_argmax(m, gen)]
            tok = torch.where(sort_needed[b], full, tok)
        out[b] = tok
    return torch.where(state.temperature == 0.0, exact_greedy, out)


def split_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, 2] u32 -> (carry [B, 2], step [B, 2]) on the host, with the
    engine's deterministic key derivation (``engine._host_split``)."""
    from helix_tpu_torch.engine.engine import _host_split

    pairs = [_host_split(np.asarray(k, np.uint32)) for k in keys]
    carry = np.stack([c for c, _ in pairs]) if pairs else keys.copy()
    step = np.stack([s for _, s in pairs]) if pairs else keys.copy()
    return carry.astype(np.uint32), step.astype(np.uint32)


def apply_penalties(
    logits: torch.Tensor,         # [B, V]
    token_counts: torch.Tensor,   # [B, V] int — output-token histogram
    presence: torch.Tensor,       # [B]
    frequency: torch.Tensor,      # [B]
) -> torch.Tensor:
    """OpenAI presence/frequency penalties from an output-token histogram
    (vLLM semantics: generated tokens only)."""
    present = (token_counts > 0).to(logits.dtype)
    return (
        logits
        - presence[:, None] * present
        - frequency[:, None] * token_counts.to(logits.dtype)
    )
