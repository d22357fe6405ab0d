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

Randomness: each slot carries a threefry key (two uint32 words);
``split_keys`` advances it once per live step and every tier of a slot
draws from the same step key with ``engine/threefry.py``, the reference's
``jax.random`` bits.  A seeded temperature > 0 request therefore draws
the tokens the JAX engine draws from the same logits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from helix_tpu_torch.device import upload
from helix_tpu_torch.engine import threefry

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
            return upload(np.array([getattr(p, attr) for p in params_list],
                                   dtype=dtype), device)

        return cls(
            temperature=col("temperature", np.float32),
            top_p=col("top_p", np.float32),
            top_k=col("top_k", np.int64),
            presence=col("presence_penalty", np.float32),
            frequency=col("frequency_penalty", np.float32),
            params=tuple(params_list),
        )


def sample(
    logits: torch.Tensor,           # [B, V] f32
    state: SamplingState,
    keys=None,                      # [B, 2] u32 per-slot step keys
) -> torch.Tensor:
    """Draw one token per slot (int64 [B]).  Greedy slots take argmax.

    Every tier of row b draws from the same step key ``keys[b]`` with
    threefry, as ``helix_tpu/engine/sampling.py:sample`` does with
    ``exact=True``."""
    B, V = logits.shape
    logits = logits.float()
    exact_greedy = torch.argmax(logits, dim=-1)
    sampled_rows = [b for b, p in enumerate(state.params) if p.temperature > 0]
    if not sampled_rows:
        return exact_greedy
    if keys is None:
        raise ValueError("sampling at temperature > 0 needs per-slot keys")
    k = min(TOPK_BOUND, V)
    dev = logits.device
    keys = threefry.as_keys(keys, dev)
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

    # a tier's draw is made only for the sampled rows whose parameters
    # can reach it; each row's draw depends on its own key and logits
    # alone.  The Gumbel noise of a [k] draw is the first k values of a
    # [V] draw with the same key (the counters are the element indices),
    # so one [V]-wide draw per row serves every tier it reaches.
    params = state.params
    tier2 = [b for b in sampled_rows
             if params[b].top_p >= 1.0 and params[b].top_k == 0]
    tier3 = [b for b in sampled_rows
             if b not in tier2 and not 0 < params[b].top_k <= k]
    rows = upload(np.array(sampled_rows), dev)
    g = threefry.gumbel(keys[rows], V if tier2 or tier3 else k)
    at = {b: i for i, b in enumerate(sampled_rows)}   # row -> row of g
    draw = torch.argmax(g[:, :k] + masked[rows], dim=-1)
    out = exact_greedy.clone()
    out[rows] = torch.gather(top_idx[rows], 1, draw[:, None])[:, 0]
    if tier2:
        # exact categorical over the whole vocab
        idx = upload(np.array(tier2), dev)
        gi = upload(np.array([at[b] for b in tier2]), dev)
        full = torch.argmax(g[gi] + scaled_full[idx], dim=-1)
        out[idx] = torch.where(cat_needed[idx], full, out[idx])
    if tier3:
        # full sort + exact nucleus prefix
        idx = upload(np.array(tier3), dev)
        gi = upload(np.array([at[b] for b in tier3]), dev)
        s_logits, s_idx = torch.sort(scaled_full[idx], dim=-1,
                                     descending=True, stable=True)
        p_s = torch.exp(s_logits - log_z[idx])
        cum_s = torch.cumsum(p_s, dim=-1)
        keep = (cum_s - p_s) < state.top_p[idx, None]
        limit = torch.where(state.top_k[idx] > 0, state.top_k[idx], V)
        keep &= torch.arange(V, device=dev)[None, :] < limit[:, None]
        m = torch.where(keep, s_logits, torch.full_like(s_logits, -torch.inf))
        d = torch.argmax(g[gi] + m, dim=-1)
        full = torch.gather(s_idx, 1, d[:, None])[:, 0]
        out[idx] = torch.where(sort_needed[idx], full, out[idx])
    return torch.where(state.temperature == 0.0, exact_greedy, out)


def split_keys(keys) -> tuple[np.ndarray, np.ndarray]:
    """[B, 2] u32 -> (carry [B, 2], step [B, 2]): ``jax.random.split(k,
    2)`` of each key, computed on the host (the reference splits on the
    device; the words are the same)."""
    carry, step = threefry.split(threefry.as_keys(keys, "cpu"))
    return (carry.numpy().astype(np.uint32),
            step.numpy().astype(np.uint32))


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
