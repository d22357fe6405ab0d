"""Host-side speculative drafting: prompt-lookup n-grams, no draft model.

Port of ``helix_tpu/engine/spec.py`` (numpy only; the port keeps its own
copy).  ``propose`` matches the sequence's trailing n-gram against its own
earlier tokens (prompt + output) and proposes what followed the most recent
earlier occurrence; ``SpecDecoder`` drafts per request and folds each
verify outcome into the request's acceptance EMA, which benches a request
whose drafts keep missing and re-probes it ``reprobe_after`` opportunities
later.  The engine verifies every drafting slot's ``1 + draft_len`` tokens
in one device call (``Engine._spec_dispatch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SpecConfig:
    """Drafter tuning (host-side only; never reaches the device)."""

    spec_tokens: int = 4      # max drafted tokens per slot per step
    max_ngram: int = 4        # longest trailing n-gram to match
    min_ngram: int = 1        # shortest n-gram worth matching
    ema_alpha: float = 0.35   # acceptance EMA update weight
    disable_below: float = 0.12   # EMA floor: speculation off under this
    reprobe_after: int = 64   # draft opportunities skipped before re-probe


@dataclasses.dataclass
class _SlotSpec:
    """Per-request drafting state (keyed by request id, not slot index:
    slots are recycled across requests but acceptance history is a
    property of the *request's* text)."""

    ema: float = 1.0          # optimistic start: every slot gets a shot
    enabled: bool = True
    cooldown: int = 0         # disabled-state countdown to the re-probe
    drafted: int = 0
    accepted: int = 0


def propose(
    tokens: Sequence[int],
    k: int,
    max_ngram: int = 4,
    min_ngram: int = 1,
) -> list:
    """Prompt-lookup draft: the continuation that followed the most
    recent earlier occurrence of the sequence's trailing n-gram.

    Longest n-gram first (a 4-gram match is far more predictive than a
    1-gram), most recent occurrence wins (locality: the repetition we
    are inside of beats one from the distant prompt).  Returns at most
    ``k`` tokens; empty when nothing matches.
    """
    n_tok = len(tokens)
    if k <= 0 or n_tok < min_ngram + 1:
        return []
    arr = np.asarray(tokens, dtype=np.int64)
    for n in range(min(max_ngram, n_tok - 1), min_ngram - 1, -1):
        pattern = arr[-n:]
        # windows over arr[:-1]: starts 0..n_tok-1-n, so the trailing
        # n-gram itself is never its own (trivial) match, while earlier
        # overlapping occurrences — the heart of "abcabcabc" — are kept
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n
        cont = arr[start: start + k]
        if cont.size:
            return [int(t) for t in cont]
    return []


class SpecDecoder:
    """Per-engine drafting controller: proposes drafts per slot and
    folds verify outcomes back into each request's acceptance EMA.

    Mutating methods run on the engine thread (plain dict state, no
    locks); ``disabled_count`` additionally serves the /metrics thread
    off a GIL-atomic snapshot, and the engine exposes aggregate
    counters off its own GIL-atomic ints.
    """

    def __init__(self, cfg: Optional[SpecConfig] = None):
        self.cfg = cfg or SpecConfig()
        self._slots: dict = {}   # request id -> _SlotSpec

    def _state(self, req_id: str) -> _SlotSpec:
        st = self._slots.get(req_id)
        if st is None:
            st = self._slots[req_id] = _SlotSpec()
        return st

    def draft(self, req_id: str, tokens: Sequence[int], k: int) -> list:
        """Draft up to ``k`` tokens for one slot, honouring the slot's
        enable/cooldown state.  ``k`` may be below ``spec_tokens`` when
        the caller clamps to page-room/token-budget headroom."""
        st = self._state(req_id)
        if not st.enabled:
            st.cooldown -= 1
            if st.cooldown > 0:
                return []
            # re-probe: one tentative round right at the disable floor —
            # a hit climbs back to full speculation, a miss re-disables
            # on the next observe()
            st.enabled = True
            st.ema = self.cfg.disable_below
        k = min(k, self.cfg.spec_tokens)
        if k <= 0:
            return []
        return propose(
            tokens, k,
            max_ngram=self.cfg.max_ngram,
            min_ngram=self.cfg.min_ngram,
        )

    def observe(self, req_id: str, drafted: int, accepted: int) -> None:
        """Fold one verify outcome into the slot's acceptance EMA."""
        if drafted <= 0:
            return
        st = self._state(req_id)
        st.drafted += drafted
        st.accepted += accepted
        ratio = accepted / drafted
        st.ema = (1.0 - self.cfg.ema_alpha) * st.ema \
            + self.cfg.ema_alpha * ratio
        if st.enabled and st.ema < self.cfg.disable_below:
            st.enabled = False
            st.cooldown = self.cfg.reprobe_after

    def forget(self, req_id: str) -> None:
        self._slots.pop(req_id, None)

    def enabled(self, req_id: str) -> bool:
        """Would a draft() call currently propose for this request?
        (Read-only: does not tick the cooldown.)"""
        st = self._slots.get(req_id)
        return st is None or st.enabled or st.cooldown <= 0

    def disabled_count(self) -> int:
        """Live slots currently sitting out speculation (EMA floor).

        Unlike the other methods this one IS called off the engine
        thread (the /metrics collector) — ``list()`` snapshots the dict
        values in one GIL-atomic op so concurrent draft/forget churn on
        the engine thread cannot raise mid-iteration."""
        return sum(1 for st in list(self._slots.values()) if not st.enabled)
