"""Host-side metadata for the unified ragged device step.

Port of ``helix_tpu/engine/ragged.py``: the prefill token-bucket ladder and
the ``PrefillPlan`` row packer are host code, copied; ``finalize_device``
uploads the finalized arrays to the engine's device as torch tensors.  The
compiled-shape registry has no counterpart: the port runs eagerly and
compiles nothing per shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from helix_tpu_torch.device import upload


def parse_token_buckets(
    spec: Optional[str], page_size: int, cap: int
) -> tuple:
    """The prefill token-bucket ladder, ascending, capped at ``cap``.

    ``spec`` (from ``HELIX_TOKEN_BUCKETS``) is a comma-separated list of
    rung sizes; invalid entries raise (a typo'd ladder must not silently
    become the default).  ``None``/empty: powers of two from
    ``page_size`` up to ``cap``.  The top rung is always ``cap`` so any
    admissible chunk has a home."""
    if spec:
        rungs = sorted(
            {min(int(tok), cap) for tok in spec.split(",") if tok.strip()}
        )
        if not rungs or any(r <= 0 for r in rungs):
            raise ValueError(
                f"HELIX_TOKEN_BUCKETS {spec!r}: rungs must be positive ints"
            )
    else:
        rungs = []
        b = page_size
        while b < cap:
            rungs.append(b)
            b *= 2
    if not rungs or rungs[-1] != cap:
        rungs.append(cap)
    return tuple(rungs)


def bucket_tokens(n: int, ladder: tuple) -> int:
    """Smallest rung >= n (callers guarantee n <= ladder[-1])."""
    for b in ladder:
        if b >= n:
            return b
    return ladder[-1]


@dataclasses.dataclass
class PrefillRow:
    req: object                 # engine.Request (None for warmup rows)
    table: np.ndarray           # full page table row [maxP]
    start: int                  # pages-resident history tokens
    rem: int                    # fresh tokens this call
    tokens: list                # the rem token ids
    key: np.ndarray             # [2] u32 sampling sub-key
    sampling: object            # SamplingParams
    t0: int = 0                 # assigned at finalize
    adapter: int = 0            # multi-LoRA pool slot (0 = identity)


class PrefillPlan:
    """One call's prefill segment: rows packed back-to-back on a flat
    token axis, finalized to a ladder rung.

    The unification win lives here: cache-hit prompts (nonzero
    ``start``), cold packed prompts and the in-flight chunk all share
    ONE segment instead of one padded call each."""

    def __init__(self, page_size: int, max_pages: int, max_rows: int):
        self.page_size = page_size
        self.max_pages = max_pages
        self.max_rows = max_rows
        self.rows: list = []
        self.used = 0

    def fits(self, rem: int, cap: int) -> bool:
        return len(self.rows) < self.max_rows and self.used + rem <= cap

    def add(self, req, table, start: int, rem: int, tokens, key,
            sampling, adapter: int = 0) -> None:
        row = PrefillRow(
            req=req, table=np.asarray(table), start=int(start),
            rem=int(rem), tokens=list(tokens), key=key, sampling=sampling,
            t0=self.used, adapter=int(adapter),
        )
        self.rows.append(row)
        self.used += row.rem

    @property
    def has_hist(self) -> bool:
        return any(r.start > 0 for r in self.rows)

    @property
    def has_adapter(self) -> bool:
        return any(r.adapter for r in self.rows)

    def finalize(self, rung: int):
        """Device arrays for the unified step's prefill inputs.

        Returns a dict of host arrays: ``tokens/pos/seg/pages/offsets/aids
        [1, rung]``, per-row ``t0/qlen/hist/ends [R]``, ``tables [R,
        maxP]`` and the rows' sampling keys ``[R, 2]``.  ``aids`` is each
        token's multi-LoRA pool slot (0 = identity: padding and
        adapter-free rows add an exact zero delta)."""
        R = self.max_rows
        ps = self.page_size
        tokens = np.zeros((1, rung), np.int32)
        pos = np.zeros((1, rung), np.int32)
        seg = np.zeros((1, rung), np.int32)
        pages = np.zeros((1, rung), np.int32)
        offsets = np.zeros((1, rung), np.int32)
        aids = np.zeros((1, rung), np.int32)
        t0 = np.zeros((R,), np.int32)
        qlen = np.zeros((R,), np.int32)
        hist = np.zeros((R,), np.int32)
        ends = np.zeros((R,), np.int32)
        tables = np.zeros((R, self.max_pages), np.int32)
        keys = np.zeros((R, 2), np.uint32)
        for j, row in enumerate(self.rows):
            sl = slice(row.t0, row.t0 + row.rem)
            tokens[0, sl] = row.tokens
            abs_pos = np.arange(row.start, row.start + row.rem)
            pos[0, sl] = abs_pos
            seg[0, sl] = j + 1
            # clamp: real rows never exceed their table (admission caps
            # max_len)
            pages[0, sl] = row.table[
                np.minimum(abs_pos // ps, len(row.table) - 1)
            ]
            offsets[0, sl] = abs_pos % ps
            aids[0, sl] = row.adapter
            t0[j] = row.t0
            qlen[j] = row.rem
            hist[j] = row.start
            ends[j] = row.t0 + row.rem - 1
            tables[j, : len(row.table)] = row.table
            keys[j] = row.key
        # unused rows park at the segment end (ascending-start contract)
        t0[len(self.rows):] = self.used
        return {
            "tokens": tokens, "pos": pos, "seg": seg,
            "pages": pages, "offsets": offsets, "aids": aids,
            "t0": t0, "qlen": qlen, "hist": hist, "ends": ends,
            "tables": tables, "keys": keys,
        }

    def finalize_device(self, rung: int, device) -> dict:
        """``finalize`` + the host->device upload of every array, queued
        without a synchronising copy (``device.upload``); the keys, which
        the sampler takes as host words, stay numpy."""
        out = {}
        for k, v in self.finalize(rung).items():
            out[k] = v if k == "keys" else upload(v, device)
        return out
