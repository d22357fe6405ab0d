"""SFT data pipeline: chat JSONL -> packed, loss-masked token batches.

The port's own copy of ``helix_tpu/training/data.py`` (numpy only, no
JAX): examples are tokenized with the serving chat template (the port's
tokenizers, ``serving/tokenizer.py``), loss is masked to assistant spans,
and sequences are packed greedily into fixed ``[B, S]`` batches with
segment ids, so packed examples never attend across a boundary, and
positions that restart per segment.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SFTExample:
    input_ids: list          # full token sequence
    loss_mask: list          # 1 where loss applies (assistant tokens)


def example_from_messages(messages: Sequence[dict], tokenizer) -> SFTExample:
    """Tokenize a chat transcript; loss on assistant turns only."""
    ids: list = []
    mask: list = []
    for i, m in enumerate(messages):
        turn = tokenizer.apply_chat_template(
            [m], add_generation_prompt=False
        )
        ids.extend(turn)
        mask.extend([1 if m["role"] == "assistant" else 0] * len(turn))
    return SFTExample(input_ids=ids, loss_mask=mask)


def example_from_prompt_completion(
    prompt: str, completion: str, tokenizer
) -> SFTExample:
    p = tokenizer.encode(prompt)
    c = tokenizer.encode(completion)
    eos = list(tokenizer.eos_ids[:1])
    return SFTExample(
        input_ids=p + c + eos,
        loss_mask=[0] * len(p) + [1] * (len(c) + len(eos)),
    )


def load_jsonl(path: str, tokenizer) -> list:
    """Accepts axolotl/OpenAI-style rows: {"messages": [...]} or
    {"prompt": ..., "completion": ...}."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "messages" in row:
                out.append(example_from_messages(row["messages"], tokenizer))
            else:
                out.append(
                    example_from_prompt_completion(
                        row.get("prompt", ""), row.get("completion", ""),
                        tokenizer,
                    )
                )
    return out


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray        # [B, S] int32 (inputs)
    targets: np.ndarray       # [B, S] int32 (inputs shifted left)
    loss_mask: np.ndarray     # [B, S] f32   (on targets)
    positions: np.ndarray     # [B, S] int32 (restart per packed segment)
    segment_ids: np.ndarray   # [B, S] int32 (0 = padding)


def pack_examples(
    examples: list,
    batch_size: int,
    seq_len: int,
    shuffle_seed: Optional[int] = 0,
    drop_remainder: bool = False,
) -> Iterator[Batch]:
    """Greedy packing into [B, S] rows with per-row segment counters
    (axolotl's ``sample_packing: true``): every batch has one shape;
    padding has segment 0 and position 0."""
    order = np.arange(len(examples))
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(order)

    def fresh():
        return Batch(
            tokens=np.zeros((batch_size, seq_len), np.int32),
            targets=np.zeros((batch_size, seq_len), np.int32),
            loss_mask=np.zeros((batch_size, seq_len), np.float32),
            positions=np.zeros((batch_size, seq_len), np.int32),
            segment_ids=np.zeros((batch_size, seq_len), np.int32),
        )

    batch = fresh()
    cursors = np.zeros(batch_size, np.int32)   # fill position per row
    seg_counter = np.ones(batch_size, np.int32)
    used = False

    for idx in order:
        ex = examples[idx]
        ids = ex.input_ids[: seq_len]          # truncate overlong examples
        lm = ex.loss_mask[: seq_len]
        n = len(ids) - 1                       # next-token pairs
        if n <= 0:
            continue
        row = int(np.argmin(cursors))
        if cursors[row] + n > seq_len:         # nothing fits -> emit batch
            if used:
                yield batch
            batch, cursors = fresh(), np.zeros(batch_size, np.int32)
            seg_counter = np.ones(batch_size, np.int32)
            used = False
            row = 0
        c = int(cursors[row])
        batch.tokens[row, c : c + n] = ids[:-1]
        batch.targets[row, c : c + n] = ids[1:]
        batch.loss_mask[row, c : c + n] = lm[1:]
        batch.positions[row, c : c + n] = np.arange(n)
        batch.segment_ids[row, c : c + n] = seg_counter[row]
        seg_counter[row] += 1
        cursors[row] += n
        used = True

    if used and not drop_remainder:
        yield batch
