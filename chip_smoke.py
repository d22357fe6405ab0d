#!/usr/bin/env python3
"""Chip smoke test of helix_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phase kernels # build + kernel checks only
    python3 chip_smoke.py --phase hotswap # those + the hot-swap phase
    python3 chip_smoke.py --phase adapters # those + the adapter phase
    python3 chip_smoke.py --phase checkpoint # those + the checkpoint phase
    python3 chip_smoke.py --phase slo     # those + the scheduler phase
    python3 chip_smoke.py --phase node    # those + the node-agent phase
    python3 chip_smoke.py --phase tunnel  # those + the tunnel phase
    python3 chip_smoke.py --phase disagg  # those + the disagg phase
    python3 chip_smoke.py --phase context # those + the tiered context phase
    python3 chip_smoke.py --phase vision  # those + the Qwen2-VL phase
    python3 chip_smoke.py --phase moe     # those + the Mixtral phase
    python3 chip_smoke.py --phase train   # those + the LoRA SFT phase
    python3 chip_smoke.py --phase tp      # those + the tensor-parallel phase

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit (``nvidia-smi``), the CUDA
   version, an ``nvcc`` build of the four kernel sources from
   ``helix_tpu_torch/csrc/`` (one process per source, started together),
   and each kernel's
   registers, local (spill) memory, shared memory per block and blocks
   per SM at the main path's shapes;
2. K2 (flash attention), 3. K1 (ragged paged attention) and 3b. K1's
   int8-pool form: each kernel's wrapper on the card at Llama-3-8B
   attention widths (H 32, KVH 8, D 128, bf16; int8 pools quantized by
   the port's ``quantize_kv``) and at the shapes the serving path gives
   it, held against its plain PyTorch version on live tokens (per
   element: K1 to one bf16 ulp of the plain value; K2, which rounds P to
   bf16 as the TPU kernel does, to ``flash_error_limit``) and shown to
   fail that check on planted faults (a key too many or too few; for
   int8, scales read from the neighbouring slot), K1 also with histories
   at the edges of its split over pages and on speculative verify rows
   (8 rows of 5 tokens, and the spec cell's 16 rows of 5 at its
   histories on its 3968-page pool), timed with CUDA events beside
   the plain version, one PyTorch library call
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take (``bound_ms``);
3c. Phi-3 kernels (``phase_phi3_kernels``): K2 and K1-int8 at
   Phi-3-mini's widths, group 1 (H = KVH = 32) and head dim 96: K2
   causal and packed at S 2048, K1-int8 on a 1024-page pool with 16
   decode rows (histories 500-2000) and a 256-token row beside 15 decode
   rows, under the same limits, planted faults and timings;
3d. K1's cold form (``phase_k1_cold``): K1 and K1-int8 on tiered rows at
   the entry's widths (H 32, KVH 8, D 128, P 16): 4 decode and 4 verify
   rows of 5 at histories 6000-8000, each with a page-aligned ~5000-token
   middle demoted (table entries zeroed, its pages packed into a slab of
   64-token chunks, one chunk owned by no row), beside 8 resident rows;
   held to the plain version and to the resident call on the same
   values, and three planted faults must fail (a chunk's owner moved,
   ``span_lo`` one page late, one cold scale negated); two launches
   bit-equal; timed beside the resident call, SDPA and the CUDA-core
   form's recorded time, which the tensor-core form must beat;
3e. Qwen2-VL kernels (``phase_vl_kernels``): K2 as the VL single-shot
   prefill calls it (causal, B 1, S 2048 and 4096 with a validity
   segment over 1,275 / 3,100 prompt tokens) and K1 with 8 decode rows
   at histories 1,300-4,000 on a 4096-page pool, at Qwen2-VL-7B's group 7
   (H 28, KVH 4, D 128), under the same limits, faults and timings;
2b. K2-backward (``phase_k2_backward``): the training shapes (B 8, S
   1024, H 32, KVH 8, D 128, bf16, segments and positions as
   ``pack_examples`` lays chats out), a small float32 case and a
   soft-capped case (cap 2).  K2's forward with its LSE at each: the
   output against the plain version per element (``flash_error_limit``
   in bf16, 1e-5 + 1e-5 |want| in float32; a dropped diagonal key must
   break it), the LSE against ``torch.logsumexp`` of the plain version's
   scores.  ``flash_attention_backward`` against autograd through the
   plain version (``flash_backward_plain``) per element within
   ``flash_backward_error_limit``; planted defects (a query head against
   the wrong KV head, the causal mask dropped, Delta left out, the cap's
   derivative dropped) must break it; in bf16 that limit carries the
   rounding of P and dS to bf16 before their tensor-core products.  Both
   timed beside their plain versions, SDPA with the same boolean mask
   (forward; backward alone on a retained graph; forward and backward: a
   yardstick the port never calls) and their bounds; both kernels'
   resources logged for both dtypes (the bf16 form must not spill);
4. end to end: ``meta-llama/Meta-Llama-3-8B-Instruct`` at full width and
   depth in bf16 with random weights made on the card, served by the
   port's engine, loop and OpenAI HTTP server; chat (plain and SSE),
   completion, 8 concurrent chats, a prompt longer than max_prefill_len
   (chunked, mixed with a decoding request), the same prompt again (a
   prefix-cache hit), and one seeded temperature 0.8 request sent twice,
   whose two texts must be identical.  The kernels' launch counters are
   zeroed just before and read just after: both must have run;
   The 8-chat batch is admitted together (``_gated_batch``), so its
   shapes do not depend on HTTP timing;
4a. async: phase 4 again with ``enable_async_loop`` on, in the same
   call: the 8-chat greedy batch and the seeded request must give the
   off run's tokens and the pipeline must have dispatched steps ahead;
   pipelined steps, ``device_idle_ratio()``, the traced batch's idle
   share and decode tok/s are printed for both;
4b. the same with int8 weights and an int8 KV pool (the profile fields
   ``quantization: int8`` and ``kv_cache_dtype: int8``), after phase 4
   has freed its engine: K1's int8 form must have run;
4c. spec: the ``profiles/v5e1-hotswap.yaml`` Llama entry as written
   (int8 weights and KV, 16 slots, 3968 pages, ``enable_spec_decode``,
   ``spec_tokens: 4``, its 16 GiB ``host_pool_bytes``; its adapter pool
   is phase 4g's): 16 chats quoting a passage, all answered, K1-int8 on
   verify rows, the seeded request reproduced; acceptance ratio, decode
   tokens per device step and active slot, TTFT, tok/s and memory
   printed; then the same chats with speculation off, for the share of
   greedy tokens that agree;
4d. oracle: 2 layers at full width in float32, greedy and seeded
   sampled requests without speculation, with a drafter proposing the
   recorded continuation (same tokens, fewer device steps) and with one
   proposing wrong tokens (no more device steps; see ``phase_oracle``);
   then the same with int8 weights and an int8 KV pool, where K1-int8
   must run the accepted verify rows;
4e. host tier (``phase_host_tier``, ``phase_host_exact``): the same
   entry at full width spills ~1500-token prefixes to its host tier by
   overflowing the pool and restores them (checksums equal, tokens equal
   to the device-resident run, K1-int8 on the restored rows); the
   ladder preempts by swap and resumes under page pressure
   (``HELIX_PREEMPT_STALL_SECONDS=0.5``); a streaming chat drains from
   one server to another over HTTP and resumes there, every token once;
   at 2 layers in float32, and with int8 weights + KV, greedy and seeded
   tokens are identical across preempt / resume and export / import.
   Host-link rates, preempt / resume / encode / decode times, wire size,
   import-to-first-token and host-pool occupancy are printed, each line
   with the card's name and power limit;
4f. hot-swap (``phase_hotswap``): ``profiles/v5e1-hotswap.yaml``'s two
   models, Llama-3-8B (int8 weights and KV) and Phi-3-mini (bf16
   weights, int8 KV), both at full width and depth, served one at a time
   under the profile's 14 GiB budget by the ``ResidencyManager`` that
   ``serve-node`` builds from a ``residency`` block, behind the OpenAI
   server (cuts, printed: the Llama entry's ``slo`` and adapters, Phi-3's
   pool to 1024 pages).  A synchronous load; a swap that evicts the idle
   model and frees >= 95% of its measured bytes before the next build
   (K2 and K1-int8 run at D 96); a 503 ``overloaded_error`` for a model
   asked for while the other is busy, whose reply finishes whole;
   ``/admin/prefetch``, after which a chat stalls for a small share of
   the first load and the seeded request gives the first load's tokens;
   three swap cycles without memory growth; Phi-3's entry as written
   refused with the reference's ``MemoryError`` text and nothing
   allocated.  Loads, swaps, estimates against measured bytes and memory
   before and after each eviction are printed with the card's name and
   power limit;
4g. adapters (``phase_adapters``, ``phase_adapter_exact``): the same
   Llama entry with its ``adapter_pool_slots: 8`` and ``adapter_rank:
   16`` (only ``slo`` cut): 16 adapter-free chats give the same tokens
   with the pool on and off; adapters published from seeds into the
   filestore rung are prefetched and served over HTTP as
   ``model@adapter`` in mixed batches with the base model (tokens unlike
   the base's, mixed-adapter steps, no page shared across adapters or
   with the base model), a wave over 11 adapters churns the 7 usable
   slots without evicting a pinned one, K2 and K1-int8 run adapter rows,
   a seeded adapter chat reproduces; at 2 layers in float32 a mixed wave
   equals pool-less engines on merged weights.  Pool and model bytes
   against the estimates, load times, TTFT and tok/s beside the
   adapter-free run, a traced mixed batch and the pool GEMMs' cost are
   printed;
4h. checkpoints (``phase_checkpoint``): the same two models written as
   HF safetensors checkpoints (Llama-3-8B per projection, Phi-3-mini
   with fused ``qkv_proj`` / ``gate_up_proj``, bf16 weights of seed 0,
   each with its fixture ``tokenizer.json`` from ``helix_tpu_torch/
   testing/tokenizer_fixtures``, both at ``CKPT_LAYERS`` (2) of 32
   layers, full width: 3.8 GB under the system temp dir or
   ``HELIX_SMOKE_CKPT_DIR``, deleted at the end) and served by
   ``serve-node``'s profile path
   without ``--random-weights``: the loaded weights equal the as-drawn
   build of seed 0 byte for byte (int8 Llama, bf16 Phi-3), 8 greedy
   chats give the as-drawn build's ids, the served tokenizers give the
   CPU tests' digests, a planted ``<|eot_id|>`` stops a chat, three swap
   cycles free each model before the next build and a prefetched model's
   chat barely stalls.  Load seconds first and again, read and upload
   GB/s, the int8 load's device peak against the as-drawn build's, the
   host's anonymous memory during each load, swap seconds, TTFT and encode
   times are printed;
4i. the scheduler, SLO accounting and /metrics (``phase_slo``): the
   same Llama entry exactly as the profile writes it, its ``slo`` block
   with the WFQ ``sched`` included, served by ``serve-node``'s profile
   path: 8 greedy chats admitted together give the same ids as on a node
   whose entry drops ``slo`` (both traced); 80 ~1500-token batch requests
   of tenant ``flood`` get exactly 16 429 ``queue_full`` answers with
   ``Retry-After: 1`` and 16 interactive chats of tenant ``chat`` none;
   every chat is admitted before any flood request under WFQ and after
   them under ``HELIX_SCHED_POLICY=fifo``; the prefill budget, scraped
   from ``/metrics`` every 0.5 s, stays in [512, 4096]; every scrape
   parses and matches ``helix_tpu_torch/testing/metric_families.json``;
   a poisoned request among 8 chats is quarantined alone
   (``engine_step`` fault), and at 2 layers in float32 the survivors'
   tokens equal an unpoisoned run's.  Any other engine step failure in
   the run fails the smoke;
4j. the node agent (``phase_node_agent``): ``serve-node --runner-id a
   --control-plane <stub>`` in process against a stand-in control plane
   (``helix_tpu_torch/testing/control_stub.py``): the card's inventory
   against the profile as written (refused: it asks for a ``tpu`` chip)
   and its ``{vendor: nvidia}`` copy; the assigned Llama entry as written
   applied (``loading`` -> ``running``), its heartbeat (the card, exactly
   ``SATURATION_KEYS``, tenants, ``model@a1``); 8 chats with the
   agent-free node's ids (phase 4i's), ``/v1/messages``; a diff re-apply
   that adds Phi-3 under a running Llama stream and one that drops it
   (>= 95% of its bytes freed); ``/admin/profiler`` (a trace naming
   K1-int8 and K2, 409, 403), ``/logs``, ``/api/v1/state``; a drain on
   the stub's request that ships 9 streams to node B, every token once,
   the seeded stream as undrained; a drained ``serve-node`` process
   exits 0.  Apply seconds, heartbeat gaps, the heartbeat body's host
   µs, drain seconds and tok/s with and without a capture are printed;
4k. the reverse tunnel and embeddings (``phase_tunnel``): every request
   through the stub's tunnel to ``serve-node --tunnel`` nodes (no TCP
   listener): node T (that wiring in process) is assigned the Llama
   entry beside ``BAAI/bge-base-en-v1.5`` (``kind: embedding``, a
   float32 bge-base checkpoint of seed 0 and a 30522-entry WordPiece
   tokenizer written in the phase); 64 texts of 8-512 tokens embedded
   and held to the CPU's plain path, a 64 x 512 batch timed, the entry's
   bytes beside the reference's 256 MiB estimate; 8 greedy chats through
   the tunnel with the ids of the same 8 sent direct to the unix socket;
   a websocket closed mid-stream by the stub (the runner re-dials, the
   slot frees, no traceback); process S (``python -m helix_tpu_torch
   serve-node --tunnel``) gives T's vectors and exits 0 on SIGTERM with
   4 streams in flight, each ended whole;
4l. the disaggregated prefill handoff and the persistent KV filestore
   (``phase_disagg``): node P (the Llama entry with ``role: prefill``,
   at 16 of its 32 layers for the smoke's time) and node D (``role:
   decode``) on one filestore directory; 8 greedy
   chats over a shared ~1500-token system prompt handed from P to D
   through the stub's plan (every token once, the counters up by 8),
   the same 8 colocated on D, a dropped and a corrupt transfer served
   whole on P, P's blobs, a restarted node restoring the shared prompt
   from disk against a cold node, a torn blob recomputed; the same at 2
   layers in float32 with handoff = colocated and warm = cold demanded;
   K2 and K1-int8 launches per node;
4m. tiered long context and the context-caching API
   (``phase_context``): the Llama entry through serve-node's profile
   path with ``HELIX_CTX_HOT_PAGES=32``: a wave of ~7,880-token chats
   tiered and resident (every token once, the tiered peak of pool pages
   at most half the resident one, re-stages, TTFT, tok/s, traced idle
   share, one cold-form launch per tiered attention call and no plain
   op), ``POST`` / ``GET /v1/context`` with 8 chats through the handle,
   a 429 and a 404, ``helix_ctx_*`` at ``/metrics``; at 2 layers in
   float32 tiered = resident, handle = written out, and a corrupt cold
   page ends its stream with the ``ColdPageError`` text;
4n. vision (``phase_vision``): ``profiles/v5e8-llama3-plus-embed.yaml``'s
   ``Qwen/Qwen2-VL-7B-Instruct`` entry (its mesh cut to ``{tp: 1}``; at
   14 of its 28 text layers and 32 vision blocks for the smoke's time)
   from a bf16 checkpoint of seed 0 written here: 8 chats with
   PNG images of 224x224 to 1280x960 (one with two, one text only)
   answered whole with K1 and K2 launched and traced, a seeded image chat
   reproduced, the reference's 400s, a ``vision-embedding`` entry on the
   same checkpoint embedding 16 mixed inputs in order, and the 2-layer
   float32 witness (image embeddings against the CPU, TF32 breaking the
   limit, greedy ids 8 of 8); host ms per image, tower ms per size, TTFT,
   tok/s, idle share and the entry's bytes are printed;
4o. mixture of experts (``phase_moe``): ``profiles/v5e8-mixtral.yaml``'s
   ``mistralai/Mixtral-8x7B-Instruct-v0.1`` entry (int8 weights of seed
   0 at full width and depth, 46.7 B parameters; its mesh cut to one
   device, speculation asked for and logged off) through serve-node's
   profile path: 8 chats of 64 tokens (one chunked, one a prefix-cache
   hit) answered whole with K1 and K2 launched, the seeded chat twice
   the same, ``helix_moe_dropped_tokens_total`` at ``/metrics``, a traced
   wave (the int8 expert casts named); the build's seconds and peak and
   the measured bytes beside the reference's estimate; then at 2 layers
   in float32 with a lowered capacity factor the card's ids and prefill
   drops equal the CPU's (TF32 breaks the logit limit), and a 2-layer
   HF-named checkpoint loads int8 byte-equal to the as-drawn build;
4p. LoRA SFT (``phase_train``): ``meta-llama/Meta-Llama-3-8B-Instruct``
   at full width and depth in bf16 (random weights, seed 0) trained by
   ``SFTTrainer`` (rank 16, alpha 32 on wq, wk, wv, wo) for
   ``TRAIN_STEPS`` steps of 8 x 1024 tokens packed from chat rows written
   in the phase and tokenized with the Llama-3 fixture tokenizer: the loss
   must fall; every attention forward launches K2 and every backward
   K2-backward (counts zeroed just before the run); step ms, tokens/s,
   peak memory and one traced step's idle share are printed, with the
   traced step's K2-backward kernels by name and their device ms (its
   bf16 dK/dV and dQ kernels and the Delta pre-pass must be there).  The
   checkpoint is saved, an engine with an adapter pool is built over the
   same base tensors, the checkpoint is published through ``POST
   /v1/adapters`` and 8 chats to ``model@sft`` are answered, each unlike
   the base model's.  Then the 2-layer float32 witness at full width:
   three steps on the card and on the CPU from the same adapter agree
   within ``TRAIN_LOSS_RTOL`` / the parameter limit, TF32 (the control)
   breaks it, and the witness adapter's greedy tokens through the pool
   equal those of the build that merges it at apply (the profile's
   ``adapter:`` field);
3f. tp kernels (``phase_tp_kernels``): K2 and K1-int8 at a tp 4 shard of
   Llama-3-8B (H 8, KVH 2, D 128): K2 on a packed wave of two 1536-token
   prompts, K1-int8 with 32 decode rows and a 1024-token chunk row beside
   31 on a shard's int8 pool of 15,872 pages, under the same limits,
   faults and timings;
4q. tensor parallel on one host (``phase_tp``): (a) the
   ``profiles/v5e8-llama3-plus-embed.yaml`` Llama entry (its engine block
   and ``context_length`` as written: 32 slots, 15,872 int8 pages,
   prefill 4096, the async loop) at full width and depth, bf16 weights of
   seed 0, built by ``build_served_model`` with a tp 4 mesh over an
   explicit device list (cards 0-3 when four are visible, else card 0
   four times; printed as ``tp_cards``) behind the OpenAI server: 16
   chats of ~1500 tokens and 64 new tokens answered, the seeded request
   twice the same, TTFT p50 and decode tok/s beside a tp 1 engine on the
   same traffic in the same call, each card's bytes within 5% of its
   shards' share of weights + pool (no card but the first above its
   shards), K1-int8 and K2 launches = shards x layers x attention
   forwards (counters, and per card from a traced wave), each card's
   traced idle share, and one 4096-token prefill chunk split into
   compute and its 64 sums; ``nvidia-smi topo -m`` printed; (b) the
   profile cut to that entry (``{vendor: nvidia, chips: 4}``) through
   ``serve-node``'s profile path: on four cards served over cards 0-3,
   8 chats answered, K1 and K2 traced on every card; on fewer refused
   with the reference's ``slice_devices`` text, nothing built; (c) 2
   layers at full width in float32, TF32 off, tp 4 against tp 1 on the
   same weights: 8 of 8 greedy streams equal;
5. parity: the engine at full width and 2 layers, kernels vs plain
   versions on the same weights, logits compared within a bf16
   tolerance, in bf16 and with int8 weights and KV.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` line,
and last the device JSON line.  The kernels build in ``helix_tpu_torch/
kernels/build.py``; every number printed is measured in this run.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version, per element: |got - want| <= ATOL + RTOL |want|.
# Both compute in f32 and round once to bf16, so on live tokens they may
# differ by one bf16 ulp of the value (<= 2**-7 |want|); ATOL covers the
# f32 summation-order noise (~1e-6) of values near zero.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-5
LOGIT_TOL = 0.25         # see phase_parity
# R1 check: one seeded sampled request, sent twice.  The prompt stays
# under one page (16 tokens), so neither run hits the prefix cache (a hit
# attends the pooled K/V -- quantized in the int8 phase -- which is a
# different input, not a different draw).
SEEDED = {"prompt": "Once upon a", "max_tokens": 24, "temperature": 0.8,
          "seed": 1234}
H, KVH, D = 32, 8, 128
MODEL = "meta-llama/Meta-Llama-3-8B-Instruct"


def log(msg: str) -> None:
    print(msg, flush=True)


# the phase running now, and every engine step failure of the run as
# (phase, loop name, error): the only ones allowed are phase 4i's planted
# faults (``main`` checks)
PHASE = [""]
STEP_FAILURES: list = []


def _timed(fn):
    """Log a phase's wall seconds when it returns (the smoke's time
    budget is shared by every phase)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.monotonic()
        outer, PHASE[0] = PHASE[0], fn.__name__
        try:
            out = fn(*args, **kwargs)
        finally:
            PHASE[0] = outer
        log(f"[time] {fn.__name__}{args if args else ''}: "
            f"{time.monotonic() - t0:.1f} s")
        return out

    return run


def _watch_step_failures() -> None:
    """Record every engine step failure with its phase: the loop's retry
    and quarantine ladder would otherwise serve on past a kernel fault."""
    from helix_tpu_torch.serving.engine_loop import EngineLoop

    handle = EngineLoop._handle_step_failure

    def watched(self, e, *args, **kwargs):
        STEP_FAILURES.append((PHASE[0], self.name, repr(e)[:300]))
        return handle(self, e, *args, **kwargs)

    EngineLoop._handle_step_failure = watched


# the step failures phase 4m(c)'s corrupt cold page causes, as recorded
CORRUPT_PAGE_FAILURES: list = []


def _check_step_failures() -> None:
    bad = [f for f in STEP_FAILURES
           if not (f[0] == "phase_slo" and "injected engine-step fault" in f[2])
           and f not in CORRUPT_PAGE_FAILURES]
    log(f"[steps] engine step failures: {len(STEP_FAILURES)}, all of them "
        f"phases 4i's and 4m's planted faults: {not bad}")
    if bad:
        raise AssertionError(f"engine steps failed outside phases 4i's and "
                             f"4m's planted faults: {bad[:5]}")


# GPU clock cycles of the sleep kernel queued ahead of each timed call
SLEEP_CYCLES_PER_CALL = 2_000_000


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = True) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls.

    ``queued``: a sleep kernel first holds the stream while the host
    enqueues all the calls, so the events bracket the device's work back
    to back -- the kernel's time, not the rate at which the host issues
    it (a wrapper's Python checks can take longer than a small kernel).
    Otherwise the calls are timed as the host issues them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got, want) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not np.isfinite(err):
        raise AssertionError("non-finite kernel output on live tokens")
    return err


def tol_ratio(got, want, limit=None) -> float:
    """Worst |got - want| / limit: 1 is the limit.  The default limit is
    one bf16 ulp, BF16_ATOL + BF16_RTOL |want|; K2 passes
    ``flash_error_limit``'s per-element tensor."""
    got, want = got.float(), want.float()
    if limit is None:
        limit = BF16_ATOL + BF16_RTOL * want.abs()
    ratio = ((got - want).abs() / limit).max().item()
    if not np.isfinite(ratio):
        raise AssertionError("non-finite kernel output on live tokens")
    return ratio


def check(label, got, want, limit=None) -> tuple:
    """(max_abs_err, worst tolerance ratio); raises past the limit."""
    err, ratio = max_err(got, want), tol_ratio(got, want, limit)
    if ratio > 1.0:
        raise AssertionError(
            f"{label}: error {ratio:.2f}x the limit (max_abs_err {err:.3e})")
    return err, ratio


def planted(label, got, want, limit=None) -> float:
    """A deliberately wrong input must fail ``check``: shows the limit is
    tight enough to see a key too many or too few."""
    ratio = tol_ratio(got, want, limit)
    if ratio <= 1.0:
        raise AssertionError(
            f"planted fault {label} passed the check ({ratio:.2f}x the "
            "limit): the limit is too loose")
    return ratio


# ---------------------------------------------------------------------------
# 1. device + build
# ---------------------------------------------------------------------------


@_timed
def phase_device() -> dict:
    from helix_tpu_torch.kernels.build import build_all
    from helix_tpu_torch.ops.attention import K2, K2B
    from helix_tpu_torch.ops.paged_kernel import K1, K1_COLD
    from helix_tpu_torch.ops.quant import matmul_f32

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    compile_s = build_all([K1, K1_COLD, K2, K2B])
    log(f"[build] nvcc for the four kernel sources: {compile_s:.1f} s "
        f"compile, {time.monotonic() - t0:.1f} s incl. load")
    for k in (K1, K1_COLD, K2, K2B):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                           k.build_log)]
        spills = re.findall(r"(\d+) bytes spill stores", k.build_log)
        if regs:
            log(f"[build] {k.name}: {len(regs)} instantiations, at most "
                f"{max(regs)} registers, spill stores "
                f"{max(int(s) for s in spills) if spills else 0} bytes")
        # each instantiation with a stack frame or spills, by name
        for fn, frame, spill in re.findall(
                r"Function properties for (\S+)\s+(\d+) bytes stack "
                r"frame, (\d+) bytes spill stores", k.build_log):
            if int(frame) or int(spill):
                log(f"[build]   {fn}: {frame} B stack frame, {spill} B "
                    "spill stores")
    infos = kernel_infos()
    for kname, info in infos.items():
        log(f"[build] {kname} at the main path's shapes ({DESIGN[kname]}): "
            f"{info['regs']} registers, {info['spill_bytes']} B local (spill) "
            "memory, "
            f"{info['smem_bytes']} B shared memory per block, "
            f"{info['blocks_per_sm']} blocks per SM")
        if info["blocks_per_sm"] < 1:
            raise AssertionError(f"{kname}: a block does not fit an SM")
    for kname, info in phi3_kernel_infos().items():
        log(f"[build] {kname} at Phi-3's shapes (H = KVH = 32, D 96): "
            f"{info['regs']} registers, {info['spill_bytes']} B local "
            f"(spill) memory, {info['smem_bytes']} B shared memory per "
            f"block, {info['blocks_per_sm']} blocks per SM")
        if info["blocks_per_sm"] < 1:
            raise AssertionError(f"{kname}: a block does not fit an SM")
    # one rounding per projection: a bf16 GEMM with a float32 output
    a = torch.ones((2, 8), device="cuda", dtype=torch.bfloat16)
    out = matmul_f32(a, a.T.contiguous())
    if out.dtype != torch.float32 or out[0, 0].item() != 8.0:
        raise AssertionError("bf16 GEMM with float32 output is wrong")
    log("[device] torch.mm(..., out_dtype=torch.float32) on bf16: "
        "available (one rounding per projection)")
    return {"smi": smi, "kind": kind, "infos": infos}


DESIGN = {
    "ragged_paged_attention":
        "split-kv over 512-token page spans, cp.async 3-stage ring, f32 "
        "CUDA-core math, f32 merge pass",
    "ragged_paged_attention_int8":
        "split-kv over 512-token page spans, cp.async 3-stage ring of int8 "
        "codes + f32 scales, f32 CUDA-core math, f32 merge pass",
    "flash_attention":
        "wgmma m64n64k16 (SS) for QK^T + m64n128k16 (RS, P in registers) "
        "for PV, cp.async 2-stage 128B-swizzled bf16 ring, tile skipping",
    "ragged_paged_attention_cold":
        "bf16: a pre-pass lists each row's live work on the device (fresh, "
        "hot pieces of <= 512 keys, cold parts of 8 chunks); a fixed grid "
        "of 4-warp blocks takes (query tile, item, KV head) units from a "
        "counter, streams each unit's keys through a 3-stage cp.async ring "
        "of 64 keys, mma.sync m16n8k16 for QK^T and PV (ldmatrix / "
        "ldmatrix.trans, swizzled tiles), f32 softmax on the fragments, P "
        "as two bf16 terms; f32 merge over the row's slots; float32 "
        "queries: the CUDA-core split of K1's source",
    "ragged_paged_attention_int8_cold":
        "the cold form over int8 pools and chunks: codes staged raw, "
        "widened to bf16 in shared memory, K scale on the f32 score, V "
        "scale folded into P",
    "flash_attention_backward":
        "Delta pre-pass; bf16: an exact tile map (the OR / AND of each tile "
        "pair's masks), then wgmma, dK/dV per (64-key tile, KV head) over "
        "the group's heads and query tiles (S^T, dP^T SS; dV += P^T dO, "
        "dK += dS^T Q RS with P^T / dS^T rounded to bf16 in registers), "
        "dQ per (64-query tile, head) recomputing S and dP (dQ += dS K RS), "
        "cp.async 2-stage 128B-swizzled rings, no atomics; f32: CUDA-core "
        "FMA on 4x4 register blocks, range tile skipping",
}


def kernel_infos() -> dict:
    """Each kernel's launch resources at the shapes phases 2-4 give it."""
    from helix_tpu_torch.ops.attention import (
        flash_backward_kernel_info,
        flash_kernel_info,
    )
    from helix_tpu_torch.ops.paged_kernel import ragged_kernel_info

    return {
        "ragged_paged_attention": ragged_kernel_info(8, H, KVH, D, 16, 256),
        "ragged_paged_attention_int8": ragged_kernel_info(
            8, H, KVH, D, 16, 256, quantized=True),
        "flash_attention": flash_kernel_info(D),
        "ragged_paged_attention_cold": ragged_kernel_info(
            8, H, KVH, D, 16, 512, cold=True),
        "ragged_paged_attention_int8_cold": ragged_kernel_info(
            8, H, KVH, D, 16, 512, quantized=True, cold=True),
        # the dK/dV kernel (the dQ kernel is printed beside it)
        "flash_attention_backward": flash_backward_kernel_info(D)["dkdv"],
    }


def phi3_kernel_infos() -> dict:
    """K1-int8's and K2's launch resources at Phi-3-mini's shapes."""
    from helix_tpu_torch.ops.attention import flash_kernel_info
    from helix_tpu_torch.ops.paged_kernel import ragged_kernel_info

    return {
        "ragged_paged_attention_int8": ragged_kernel_info(
            16, 32, 32, 96, 16, 256, quantized=True),
        "flash_attention": flash_kernel_info(96),
    }


# ---------------------------------------------------------------------------
# 2. K2 flash attention
# ---------------------------------------------------------------------------


def _k2_case(label, seg_lens, gen, heads=(H, KVH, D), valid=None):
    """One packed batch row: segments of ``seg_lens``, positions restart
    per segment (one segment = plain causal); ``heads`` = (H, KVH, D).
    ``valid``: the VL single-shot prefill's form instead, one bucket of
    ``seg_lens[0]`` tokens at positions 0..S-1 whose first ``valid`` are
    the prompt (segment 1) and the rest padding (segment 0)."""
    from helix_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_plain,
        flash_error_limit,
    )

    H, KVH, D = heads
    dev = "cuda"
    S = sum(seg_lens)
    i32 = torch.int32
    if valid is None:
        pos = torch.cat([torch.arange(n, dtype=i32) for n in seg_lens])
        seg = torch.cat([torch.full((n,), i + 1, dtype=i32) for i, n in
                         enumerate(seg_lens)])
    else:
        pos = torch.arange(S, dtype=i32)
        seg = (pos < valid).to(i32)
    pos, seg = pos[None].to(dev), seg[None].to(dev)
    q = torch.randn((1, S, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, S, KVH, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, S, KVH, D), generator=gen, device=dev).bfloat16()
    kw = dict(q_positions=pos, kv_positions=pos)
    meta = [pos, pos]
    if len(seg_lens) > 1 or valid is not None:
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
        meta += [seg, seg]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    # P is rounded to bf16 before P.V, as the TPU kernel does: the limit
    # adds that rounding's bound, 2**-8 plain(q, k, |v|)
    limit = flash_error_limit(q, k, v, **kw)
    err, ratio = check(f"K2 {label}", got, want, limit)
    # planted fault: every query loses its own (diagonal) key; row 0 of
    # each segment loses its only one
    fault = planted("K2 diagonal key dropped", flash_attention(
        q, k, v, **{**kw, "kv_positions": pos + 1}), want, limit)
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
    call_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10,
                      queued=False)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 3, 1)
    # library yardstick: SDPA with the equivalent boolean mask
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2)
    mask = (pos[0][:, None] >= pos[0][None, :]) & (
        seg[0][:, None] == seg[0][None, :])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qt, kt, vt, attn_mask=mask[None, None])
    lib_err = max_err(lib_out.transpose(1, 2), want)
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt,
                                      attn_mask=mask[None, None]), 10)
    runs = seg_lens if valid is None else [valid, S - valid]
    pairs = sum(n * (n + 1) // 2 for n in runs)
    b_ms, b_by = bound(4.0 * H * D * pairs, nbytes(q, k, v, got, *meta))
    row = dict(case=label, max_abs_err=err, tol_ratio=ratio,
               planted_fault_ratio=fault, ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by)
    log(f"[K2] {label}: max_abs_err {err:.3e}, {ratio:.3f}x the limit "
        "(flash_error_limit) "
        f"(sdpa {lib_err:.3e}; planted fault {fault:.1f}x) kernel_ms "
        f"{ms:.4f} (as the host issues calls {call_ms:.4f}) plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return row


@_timed
def phase_k2() -> list:
    gen = torch.Generator(device="cuda").manual_seed(2)
    return [
        _k2_case("packed S=512, 4 segments", [140, 100, 152, 120], gen),
        _k2_case("causal S=2048", [2048], gen),
    ]


# ---------------------------------------------------------------------------
# 3. K1 ragged paged attention
# ---------------------------------------------------------------------------


def _k1_case(label, q_lens, hists, pool, gen, rng, scales=None,
             pool_pages=None, heads=(H, KVH, D)):
    """One K1 case.  ``scales``: the int8 pool's (k_scale, v_scale); the
    int8 form is then held to the plain version evaluated in float32 (it
    dequantizes history in f32 without rounding it, like the kernel) and
    rounded once, under the same one-ulp limit; the ratio against the
    bf16 plain version, which rounds the dequantized history to bf16 as
    the reference oracle does, is printed beside it.  ``pool_pages``: run
    on a copy of the pool's first ``pool_pages`` pages (an engine's page
    count), with tables laid out as the engine's: distinct pages up to
    each row's history, the garbage page 0 past it.  ``heads`` = (H,
    KVH, D)."""
    from helix_tpu_torch.ops.paged_kernel import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    H, KVH, D = heads
    dev = "cuda"
    if pool_pages is not None:
        pool = tuple(x[:, :pool_pages].contiguous() for x in pool)
        if scales is not None:
            scales = tuple(x[:, :pool_pages].contiguous() for x in scales)
    kp, vp = pool
    L, N, P = kp.shape[:3]
    maxP = 256
    R = len(q_lens)
    q_lens = np.asarray(q_lens, np.int32)
    hists = np.asarray(hists, np.int32)
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum())
    if pool_pages is None and R * maxP <= N - 1:
        tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(
            R, maxP)
    elif pool_pages is None:
        # more table entries than pages: each row draws its own pages
        tables = np.stack([rng.permutation(np.arange(1, N))[:maxP]
                           for _ in range(R)])
    else:
        walked = -(-(hists + q_lens) // P)
        perm = rng.permutation(np.arange(1, N))
        tables = np.zeros((R, maxP), np.int64)
        for r, (n, a) in enumerate(zip(walked, np.cumsum(walked) - walked)):
            tables[r, :n] = perm[a:a + n]
    meta = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
            for x in (t0, q_lens, hists, tables)]
    q = torch.randn((T, H, D), generator=gen, device=dev).bfloat16()
    kn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    layer = 7
    args = (q, kn, vn, kp, vp, layer, *meta)
    kw = {} if scales is None else dict(k_scale=scales[0],
                                        v_scale=scales[1])
    tag = "K1" if scales is None else "K1-int8"
    got = ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want_bf16 = ragged_paged_attention_plain(*args, **kw)
    if scales is None:
        want = want_bf16
    else:
        want = ragged_paged_attention_plain(
            q.float(), kn.float(), vn.float(), *args[3:], **kw).bfloat16()
    err, ratio = check(f"{tag} {label}", got, want)
    extra = {}
    if scales is not None:
        extra["tol_ratio_vs_bf16_plain"] = tol_ratio(got, want_bf16)
        extra["max_abs_err_vs_bf16_plain"] = max_err(got, want_bf16)
    # planted faults: every row reads one history slot too few / too many
    # (and, for int8, every scale from the neighbouring slot)
    faults = {f"hist{d:+d}": planted(f"{tag} hist{d:+d}",
                                     ragged_paged_attention(
                                         *args[:8], meta[2] + d, meta[3],
                                         **kw), want) for d in (-1, 1)}
    if scales is not None:
        rolled = [torch.roll(x, 1, dims=2).contiguous() for x in scales]
        faults["scale_roll"] = planted(
            f"{tag} scales rolled one slot", ragged_paged_attention(
                *args, k_scale=rolled[0], v_scale=rolled[1]), want)
        del rolled
    ms = cuda_ms(lambda: ragged_paged_attention(*args, **kw), 20)
    call_ms = cuda_ms(lambda: ragged_paged_attention(*args, **kw), 20,
                      queued=False)
    plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, **kw),
                       3, 1)
    # library yardstick: SDPA over each row's gathered (and, for int8,
    # dequantized) history + fresh tokens, rows padded to one batch; the
    # gather and the dequantization are not timed
    Sq = int(q_lens.max())
    Skv = int((hists + q_lens).max())
    qb = torch.zeros((R, H, Sq, D), device=dev, dtype=torch.bfloat16)
    kb = torch.zeros((R, H, Skv, D), device=dev, dtype=torch.bfloat16)
    vb = torch.zeros_like(kb)
    mask = torch.zeros((R, 1, Sq, Skv), device=dev, dtype=torch.bool)
    for r in range(R):
        n, h, s = int(q_lens[r]), int(hists[r]), int(t0[r])
        pages = torch.from_numpy(tables[r]).to(dev).long()
        kh = kp[layer][pages].reshape(-1, KVH, D)[:h]
        vh = vp[layer][pages].reshape(-1, KVH, D)[:h]
        if scales is not None:
            kh = kh.float() * scales[0][layer][pages].reshape(
                -1, KVH)[:h, :, None]
            vh = vh.float() * scales[1][layer][pages].reshape(
                -1, KVH)[:h, :, None]
        kh, vh = kh.bfloat16(), vh.bfloat16()
        k_all = torch.cat([kh, kn[s:s + n]]).repeat_interleave(H // KVH, 1)
        v_all = torch.cat([vh, vn[s:s + n]]).repeat_interleave(H // KVH, 1)
        qb[r, :, :n] = q[s:s + n].transpose(0, 1)
        kb[r, :, :h + n] = k_all.transpose(0, 1)
        vb[r, :, :h + n] = v_all.transpose(0, 1)
        qi = torch.arange(n, device=dev)[:, None] + h
        ki = torch.arange(Skv, device=dev)[None, :]
        mask[r, 0, :n] = ki <= qi
        mask[r, 0, n:, 0] = True          # padding rows: any one key
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qb, kb, vb, attn_mask=mask), 20)
    # bytes: the history K/V walked (int8: codes plus one f32 scale per
    # token and KV head, for K and for V), the page-table entries walked
    # (ceil(hist / P) per row), the row metadata, q, fresh K/V and out
    per_tok = 2 * KVH * D * kp.element_size()
    if scales is not None:
        per_tok += 2 * KVH * 4
    hist_bytes = int(hists.sum()) * per_tok
    table_bytes = int(sum(-(-int(h) // P) for h in hists)) * 4
    fresh_pairs = int(sum(n * (n + 1) // 2 for n in q_lens))
    flops = 4.0 * H * D * (int((q_lens * hists).sum()) + fresh_pairs)
    b_ms, b_by = bound(flops, hist_bytes + table_bytes
                       + nbytes(q, kn, vn, got, *meta[:3]))
    row = dict(case=label, max_abs_err=err, tol_ratio=ratio,
               planted_fault_ratio=min(faults.values()),
               planted_faults=faults, ms=ms, call_ms=call_ms,
               plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, **extra)
    bf16_note = ("" if scales is None else
                 f"; vs the bf16 plain version "
                 f"{extra['tol_ratio_vs_bf16_plain']:.3f}x the limit")
    log(f"[{tag}] {label}: max_abs_err {err:.3e}, {ratio:.3f}x the limit"
        f"{bf16_note} (planted faults "
        + ", ".join(f"{k} {v:.1f}x" for k, v in faults.items())
        + f") kernel_ms {ms:.4f} (as the host issues calls {call_ms:.4f})"
        f" plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.6f} ({b_by})")
    return row


def _k1_cases(pool, gen, rng, scales=None) -> list:
    return [
        _k1_case("decode 8 rows, hist 1000-4000", [1] * 8,
                 rng.integers(1000, 4000, size=8), pool, gen, rng, scales),
        _k1_case("mixed 256-token row (hist 512) + 7 decode rows",
                 [256] + [1] * 7,
                 [512] + list(rng.integers(1000, 4000, size=7)),
                 pool, gen, rng, scales),
        # the split's edges: hist at a 512-token span boundary and one
        # either side, and at the pool's full maxP * P = 4096
        _k1_case("decode 8 rows at split edges",
                 [1] * 8, [511, 512, 513, 1023, 1025, 4095, 4096, 2048],
                 pool, gen, rng, scales),
        _k1_case("mixed two 256-token rows at split edges + 6 decode rows",
                 [256, 256] + [1] * 6, [511, 513, 512, 4096, 4095, 0, 1,
                                        1024],
                 pool, gen, rng, scales),
        # speculative verify rows: W = spec_tokens + 1 = 5 tokens, 5 x 4
        # query heads per KV head = 20 (token, head) rows in one tile
        _k1_case("verify 8 rows of 5 tokens, hist 1000-4000", [5] * 8,
                 rng.integers(1000, 4000, size=8), pool, gen, rng, scales),
        _k1_case("verify 8 rows of 5 tokens at split edges", [5] * 8,
                 [511, 512, 513, 1023, 1025, 4091, 2047, 2049],
                 pool, gen, rng, scales),
        # the spec cell's own shape: 16 slots of 5 tokens (query tiles
        # numbered across twice the rows) at its histories, on the
        # v5e1-hotswap entry's 3968-page pool
        _k1_case("verify 16 rows of 5 tokens, hist 300-450, 3968 pages",
                 [5] * 16, rng.integers(300, 450, size=16), pool, gen, rng,
                 scales, pool_pages=3968),
    ]


@_timed
def phase_k1() -> list:
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    L, N, P = 32, 4096, 16
    shape = (L, N, P, KVH, D)
    kp = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    for lyr in range(L):
        kp[lyr].normal_(generator=gen)
        vp[lyr].normal_(generator=gen)
    rows = _k1_cases((kp, vp), gen, rng)
    del kp, vp
    torch.cuda.empty_cache()
    return rows


@_timed
def phase_k1_int8() -> list:
    """K1's int8 form at the same two cases, on a full-size int8 pool
    (32 layers, 4096 pages) quantized layer by layer with the port's
    ``quantize_kv`` from unit-normal K/V."""
    from helix_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    L, N, P = 32, 4096, 16
    shape = (L, N, P, KVH, D)
    pools = [torch.empty(shape, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.empty(shape[:-1], dtype=torch.float32, device=dev)
              for _ in range(2)]
    for lyr in range(L):
        for pool, sc in zip(pools, scales):
            pool[lyr], sc[lyr] = quantize_kv(torch.randn(
                shape[1:], generator=gen, device=dev))
    rows = _k1_cases(tuple(pools), gen, rng, tuple(scales))
    del pools, scales
    torch.cuda.empty_cache()
    return rows


# Phi-3-mini's attention widths: group 1 (H = KVH = 32), head dim 96
PHI3_HEADS = (32, 32, 96)


@_timed
def phase_phi3_kernels() -> tuple:
    """K2 and K1-int8 at Phi-3-mini's shapes, the hot-swap phase's second
    model: K2 causal and packed at S 2048, bf16 (D 96 is padded to 128
    for the wgmma tiles); K1-int8 on a 1024-page int8 pool [32, 1024, 16,
    32, 96] (the hot-swap entry's cut pool) quantized with
    ``quantize_kv``, 16 decode rows at histories 500-2000 and one
    256-token row beside 15 decode rows.  With group 1 a query tile holds
    32 tokens of one head.  Same limits and planted faults as the Llama
    cases.  Returns (K2 rows, K1-int8 rows)."""
    from helix_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    H3, KVH3, D3 = PHI3_HEADS
    k2 = [
        _k2_case("Phi-3 causal S=2048, H=KVH=32, D=96", [2048], gen,
                 PHI3_HEADS),
        _k2_case("Phi-3 packed S=2048, 4 segments, H=KVH=32, D=96",
                 [520, 480, 560, 488], gen, PHI3_HEADS),
    ]
    L, N, P = 32, 1024, 16
    shape = (L, N, P, KVH3, D3)
    pools = [torch.empty(shape, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.empty(shape[:-1], dtype=torch.float32, device=dev)
              for _ in range(2)]
    for lyr in range(L):
        for pool, sc in zip(pools, scales):
            pool[lyr], sc[lyr] = quantize_kv(torch.randn(
                shape[1:], generator=gen, device=dev))
    k1 = [
        _k1_case("Phi-3 decode 16 rows, hist 500-2000, 1024 pages",
                 [1] * 16, rng.integers(500, 2000, size=16), tuple(pools),
                 gen, rng, tuple(scales), heads=PHI3_HEADS),
        _k1_case("Phi-3 mixed 256-token row (hist 512) + 15 decode rows, "
                 "1024 pages", [256] + [1] * 15,
                 [512] + list(rng.integers(500, 2000, size=15)),
                 tuple(pools), gen, rng, tuple(scales), heads=PHI3_HEADS),
    ]
    del pools, scales
    torch.cuda.empty_cache()
    return k2, k1


# Qwen2-VL-7B's attention widths: group 7 (H 28, KVH 4), head dim 128
VL_HEADS = (28, 4, 128)


@_timed
def phase_vl_kernels() -> tuple:
    """3e. K2 and K1 at Qwen2-VL-7B's shapes (phase 4n's model): group 7,
    not a power of two (K1's query tile then holds 4 tokens x 7 heads =
    28 of its 32 rows; K2's grid spans 28 heads).  K2 as the VL
    single-shot prefill calls it: causal, B 1, at the power-of-two
    buckets the prompts take (S 2048 with 1,275 prompt tokens, a
    1,280x960 chat; S 4096 with 3,100), a validity segment over the
    prompt; K1 with 8 decode rows at histories 1,300-4,000 on a bf16 pool
    of 4096 pages [28, 4096, 16, 4, 128] (the profile entry's).  Same
    limits, planted faults and timings as the Llama cases.  Returns (K2
    rows, K1 rows)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    k2 = [
        _k2_case("Qwen2-VL causal S=2048 (1275 valid), H=28, KVH=4",
                 [2048], gen, VL_HEADS, valid=1275),
        _k2_case("Qwen2-VL causal S=4096 (3100 valid), H=28, KVH=4",
                 [4096], gen, VL_HEADS, valid=3100),
    ]
    L, N, P = 28, 4096, 16
    shape = (L, N, P, VL_HEADS[1], VL_HEADS[2])
    kp = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    for lyr in range(L):
        kp[lyr].normal_(generator=gen)
        vp[lyr].normal_(generator=gen)
    k1 = [_k1_case("Qwen2-VL decode 8 rows, hist 1300-4000, group 7",
                   [1] * 8, rng.integers(1300, 4000, size=8), (kp, vp),
                   gen, rng, heads=VL_HEADS)]
    del kp, vp
    torch.cuda.empty_cache()
    return k2, k1


# ---------------------------------------------------------------------------
# 3d. K1's cold form (tiered rows)
# ---------------------------------------------------------------------------

COLD_STREAM_PAGES = 4        # the engine's default ctx_stream_pages
COLD_MAXP = 512              # the entry's 8192-token page tables
# the CUDA-core cold form's device ms on this case before the tensor-core
# redesign (PERF.md, one H100 80GB HBM3 at 700 W): the yardstick the
# redesign must beat, printed beside this run's times
COLD_CUDA_CORE_MS = {"K1-tiered": 0.6320, "K1-int8-tiered": 0.6840}


def _k1_cold_layout(rng, P=16):
    """Rows of phase 3d: 4 tiered decode rows and 4 tiered verify rows of
    5 at histories 6000-8000, each with a page-aligned middle span of
    ~5000 tokens demoted, beside 8 resident decode rows at 1000-8000.
    Returns (q_lens, hists, spans [(lo, hi) tokens, (0, 0) resident])."""
    q_lens = [1] * 4 + [5] * 4 + [1] * 8
    hists = list(rng.integers(6000, 8000, size=8)) \
        + list(rng.integers(1000, 8000, size=8))
    spans = []
    for r, h in enumerate(hists):
        if r >= 8:
            spans.append((0, 0))
            continue
        lo = int(rng.integers(8, 32)) * P
        hi = lo + (5000 // P) * P
        assert hi <= h - 32 * P          # the hot tail stays resident
        spans.append((lo, hi))
    return (np.asarray(q_lens, np.int32), np.asarray(hists, np.int32),
            spans)


def _k1_cold_case(label, pools, gen, rng, scales=None) -> dict:
    """One call of K1's cold form on the layout of ``_k1_cold_layout``.

    The resident tables give every history page its own pool page; the
    tiered tables zero each span's entries (page 0, as the engine's
    demotion leaves them) and the span's pages are packed into a slab of
    ``COLD_STREAM_PAGES``-page chunks, one padding chunk owned by no row
    at the end.  The kernel is held to its plain version (int8: the plain
    version in f32, rounded once) under the one-ulp limit, and to the
    resident call of the kernel on the same values; three planted faults
    must fail the check: a chunk's owner moved to another row,
    ``span_lo`` one page late, one cold scale negated (int8).  Two
    launches must give the same bits, and the form must beat the
    CUDA-core form's recorded time (``COLD_CUDA_CORE_MS``)."""
    from helix_tpu_torch.ops.paged_kernel import (
        _k1_cold_slots,
        ragged_kernel_info,
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    dev = "cuda"
    kp, vp = pools
    L, N, P = kp.shape[:3]
    q_lens, hists, spans = _k1_cold_layout(rng, P)
    R, maxP = len(q_lens), COLD_MAXP
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum())
    walked = -(-(hists + q_lens) // P)
    perm = rng.permutation(np.arange(1, N))
    assert walked.sum() <= N - 1
    full = np.zeros((R, maxP), np.int32)
    for r, (n, a) in enumerate(zip(walked, np.cumsum(walked) - walked)):
        full[r, :n] = perm[a:a + n]
    tiered = full.copy()
    lo = np.array([s[0] for s in spans], np.int32)
    hi = np.array([s[1] for s in spans], np.int32)
    owners, lens, chunk_pages = [], [], []
    for r in range(R):
        if hi[r] <= lo[r]:
            continue
        tiered[r, lo[r] // P:hi[r] // P] = 0
        for c0 in range(lo[r] // P, hi[r] // P, COLD_STREAM_PAGES):
            pg = list(full[r, c0:min(c0 + COLD_STREAM_PAGES, hi[r] // P)])
            owners.append(r)
            lens.append(len(pg) * P)
            chunk_pages.append(pg)
    owners.append(-1)                          # a chunk with no owner
    lens.append(COLD_STREAM_PAGES * P)
    chunk_pages.append(list(perm[-COLD_STREAM_PAGES:]))
    nC, Ct = len(owners), COLD_STREAM_PAGES * P

    def slab(pool):
        idx = np.zeros((nC, COLD_STREAM_PAGES), np.int64)
        for c, pg in enumerate(chunk_pages):
            idx[c, :len(pg)] = pg
        got = pool[:, torch.from_numpy(idx).to(dev)]   # [L, nC, S, P, ...]
        got = got.reshape((L, nC, Ct) + tuple(pool.shape[3:]))
        for c, pg in enumerate(chunk_pages):
            got[:, c, len(pg) * P:] = 0
        return got.contiguous()

    up = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
    meta = [up(x) for x in (t0, q_lens, hists)]
    q = torch.randn((T, H, D), generator=gen, device=dev).bfloat16()
    kn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    layer = L - 1
    kw = {} if scales is None else dict(k_scale=scales[0],
                                        v_scale=scales[1])
    cold = dict(span_lo=up(lo), span_hi=up(hi), cold_k=slab(kp),
                cold_v=slab(vp), cold_row=up(owners), cold_len=up(lens))
    if scales is not None:
        cold.update(cold_k_scale=slab(scales[0]),
                    cold_v_scale=slab(scales[1]))
    args = (q, kn, vn, kp, vp, layer, *meta, up(tiered))
    resident_args = (q, kn, vn, kp, vp, layer, *meta, up(full))
    tag = "K1-tiered" if scales is None else "K1-int8-tiered"
    got = ragged_paged_attention(*args, **kw, **cold)
    again = ragged_paged_attention(*args, **kw, **cold)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{tag} {label}: two launches differ")
    if scales is None:
        want = ragged_paged_attention_plain(*args, **kw, **cold)
    else:
        want = ragged_paged_attention_plain(
            q.float(), kn.float(), vn.float(), *args[3:], **kw,
            **cold).bfloat16()
    err, ratio = check(f"{tag} {label}", got, want)
    resident = ragged_paged_attention(*resident_args, **kw)
    err_res, ratio_res = check(f"{tag} {label} vs the resident call", got,
                               resident)
    faults = {}
    moved = cold["cold_row"].clone()
    moved[0] = 1                                # row 0's chunk -> row 1
    faults["owner_moved"] = planted(
        f"{tag} owner moved", ragged_paged_attention(
            *args, **kw, **dict(cold, cold_row=moved)), want)
    late = cold["span_lo"].clone()
    late[:8] += P
    faults["span_lo_late"] = planted(
        f"{tag} span_lo one page late", ragged_paged_attention(
            *args, **kw, **dict(cold, span_lo=late)), want)
    if scales is not None:
        flipped = cold["cold_k_scale"].clone()
        flipped[layer, 0, 0] *= -1
        fv = cold["cold_v_scale"].clone()
        fv[layer, 0, 0] *= -1
        faults["scale_flipped"] = planted(
            f"{tag} one cold scale negated", ragged_paged_attention(
                *args, **kw, **dict(cold, cold_k_scale=flipped,
                                    cold_v_scale=fv)), want)
    ms = cuda_ms(lambda: ragged_paged_attention(*args, **kw, **cold), 20)
    resident_ms = cuda_ms(
        lambda: ragged_paged_attention(*resident_args, **kw), 20)
    plain_ms = cuda_ms(
        lambda: ragged_paged_attention_plain(*args, **kw, **cold), 2, 1)
    # library yardstick: SDPA over each row's gathered resident history
    Sq = int(q_lens.max())
    Skv = int((hists + q_lens).max())
    qb = torch.zeros((R, H, Sq, D), device=dev, dtype=torch.bfloat16)
    kb = torch.zeros((R, H, Skv, D), device=dev, dtype=torch.bfloat16)
    vb = torch.zeros_like(kb)
    mask = torch.zeros((R, 1, Sq, Skv), device=dev, dtype=torch.bool)
    for r in range(R):
        n, h, s = int(q_lens[r]), int(hists[r]), int(t0[r])
        pages = torch.from_numpy(full[r]).to(dev).long()
        kh = kp[layer][pages].reshape(-1, KVH, D)[:h]
        vh = vp[layer][pages].reshape(-1, KVH, D)[:h]
        if scales is not None:
            kh = kh.float() * scales[0][layer][pages].reshape(
                -1, KVH)[:h, :, None]
            vh = vh.float() * scales[1][layer][pages].reshape(
                -1, KVH)[:h, :, None]
        kh, vh = kh.bfloat16(), vh.bfloat16()
        k_all = torch.cat([kh, kn[s:s + n]]).repeat_interleave(H // KVH, 1)
        v_all = torch.cat([vh, vn[s:s + n]]).repeat_interleave(H // KVH, 1)
        qb[r, :, :n] = q[s:s + n].transpose(0, 1)
        kb[r, :, :h + n] = k_all.transpose(0, 1)
        vb[r, :, :h + n] = v_all.transpose(0, 1)
        qi = torch.arange(n, device=dev)[:, None] + h
        mask[r, 0, :n] = torch.arange(Skv, device=dev)[None, :] <= qi
        mask[r, 0, n:, 0] = True
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qb, kb, vb, attn_mask=mask), 20)
    del qb, kb, vb, mask
    # bytes: every history token once, hot from the pool and cold from
    # the slab (the owned chunks' live tokens), per token and KV head
    # K and V (int8: codes + one f32 scale each); the hot pages' table
    # entries, the row metadata and the chunk owners / lengths; q, fresh
    # K/V and out.  Operations: 4 H D per (query, key) pair.
    per_tok = 2 * KVH * D * kp.element_size()
    if scales is not None:
        per_tok += 2 * KVH * 4
    cold_tok = int((hi - lo).sum())
    hot_pages = int(sum(-(-int(h) // P) for h in hists)) - cold_tok // P
    fresh_pairs = int(sum(n * (n + 1) // 2 for n in q_lens))
    flops = 4.0 * H * D * (int((q_lens * hists).sum()) + fresh_pairs)
    b_ms, b_by = bound(flops, int(hists.sum()) * per_tok + hot_pages * 4
                       + 4 * (2 * nC + 5 * R)
                       + nbytes(q, kn, vn, got))
    info = ragged_kernel_info(T, H, KVH, D, P, maxP,
                              quantized=scales is not None, cold=True, R=R)
    row = dict(case=label, max_abs_err=err, tol_ratio=ratio,
               max_abs_err_vs_resident=err_res,
               tol_ratio_vs_resident=ratio_res,
               planted_fault_ratio=min(faults.values()),
               planted_faults=faults, ms=ms, resident_ms=resident_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, bound_fraction=b_ms / ms,
               cuda_core_ms_recorded=COLD_CUDA_CORE_MS[tag], chunks=nC,
               chunk_tokens=Ct, slots=_k1_cold_slots(maxP, P),
               cold_tokens=cold_tok, bitwise_repeat=True, resources=info)
    log(f"[{tag}] {label}: {nC} chunks of {Ct} tokens "
        f"({cold_tok} cold tokens over 8 tiered rows), max_abs_err "
        f"{err:.3e}, {ratio:.3f}x the limit; vs the resident call "
        f"{ratio_res:.3f}x (planted faults "
        + ", ".join(f"{k} {v:.1f}x" for k, v in faults.items())
        + f"); two launches bit-equal; kernel_ms {ms:.4f} (the CUDA-core "
        f"form's recorded {COLD_CUDA_CORE_MS[tag]:.4f}) resident_ms "
        f"{resident_ms:.4f} plain_ms {plain_ms:.4f} library_ms (SDPA) "
        f"{library_ms:.4f} bound_ms {b_ms:.6f} ({b_by}), {b_ms / ms:.3f} of "
        f"the bound; main kernel {info['regs']} registers, "
        f"{info['spill_bytes']} B spills, {info['smem_bytes']} B shared "
        f"memory, {info['blocks_per_sm']} blocks per SM")
    if ms >= COLD_CUDA_CORE_MS[tag]:
        raise AssertionError(f"{tag} {label}: {ms:.4f} ms, not below the "
                             f"CUDA-core form's {COLD_CUDA_CORE_MS[tag]}")
    return row


@_timed
def phase_k1_cold() -> tuple:
    """K1 and K1-int8's cold form at the entry's widths (H 32, KVH 8, D
    128, P 16) on 4-layer pools of 8192 pages (bf16, and int8 quantized
    with ``quantize_kv``): the rows of ``_k1_cold_layout``.  Returns
    (K1-tiered rows, K1-int8-tiered rows)."""
    from helix_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    L, N, P = 4, 8192, 16
    shape = (L, N, P, KVH, D)
    kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    rows = [_k1_cold_case("4 decode + 4 verify rows tiered, hist "
                          "6000-8000, ~5000 cold each, + 8 resident",
                          (kp, vp), gen, np.random.default_rng(13))]
    del kp, vp
    pools = [torch.empty(shape, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.empty(shape[:-1], dtype=torch.float32, device=dev)
              for _ in range(2)]
    for lyr in range(L):
        for pool, sc in zip(pools, scales):
            pool[lyr], sc[lyr] = quantize_kv(torch.randn(
                shape[1:], generator=gen, device=dev))
    rows_int8 = [_k1_cold_case(
        "4 decode + 4 verify rows tiered, hist 6000-8000, ~5000 cold "
        "each, + 8 resident", tuple(pools), gen,
        np.random.default_rng(14), tuple(scales))]
    del pools, scales
    torch.cuda.empty_cache()
    return rows, rows_int8


# ---------------------------------------------------------------------------
# 4. end to end over HTTP
# ---------------------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _chat(base, content, max_tokens, stream=False, model=MODEL):
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0,
            "messages": [{"role": "user", "content": content}],
            "stream": stream}
    text = _post(base + "/v1/chat/completions", body)
    if not stream:
        out = json.loads(text)
        assert out["object"] == "chat.completion", out
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        assert out["usage"]["completion_tokens"] >= 1
        return out
    frames = [f for f in text.split("\n\n") if f]
    assert frames[-1] == "data: [DONE]", frames[-1]
    chunks = [json.loads(f[6:]) for f in frames[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    return chunks


class _IdTokenizer:
    """The served byte tokenizer, except that ``decode`` writes every
    token id as ``<id>``: random weights put almost every draw outside
    the 256 byte ids, which the byte tokenizer decodes to nothing, so
    the texts compared would be empty whatever the tokens were."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def decode(self, ids) -> str:
        return "".join(f"<{i}>" for i in ids)


def _seeded_twice(base) -> str:
    """R1 on the card: one seeded sampled completion sent twice must give
    the same text twice."""
    texts = []
    for _ in range(2):
        out = json.loads(_post(base + "/v1/completions",
                               {"model": MODEL, **SEEDED}))
        texts.append(out["choices"][0]["text"])
    if not texts[0] or texts[0] != texts[1]:
        raise AssertionError(
            f"seeded temperature {SEEDED['temperature']} request did not "
            f"reproduce: {texts[0]!r} != {texts[1]!r}")
    return texts[0]


def _kernel_ms(prof) -> dict:
    """Device milliseconds per kernel name of a finished
    ``torch.profiler`` capture: the device events ``key_averages()`` sums
    as ``self_device_time_total``, read from the capture's raw activity
    records without building its event tree (seconds of host time per
    100k events)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_hidden_event", lambda: False)():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


def _profile_batch(base, prompts, models=None) -> dict:
    """Where a decode-heavy batch's device time goes: 8 concurrent chats
    of 32 new tokens under ``torch.profiler`` (after the measured batch,
    so tracing does not touch its tok/s), chat i to ``models[i]`` when
    given.  Returns the wall time, the device time summed over kernels,
    the idle share and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    models = models or [MODEL] * len(prompts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            list(ex.map(lambda pm: _chat(base, pm[0], 32, model=pm[1]),
                        zip(prompts, models)))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_kernel = _kernel_ms(prof)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]

    def share(word):
        return sum(t for k, t in by_kernel.items() if word in k) / busy_ms

    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "k1_share": share("ragged_"), "k2_share": share("flash_"),
            "top": [(k[:70], t) for k, t in top]}


def _threefry_cost(eng) -> dict:
    """What the threefry draw adds to a sampled decode step: ``sample``
    over the engine's [B, V] logits with every row at temperature 0.8
    (tiers 1 and 2 reachable, as for OpenAI's defaults) against every row
    greedy, and the Gumbel bits of the full-vocab tier alone."""
    from helix_tpu_torch.engine import threefry
    from helix_tpu_torch.engine.sampling import (
        SamplingParams,
        SamplingState,
        sample,
    )

    B, V = eng.cfg.max_decode_batch, eng.model_cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(9)
    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    keys = np.stack([np.array([i, 7 * i + 1], np.uint32) for i in range(B)])
    hot = SamplingState.from_params(
        [SamplingParams(temperature=0.8)] * B, device="cuda")
    cold = SamplingState.from_params(
        [SamplingParams(temperature=0.0)] * B, device="cuda")
    tk = threefry.as_keys(keys, "cuda")
    sampled_ms = cuda_ms(lambda: sample(logits, hot, keys), 20)
    greedy_ms = cuda_ms(lambda: sample(logits, cold, keys), 20)
    gumbel_ms = cuda_ms(lambda: threefry.gumbel(tk, V), 20)
    return {"sampled_step_ms": sampled_ms, "greedy_step_ms": greedy_ms,
            "added_ms": sampled_ms - greedy_ms,
            "gumbel_full_vocab_ms": gumbel_ms}


def _rounding_cost(eng) -> dict:
    """What one rounding per projection costs on Llama's path, where the
    only projection it changes is the vocab projection: ``project_logits``
    (a bf16 GEMM with a float32 output) against the bf16 GEMM rounded to
    bf16 and then cast, at the decode shape [B, E] x [E, V]."""
    from helix_tpu_torch.models.llama import project_logits

    cfg, params = eng.model_cfg, eng.params
    gen = torch.Generator(device="cuda").manual_seed(11)
    h = torch.randn((eng.cfg.max_decode_batch, cfg.hidden_size),
                    generator=gen, device="cuda").bfloat16()
    w = params["lm_head"]["weight"]
    one = cuda_ms(lambda: project_logits(params, cfg, h), 20)
    two = cuda_ms(lambda: torch.matmul(h, w).float(), 20)
    return {"f32_output_ms": one, "bf16_then_cast_ms": two}


@contextlib.contextmanager
def _held_inbox(loop):
    """The loop takes nothing from its inbox until the yielded release
    is called (or the block ends)."""
    drain = loop._drain_inbox
    gate = threading.Event()
    loop._drain_inbox = lambda: drain() if gate.is_set() else None
    try:
        yield gate.set
    finally:
        gate.set()
        loop._drain_inbox = drain


def _gated_calls(loop, n, call, wait=True) -> tuple:
    """``call(i)`` for i < n on threads, each sending one request, that
    the engine admits together and in this order: the loop takes nothing
    from its inbox until every request is queued, so the admission waves,
    and with them every shape the kernels and GEMMs see, do not depend on
    HTTP timing (two runs then compute the same thing).  With ``wait``
    the calls are joined and the first error raised; else they run on.
    Returns (results, errors, threads, the release time)."""
    outs, errors, threads = [None] * n, [], []

    def run(i):
        try:
            outs[i] = call(i)
        except Exception as e:  # noqa: BLE001 — re-raised or returned
            errors.append(e)

    with _held_inbox(loop) as release:
        for i in range(n):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 120
            while loop._inbox.qsize() < i + 1 and not errors:
                if time.monotonic() > deadline:
                    raise AssertionError("a request never reached the "
                                         "engine")
                time.sleep(0.002)
        t0 = time.monotonic()
        release()
        if wait:
            for t in threads:
                t.join(600)
    if wait and errors:
        raise errors[0]
    return outs, errors, threads, t0


def _gated_batch(base, loop, prompts, max_tokens, bodies=None) -> tuple:
    """Concurrent chats admitted together (``_gated_calls``).  ``bodies``:
    whole chat request bodies (model and messages of each) in place of
    ``prompts``.  Returns (the chats' texts, seconds from the release to
    the last answer, step records made meanwhile)."""
    def send(i):
        if bodies is None:
            return _chat(base, prompts[i], max_tokens)
        return json.loads(_post(
            base + "/v1/chat/completions",
            {"max_tokens": max_tokens, "temperature": 0, **bodies[i]}))

    rec0 = loop.window.recorded
    n = len(bodies) if bodies is not None else len(prompts)
    outs, _e, _t, t0 = _gated_calls(loop, n, send)
    seconds = time.monotonic() - t0
    texts = [o["choices"][0]["message"]["content"] for o in outs]
    return texts, seconds, loop.window.recorded - rec0


def _serve(engine, quantization=None, layers=None):
    """A started server for MODEL with random weights on the card, at
    ``layers`` of its depth when given: (served, engine, httpd, base
    url, registry, memory after build)."""
    from helix_tpu_torch.cli import build_served_model

    torch.cuda.reset_peak_memory_stats()
    served = build_served_model(
        MODEL, device="cuda", seed=0, quantization=quantization,
        engine=engine,
        model_overrides={"num_layers": layers} if layers else None)
    served.tokenizer = _IdTokenizer(served.tokenizer)
    eng = served.loop.engine
    mem = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "kv_pool_gib": sum(nbytes(t) for t in eng.cache.carry()) / 2**30}
    httpd, base, registry = _start_server(served)
    return served, eng, httpd, base, registry, mem


def _start_server(served):
    """A started OpenAI server for one served model: (httpd, base url,
    registry)."""
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry

    registry = ModelRegistry()
    registry.register(served)
    httpd = OpenAIServer(registry).start("127.0.0.1", 0)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", registry


def _unserve(served, httpd, registry) -> None:
    httpd.shutdown()
    httpd.server_close()
    served.loop.stop()
    registry.unregister(MODEL)


def _free() -> None:
    """Return a finished phase's device memory: the loop and its emission
    stage refer to each other, so the engine goes only with a collection."""
    from helix_tpu_torch.device import release_device_memory

    release_device_memory()


@_timed
def phase_e2e(label="bf16", quantization=None, kv_cache_dtype=None,
              async_loop=False) -> dict:
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8

    t0 = time.monotonic()
    engine = dict(max_decode_batch=8, page_size=16, num_pages=4096,
                  max_pages_per_seq=256, max_prefill_len=512,
                  enable_async_loop=async_loop)
    if kv_cache_dtype:
        engine["kv_cache_dtype"] = kv_cache_dtype
    served, eng, httpd, base, registry, mem = _serve(engine, quantization)
    loop = served.loop
    cfg = eng.model_cfg
    tag = f"e2e {label}"
    log(f"[{tag}] {MODEL}: L {cfg.num_layers} E {cfg.hidden_size} H "
        f"{cfg.num_heads} KVH {cfg.num_kv_heads} D {cfg.head_dim} F "
        f"{cfg.intermediate_size} V {cfg.vocab_size} {cfg.dtype}, weights "
        f"{eng.params['layers']['wq']['weight'].dtype}, KV pool "
        f"{eng.cache.k_pages.dtype} ({mem['kv_pool_gib']:.2f} GiB), async "
        f"loop {'on' if async_loop else 'off'}; built + warmed in "
        f"{time.monotonic() - t0:.1f} s; device memory "
        f"{mem['allocated_gib']:.2f} GiB allocated")
    answered = 0
    try:
        # the main path starts here: counters to 0
        K1.launches = K1_INT8.launches = K2.launches = 0
        hits0, mixed0 = eng.prefix_cache_hits, eng.num_mixed_steps
        eng.recent_ttfts.clear()
        _chat(base, "Say hello in one line.", 16)
        _chat(base, "Count to five.", 16, stream=True)
        out = json.loads(_post(base + "/v1/completions", {
            "model": MODEL, "prompt": "The capital of France is",
            "max_tokens": 16, "temperature": 0}))
        assert out["object"] == "text_completion", out
        answered += 3
        # 8 concurrent chats of ~200 prompt tokens, 64 new tokens each,
        # admitted together
        prompts = [f"Request {i}: " + "summarise the history of the "
                   "printing press in plain words please. " * 3
                   for i in range(8)]
        dec0, piped0 = eng.num_decode_tokens, loop.pipelined_steps
        batch_texts, batch_s, n_rec = _gated_batch(base, loop, prompts, 64)
        decode_tps = (eng.num_decode_tokens - dec0) / batch_s
        pipelined = loop.pipelined_steps - piped0
        idle_ratio = loop.window.window_ratio("idle_gap_s", ("wall_s",),
                                              recent=n_rec)
        answered += len(batch_texts)
        # a prompt longer than max_prefill_len (chunked), admitted while
        # another request decodes (mixed step), then again (prefix hit)
        long_prompt = "".join(
            f"Line {i}: the quick brown fox jumps over the lazy dog. "
            for i in range(14))
        assert len(long_prompt) > 600
        first_frame = threading.Event()
        bg_result = {}

        def background():
            body = {"model": MODEL, "max_tokens": 64, "temperature": 0,
                    "stream": True,
                    "messages": [{"role": "user", "content": "Tell a story."}]}
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                r.readline()
                first_frame.set()
                bg_result["rest"] = r.read().decode()

        bg = threading.Thread(target=background)
        bg.start()
        if not first_frame.wait(300):
            raise AssertionError("background stream never started")
        _chat(base, long_prompt, 8)
        bg.join(600)
        assert bg_result["rest"].rstrip().endswith("data: [DONE]")
        _chat(base, long_prompt, 8)
        answered += 3
        seeded_text = _seeded_twice(base)
        answered += 2
        torch.cuda.synchronize()
        launches = {"ragged_paged_attention": K1.launches,
                    "ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches}
        # the 16 requests' own numbers, before the traced batch
        ttfts = sorted(eng.recent_ttfts)
        mixed = eng.num_mixed_steps - mixed0
        hits = eng.prefix_cache_hits - hits0
        try:    # the trace informs PERF.md; its absence fails nothing
            trace = _profile_batch(base, [p.replace("Request", "Traced")
                                          for p in prompts])
        except Exception as e:  # noqa: BLE001
            trace = {"error": repr(e)}
    finally:
        _unserve(served, httpd, registry)
    ttft_p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else float("nan")
    mem["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    draw = _threefry_cost(eng)
    if quantization is None and not async_loop:
        r2 = _rounding_cost(eng)
        log(f"[{tag}] vocab projection, one rounding (f32-output GEMM) "
            f"{r2['f32_output_ms']:.4f} ms vs bf16 GEMM then cast "
            f"{r2['bf16_then_cast_ms']:.4f} ms, once per decode step")
    log(f"[{tag}] requests answered {answered}; TTFT p50 {ttft_p50:.1f} ms "
        f"over {len(ttfts)} requests; decode {decode_tps:.1f} tok/s over "
        f"the 8-chat batch ({batch_s:.2f} s; pipelined steps {pipelined}, "
        f"device_idle_ratio {idle_ratio:.3f}); mixed steps {mixed}; prefix "
        f"hits {hits}; launches {launches}; device memory peak "
        f"{mem['peak_gib']:.2f} GiB")
    if "error" in trace:
        log(f"[{tag}] traced batch: not measured ({trace['error']})")
    else:
        log(f"[{tag}] traced 8-chat batch (32 new tokens each): wall "
            f"{trace['wall_ms']:.1f} ms, device busy "
            f"{trace['device_busy_ms']:.1f} ms (idle share "
            f"{trace['idle_share']:.3f}); K1 {trace['k1_share']:.3f} and K2 "
            f"{trace['k2_share']:.3f} of device time; top kernels (ms): "
            + "; ".join(f"{k} {t:.1f}" for k, t in trace["top"]))
    log(f"[{tag}] seeded temperature {SEEDED['temperature']} request "
        f"reproduced ({seeded_text.count('<')} tokens: "
        f"{seeded_text[:48]}...); threefry: a sampled step's "
        f"sample() {draw['sampled_step_ms']:.4f} ms vs greedy "
        f"{draw['greedy_step_ms']:.4f} ms (adds {draw['added_ms']:.4f} ms; "
        f"full-vocab Gumbel bits alone {draw['gumbel_full_vocab_ms']:.4f} "
        f"ms)")
    k1 = ("ragged_paged_attention_int8" if kv_cache_dtype == "int8"
          else "ragged_paged_attention")
    if launches[k1] <= 0:
        raise AssertionError(f"{k1} never launched on the serving path")
    if launches["flash_attention"] <= 0:
        raise AssertionError("K2 never launched on the serving path")
    if mixed <= 0:
        raise AssertionError("no mixed step ran")
    if hits <= 0:
        raise AssertionError("no prefix-cache hit")
    if answered != 16:
        raise AssertionError(f"answered {answered} of 16 requests")
    if async_loop and pipelined <= 0:
        raise AssertionError("the async loop pipelined no step")
    del served, eng, registry, loop
    _free()
    return {"launches": launches, "answered": answered,
            "ttft_p50_ms": ttft_p50, "decode_tokens_per_s": decode_tps,
            "memory": mem, "threefry": draw, "trace": trace,
            "batch_texts": batch_texts, "seeded_text": seeded_text,
            "pipelined_steps": pipelined, "device_idle_ratio": idle_ratio}


@_timed
def phase_async(off: dict) -> dict:
    """Phase 4 again with ``enable_async_loop`` on, in the same call: the
    8-chat greedy batch and the seeded request must give the off run's
    tokens; the pipeline's numbers are printed beside the off run's."""
    on = phase_e2e("bf16 async", async_loop=True)
    for name in ("batch_texts", "seeded_text"):
        if on[name] != off[name]:
            raise AssertionError(
                f"async loop changed the tokens of {name}: "
                f"{str(on[name])[:200]} != {str(off[name])[:200]}")

    def idle(r):
        t = r["trace"]
        return "not measured" if "error" in t else f"{t['idle_share']:.3f}"

    for label, r in (("off", off), ("on", on)):
        log(f"[async] loop {label}: pipelined_steps {r['pipelined_steps']}, "
            f"device_idle_ratio() {r['device_idle_ratio']:.3f}, traced "
            f"batch idle share {idle(r)}, decode "
            f"{r['decode_tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms")
    log("[async] 8-chat greedy batch and seeded request: identical tokens "
        "with the loop off and on")
    return on


# the spec phase's chats quote this passage (~300 byte tokens) and ask for
# it back: prompt-lookup drafting has the passage to draft from
PASSAGE = (
    "The printing press came to Mainz around 1450. Johannes Gutenberg "
    "cast movable type from a lead alloy, pressed oil-based ink onto "
    "paper with a screw press adapted from wine making, and printed a "
    "Bible of about 1,280 pages. Within fifty years, presses worked in "
    "more than two hundred cities, and books became cheap enough for "
    "merchants, students and craftsmen to own.")


# the ``profiles/v5e1-hotswap.yaml`` Llama entry's engine block as the
# profile writes it, less ``adapter_pool_slots`` / ``adapter_rank``: the
# phases before 4g measure the entry without its adapter pool
ENTRY = dict(max_decode_batch=16, num_pages=3968, page_size=16,
             max_prefill_len=2048, kv_cache_dtype="int8",
             enable_spec_decode=True, spec_tokens=4,
             host_pool_bytes=17179869184)


@_timed
def phase_spec() -> dict:
    """The ``profiles/v5e1-hotswap.yaml`` Llama entry as the profile
    writes it (``ENTRY``), with speculative decoding and its 16 GiB host
    tier: int8 weights, int8 KV, 16 decode slots, 3968 pages of 16,
    max_prefill_len 2048, spec_tokens 4 (its adapter pool is phase
    4g's).  16 concurrent chats quote a passage and ask for it back; the
    seeded request is sent twice."""
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8

    t0 = time.monotonic()
    engine = dict(ENTRY)
    served, eng, httpd, base, registry, mem = _serve(engine, "int8")
    tag = "spec"
    if eng.host_pool is None or eng.host_pool.budget_bytes != \
            ENTRY["host_pool_bytes"]:
        raise AssertionError("the entry's host tier was not built")
    log(f"[{tag}] {MODEL} as the v5e1-hotswap entry: int8 weights, int8 "
        f"KV ({mem['kv_pool_gib']:.2f} GiB), {engine}; built + warmed in "
        f"{time.monotonic() - t0:.1f} s; without its adapter pool (phase "
        "4g serves it)")
    try:
        K1.launches = K1_INT8.launches = K2.launches = 0
        eng.recent_ttfts.clear()
        c0 = {k: getattr(eng, k) for k in (
            "num_decode_tokens", "num_decode_device_steps", "num_spec_steps",
            "num_spec_drafted_tokens", "num_spec_accepted_tokens",
            "num_device_calls", "num_decode_slot_steps")}
        prompts = [f"Chat {i}: repeat this passage word for word.\n\n"
                   f"{PASSAGE}\n\nNow repeat it." for i in range(16)]
        # each chat's emitted token count when the first verify step
        # that finds it in a slot is dispatched
        first_verify = [None] * len(prompts)
        tail = eng._spec_dispatch_tail

        def spy(drafts, draft_len):
            for r in eng.slots:
                if r is not None:
                    i = int(re.search(r"Chat (\d+):", served.tokenizer._tok
                                      .decode(r.prompt_tokens)).group(1))
                    if first_verify[i] is None:
                        first_verify[i] = len(r.output_tokens)
            return tail(drafts, draft_len)

        eng._spec_dispatch_tail = spy
        try:
            texts, batch_s, _ = _gated_batch(base, served.loop, prompts, 64)
        finally:
            eng._spec_dispatch_tail = tail
        d = {k: getattr(eng, k) - v for k, v in c0.items()}
        answered = len(texts)
        ttfts = sorted(eng.recent_ttfts)
        seeded_text = _seeded_twice(base)
        torch.cuda.synchronize()
        launches = {"ragged_paged_attention": K1.launches,
                    "ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches}
        ratio = (d["num_spec_accepted_tokens"] / d["num_spec_drafted_tokens"]
                 if d["num_spec_drafted_tokens"] else 0.0)
        try:    # the trace informs PERF.md; its absence fails nothing
            trace = _profile_batch(base, prompts[:8])
        except Exception as e:  # noqa: BLE001
            trace = {"error": repr(e)}
    finally:
        _unserve(served, httpd, registry)
    mem["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ttft_p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else float("nan")
    tps = d["num_decode_tokens"] / batch_s
    per_step = d["num_decode_tokens"] / max(1, d["num_decode_device_steps"])
    per_slot = d["num_decode_tokens"] / max(1, d["num_decode_slot_steps"])
    log(f"[{tag}] answered {answered} of 16 chats; TTFT p50 "
        f"{ttft_p50:.1f} ms; decode {tps:.1f} tok/s ({batch_s:.2f} s); "
        f"spec_acceptance_ratio {ratio:.3f} ({d['num_spec_accepted_tokens']}"
        f" of {d['num_spec_drafted_tokens']} drafted, "
        f"{d['num_spec_steps']} verify steps); decode tokens per device "
        f"step and active slot {per_slot:.3f} (all slots: {per_step:.2f}; "
        f"{d['num_decode_tokens']} tokens, "
        f"{d['num_decode_device_steps']} device steps, "
        f"{d['num_device_calls']} unified-step calls); launches {launches};"
        f" device memory {mem['allocated_gib']:.2f} GiB after build, peak "
        f"{mem['peak_gib']:.2f} GiB; seeded request reproduced "
        f"({seeded_text.count('<')} tokens)")
    if "error" in trace:
        log(f"[{tag}] traced batch: not measured ({trace['error']})")
    else:
        log(f"[{tag}] traced 8 of the chats (32 new tokens each): wall "
            f"{trace['wall_ms']:.1f} ms, device busy "
            f"{trace['device_busy_ms']:.1f} ms (idle share "
            f"{trace['idle_share']:.3f}); K1-int8 {trace['k1_share']:.3f} and "
            f"K2 {trace['k2_share']:.3f} of device time; top kernels (ms): "
            + "; ".join(f"{k} {t:.1f}" for k, t in trace["top"]))
    if answered != 16:
        raise AssertionError(f"answered {answered} of 16 chats")
    if launches["ragged_paged_attention_int8"] <= 0:
        raise AssertionError("K1-int8 never launched on the spec path")
    if d["num_spec_steps"] <= 0:
        raise AssertionError("no verify step ran")
    del served, eng, registry
    _free()
    agree = _spec_off_agreement(engine, prompts, texts, first_verify)
    return {"answered": answered, "ttft_p50_ms": ttft_p50,
            "decode_tokens_per_s": tps, "acceptance_ratio": ratio,
            "decode_tokens_per_device_step": per_step,
            "decode_tokens_per_slot_step": per_slot, "launches": launches,
            "memory": mem, "spec_off_agreement": agree, "trace": trace, **d}


def _spec_off_agreement(engine, prompts, texts_on, first_verify) -> dict:
    """The same 16 chats on the same weights with speculation off: the
    share of greedy tokens that agree with the spec-on run, position by
    position.  Plain steps run their state rows 1 wide with speculation
    on or off; a verify step runs its GEMMs at M = 16 x 5, where cuBLAS
    may round otherwise, so near-tied argmaxes of random weights may part
    after one; printed, not held to a limit (float32 identity is phase
    4d's and the CPU tests').  Before a chat's first verify step
    (``first_verify``: its emitted count then, None if none found it)
    the two runs compute the same shapes, so its tokens up to there must
    agree."""
    off = {k: v for k, v in engine.items()
           if k not in ("enable_spec_decode", "spec_tokens")}
    served, _eng, httpd, base, registry, _mem = _serve(off, "int8")
    try:
        texts_off, _, _ = _gated_batch(base, served.loop, prompts, 64)
    finally:
        _unserve(served, httpd, registry)
    del served, _eng, registry
    _free()
    ids = [[re.findall(r"<(\d+)>", t) for t in texts]
           for texts in (texts_on, texts_off)]
    same = sum(a == b for on, of in zip(*ids) for a, b in zip(on, of))
    total = sum(max(len(on), len(of)) for on, of in zip(*ids))
    whole = sum(on == of for on, of in zip(*ids))
    parts = [next((j for j, (a, b) in enumerate(zip(on, of)) if a != b),
                  min(len(on), len(of))) for on, of in zip(*ids)]
    early = [i for i, (p, v) in enumerate(zip(parts, first_verify))
             if p < (len(ids[0][i]) if v is None else v)]
    log(f"[spec] the same chats with speculation off: {same} of {total} "
        f"greedy tokens agree position by position ({same / total:.3f}); "
        f"{whole} of {len(texts_on)} chats identical; per chat, first "
        f"token that differs {parts} and tokens emitted before its first "
        f"verify step {first_verify}")
    if early:
        raise AssertionError(
            f"chats {early} part from the speculation-off run before "
            f"their first verify step: plain steps must not change tokens")
    return {"tokens_agree": same, "tokens": total, "chats_identical": whole,
            "first_differing_token": parts, "first_verify": first_verify}


class _ScriptedDrafter:
    """Test drafter of the oracle check (not a package feature): proposes
    ``fn(request id, tokens so far, cap)`` in place of prompt lookup."""

    def __init__(self, fn):
        self.fn = fn

    def draft(self, req_id, tokens, k):
        return [int(t) for t in self.fn(req_id, list(tokens), k)]

    def observe(self, *args):
        pass

    def forget(self, *args):
        pass

    def disabled_count(self):
        return 0


@_timed
def phase_oracle(int8: bool = False) -> dict:
    """Speculation preserves the tokens, at full width and 2 layers in
    float32: greedy and seeded temperature 0.8 with penalties, run
    without speculation, then with a drafter that proposes the recorded
    continuation (every draft accepted: fewer device steps) and with one
    that proposes a wrong token at every position (every draft rejected:
    no more device steps).  The oracle run must give the plain run's
    tokens for both requests, the wrong-drafter run for the greedy one.
    The seeded request under the wrong drafter keeps the plain tokens up
    to and including the first verify step's, and no further: as in the
    reference, a verify call spends one key split at every live position,
    rejected drafts included, and does not give them back (the reference
    holds bit identity only with an oracle, ``tests/test_spec_decode.py``;
    the CPU tests hold the port's key stream to the JAX engine's).  With
    ``int8`` the weights are quantized on the card and the KV pool is
    int8, as in the spec cell: K1-int8 must run the accepted verify
    rows."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.ops.quant import quantize_params

    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2, dtype="float32")
    params = init_params(cfg, 2, device="cuda")
    extra = {}
    if int8:
        params = quantize_params(params)
        extra["kv_cache_dtype"] = "int8"
    kernel = K1_INT8 if int8 else K1
    V, k = cfg.vocab_size, 4
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(4, 260, size=300)]
               for _ in range(2)]
    n_tok = 1 + 4 * (k + 1)
    sps = [SamplingParams(temperature=0.0, max_tokens=n_tok),
           SamplingParams(temperature=0.8, seed=99, presence_penalty=0.3,
                          frequency_penalty=0.2, max_tokens=n_tok)]

    def run(spec, drafter=None):
        eng = Engine(cfg, params, EngineConfig(
            max_decode_batch=8, page_size=16, num_pages=256,
            max_pages_per_seq=64, max_prefill_len=512,
            enable_spec_decode=spec, spec_tokens=k, **extra), device="cuda")
        if drafter is not None:
            eng.spec = drafter
        reqs = [Request(id=f"o{i}", prompt_tokens=p, sampling=s)
                for i, (p, s) in enumerate(zip(prompts, sps))]
        for r in reqs:
            eng.add_request(r)
        kernel.launches = 0
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
        eng.k1_launches = kernel.launches
        return [r.output_tokens for r in reqs], eng

    base, off = run(False)
    target = {f"o{i}": prompts[i] + base[i] for i in range(len(prompts))}
    oracle = _ScriptedDrafter(
        lambda rid, toks, cap: target[rid][len(toks): len(toks) + cap])
    wrong = _ScriptedDrafter(
        lambda rid, toks, cap: [(t + 1) % V for t in
                                target[rid][len(toks): len(toks) + cap]])
    got_o, eng_o = run(True, oracle)
    got_w, eng_w = run(True, wrong)
    engs = {"off": off, "oracle": eng_o, "wrong": eng_w}
    steps = {n: e.num_decode_device_steps for n, e in engs.items()}
    per_slot = {n: e.num_decode_tokens / max(1, e.num_decode_slot_steps)
                for n, e in engs.items()}
    seeded_same = next((i for i, (a, b) in enumerate(zip(got_w[1], base[1]))
                        if a != b), n_tok)
    name = "K1-int8" if int8 else "K1 (float32)"
    tag = "oracle int8" if int8 else "oracle"
    log(f"[{tag}] 2-layer full width f32"
        + (", int8 weights + int8 KV" if int8 else "")
        + f", greedy + seeded temperature 0.8 with penalties, {n_tok} "
        f"tokens each: oracle drafter tokens identical {got_o == base}; "
        f"wrong drafter greedy tokens identical {got_w[0] == base[0]}, "
        f"seeded tokens identical for the first {seeded_same}; device "
        f"steps {steps}; decode tokens per device step and active slot "
        + ", ".join(f"{n} {v:.3f}" for n, v in per_slot.items())
        + f"; oracle accepted {eng_o.num_spec_accepted_tokens} of "
        f"{eng_o.num_spec_drafted_tokens}, wrong accepted "
        f"{eng_w.num_spec_accepted_tokens} of "
        f"{eng_w.num_spec_drafted_tokens}; {name} launches: oracle run "
        f"{eng_o.k1_launches}, wrong run {eng_w.k1_launches}")
    if eng_o.k1_launches <= 0 or eng_o.num_spec_accepted_tokens <= 0:
        raise AssertionError(f"{name} ran no accepted verify row")
    if got_o != base or got_w[0] != base[0] or seeded_same < 2:
        raise AssertionError(f"speculation changed tokens: off {base}, "
                             f"oracle {got_o}, wrong {got_w}")
    if not steps["oracle"] < steps["off"]:
        raise AssertionError(f"oracle drafter saved no device step: {steps}")
    if steps["wrong"] > steps["off"]:
        raise AssertionError(f"wrong drafter cost device steps: {steps}")
    del params, off, eng_o, eng_w, engs
    _free()
    return {"device_steps": steps, "wrong_seeded_same": seeded_same,
            "tokens_per_slot_step": per_slot}


# ---------------------------------------------------------------------------
# 4e. the host KV tier: spill and restore, preemption, migration
# ---------------------------------------------------------------------------

# H100 SXM host link, PCIe Gen5 x16: 128 GB/s both ways (NVIDIA's data
# sheet), 64 GB/s each way -- the bound of a copy to or from host memory
PCIE_BYTES = 64e9
# phase 4e runs the entry at full width and 8 of Llama-3-8B's 32 layers:
# a depth cut that makes room for phases 4j and 4m within the smoke's time
HOST_TIER_LAYERS = 8
# its int8 page: 2 (K, V) x 8 layers x 16 slots x 8 KV heads x (128
# codes + one f32 scale), bytes
PAGE_BYTES_INT8 = 2 * HOST_TIER_LAYERS * 16 * 8 * (128 + 4)
# phase 4e.2's cut of the entry's pool: at 128 pages per sequence its 16
# slots hold at most 2048 of 3968 pages, so the pool as written never
# runs out; at 256 pages eleven of its chats fill it
LADDER_PAGES = 256
# fill chats of phase 4e.1: each adopts 93 pages; 51 prompts' prefixes
# (4743 pages) overflow the 3968-page pool by ~800
N_FILL = 48
# snapshot_to_wire's document as the shipper posts it (a wrapper below
# takes the shipper's ``json`` argument)
_dumps = json.dumps


def _ids(text) -> list:
    return [int(x) for x in re.findall(r"<(\d+)>", text)]


def _system_prompt(i) -> str:
    """~1470 bytes, distinct per i: with the chat template ~1500 tokens
    of the byte tokenizer."""
    return f"System prompt {i:03d}. " + "".join(
        f"Rule {j} of deployment {i}: answer briefly, cite the source. "
        for j in range(25))


def _msgs(i, user="Summarise the rules in one line."):
    return [{"role": "system", "content": _system_prompt(i)},
            {"role": "user", "content": user}]


def _chat_msgs(base, messages, max_tokens, model=MODEL, **extra) -> str:
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0,
            "messages": messages, **extra}
    out = json.loads(_post(base + "/v1/chat/completions", body))
    assert out["choices"][0]["finish_reason"] in ("stop", "length"), out
    return out["choices"][0]["message"]["content"]


def _concurrent(base, bodies, max_tokens, workers=16, models=None) -> list:
    models = models or [MODEL] * len(bodies)
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(
            lambda mm: _chat_msgs(base, mm[0], max_tokens, model=mm[1]),
            zip(bodies, models)))


def _first_verify(eng) -> list:
    """Spy on ``eng``'s verify dispatches: the returned list receives the
    emitted-token count of the first occupied slot at each one (phase
    4e.3 runs one request at a time).  Undo with ``del
    eng._spec_dispatch_tail``."""
    seen, tail = [], eng._spec_dispatch_tail

    def spy(drafts, draft_len):
        seen.extend(len(r.output_tokens) for r in eng.slots[:1]
                    if r is not None)
        return tail(drafts, draft_len)

    eng._spec_dispatch_tail = spy
    return seen


def _page_sums(eng, digests) -> list:
    """Checksums of a prefix's pages where the device prefix cache holds
    them now (read while the engine is idle)."""
    return _sums(eng.cache, [eng.prefix_cache._entries[h][0]
                             for h in digests])


def _round_trip(eng, page_ids, scratch, want) -> dict:
    """One batch of the pool's pages through the host tier and back:
    gather + ``HostPagePool.put`` (pinned staging copies, queued), the
    pageable store (``drain_pending``: copy out of staging + checksums),
    ``restore_pages`` into ``scratch``; bytes checked both ways."""
    from helix_tpu_torch.engine.kv_cache import (
        HostPagePool,
        gather_pages,
        page_checksum,
        restore_pages,
    )

    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    hp = HostPagePool(1 << 36, device="cuda")
    torch.cuda.synchronize()
    e0, e1, e2 = ev(), ev(), ev()
    t0 = time.monotonic()
    e0.record()
    pages = gather_pages(eng.cache, page_ids)
    e1.record()
    for i, p in zip(page_ids, pages):
        if not hp.put(i, p):
            raise AssertionError("host tier refused a page")
    e2.record()
    del pages
    torch.cuda.synchronize()
    d2h_wall = time.monotonic() - t0
    t1 = time.monotonic()
    hp.drain_pending()
    finalize_s = time.monotonic() - t1
    nbytes = hp.used_bytes
    entries = [hp.take_restored(i) for i in page_ids]
    if [page_checksum(e) for e in entries] != want:
        raise AssertionError("pages changed on their way to the host")
    targets = list(range(1, len(page_ids) + 1))
    torch.cuda.synchronize()
    t2 = time.monotonic()
    restore_pages(scratch, targets, entries)
    torch.cuda.synchronize()
    h2d_wall = time.monotonic() - t2
    if _sums(scratch, targets) != want:
        raise AssertionError("pages changed on their way back")
    d2h_ms = e1.elapsed_time(e2)
    return {"bytes": nbytes, "gather_ms": e0.elapsed_time(e1),
            "d2h_ms": d2h_ms, "d2h_gbps": nbytes / d2h_ms / 1e6,
            "d2h_wall_ms": d2h_wall * 1e3, "finalize_ms": finalize_s * 1e3,
            "h2d_wall_ms": h2d_wall * 1e3,
            "h2d_gbps": nbytes / h2d_wall / 1e9}


def _sums(cache, page_ids) -> list:
    from helix_tpu_torch.engine.kv_cache import gather_pages, page_checksum

    return [page_checksum({f: None if a is None else a.cpu()
                           for f, a in p.items()})
            for p in gather_pages(cache, page_ids)]


def _link_rates(eng, page_ids) -> dict:
    """Host-link rates for one batch of pages on an idle engine: two
    round trips (the first also allocates the pinned staging blocks,
    which PyTorch's pinned-memory cache keeps for the second) and a bare
    pinned upload of the same bytes, against the link's data-sheet rate."""
    from helix_tpu_torch.engine.kv_cache import CacheConfig, PagedKVCache

    cc = eng.cache_cfg
    scratch = PagedKVCache.create(eng.model_cfg, CacheConfig(
        num_pages=len(page_ids) + 1, page_size=cc.page_size,
        max_pages_per_seq=cc.max_pages_per_seq, dtype=cc.dtype), "cuda")
    want = _sums(eng.cache, page_ids)
    cold = _round_trip(eng, page_ids, scratch, want)
    warm = _round_trip(eng, page_ids, scratch, want)
    stage = torch.empty(warm["bytes"], dtype=torch.uint8, pin_memory=True)
    h0 = torch.cuda.Event(enable_timing=True)
    h1 = torch.cuda.Event(enable_timing=True)
    h0.record()
    stage.to("cuda", non_blocking=True)
    h1.record()
    torch.cuda.synchronize()
    up_ms = h0.elapsed_time(h1)
    del scratch
    return {"pages": len(page_ids), "cold": cold, "warm": warm,
            "bytes": warm["bytes"], "h2d_pinned_ms": up_ms,
            "h2d_pinned_gbps": warm["bytes"] / up_ms / 1e6,
            "bound_ms": warm["bytes"] / PCIE_BYTES * 1e3}


@_timed
def phase_host_tier(smi) -> dict:
    """4e.1-4e.3 on the v5e1-hotswap entry at full width and
    ``HOST_TIER_LAYERS`` of its 32 layers (``ENTRY``, its 16 GiB host
    tier included), int8 weights and KV:

    1. spill and restore on engine A: three probe chats, each sent
       twice (cold, then a device prefix hit), then ``N_FILL`` distinct
       ~1500-token system prompts that overflow the 3968-page pool and
       push the probes' prefixes to the host, then the probes a third
       time: their pages come back from the host (restores > 0),
       checksums equal to those of the device-resident pages, and tokens
       equal to the device hit's (the same step composition: one chat
       alone, the same history and rows); K1-int8 must run the restored
       rows;
    2. the ladder on engine B (the entry with ``LADDER_PAGES`` pages,
       ``HELIX_PREEMPT_STALL_SECONDS=0.5``): 14 chats of 200 tokens where
       11 fit; at least one preemption and one resume, every chat
       answered, the seeded request reproduced;
    3. export -> wire -> import over HTTP: a chat streaming from A is
       drained with a ``PeerShipper`` aimed at B and continued with
       ``/v1/migrate/resume``; every token exactly once, the stream
       complete, K1-int8 on the imported rows."""
    from helix_tpu_torch.engine.kv_cache import PrefixCache
    from helix_tpu_torch.ops.paged_kernel import K1_INT8
    from helix_tpu_torch.serving import migration, openai_api

    tag = "host tier"
    out = {}
    t0 = time.monotonic()
    sa, eng_a, httpd_a, base_a, reg_a, mem_a = _serve(
        dict(ENTRY), "int8", layers=HOST_TIER_LAYERS)
    hp = eng_a.host_pool
    log(f"[{tag}] ({smi}) engine A: the v5e1-hotswap entry {ENTRY} at "
        f"{HOST_TIER_LAYERS} of 32 layers (a depth cut), built in "
        f"{time.monotonic() - t0:.1f} s, KV pool {mem_a['kv_pool_gib']:.2f} "
        f"GiB, host tier budget {hp.budget_bytes} B = "
        f"{hp.budget_bytes // PAGE_BYTES_INT8} int8 pages of "
        f"{PAGE_BYTES_INT8} B ({hp.budget_bytes / PAGE_BYTES_INT8 / 3968:.2f}"
        f"x the 3968-page pool)")
    page = eng_a.cache_cfg.page_bytes(eng_a.model_cfg)
    if page != PAGE_BYTES_INT8:
        raise AssertionError(f"int8 page is {page} B, not {PAGE_BYTES_INT8}")
    sb = httpd_b = reg_b = None
    try:
        # -- 4e.1 spill and restore ------------------------------------
        probes = (0, 1, 2)
        tok = sa.tokenizer
        digests = {}
        for i in probes:
            ids = tok.apply_chat_template(_msgs(i), add_generation_prompt=True)
            digests[i] = PrefixCache.page_hashes(ids, 16, (len(ids) - 1) // 16)
        cold = {i: _ids(_chat_msgs(base_a, _msgs(i), 16)) for i in probes}
        hit = {i: _ids(_chat_msgs(base_a, _msgs(i), 16)) for i in probes}
        resident = {i: _page_sums(eng_a, digests[i]) for i in probes}
        t1 = time.monotonic()
        _concurrent(base_a, [_msgs(100 + i) for i in range(N_FILL)], 8)
        fill_s = time.monotonic() - t1
        on_host = {i: sum(hp.contains(h) for h in digests[i]) for i in probes}
        spilled, stats_fill = hp.spilled_pages, hp.stats()
        occupancy = hp.occupancy
        if spilled <= 0 or not all(on_host.values()):
            raise AssertionError(f"the probes' prefixes were not spilled: "
                                 f"{on_host}, {stats_fill}")
        K1_INT8.launches = 0
        r0, c0 = hp.restored_pages, eng_a.restore_seconds
        again = {i: _ids(_chat_msgs(base_a, _msgs(i), 16)) for i in probes}
        restored = hp.restored_pages - r0
        k1_restored = K1_INT8.launches
        back = {i: _page_sums(eng_a, digests[i]) for i in probes}
        same = {i: again[i] == hit[i] for i in probes}
        cold_agree = sum(a == b for i in probes
                         for a, b in zip(cold[i], hit[i]))
        out["spill"] = dict(spilled_pages=spilled, restored_pages=restored,
                            host_stats=stats_fill, occupancy=occupancy,
                            k1_int8_launches=k1_restored)
        log(f"[{tag}] ({smi}) 4e.1: {N_FILL} fill chats of ~1500 tokens in "
            f"{fill_s:.1f} s; pages spilled {spilled} "
            f"({spilled * PAGE_BYTES_INT8} B); host pool {stats_fill}, "
            f"occupancy {occupancy:.4f}; probes' prefix pages on the host "
            f"{on_host}; third sends restored {restored} pages in "
            f"{(eng_a.restore_seconds - c0) * 1e3:.1f} ms of restore "
            f"(host clock); checksums equal to the device-resident pages: "
            f"{back == resident}; tokens equal to the device-hit run: "
            f"{same}; cold vs hit agreement {cold_agree} of "
            f"{sum(len(hit[i]) for i in probes)}; K1-int8 launches on the "
            f"restored runs {k1_restored}")
        if restored <= 0:
            raise AssertionError("no page was restored from the host")
        if back != resident:
            raise AssertionError("restored pages differ from the spilled")
        if not all(same.values()):
            raise AssertionError(f"restored-prefix tokens differ from the "
                                 f"device-resident run: {again} vs {hit}")
        if k1_restored <= 0:
            raise AssertionError("K1-int8 did not run the restored rows")
        if hp.corrupt_pages or hp.alloc_failures:
            raise AssertionError(f"host tier faults: {hp.stats()}")
        rates = _link_rates(eng_a, [eng_a.prefix_cache._entries[h][0]
                                    for h in digests[0]])
        out["link"] = rates
        for run in ("cold", "warm"):
            r = rates[run]
            log(f"[{tag}] ({smi}) host link, a batch of {rates['pages']} "
                f"pages ({r['bytes']} B), {run}: device-to-host copies "
                f"{r['d2h_ms']:.3f} ms = {r['d2h_gbps']:.2f} GB/s (gather "
                f"{r['gather_ms']:.3f} ms; queued and waited "
                f"{r['d2h_wall_ms']:.1f} ms; pageable store + checksums "
                f"{r['finalize_ms']:.1f} ms); restore {r['h2d_wall_ms']:.1f}"
                f" ms wall = {r['h2d_gbps']:.2f} GB/s (pinned staging copy "
                f"+ upload + index_copy_)")
        log(f"[{tag}] ({smi}) host link: bare pinned upload of the batch "
            f"{rates['h2d_pinned_ms']:.3f} ms = "
            f"{rates['h2d_pinned_gbps']:.2f} GB/s; bound (PCIe Gen5 x16, "
            f"64 GB/s each way) {rates['bound_ms']:.3f} ms")

        # -- 4e.2 the ladder on engine B ---------------------------------
        os.environ["HELIX_PREEMPT_STALL_SECONDS"] = "0.5"
        os.environ["HELIX_ADMISSION_TIMEOUT"] = "300"
        try:
            t1 = time.monotonic()
            sb, eng_b, httpd_b, base_b, reg_b, _m = _serve(
                {**ENTRY, "num_pages": LADDER_PAGES}, "int8",
                layers=HOST_TIER_LAYERS)
        finally:
            os.environ.pop("HELIX_PREEMPT_STALL_SECONDS")
            os.environ.pop("HELIX_ADMISSION_TIMEOUT")
        if sb.loop.preempt_stall_seconds != 0.5:
            raise AssertionError("HELIX_PREEMPT_STALL_SECONDS not read")
        preempt_s = []
        preempt = eng_b.preempt

        def timed_preempt(rid):
            ts = time.monotonic()
            ok = preempt(rid)
            preempt_s.append(time.monotonic() - ts)
            return ok

        eng_b.preempt = timed_preempt
        chats = [[{"role": "user", "content": f"Chat {i}: " + "tell me "
                   "about the printing press in plain words. " * 3}]
                 for i in range(14)]
        K1_INT8.launches = 0
        c0 = (eng_b.num_resumes, eng_b.restore_seconds)
        texts = _concurrent(base_b, chats, 200)
        st = sb.loop.stats()
        resumes = eng_b.num_resumes - c0[0]
        resume_s = eng_b.restore_seconds - c0[1]
        eng_b.preempt = preempt
        seeded = _seeded_twice(base_b)
        out["ladder"] = dict(preemptions=st["preemptions"], resumes=resumes,
                             answered=len(texts), k1=K1_INT8.launches)
        log(f"[{tag}] ({smi}) 4e.2: engine B = the entry with {LADDER_PAGES} pages "
            f"(built in {time.monotonic() - t1:.1f} s with the chats); 14 "
            f"chats of 200 tokens: answered {len(texts)}, preemptions "
            f"{st['preemptions']}, resumes {resumes}, parked at the end "
            f"{st['preempted_parked']}, sheds {st['kv_exhausted_sheds']}; "
            f"preempt {np.mean(preempt_s) * 1e3 if preempt_s else 0:.1f}"
            f" ms per request (host clock, {len(preempt_s)} calls), resume "
            f"{resume_s / max(1, resumes) * 1e3:.1f} ms per request (host "
            f"clock, restore incl. the queued upload); host pool "
            f"{st['host_pool']}; K1-int8 launches {K1_INT8.launches}; "
            f"seeded request reproduced ({seeded.count('<')} tokens)")
        if len(texts) != 14 or not all(_ids(t) for t in texts):
            raise AssertionError("a ladder chat went unanswered")
        if st["preemptions"] < 1 or resumes < 1:
            raise AssertionError(f"no preemption and resume: {st}")
        if st["preempted_parked"] or st["kv_exhausted_sheds"]:
            raise AssertionError(f"ladder left work behind: {st}")

        # -- 4e.3 export -> wire -> import over HTTP ------------------------
        story = _msgs(0, user="Write a long story about the rules.")
        # once to adopt the story prompt's own pages, so the reference
        # run and the drained one are the same full-prefix hit
        _chat_msgs(base_a, story, 8)
        verify_a = _first_verify(eng_a)
        ref = _ids(_chat_msgs(base_a, story, 160))
        del eng_a._spec_dispatch_tail
        verify_b = _first_verify(eng_b)
        wires, clock, b_events = [], {}, []
        encode, decode, export = [], [], []

        def timed_post(url, json=None, headers=None, timeout=None):
            wires.append(json)
            clock["wire_bytes"] = len(_dumps(json))
            K1_INT8.launches = 0   # A stepped its last; B's work from here
            clock["post"] = time.monotonic()
            return migration.http_post(url, json=json, headers=headers,
                                       timeout=timeout)

        def timed(fn, sink):
            def wrapper(*a, **kw):
                ts = time.monotonic()
                r = fn(*a, **kw)
                sink.append(time.monotonic() - ts)
                return r
            return wrapper

        on_event = migration.ImportedStream.on_event

        def spy(stream, ev):
            b_events.append((time.monotonic(), ev))
            on_event(stream, ev)

        patches = [(migration, "snapshot_to_wire",
                    timed(migration.snapshot_to_wire, encode)),
                   (openai_api, "wire_to_snapshot",
                    timed(openai_api.wire_to_snapshot, decode)),
                   (migration.ImportedStream, "on_event", spy)]
        saved = [(o, n, getattr(o, n)) for o, n, _f in patches]
        eng_a.export_request = timed(eng_a.export_request, export)
        sa.loop.exporter = migration.PeerShipper(
            targets=[{"id": "engine-b", "address": base_b}], post=timed_post)
        for o, n, f in patches:
            setattr(o, n, f)
        try:
            got, first = {}, threading.Event()

            def client():
                body = {"model": MODEL, "max_tokens": 160, "temperature": 0,
                        "messages": story, "stream": True}
                req = urllib.request.Request(
                    base_a + "/v1/chat/completions",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    lines = []
                    for _ in range(24):
                        lines.append(r.readline().decode())
                    first.set()
                    got["raw"] = "".join(lines) + r.read().decode()

            t = threading.Thread(target=client)
            t.start()
            if not first.wait(300):
                raise AssertionError("the stream on A never started")
            sa.loop.stop(drain=0.05)
            t.join(300)
            frames = [f[6:] for f in got["raw"].split("\n\n")
                      if f.startswith("data: ")]
            err = json.loads(frames[-2])["error"]
            peer = migration.parse_migrated_peer(err["message"])
            rid = err["message"].split()[2]
            seen = "".join(json.loads(f)["choices"][0]["delta"].get(
                "content", "") for f in frames[:-2])
            with urllib.request.urlopen(urllib.request.Request(
                    base_b + "/v1/migrate/resume",
                    data=json.dumps({"request_id": rid,
                                     "emitted_chars": len(seen)}).encode(),
                    headers={"Content-Type": "application/json"}),
                    timeout=600) as r:
                resumed = [json.loads(f[6:]) for f in
                           r.read().decode().split("\n\n")
                           if f.startswith("data: {")]
        finally:
            for o, n, f in saved:
                setattr(o, n, f)
        k1_import = K1_INT8.launches
        del eng_b._spec_dispatch_tail
        eos = set(sa.tokenizer.eos_ids)
        prior = wires[0]["output_tokens"]
        b_new = [ev.token_id for _t, ev in b_events if not ev.error]
        sent = [t for t in prior + b_new if t not in eos]
        full = _ids(seen + "".join(d.get("delta", "") for d in resumed))
        agree = sum(a == b for a, b in zip(full, ref))
        parts = next((j for j, (a, b) in enumerate(zip(full, ref))
                      if a != b), min(len(full), len(ref)))
        first_tok_ms = (b_events[0][0] - clock["post"]) * 1e3
        out["migration"] = dict(peer=peer, tokens=len(full),
                                wire_bytes=clock["wire_bytes"],
                                k1_int8_launches=k1_import)
        log(f"[{tag}] ({smi}) 4e.3: drained A to {peer}: {len(_ids(seen))} tokens "
            f"streamed from A, snapshot of {len(prior)} emitted tokens and "
            f"{len(wires[0]['pages'])} pages, wire {clock['wire_bytes']} B; "
            f"export (gather) {export[0] * 1e3:.1f} ms, encode "
            f"{encode[0] * 1e3:.1f} ms, decode {decode[0] * 1e3:.1f} ms per "
            f"snapshot (host clock); import to first token "
            f"{first_tok_ms:.1f} ms (POST start to B's first event); "
            f"resumed stream {len(resumed)} frames ending "
            f"{resumed[-1].get('finish_reason')}; {len(full)} tokens in "
            f"all, {agree} agree with A's uninterrupted run of the same "
            f"composition, the first differing at {parts} (verify steps "
            f"at emitted counts: A's run {verify_a[:6]}, B's continuation "
            f"{verify_b[:6]}); "
            f"K1-int8 launches on B's imported rows {k1_import}")
        if peer != "engine-b" or err.get("code") != "migrated":
            raise AssertionError(f"no migrated frame: {err}")
        if _ids(seen) != prior[: len(_ids(seen))]:
            raise AssertionError("the client saw tokens A never emitted")
        if full != sent:
            raise AssertionError("a token was lost or sent twice")
        if resumed[-1].get("finish_reason") not in ("stop", "length"):
            raise AssertionError(f"the resumed stream did not finish: "
                                 f"{resumed[-1]}")
        if len(full) != len(ref) and resumed[-1]["finish_reason"] == \
                "length":
            raise AssertionError(f"{len(full)} tokens, not {len(ref)}")
        if k1_import <= 0:
            raise AssertionError("K1-int8 did not run the imported rows")
    finally:
        _unserve(sa, httpd_a, reg_a)
        if sb is not None:
            _unserve(sb, httpd_b, reg_b)
    del sa, sb, eng_a, reg_a, reg_b, hp
    _free()
    return out


@_timed
def phase_host_exact(smi, int8: bool = False) -> dict:
    """4e.4: exactness at 2 layers, full width, float32 (and with int8
    weights + int8 KV): a greedy and a seeded temperature 0.8 request
    with penalties, each run alone, give the same tokens uninterrupted,
    across a preempt / resume through the host tier after 10 tokens, and
    exported after 10 tokens, through the JSON wire, imported into a
    second engine and continued.  The K1 form of the pool must run the
    resumed and the imported rows."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.ops.quant import quantize_params
    from helix_tpu_torch.serving import migration

    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2, dtype="float32")
    params = init_params(cfg, 4, device="cuda")
    extra = {}
    if int8:
        params = quantize_params(params)
        extra["kv_cache_dtype"] = "int8"
    kernel = K1_INT8 if int8 else K1
    prompt = [int(t) for t in np.random.default_rng(8).integers(
        4, 260, size=300)]
    sps = {"greedy": SamplingParams(temperature=0.0, max_tokens=24),
           "seeded": SamplingParams(temperature=0.8, seed=99,
                                    presence_penalty=0.3,
                                    frequency_penalty=0.2, max_tokens=24)}

    def engine():
        return Engine(cfg, params, EngineConfig(
            max_decode_batch=8, page_size=16, num_pages=256,
            max_pages_per_seq=64, max_prefill_len=512,
            host_pool_bytes=1 << 30, **extra), device="cuda")

    def start(eng, rid, sp, cut):
        req = Request(id=rid, prompt_tokens=list(prompt), sampling=sp)
        eng.add_request(req)
        while len(req.output_tokens) < cut:
            eng.step()
        return req

    def finish(eng, req):
        while not req.finished:
            eng.step()
        return list(req.output_tokens)

    rows = {}
    for name, sp in sps.items():
        eng = engine()
        base = finish(eng, start(eng, "u", sp, 1))
        eng = engine()
        req = start(eng, "p", sp, 10)
        if not eng.preempt("p"):
            raise AssertionError("preempt refused")
        kernel.launches = 0
        swapped = finish(eng, req)
        resumed_launches = kernel.launches
        eng = engine()
        req = start(eng, "x", sp, 10)
        ts = time.monotonic()
        snap = eng.export_request("x")
        wire = json.dumps(migration.snapshot_to_wire(snap))
        enc_ms = (time.monotonic() - ts) * 1e3
        eng.abort("x")
        other = engine()
        ts = time.monotonic()
        imp = other.import_request(migration.wire_to_snapshot(
            json.loads(wire)))
        dec_ms = (time.monotonic() - ts) * 1e3
        kernel.launches = 0
        moved = finish(other, imp)
        rows[name] = dict(same_swap=swapped == base, same_move=moved == base,
                          resumed_launches=resumed_launches,
                          imported_launches=kernel.launches,
                          wire_bytes=len(wire), export_encode_ms=enc_ms,
                          decode_import_ms=dec_ms)
        del eng, other
    tag = "host exact int8" if int8 else "host exact"
    kname = "K1-int8" if int8 else "K1 (float32)"
    log(f"[{tag}] ({smi}) 2 layers full width f32"
        + (", int8 weights + int8 KV" if int8 else "") + ": "
        + "; ".join(f"{n}: tokens identical across preempt/resume "
                    f"{r['same_swap']}, across export/import "
                    f"{r['same_move']}; {kname} launches on resumed rows "
                    f"{r['resumed_launches']}, on imported rows "
                    f"{r['imported_launches']}; wire {r['wire_bytes']} B, "
                    f"export + encode {r['export_encode_ms']:.1f} ms, "
                    f"decode + import {r['decode_import_ms']:.1f} ms"
                    for n, r in rows.items()))
    for n, r in rows.items():
        if not (r["same_swap"] and r["same_move"]):
            raise AssertionError(f"{tag} {n}: tokens changed: {r}")
        if r["resumed_launches"] <= 0 or r["imported_launches"] <= 0:
            raise AssertionError(f"{tag} {n}: {kname} did not run the "
                                 "resumed or imported rows")
    del params
    _free()
    return rows


# ---------------------------------------------------------------------------
# 4f. hot-swap: Llama-3-8B and Phi-3-mini under the profile's HBM budget
# ---------------------------------------------------------------------------

PHI3 = "microsoft/Phi-3-mini-4k-instruct"
HOTSWAP_PROFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "profiles", "v5e1-hotswap.yaml")
# Phi-3's pool cut for the card run: as written (2048 pages) the entry's
# estimate is over the budget, so the reference node can never load it
PHI3_CUT_PAGES = 1024


def _hotswap_copy(phi3_pages=PHI3_CUT_PAGES, llama_as_written=False) -> tuple:
    """``profiles/v5e1-hotswap.yaml`` with the cuts this phase makes: the
    Llama entry's ``slo`` (served in phase 4i) and adapter pool dropped
    (the phase holds the manager to the reference's estimate, which has no
    pool; phase 4g serves it) unless ``llama_as_written``, and Phi-3's pool
    cut to ``phi3_pages`` (unless it is None).  Returns (profile, the cuts
    made)."""
    from helix_tpu_torch.cli import _load_profile

    prof = _load_profile(HOTSWAP_PROFILE)
    cuts = []
    for m in prof["models"]:
        if llama_as_written and m["name"] == MODEL:
            continue
        if "slo" in m:
            del m["slo"]
            cuts.append(f"{m['name']}: slo dropped (served in phase 4i)")
        for k in ("adapter_pool_slots", "adapter_rank"):
            if k in m["engine"]:
                del m["engine"][k]
                cuts.append(f"{m['name']}: engine.{k} dropped (served in "
                            "phase 4g)")
        if m["name"] == PHI3 and phi3_pages is not None:
            cuts.append(f"{m['name']}: engine.num_pages "
                        f"{m['engine']['num_pages']} -> {phi3_pages}")
            m["engine"]["num_pages"] = phi3_pages
    return prof, cuts


def _node(prof, tmpdir, tag, build, random_weights=True):
    """The profile as ``serve-node --profile <copy> [--random-weights]``
    builds it (``cli.make_node`` in process, with no control plane: the
    node agent applies the profile, each entry through ``build``, which
    takes ``cli.build_served_model``'s keywords), behind a started
    server: (registry, manager, httpd, base url, copy path)."""
    from helix_tpu_torch import cli

    path = os.path.join(tmpdir, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(prof, f)
    agent, httpd = cli.make_node(
        _node_args(None, tag, path, random_weights=random_weights),
        build_model=build)
    if agent.state.status != "running":
        httpd.server_close()
        raise AssertionError(f"{tag}: the apply failed: {agent.state.error}")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    return agent.registry, agent.registry.inner, httpd, base, path


def _error_of(base, body, path="/v1/chat/completions") -> tuple:
    """(status, error body) of a request expected to fail."""
    try:
        out = _post(base + path, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError(f"expected an error, got 200: {out[:200]}")


def _ttft_chat(base, model, content, max_tokens) -> tuple:
    """A streamed chat: (seconds to the first content frame, token
    count, finish reason)."""
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "messages": [{"role": "user",
                                          "content": content}]}
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    ttft, text, finish = None, "", None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            frame = json.loads(line[6:])
            if "error" in frame:
                raise AssertionError(f"stream failed: {frame}")
            ch = frame["choices"][0]
            if ch["delta"].get("content") and ttft is None:
                ttft = time.monotonic() - t0
            text += ch["delta"].get("content", "")
            finish = ch["finish_reason"] or finish
    return ttft, text.count("<"), finish


def _seeded(base, model) -> str:
    out = json.loads(_post(base + "/v1/completions",
                           {"model": model, **SEEDED}))
    text = out["choices"][0]["text"]
    if not text:
        raise AssertionError(f"{model}: empty seeded completion")
    return text


def _pinned_bytes() -> int:
    """Bytes of pinned host memory PyTorch's pinned-memory allocator
    holds (in use and cached)."""
    return int(torch.cuda.host_memory_stats()["allocated_bytes.current"])


@_timed
def phase_hotswap(smi) -> dict:
    """The ``v5e1-hotswap`` profile's two models, both at full width and
    depth with random weights from seed 0, on one card under the
    profile's 14 GiB budget, one at a time, through the port's
    ``ResidencyManager`` behind its OpenAI server (``_hotswap_copy``'s
    cuts).  Steps: (1) 4 chats to Llama, a synchronous load, and a
    seeded request; (2) 4 chats to Phi-3 while Llama is idle: Llama is
    evicted, its memory freed before Phi-3's build, K2 and K1-int8 run
    at D 96; (3) Llama asked for while Phi-3 streams a long reply: 503
    ``overloaded_error``, the reply finishes whole; (4)
    ``/admin/prefetch`` of Llama once Phi-3 is idle: the next chat
    stalls for a small share of step 1's load and the seeded request
    gives step 1's tokens; (5) three swap cycles: memory with Llama
    resident within 1% of the first cycle's, pinned host memory not
    growing; (6) Phi-3's entry as written (2048 pages) on a second node:
    503 with the reference's ``MemoryError`` text, nothing allocated."""
    import tempfile

    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.engine.residency import (
        estimate_model_bytes,
        served_model_bytes,
    )
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8

    tag = f"[hotswap] ({smi})"
    gib = 2 ** 30
    prof, cuts = _hotswap_copy()
    for c in cuts:
        log(f"{tag} cut: {c}")
    budget = prof["residency"]["hbm_budget_bytes"]
    entries = {m["name"]: m for m in prof["models"]}
    estimates = {n: estimate_model_bytes(CATALOG[n], m["engine"],
                                         m.get("quantization"))
                 for n, m in entries.items()}
    builds = []     # one record per build: memory at its start, measured

    def build(**kw):
        rec = {"name": kw["name"], "allocated_at_start":
               torch.cuda.memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        served = build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        rec.update(
            measured=served_model_bytes(served, headroom=0.0),
            peak=torch.cuda.max_memory_allocated(),
            allocated_after=torch.cuda.memory_allocated(),
            split=served.build_seconds)
        builds.append(rec)
        log(f"{tag} built {kw['name']}: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in rec["split"].items())
            + f" (init includes int8 quantization); memory at build start "
            f"{rec['allocated_at_start'] / gib:.3f} GiB, after "
            f"{rec['allocated_after'] / gib:.3f} GiB, peak during build "
            f"{rec['peak'] / gib:.3f} GiB; weights + pools measured "
            f"{rec['measured']} B ({rec['measured'] / gib:.3f} GiB; x1.1 "
            f"= {int(rec['measured'] * 1.1)} B) vs estimate "
            f"{estimates[kw['name']]} B")
        return served

    def engine_of(name):
        return next(m for m in mgr.list() if m.name == name).loop.engine

    def swap_freed(before, name_evicted):
        """The build after an eviction started with the evicted model's
        memory given back (>= 95% of its measured bytes)."""
        measured = max(b["measured"] for b in builds
                       if b["name"] == name_evicted)
        freed = before - builds[-1]["allocated_at_start"]
        if freed < 0.95 * measured:
            raise AssertionError(
                f"evicting {name_evicted} freed {freed} B before the next "
                f"build, under 95% of its {measured} B")
        return freed

    def chats(model, n, max_tokens=32):
        prompts = [f"Hot-swap chat {i} for {model.split('/')[0]}: "
                   "summarise the history of paged attention in a few "
                   "lines." for i in range(n)]
        with concurrent.futures.ThreadPoolExecutor(n) as ex:
            return list(ex.map(lambda p: _ttft_chat(base, model, p,
                                                    max_tokens), prompts))

    out = {"cuts": cuts, "estimates": estimates}
    tmpdir = tempfile.mkdtemp(prefix="helix-hotswap-")
    _free()
    start_alloc = torch.cuda.memory_allocated()
    registry, mgr, httpd, base, _ = _node(prof, tmpdir, "hotswap", build)
    node_b = None
    try:
        if mgr.resident_names() or builds:
            raise AssertionError("the residency node built at start")
        log(f"{tag} node: {mgr.names()} registered, none resident; budget "
            f"{budget} B ({budget / gib:.2f} GiB); estimates "
            + ", ".join(f"{n} {e} B ({e / gib:.2f} GiB)"
                        for n, e in estimates.items()))
        K1.launches = K1_INT8.launches = K2.launches = 0
        # (1) Llama: a synchronous load under the first chats
        t0 = time.monotonic()
        r1 = chats(MODEL, 4)
        wall1 = time.monotonic() - t0
        st = mgr.stats()
        load1 = st["load_seconds"][MODEL]
        seeded1 = _seeded(base, MODEL)
        llama_launch = {"k1_int8": K1_INT8.launches, "k2": K2.launches}
        log(f"{tag} (1) 4 chats to Llama: synchronous load "
            f"load_seconds {load1:.3f} s, swap_seconds "
            f"{st['swap_seconds'][MODEL]:.3f} s; TTFT "
            + ", ".join(f"{t:.3f}" for t, _, _ in r1)
            + f" s; wall {wall1:.2f} s; loads {st['loads']} evictions "
            f"{st['evictions']}; used {st['used_bytes']} B; launches "
            f"{llama_launch}; seeded {seeded1.count('<')} tokens")
        if mgr.resident_names() != [MODEL] or st["loads"] != 1:
            raise AssertionError(f"step 1: resident {mgr.resident_names()}")
        # (2) Phi-3 while Llama is idle: evict, free, build
        before = torch.cuda.memory_allocated()
        K1.launches = K1_INT8.launches = K2.launches = 0
        r2 = chats(PHI3, 4)
        phi_launch = {"k1_int8": K1_INT8.launches, "k2": K2.launches,
                      "k1_float": K1.launches}
        after_load = torch.cuda.memory_allocated()
        freed = swap_freed(before, MODEL)
        st = mgr.stats()
        eng = engine_of(PHI3)
        d_phi = eng.model_cfg.head_dim
        log(f"{tag} (2) 4 chats to Phi-3 (D {d_phi}, H {eng.model_cfg.num_heads}"
            f" KVH {eng.model_cfg.num_kv_heads}, V "
            f"{eng.model_cfg.vocab_size}, weights "
            f"{eng.params['layers']['wq']['weight'].dtype}, KV "
            f"{eng.cache.k_pages.dtype}): memory_allocated before the "
            f"eviction {before / gib:.3f} GiB, after it "
            f"{builds[-1]['allocated_at_start'] / gib:.3f} GiB (freed "
            f"{freed} B), after the load {after_load / gib:.3f} GiB; "
            f"load_seconds {st['load_seconds'][PHI3]:.3f} s; TTFT "
            + ", ".join(f"{t:.3f}" for t, _, _ in r2)
            + f" s; evictions {st['evictions']}; launches at D 96 "
            f"{phi_launch}")
        if mgr.resident_names() != [PHI3] or st["evictions"] != 1:
            raise AssertionError(f"step 2: resident {mgr.resident_names()}")
        if d_phi != 96 or phi_launch["k1_int8"] <= 0 or phi_launch["k2"] <= 0:
            raise AssertionError(f"step 2: launches {phi_launch} at D {d_phi}")
        # (3) a busy model is never evicted
        first = threading.Event()
        long_out = {}

        def long_reply():
            body = {"model": PHI3, "max_tokens": 384, "temperature": 0,
                    "stream": True, "messages": [
                        {"role": "user", "content": "Write a long story."}]}
            req = urllib.request.Request(
                base + "/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                frames = []
                for raw in r:
                    line = raw.decode().strip()
                    if line.startswith("data: "):
                        frames.append(line[6:])
                        first.set()
                long_out["frames"] = frames

        bg = threading.Thread(target=long_reply)
        bg.start()
        if not first.wait(300):
            raise AssertionError("the long Phi-3 reply never started")
        status, err = _error_of(base, {
            "model": MODEL, "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        busy_during = engine_of(PHI3).has_work()
        bg.join(600)
        frames = long_out.get("frames", [])
        chunks = [json.loads(f) for f in frames[:-1]]
        n_long = sum(c["choices"][0]["delta"].get("content", "").count("<")
                     for c in chunks if "choices" in c)
        finish = chunks[-1]["choices"][0]["finish_reason"] if chunks else None
        log(f"{tag} (3) Llama asked for while Phi-3 streams: {status} "
            f"{err['error']['type']}: {err['error']['message']!r}; Phi-3 "
            f"busy then {busy_during}; its reply {n_long} tokens, finish "
            f"{finish}, last frame {frames[-1] if frames else None}")
        if status != 503 or err["error"]["type"] != "overloaded_error":
            raise AssertionError(f"step 3: {status} {err}")
        if frames[-1:] != ["[DONE]"] or finish not in ("length", "stop") \
                or any("error" in c for c in chunks):
            raise AssertionError("step 3: the busy model's reply broke")
        if mgr.resident_names() != [PHI3]:
            raise AssertionError("step 3: the busy model was evicted")
        # (4) prefetch Llama once Phi-3 is idle
        deadline = time.monotonic() + 60
        while engine_of(PHI3).has_work():
            if time.monotonic() > deadline:
                raise AssertionError("Phi-3 never went idle")
            time.sleep(0.01)
        before = torch.cuda.memory_allocated()
        loads0 = mgr.stats()["loads"]
        t0 = time.monotonic()
        pre = json.loads(_post(base + "/admin/prefetch", {"model": MODEL}))
        call_s = time.monotonic() - t0
        while mgr.stats()["loads"] == loads0:
            if time.monotonic() > t0 + 300:
                raise AssertionError("the prefetch never finished")
            time.sleep(0.01)
        ready_s = time.monotonic() - t0
        freed4 = swap_freed(before, PHI3)
        r4 = chats(MODEL, 1)
        st = mgr.stats()
        swap4 = st["swap_seconds"][MODEL]
        seeded4 = _seeded(base, MODEL)
        log(f"{tag} (4) /admin/prefetch {pre} in {call_s:.3f} s (the "
            f"eviction), resident after {ready_s:.3f} s, load_seconds "
            f"{st['load_seconds'][MODEL]:.3f} s; freed {freed4} B before "
            f"the build; next Llama chat stalled swap_seconds {swap4:.6f} s "
            f"({swap4 / load1:.5f} of step 1's load), TTFT {r4[0][0]:.3f} "
            f"s; seeded tokens equal step 1's: {seeded4 == seeded1}")
        if pre != {"model": MODEL, "prefetch": "started"}:
            raise AssertionError(f"step 4: {pre}")
        if swap4 > 0.1 * load1:
            raise AssertionError(f"step 4: stalled {swap4:.3f} s")
        if seeded4 != seeded1:
            raise AssertionError(
                f"step 4: seeded tokens changed across the reload: "
                f"{seeded4[:120]} != {seeded1[:120]}")
        # (5) three full swap cycles
        cycles = []
        for c in range(3):
            ev0, ld0 = st["evictions"], st["loads"]
            b_phi = torch.cuda.memory_allocated()
            chats(PHI3, 1, 8)
            f_phi = swap_freed(b_phi, MODEL)
            b_llama = torch.cuda.memory_allocated()
            chats(MODEL, 1, 8)
            f_llama = swap_freed(b_llama, PHI3)
            st = mgr.stats()
            torch.cuda.synchronize()
            cycles.append({"allocated": torch.cuda.memory_allocated(),
                           "reserved": torch.cuda.memory_reserved(),
                           "pinned": _pinned_bytes(),
                           "swap_phi3_s": st["swap_seconds"][PHI3],
                           "swap_llama_s": st["swap_seconds"][MODEL],
                           "freed": (f_phi, f_llama)})
            log(f"{tag} (5) cycle {c + 1}: memory_allocated "
                f"{cycles[-1]['allocated']} B, reserved "
                f"{cycles[-1]['reserved']} B, pinned host "
                f"{cycles[-1]['pinned']} B; swaps Phi-3 "
                f"{cycles[-1]['swap_phi3_s']:.3f} s, Llama "
                f"{cycles[-1]['swap_llama_s']:.3f} s; freed before each "
                f"build {f_phi} / {f_llama} B")
            if (st["evictions"] - ev0, st["loads"] - ld0) != (2, 2):
                raise AssertionError(f"cycle {c + 1}: {st}")
        a0 = cycles[0]["allocated"]
        drift = max(abs(x["allocated"] - a0) for x in cycles) / a0
        if drift > 0.01:
            raise AssertionError(f"memory drifted {drift:.4f} over cycles")
        if cycles[-1]["pinned"] > cycles[0]["pinned"]:
            raise AssertionError("pinned host memory grew over the cycles")
        # (6) Phi-3's entry as written, on a second node
        prof_b, _ = _hotswap_copy(phi3_pages=None)
        node_b = _node(prof_b, tmpdir, "as-written", build)
        n_builds = len(builds)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        status, err = _error_of(node_b[3], {
            "model": PHI3, "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        est = estimate_model_bytes(CATALOG[PHI3],
                                   prof_b["models"][1]["engine"])
        want = (f"cannot fit model '{PHI3}' ({est >> 20} MiB) in HBM budget "
                f"{budget >> 20} MiB: all resident models busy")
        log(f"{tag} (6) Phi-3 as written ({est} B = {est / gib:.2f} GiB "
            f"estimated, budget {budget / gib:.2f} GiB): {status} "
            f"{err['error']['type']}: {err['error']['message']!r}; "
            f"memory_allocated {before} -> {after} B; builds "
            f"{len(builds) - n_builds}")
        if status != 503 or err["error"] != {"message": want,
                                             "type": "overloaded_error"}:
            raise AssertionError(f"step 6: {status} {err}")
        if after != before or len(builds) != n_builds:
            raise AssertionError("step 6: the refused model allocated")
        launches = {"ragged_paged_attention_int8":
                    llama_launch["k1_int8"] + phi_launch["k1_int8"],
                    "flash_attention": llama_launch["k2"] + phi_launch["k2"]}
        out.update(load1=load1, swap4=swap4, cycles=cycles, builds=builds,
                   launches=launches, phi_launches=phi_launch,
                   llama_launches=llama_launch)
    finally:
        for node in (node_b, (registry, mgr, httpd, base, None)):
            if node is None:
                continue
            node[2].shutdown()
            node[2].server_close()
            for name in node[1].resident_names():
                node[1].evict(name)
    _free()
    end_alloc = torch.cuda.memory_allocated()
    log(f"{tag} memory_allocated at the phase's start {start_alloc} B, at "
        f"its end {end_alloc} B")
    return out


# ---------------------------------------------------------------------------
# 5. parity: kernels vs plain versions inside the engine
# ---------------------------------------------------------------------------
# 4g. multi-LoRA adapters: the v5e1-hotswap Llama entry with its pool
# ---------------------------------------------------------------------------

# the entry's engine block as the profile writes it, adapters included
ADAPTER_ENTRY = dict(ENTRY, adapter_pool_slots=8, adapter_rank=16)
ADAPTER_SCALE = 2.0          # alpha / rank = 32 / 16
ADAPTER_TARGETS = ("wq", "wk", "wv", "wo")
# the estimate of the pool's bytes: 32 x 8 x (2 x (4096 x 16 + 16 x 4096)
# + 2 x (4096 x 16 + 16 x 1024)) x 2 B
POOL_BYTES_LLAMA = 218_103_808
N_ADAPTERS = 11              # more than the pool's 7 usable slots


def _adapter_tree(cfg, seed, layers=None) -> dict:
    """A rank-16 LoRA tree from a seed with nonzero ``b`` (a fresh LoRA
    is the identity): ``a`` N(0, 1/in), ``b`` N(0, 0.05^2), float32."""
    from helix_tpu_torch.engine.adapters import target_dims

    rng = np.random.default_rng(seed)
    L = layers or cfg.num_layers
    out = {}
    for t in ADAPTER_TARGETS:
        fan_in, fan_out = target_dims(cfg)[t]
        out[t] = {"lora_a": (rng.standard_normal((L, fan_in, 16),
                                                 dtype=np.float32)
                             / np.float32(np.sqrt(fan_in))),
                  "lora_b": rng.standard_normal((L, 16, fan_out),
                                                dtype=np.float32)
                  * np.float32(0.05)}
    return out


def _merge_adapter(params, tree, scale) -> dict:
    """A plain merge: every targeted float weight ``w + scale * a @ b``,
    in float32 on the card (the numerical reference of the pool)."""
    merged = dict(params)
    layers = dict(params["layers"])
    for t, f in tree.items():
        w = layers[t]["weight"]
        a = torch.from_numpy(f["lora_a"]).to(w.device)
        b = torch.from_numpy(f["lora_b"]).to(w.device)
        layers[t] = {**layers[t],
                     "weight": (w.float() + scale * (a @ b)).to(w.dtype)}
    merged["layers"] = layers
    return merged


def _owner_spy(eng) -> dict:
    """Which adapter prefilled each prefix-cache page, and every
    admission that acquired a page another adapter (or the base model)
    prefilled.  Returns the spy's record; undo with ``del
    eng._try_claim, eng._adopt_prompt_pages``."""
    rec = {"owner": {}, "foreign": [], "claims": 0}
    claim, adopt = eng._try_claim, eng._adopt_prompt_pages

    def spy_adopt(req, table):
        before = set(eng.prefix_cache._entries)
        adopt(req, table)
        for h in set(eng.prefix_cache._entries) - before:
            rec["owner"][h] = req.adapter

    def spy_claim(req, use_cache=False):
        table = claim(req, use_cache)
        if table is not None:
            rec["claims"] += 1
            by_page = eng.prefix_cache._by_page
            for pg in eng._shared_pages.get(req.id, []):
                h = by_page.get(int(pg))
                if h in rec["owner"] and rec["owner"][h] != req.adapter:
                    rec["foreign"].append((req.adapter, rec["owner"][h]))
        return table

    eng._try_claim, eng._adopt_prompt_pages = spy_claim, spy_adopt
    return rec


def _evict_spy(pool) -> list:
    """Every pool eviction as (adapter id, its refcount then)."""
    seen, free_slot = [], pool._free_slot_locked

    def spy():
        before = dict(pool._slot_of)
        refs = dict(pool._refs)
        slot = free_slot()
        for aid in set(before) - set(pool._slot_of):
            seen.append((aid, refs.get(aid, 0)))
        return slot

    pool._free_slot_locked = spy
    return seen


def _pool_gemm_cost(eng) -> dict:
    """What the pool's two GEMMs add to one projection at a decode step
    (16 rows, two adapters and adapter-free rows): ``maybe_dequant_dense``
    of layer 0's int8 weights with the pool's delta against without it,
    per target, CUDA events."""
    from helix_tpu_torch.models.llama import _layer_params
    from helix_tpu_torch.ops.quant import maybe_dequant_dense

    p = _layer_params(eng._graft_params()["layers"], 0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.tensor([[0], [1], [2]] * 5 + [[0]], device="cuda")
    out = {}
    for t in ADAPTER_TARGETS:
        fan_in = p[t]["weight"].shape[0]
        x = torch.randn((16, 1, fan_in), generator=gen,
                        device="cuda").bfloat16()
        with_ms = cuda_ms(lambda: maybe_dequant_dense(x, p[t], ids), 50)
        base_ms = cuda_ms(lambda: maybe_dequant_dense(x, p[t]), 50)
        out[t] = (with_ms, base_ms)
    return out


@_timed
def phase_adapters(smi) -> dict:
    """4g: ``profiles/v5e1-hotswap.yaml``'s Llama entry as written (int8
    weights and KV, 16 slots, 3968 pages, spec 4, its 16 GiB host tier,
    ``adapter_pool_slots: 8``, ``adapter_rank: 16``; only its ``slo``,
    A7, is cut), at full width with random weights, over HTTP:

    1. the same 16 adapter-free chats (one ~1500-token system prompt, four
       user messages) on the entry without its pool and on the entry
       with it: identical tokens;
    2. adapters a1-a3 (from seeds, nonzero ``b``) published by another
       store into the filestore rung, so each first request waits on a
       prefetch; 16 chats as ``base``, ``base@a1``, ``base@a2``,
       ``base@a3`` in turn over the shared system prompt: every chat
       answered, each adapter's tokens unlike the base model's for the
       same message, mixed-adapter steps, no adapter row on a page that
       another adapter or the base model prefilled (per-adapter hit
       counters and the pages' prefill owners); one mixed decode batch
       traced;
    3. a4-a11 published: a wave over all 11 adapters while a request on
       a1 keeps it pinned: loads and evictions counted, the pinned
       adapter never evicted, K2 and K1-int8 launched on adapter rows;
    4. a seeded chat through a1, sent twice.
    Printed: load seconds, the pool's bytes and the model's measured
    bytes against the estimates, TTFT p50 and decode tok/s of the mixed
    and the adapter-free traffic, the traced busy ms, the pool GEMMs'
    cost per projection."""
    import tempfile

    from helix_tpu_torch.engine.adapters import AdapterStore, pack_lora_tree
    from helix_tpu_torch.engine.residency import (
        estimate_model_bytes,
        served_model_bytes,
    )
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1_INT8

    tag = "adapters"
    out = {}
    msgs = [[{"role": "system", "content": _system_prompt(900)},
             {"role": "user", "content": f"Question {q}: which rule comes "
              "first, and why?"}] for q in range(4)]
    models = [MODEL, f"{MODEL}@a1", f"{MODEL}@a2", f"{MODEL}@a3"]
    free_bodies = [{"model": MODEL, "messages": msgs[i // 4]}
                   for i in range(16)]
    mixed_bodies = [{"model": models[i % 4], "messages": msgs[i // 4]}
                    for i in range(16)]
    log(f"[{tag}] ({smi}) {MODEL} as the v5e1-hotswap entry "
        f"{ADAPTER_ENTRY}; cut: slo (A7)")

    # -- 1. adapter-free traffic, pool off then on -------------------------
    served, eng, httpd, base, registry, mem = _serve(dict(ENTRY), "int8")
    try:
        eng.recent_ttfts.clear()
        dec0 = eng.num_decode_tokens
        texts_off, off_s, _ = _gated_batch(base, served.loop, None, 32,
                                           bodies=free_bodies)
        off = dict(ttft_p50_ms=sorted(eng.recent_ttfts)[8] * 1e3,
                   tps=(eng.num_decode_tokens - dec0) / off_s)
        bytes_off = served_model_bytes(served, headroom=0.0)
    finally:
        _unserve(served, httpd, registry)
    del served, eng, registry
    _free()

    root = tempfile.mkdtemp(prefix="helix-adapters-")
    os.environ["HELIX_FILESTORE_KV_DIR"] = root
    t0 = time.monotonic()
    served, eng, httpd, base, registry, mem = _serve(dict(ADAPTER_ENTRY),
                                                     "int8")
    build_s = time.monotonic() - t0
    loop, pool, store = served.loop, eng.adapter_pool, eng.adapter_store
    cfg = eng.model_cfg
    try:
        if pool is None or (pool.slots, pool.rank) != (8, 16):
            raise AssertionError("the entry's adapter pool was not built")
        measured = served_model_bytes(served, headroom=0.0)
        est = estimate_model_bytes(CATALOG[MODEL], ADAPTER_ENTRY, "int8")
        log(f"[{tag}] built + warmed in {build_s:.1f} s; pool "
            f"{pool.hbm_bytes()} B (estimate {POOL_BYTES_LLAMA} B) + scales "
            f"{nbytes(pool._scale)} B; measured weights + KV pools "
            f"{measured} B (pool off {bytes_off} B), with the pool "
            f"{measured + pool.hbm_bytes()} B = "
            f"{(measured + pool.hbm_bytes()) / (measured or 1):.4f}x; "
            f"estimate_model_bytes {est} B = "
            f"{(measured + pool.hbm_bytes()) * 1.1 / est - 1:+.4f} over "
            "with the 10% headroom (the reference's estimate has no pool)")
        if pool.hbm_bytes() != POOL_BYTES_LLAMA:
            raise AssertionError(f"pool bytes {pool.hbm_bytes()}")
        eng.recent_ttfts.clear()
        dec0 = eng.num_decode_tokens
        texts_on, on_s, _ = _gated_batch(base, loop, None, 32,
                                         bodies=free_bodies)
        on = dict(ttft_p50_ms=sorted(eng.recent_ttfts)[8] * 1e3,
                  tps=(eng.num_decode_tokens - dec0) / on_s)
        same_free = sum(a == b for a, b in zip(texts_off, texts_on))
        log(f"[{tag}] 1. 16 adapter-free chats: identical with the pool "
            f"on and off in {same_free} of 16; TTFT p50 "
            f"{off['ttft_p50_ms']:.1f} / {on['ttft_p50_ms']:.1f} ms, decode "
            f"{off['tps']:.1f} / {on['tps']:.1f} tok/s (off / on)")
        if same_free != 16:
            raise AssertionError("adapter-free tokens changed with the pool")

        # -- 2. mixed traffic ----------------------------------------------
        publisher = AdapterStore(store.model_name, store.dims,
                                 store.num_layers, store.rank_cap,
                                 root_dir=store.root)
        trees = {}
        t1 = time.monotonic()
        for i in range(1, 4):
            trees[f"a{i}"] = _adapter_tree(cfg, 100 + i)
            publisher.publish(pack_lora_tree(f"a{i}", trees[f"a{i}"],
                                             ADAPTER_SCALE))
        pub_s = (time.monotonic() - t1) / 3
        spy = _owner_spy(eng)
        K1_INT8.launches = K2.launches = 0
        rec0, pf0 = loop.window.recorded, store.prefetches
        hits0 = dict(eng.prefix_hit_tokens_by_adapter)
        eng.recent_ttfts.clear()
        dec0 = eng.num_decode_tokens
        texts_mix, mix_s, n_rec = _gated_batch(base, loop, None, 32,
                                               bodies=mixed_bodies)
        mixed = dict(ttft_p50_ms=sorted(eng.recent_ttfts)[8] * 1e3,
                     tps=(eng.num_decode_tokens - dec0) / mix_s)
        launch_mix = {"k1_int8": K1_INT8.launches, "k2": K2.launches}
        recs = loop.window.records(n_rec)
        distinct = max(r.get("distinct_adapters", 0) for r in recs)
        hits = {k: v - hits0.get(k, 0)
                for k, v in eng.prefix_hit_tokens_by_adapter.items()}
        differ = {models[m].split("@")[-1]: sum(
            texts_mix[4 * q + m] != texts_mix[4 * q] for q in range(4))
            for m in (1, 2, 3)}
        base_same = sum(texts_mix[4 * q] == texts_on[4 * q]
                        for q in range(4))
        log(f"[{tag}] 2. a1-a3 published into the filestore rung "
            f"({pub_s:.2f} s each: {pack_lora_tree('x', trees['a1'], 2.0).nbytes}"
            f" B of f32 factors, blob + blake2b), prefetches "
            f"{store.prefetches - pf0}; 16 mixed chats answered "
            f"{len(texts_mix)}; TTFT p50 {mixed['ttft_p50_ms']:.1f} ms, "
            f"decode {mixed['tps']:.1f} tok/s ({mix_s:.2f} s) beside the "
            f"adapter-free run's {on['ttft_p50_ms']:.1f} ms / "
            f"{on['tps']:.1f} tok/s; max distinct adapters in a step "
            f"{distinct}; chats unlike the base model's for the same "
            f"message {differ} (of 4 each); base chats equal to the "
            f"adapter-free run's {base_same} of 4 (not a check: other "
            "admission waves, and bf16 GEMMs may round a row otherwise at "
            f"another row count); prefix-hit tokens per "
            f"adapter {hits}; admissions {spy['claims']}, pages acquired "
            f"from another adapter or the base model {len(spy['foreign'])};"
            f" launches {launch_mix}")
        if len(texts_mix) != 16:
            raise AssertionError("a mixed chat was not answered")
        if any(n != 4 for n in differ.values()):
            raise AssertionError(f"adapter tokens equal the base's: {differ}")
        if distinct < 2:
            raise AssertionError("no mixed-adapter step ran")
        if spy["foreign"]:
            raise AssertionError(f"pages shared across adapters: "
                                 f"{spy['foreign'][:4]}")
        if store.prefetches - pf0 < 3:
            raise AssertionError("the cold adapters were not prefetched")
        traces = {}
        for label, ms in (("adapter-free", [MODEL] * 8),
                          ("mixed", [models[i % 4] for i in range(8)])):
            try:    # the traces inform PERF.md; their absence fails nothing
                traces[label] = trace = _profile_batch(
                    base, [f"Traced chat {i}" for i in range(8)], ms)
            except Exception as e:  # noqa: BLE001
                traces[label] = trace = {"error": repr(e)}
            if "error" in trace:
                log(f"[{tag}] traced {label} batch: not measured "
                    f"({trace['error']})")
                continue
            log(f"[{tag}] traced {label} 8-chat batch (models {ms[:4]}..., "
                f"32 new tokens): wall {trace['wall_ms']:.1f} ms, device "
                f"busy {trace['device_busy_ms']:.1f} ms (idle share "
                f"{trace['idle_share']:.3f}); K1-int8 "
                f"{trace['k1_share']:.3f}, K2 {trace['k2_share']:.3f}; top "
                "kernels (ms): " + "; ".join(
                    f"{k} {t:.1f}" for k, t in trace["top"]))

        # -- 3. a wave over 11 adapters, a1 pinned ---------------------------
        for i in range(4, N_ADAPTERS + 1):
            trees[f"a{i}"] = _adapter_tree(cfg, 100 + i)
            publisher.publish(pack_lora_tree(f"a{i}", trees[f"a{i}"],
                                             ADAPTER_SCALE))
        evicted = _evict_spy(pool)
        st0 = pool.stats()
        K1_INT8.launches = K2.launches = 0
        pinned, wave_done = {}, threading.Event()

        def long_a1():
            # a long stream on a1, read until the wave is over; closing it
            # then makes the server abort the request at its next frame
            body = {"model": f"{MODEL}@a1", "max_tokens": 1024,
                    "temperature": 0, "stream": True, "messages": [
                        {"role": "user", "content": "Tell a long story."}]}
            req = urllib.request.Request(
                base + "/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            frames = 0
            with urllib.request.urlopen(req, timeout=600) as r:
                for raw in r:
                    frames += raw.startswith(b"data: {")
                    if wave_done.is_set() or raw.startswith(b"data: [DONE]"):
                        break
            pinned["out"] = frames

        bg = threading.Thread(target=long_a1)
        bg.start()
        deadline = time.monotonic() + 300
        while pool.stats()["pinned"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        slot_a1 = pool.slot_for("a1")
        wave = _concurrent(base, [
            [{"role": "system", "content": _system_prompt(900 + i)},
             {"role": "user", "content": f"Adapter {i}: one line."}]
            for i in range(1, N_ADAPTERS + 1)], 16, models=[
                f"{MODEL}@a{i}" for i in range(1, N_ADAPTERS + 1)])
        # the stream must outlast the wave, a1 keep its slot through it
        bg_alive = bg.is_alive()
        a1_through = pool.slot_for("a1") == slot_a1
        wave_done.set()
        bg.join(600)
        st = pool.stats()
        launch_wave = {"k1_int8": K1_INT8.launches, "k2": K2.launches}
        wave_loads, wave_evictions = (st["loads"] - st0["loads"],
                                      st["evictions"] - st0["evictions"])
        log(f"[{tag}] 3. {N_ADAPTERS} adapters over 7 usable slots, a1 "
            f"pinned by a streaming chat ({pinned.get('out')} frames, "
            f"still running at the wave's end: {bg_alive}): answered "
            f"{len(wave)}; loads {wave_loads}, "
            f"evictions {wave_evictions} ({evicted}), a1 kept slot "
            f"{slot_a1}: {a1_through}; pool {st}; store "
            f"{store.stats()}; launches on adapter rows {launch_wave}; "
            f"load seconds per adapter (host, slot write queued) "
            f"{st['load_seconds'] / max(1, st['loads']):.4f}")
        if len(wave) != N_ADAPTERS or not pinned.get("out") or not bg_alive:
            raise AssertionError("a wave chat was not answered, or the "
                                 "pinning stream ended before the wave")
        if wave_evictions < N_ADAPTERS - 7 or wave_loads < N_ADAPTERS - 3:
            raise AssertionError(f"loads {wave_loads}, evictions "
                                 f"{wave_evictions}")
        if not a1_through or any(refs > 0 for _aid, refs in evicted):
            raise AssertionError(f"a pinned adapter was evicted: {evicted}")
        if launch_wave["k1_int8"] <= 0 or launch_wave["k2"] <= 0:
            raise AssertionError(f"kernels not launched on adapter rows: "
                                 f"{launch_wave}")

        # -- 4. seeded through a1, and the costs -----------------------------
        seeded = [_seeded(base, f"{MODEL}@a1") for _ in range(2)]
        if seeded[0] != seeded[1]:
            raise AssertionError("the seeded adapter chat did not reproduce")
        t2 = time.monotonic()
        cold = AdapterStore(store.model_name, store.dims, store.num_layers,
                            store.rank_cap, root_dir=store.root)
        if cold.get("a5") is None:
            raise AssertionError("a5's blob did not load")
        blob_s = time.monotonic() - t2
        # one load into a slot, the card's work included
        aid = next(a for a in trees if not pool.resident(a))
        spec = cold.get(aid)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        slot = pool.acquire(aid, lambda _id: spec)
        torch.cuda.synchronize()
        slot_s = time.monotonic() - t3
        if slot is None:
            raise AssertionError(f"{aid} did not load into a free slot")
        pool.release(aid)
        gemm = _pool_gemm_cost(eng)
        log(f"[{tag}] 4. seeded chat through a1 reproduced "
            f"({seeded[0].count('<')} tokens); one adapter from its blob "
            f"(read + checksum) {blob_s:.3f} s, into a slot with the card's "
            f"copy {slot_s * 1e3:.2f} ms ({aid}); pool GEMMs per projection at a 16-row decode step, layer 0 "
            "(with / without the delta, ms): " + "; ".join(
                f"{t} {a:.4f} / {b:.4f}" for t, (a, b) in gemm.items()))
        out.update(free_off=off, free_on=on, mixed=mixed, hits=hits,
                   differ=differ, distinct=distinct, wave_loads=wave_loads,
                   wave_evictions=wave_evictions, launch_mix=launch_mix,
                   launch_wave=launch_wave, traces=traces, gemm=gemm,
                   blob_s=blob_s, slot_s=slot_s, pool_bytes=pool.hbm_bytes(),
                   measured=measured, estimate=est,
                   launches={"ragged_paged_attention_int8":
                             launch_mix["k1_int8"] + launch_wave["k1_int8"],
                             "flash_attention":
                             launch_mix["k2"] + launch_wave["k2"]})
    finally:
        _unserve(served, httpd, registry)
        del os.environ["HELIX_FILESTORE_KV_DIR"]
    del served, eng, registry, loop, pool, store
    _free()
    return out


@_timed
def phase_adapter_exact(smi) -> dict:
    """4g.5: exactness at 2 layers, full width, float32 (as 4e.4): one
    wave of a base request and requests through a1, a2 and a3 (300-token
    prompts, one device call per step) gives each request the tokens of a
    pool-less engine on merged weights (``_merge_adapter``)."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.paged_kernel import K1

    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2, dtype="float32")
    params = init_params(cfg, 4, device="cuda")
    geo = dict(max_decode_batch=8, page_size=16, num_pages=256,
               max_pages_per_seq=64, max_prefill_len=2048)
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    prompts = {aid: [int(t) for t in np.random.default_rng(20 + i).integers(
        4, 260, size=300)] for i, aid in enumerate(("", "a1", "a2", "a3"))}
    trees = {aid: _adapter_tree(cfg, 200 + i, layers=2)
             for i, aid in enumerate(("a1", "a2", "a3"))}
    eng = Engine(cfg, params, EngineConfig(**geo, adapter_pool_slots=8,
                                           adapter_rank=16), device="cuda")
    for aid, tree in trees.items():
        eng.publish_adapter(aid, tree, ADAPTER_SCALE)
    reqs = [Request(id=f"x{aid}", prompt_tokens=p, sampling=sp, adapter=aid)
            for aid, p in prompts.items()]
    for r in reqs:
        eng.add_request(r)
    K1.launches = 0
    calls0 = eng.num_device_calls
    while eng.has_work():
        eng.step()
    calls = eng.num_device_calls - calls0
    same = {}
    for r in reqs:
        p = params if not r.adapter else _merge_adapter(
            params, trees[r.adapter], ADAPTER_SCALE)
        ref = Engine(cfg, p, EngineConfig(**geo), device="cuda")
        same[r.adapter or "base"] = ref.generate(
            [prompts[r.adapter]], sp)[0] == r.output_tokens
        del ref
    log(f"[adapters exact] ({smi}) 2 layers full width f32, one wave of "
        f"base + a1-a3 (300-token prompts, 16 tokens): {calls} device calls;"
        f" tokens equal to the merged-weights engine {same}; K1 (float32) "
        f"launches {K1.launches}")
    if not all(same.values()):
        raise AssertionError(f"pool tokens differ from merged weights: "
                             f"{same}")
    if calls != sp.max_tokens:
        raise AssertionError(f"{calls} device calls for one wave of "
                             f"{sp.max_tokens} tokens")
    del eng, params
    _free()
    return {"same": same, "calls": calls}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 4h. checkpoints: both v5e1-hotswap entries from safetensors files on disk
# ---------------------------------------------------------------------------

# the checkpoints' depth: 2 of the entries' 32 layers at full width, a
# depth cut for the smoke's time limit (at 32 the phase took 79.2 s of an
# 876 s smoke, 33.4 s of it writing and syncing 23.7 GB; ROADMAP P3)
CKPT_LAYERS = 2
# the largest single tensor: Llama-3-8B's bf16 embedding
LLAMA_EMBED_BYTES = 1_050_673_152
RSS_RISE_LIMIT = 2 << 30
CKPT_SPECS = (
    # name, directory, HF model_type, fused qkv / gate_up, fixture, config
    (MODEL, "llama3-8b-instruct", "llama", False, "llama3", {}),
    (PHI3, "phi3-mini", "phi3", True, "phi3", {"sliding_window": 2047}),
)


def _rss_anon() -> int:
    """The process's anonymous resident bytes: ``RssAnon`` of
    ``/proc/self/status`` where the kernel reports it, else the sum of
    ``Anonymous:`` over ``/proc/self/smaps`` (file-backed pages, mapped
    checkpoint files among them, count in neither)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1]) * 1024
    n = 0
    with open("/proc/self/smaps") as f:
        for line in f:
            if line.startswith("Anonymous:"):
                n += int(line.split()[1]) * 1024
    return n


def _rss_source() -> str:
    with open("/proc/self/status") as f:
        if any(line.startswith("RssAnon:") for line in f):
            return "RssAnon"
    return "the Anonymous: lines of /proc/self/smaps"


class _Sampled:
    """Around one call: wall seconds, device memory at its start and its
    peak (``max_memory_allocated`` after a reset), and the host's
    anonymous memory (``_rss_anon``) at its start and its peak, sampled
    every 5 ms by a thread."""

    def __init__(self, fn, records):
        self.fn, self.records = fn, records

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        rec = {"allocated_at_start": torch.cuda.memory_allocated(),
               "rss_at_start": _rss_anon()}
        torch.cuda.reset_peak_memory_stats()
        peak = [rec["rss_at_start"]]
        done = threading.Event()

        def sample():
            while not done.wait(0.005):
                peak[0] = max(peak[0], _rss_anon())

        th = threading.Thread(target=sample, daemon=True)
        th.start()
        t0 = time.monotonic()
        try:
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
        finally:
            done.set()
            th.join()
        rec.update(seconds=time.monotonic() - t0,
                   peak=torch.cuda.max_memory_allocated(),
                   rss_peak=max(peak[0], _rss_anon()))
        rec["rise"] = rec["peak"] - rec["allocated_at_start"]
        rec["rss_rise"] = rec["rss_peak"] - rec["rss_at_start"]
        self.records.append(rec)
        return out


def _gbps(nbytes, seconds) -> str:
    if not seconds:
        return "not measured"
    return f"{seconds:.3f} s ({nbytes / seconds / 1e9:.2f} GB/s)"


def _ckpt_config(name):
    """The entry's model at ``CKPT_LAYERS`` layers, full width."""
    from helix_tpu_torch.models.common import CATALOG

    return dataclasses.replace(CATALOG[name], num_layers=CKPT_LAYERS)


def _write_checkpoints(root, tag) -> dict:
    """Llama-3-8B (per projection) and Phi-3-mini (fused) at
    ``CKPT_LAYERS`` layers as HF checkpoints of ``init_params(cfg, 0)`` in
    bf16, each with its fixture ``tokenizer.json``.  They stay in the page
    cache: the card's machine does not evict a file's pages on request
    (``posix_fadvise(DONTNEED)`` after an fsync left the first load as
    fast as the later ones), so every load reads warm."""
    import shutil

    from helix_tpu_torch.engine.residency import tree_bytes
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint
    from helix_tpu_torch.testing.tokenizer_fixtures import FIXTURES

    out = {}
    for name, sub, model_type, fused, fixture, extra in CKPT_SPECS:
        d = os.path.join(root, sub)
        t0 = time.monotonic()
        cfg = _ckpt_config(name)
        params = init_params(cfg, 0, device="cuda")
        weight_bytes = tree_bytes(params)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        paths = write_checkpoint(d, cfg, params, model_type=model_type,
                                 fused=fused, config_extra=extra)
        paths.append(shutil.copy(
            os.path.join(FIXTURES[fixture], "tokenizer.json"), d))
        del params
        _free()
        t2 = time.monotonic()
        tensors = sum(os.path.getsize(p) for p in paths
                      if p.endswith(".safetensors"))
        out[name] = {"dir": d, "file_bytes": tensors, "files": len(paths),
                     "draw_s": t1 - t0, "write_s": t2 - t1}
        log(f"{tag} wrote {name} ({CKPT_LAYERS} layers) to {d}: "
            f"{len(paths) - 2} safetensors files, {tensors} B (bf16 "
            f"weights {weight_bytes} B + headers), fused {fused}; draw on "
            f"the card {t1 - t0:.2f} s,"
            f" write {t2 - t1:.2f} s ({tensors / (t2 - t1) / 1e9:.2f} GB/s"
            f" through the page cache)")
    return out


def _tree_diff(a: dict, b: dict) -> tuple:
    """(tensors compared, paths that differ) of two parameter trees on
    the card, layer by layer for stacked tensors."""
    n, bad = 0, []

    def walk(x, y, path):
        nonlocal n
        if isinstance(x, dict):
            if set(x) != set(y):
                bad.append((path, sorted(set(x) ^ set(y))))
                return
            for k in x:
                walk(x[k], y[k], path + (k,))
            return
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append((path, "shape or dtype"))
            return
        rows = range(x.shape[0]) if path[0] == "layers" else (None,)
        for i in rows:
            n += 1
            if not torch.equal(x if i is None else x[i],
                               y if i is None else y[i]):
                bad.append((path, i))

    walk(a, b, ())
    return n, bad


def _batch(base, loop, eng, model, prompts, max_tokens=32) -> tuple:
    """An admitted 8-chat greedy batch: (texts, TTFT p50 ms, decode
    tok/s)."""
    eng.recent_ttfts.clear()
    dec0 = eng.num_decode_tokens
    texts, secs, _ = _gated_batch(base, loop, None, max_tokens, bodies=[
        {"model": model, "messages": [{"role": "user", "content": p}]}
        for p in prompts])
    ttfts = sorted(eng.recent_ttfts)
    return (texts, ttfts[len(ttfts) // 2] * 1e3,
            (eng.num_decode_tokens - dec0) / secs)


def _stop_side(httpd, served) -> None:
    """Stop a side server and give its model's memory back."""
    from helix_tpu_torch.engine.residency import release_served_model

    httpd.shutdown()
    httpd.server_close()
    release_served_model(served)


@_timed
def phase_checkpoint(smi) -> dict:
    """4h: ``profiles/v5e1-hotswap.yaml``'s two models served from HF
    safetensors checkpoints on disk, at full width and ``CKPT_LAYERS`` (2)
    of their 32 layers (a depth cut for the smoke's time), through
    ``serve-node``'s profile path without ``--random-weights``
    (``_hotswap_copy``'s cuts, the checkpoint paths pointing at files
    written here, the residency budget cut to 1.2x the larger model's
    estimate so that each swap still evicts).  Steps:

    1. Llama-3-8B (per projection) and Phi-3-mini (fused) written as bf16
       checkpoints of ``init_params(cfg, 0)`` with the fixture tokenizers,
       left in the page cache (the card's machine does not evict on
       request: every load reads warm);
    2. each model's first chat loads it (first; Phi-3's
       evicts Llama); its weights equal the as-drawn build of seed 0 byte
       for byte (int8 Llama: weight, scale, embed_scale; bf16 Phi-3),
       compared on the card a layer at a time; 8 greedy chats in one
       admitted batch give the as-drawn build's ids (same tokenizer);
       the same batch on the as-drawn build with its ``ByteTokenizer``
       for TTFT and tok/s; the served tokenizer gives ``DIGESTS`` for the
       fixed conversation and the ~1500-token prompt, and decodes that
       prompt back;
    3. ``<|eot_id|>`` planted as Llama's greedy first token (its lm_head
       column copied from the token greedy picks, twice the scale) stops
       a chat with ``finish_reason: stop``;
    4. three swap cycles between the two models (warm: from the page
       cache), each eviction freeing >= 95% of the model's measured bytes
       before the next build, then ``/admin/prefetch``: the next chat
       stalls < 10% of a synchronous load.
    Limits: the int8 Llama load's device peak above its start no more
    than the bf16 embedding above the as-drawn int8 build's; the host's
    anonymous memory (``_rss_anon``) rising < 2 GiB during every load."""
    import shutil
    import statistics
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.engine.residency import (
        model_param_count,
        served_model_bytes,
    )
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.serving.tokenizer import HFTokenizer
    from helix_tpu_torch.testing import tokenizer_fixtures as fx

    tag = f"[checkpoint] ({smi})"
    gib = 2 ** 30
    root = os.environ.get("HELIX_SMOKE_CKPT_DIR") or tempfile.gettempdir()
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    need = sum(2 * model_param_count(_ckpt_config(n)) for n, *_ in CKPT_SPECS)
    log(f"{tag} cut: both checkpoints at {CKPT_LAYERS} of 32 layers, full "
        "width (a depth cut for the smoke's time limit), and the residency "
        "budget to 1.2x the larger model's estimate, so each swap still "
        "evicts")
    log(f"{tag} checkpoint root {root}: {free} B free, the two "
        f"checkpoints need {need} B of weights; host anonymous memory "
        f"read from {_rss_source()}")
    if free < need * 1.02:
        raise AssertionError(f"{root} has {free} B free, under {need} B")
    ckdir = tempfile.mkdtemp(prefix="helix-ckpt-", dir=root)
    loads, draws, builds = [], [], []
    real_load, real_init = cli.load_params, cli.init_params
    cli.load_params = _Sampled(real_load, loads)
    cli.init_params = _Sampled(real_init, draws)
    node = None
    out = {}
    try:
        t_phase = time.monotonic()
        written = _write_checkpoints(ckdir, tag)
        out["written"] = written
        prof, cuts = _hotswap_copy()
        for m in prof["models"]:
            m["checkpoint"] = written[m["name"]]["dir"]
        # room for the larger model with a fifth to spare (a prefetch
        # holds it to its measured bytes and headroom), never for both
        ests = [cli.spec_bytes(m) for m in prof["models"]]
        budget = int(1.2 * max(ests))
        if budget >= sum(ests):
            raise AssertionError(f"budget {budget} B holds both models: "
                                 f"{ests}")
        cuts.append(f"residency.hbm_budget_bytes "
                    f"{prof['residency']['hbm_budget_bytes']} -> {budget}")
        prof["residency"]["hbm_budget_bytes"] = budget
        for c in cuts:
            log(f"{tag} cut: {c}")
        entries = {m["name"]: m for m in prof["models"]}

        def build(**kw):
            rec = {"name": kw["name"], "allocated_at_start":
                   torch.cuda.memory_allocated(), "loads_before": len(loads)}
            served = cli.build_served_model(**kw)
            rec.update(measured=served_model_bytes(served, headroom=0.0),
                       split=served.build_seconds,
                       stats=served.load_stats, load=loads[-1])
            served.tokenizer = _IdTokenizer(served.tokenizer)
            builds.append(rec)
            ld, st = rec["load"], rec["stats"]
            n = sum(b["name"] == kw["name"] for b in builds)
            log(f"{tag} loaded {kw['name']} ({'first' if n == 1 else 'again'})"
                ": " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in rec["split"].items())
                + f"; {st['bytes']} B in {st['blocks']} blocks, host read "
                f"{_gbps(st['bytes'], st['read_seconds'])}, upload "
                f"{_gbps(st['bytes'], st['upload_seconds'])} of device "
                f"time, whole load {_gbps(st['bytes'], st['seconds'])}; "
                "device "
                f"memory at the load's start {ld['allocated_at_start']} B, "
                f"peak {ld['peak']} B (+{ld['rise']} B); host anonymous "
                f"memory {ld['rss_at_start']} B, peak {ld['rss_peak']} B "
                f"(+{ld['rss_rise']} B); weights + pools measured "
                f"{rec['measured']} B")
            return served

        node = _node(prof, ckdir, "checkpoint", build, random_weights=False)
        _registry, mgr, _httpd, base, _path = node
        if mgr.resident_names() or builds:
            raise AssertionError("the residency node built at start")

        def served_of(name):
            return next(m for m in mgr.list() if m.name == name)

        launches = {"ragged_paged_attention_int8": 0, "flash_attention": 0}

        def counted(fn, *a, **kw):
            K1.launches = K1_INT8.launches = K2.launches = 0
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            launches["ragged_paged_attention_int8"] += K1_INT8.launches
            launches["flash_attention"] += K2.launches
            if K1.launches:
                raise AssertionError("K1's float form ran on an int8 pool")
            return r

        prompts = [f"Checkpoint chat {i}: summarise the history of the "
                   "printing press in plain words please." for i in range(8)]
        per_model = {}
        for name, _sub, _mt, _fused, fixture, _x in CKPT_SPECS:
            quant = entries[name].get("quantization")
            evicted = mgr.resident_names()
            before = torch.cuda.memory_allocated()
            # (2) the first chat loads the model
            t0 = time.monotonic()
            ttft, _n, _f = counted(_ttft_chat, base, name,
                                   "Say hello in one line.", 8)
            first_wall = time.monotonic() - t0
            st = mgr.stats()
            rec = {"load_s": st["load_seconds"][name],
                   "swap_s": st["swap_seconds"][name],
                   "first_ttft_s": ttft, "first_wall_s": first_wall}
            if evicted:
                freed = before - builds[-1]["allocated_at_start"]
                meas = max(b["measured"] for b in builds
                           if b["name"] == evicted[0])
                rec["freed"] = freed
                if freed < 0.95 * meas:
                    raise AssertionError(
                        f"evicting {evicted} freed {freed} B (from {before} "
                        f"to {builds[-1]['allocated_at_start']} B), under "
                        f"95% of {meas} B")
            served = served_of(name)
            eng = served.loop.engine
            tok = served.tokenizer._tok
            # the as-drawn build of the same seed, same engine block
            _free()
            ref = cli.build_served_model(
                name, device="cuda", seed=0, quantization=quant,
                model_overrides={"num_layers": CKPT_LAYERS},
                engine={**entries[name]["engine"],
                        "eos_token_ids": list(tok.eos_ids)})
            n_cmp, bad = _tree_diff(eng.params, ref.loop.engine.params)
            rec["draw"] = draws[-1]
            log(f"{tag} {name}: loaded weights vs the as-drawn build "
                f"(seed 0, {quant or 'bf16'}): {n_cmp} tensors compared "
                f"on the card, layer by layer; differ: {bad[:4]}")
            if bad or not n_cmp:
                raise AssertionError(f"{name}: loaded weights differ from "
                                     f"the as-drawn build at {bad[:8]}")
            # the 8-chat batch: loaded vs as-drawn with the same tokenizer,
            # and the as-drawn build's own ByteTokenizer
            texts_l, ttft_l, tps_l = counted(_batch, base, served.loop, eng,
                                             name, prompts)
            byte_tok = ref.tokenizer
            ref.tokenizer = _IdTokenizer(tok)
            s_httpd, s_base, _reg = _start_server(ref)
            try:
                texts_r, ttft_r, tps_r = _batch(
                    s_base, ref.loop, ref.loop.engine, name, prompts)
                ref.tokenizer = _IdTokenizer(byte_tok)
                _texts_b, ttft_b, tps_b = _batch(
                    s_base, ref.loop, ref.loop.engine, name, prompts)
            finally:
                _stop_side(s_httpd, ref)
            same = sum(a == b for a, b in zip(texts_l, texts_r))
            log(f"{tag} {name}: 8-chat batch, loaded vs as-drawn (fixture "
                f"tokenizer): {same} of 8 identical; TTFT p50 {ttft_l:.1f}"
                f" / {ttft_r:.1f} ms, decode {tps_l:.1f} / {tps_r:.1f} "
                f"tok/s; as-drawn with the ByteTokenizer: TTFT p50 "
                f"{ttft_b:.1f} ms, decode {tps_b:.1f} tok/s")
            if same != 8:
                raise AssertionError(f"{name}: {8 - same} of 8 chats differ"
                                     " between the loaded and the as-drawn"
                                     " build")
            del ref
            _free()
            # the tokenizer on the served path
            sp = fx.system_prompt()
            t0 = time.perf_counter()
            cold_ids = HFTokenizer(os.path.join(written[name]["dir"],
                                                "tokenizer.json")).encode(sp)
            cold_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ids = tok.encode(sp)
            warm_ms = (time.perf_counter() - t0) * 1e3
            tmpl = fx.digest(tok.apply_chat_template(fx.CONVERSATION))
            dig = {"template": tmpl, "prompt": fx.digest(ids)}
            back = tok.decode(ids) == sp
            log(f"{tag} {name}: fixture {fixture}: template digest "
                f"{tmpl[:16]}..., prompt {len(ids)} tokens, digest "
                f"{dig['prompt'][:16]}...; equal to the CPU tests' "
                f"{dig == fx.DIGESTS[fixture]}; decode(encode(prompt)) == "
                f"prompt {back}; encode {cold_ms:.2f} ms (first, a new "
                f"tokenizer) / {warm_ms:.2f} ms (again)")
            if dig != fx.DIGESTS[fixture] or not back or cold_ids != ids:
                raise AssertionError(f"{name}: tokenizer digests {dig}")
            rec.update(same=same, ttft_p50_ms=ttft_l, decode_tps=tps_l,
                       asdrawn_ttft_p50_ms=ttft_r, asdrawn_tps=tps_r,
                       byte_ttft_p50_ms=ttft_b, byte_tps=tps_b,
                       encode_ms=(cold_ms, warm_ms), prompt_tokens=len(ids),
                       tensors_compared=n_cmp)
            if name == MODEL:
                # (3) <|eot_id|> stops a generation
                eot = tok._special("<|eot_id|>")
                body = {"model": name, "max_tokens": 8, "temperature": 0,
                        "messages": [{"role": "user", "content": "hi"}]}
                r0 = json.loads(_post(base + "/v1/chat/completions", body))
                t_first = int(r0["choices"][0]["message"]["content"]
                              .split(">")[0].lstrip("<"))
                head = eng.params["lm_head"]
                head["weight"][:, eot] = head["weight"][:, t_first]
                head["scale"][..., eot] = 2 * head["scale"][..., t_first]
                r1 = json.loads(_post(base + "/v1/chat/completions", body))
                fin = (r0["choices"][0]["finish_reason"],
                       r1["choices"][0]["finish_reason"])
                log(f"{tag} {name}: <|eot_id|> (id {eot}) planted as the "
                    f"greedy first token (was {t_first}): finish "
                    f"{fin[0]!r} before, {fin[1]!r} after; content after "
                    f"{r1['choices'][0]['message']['content']!r}; usage "
                    f"{r1['usage']}")
                if fin != ("length", "stop") or \
                        r1["usage"]["completion_tokens"] > 1:
                    raise AssertionError(f"<|eot_id|> did not stop: {fin}")
                del head
            per_model[name] = rec
            # nothing here may keep the model alive past its eviction
            del served, eng, tok
        out["models"] = per_model
        llama_load = next(b for b in builds if b["name"] == MODEL)["load"]
        llama_draw = per_model[MODEL]["draw"]
        log(f"{tag} int8 Llama: device peak above the load's start "
            f"{llama_load['rise']} B ({llama_load['rise'] / gib:.3f} GiB)"
            f" vs the as-drawn build's {llama_draw['rise']} B "
            f"({llama_draw['rise'] / gib:.3f} GiB); limit +"
            f"{LLAMA_EMBED_BYTES} B")
        if llama_load["rise"] > llama_draw["rise"] + LLAMA_EMBED_BYTES:
            raise AssertionError("the int8 Llama load peaked above its limit")
        # (4) three swap cycles, warm, then a prefetch
        swaps = []
        for c in range(3):
            for name in (MODEL, PHI3):
                other = PHI3 if name == MODEL else MODEL
                b = torch.cuda.memory_allocated()
                n0 = len(builds)
                ttft, _n, _f = counted(_ttft_chat, base, name,
                                       "Say hello in one line.", 8)
                if len(builds) != n0 + 1:
                    raise AssertionError(f"cycle {c + 1}: {name} not built")
                freed = b - builds[-1]["allocated_at_start"]
                meas = max(x["measured"] for x in builds
                           if x["name"] == other)
                st = mgr.stats()
                swaps.append({"name": name, "ttft_s": ttft,
                              "swap_s": st["swap_seconds"][name],
                              "load_s": st["load_seconds"][name],
                              "freed": freed, "measured": meas})
                if freed < 0.95 * meas:
                    raise AssertionError(f"evicting {other} freed {freed} "
                                         f"B, under 95% of {meas} B")
            log(f"{tag} cycle {c + 1}: " + "; ".join(
                f"{s['name'].split('/')[0]} swap {s['swap_s']:.3f} s (load "
                f"{s['load_s']:.3f} s), first-chat TTFT {s['ttft_s']:.3f} "
                f"s, freed {s['freed']} B of {s['measured']} B"
                for s in swaps[-2:]))
        # Phi-3 is resident: prefetch Llama, then chat to it
        warm_sync = min(s["load_s"] for s in swaps if s["name"] == MODEL)
        loads0 = mgr.stats()["loads"]
        b = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        pre = json.loads(_post(base + "/admin/prefetch", {"model": MODEL}))
        while mgr.stats()["loads"] == loads0:
            if time.monotonic() > t0 + 300:
                raise AssertionError("the prefetch never finished")
            time.sleep(0.01)
        ready = time.monotonic() - t0
        freed = b - builds[-1]["allocated_at_start"]
        ttft, _n, _f = counted(_ttft_chat, base, MODEL,
                               "Say hello in one line.", 8)
        stall = mgr.stats()["swap_seconds"][MODEL]
        log(f"{tag} /admin/prefetch {pre}: Llama resident after "
            f"{ready:.3f} s (freed {freed} B first); its next chat stalled "
            f"swap_seconds {stall:.6f} s = {stall / warm_sync:.5f} of a "
            f"synchronous warm load ({warm_sync:.3f} s); TTFT {ttft:.3f} s")
        if pre != {"model": MODEL, "prefetch": "started"} or \
                stall > 0.1 * warm_sync:
            raise AssertionError(f"prefetch: {pre}, stalled {stall} s")
        first = sorted(s["ttft_s"] for s in swaps)
        out.update(swaps=swaps, prefetch_stall_s=stall, launches=launches,
                   builds=builds, loads=loads,
                   swap_ttft_p50_s=first[len(first) // 2])
        for ld in loads:
            if ld["rss_rise"] >= RSS_RISE_LIMIT:
                raise AssertionError(f"host anonymous memory rose "
                                     f"{ld['rss_rise']} B during a load")
        secs = {n: [b["stats"]["seconds"] for b in builds if b["name"] == n]
                for n in (MODEL, PHI3)}
        log(f"{tag} summary: load seconds first / again (median): "
            + "; ".join(f"{n.split('/')[0]} {v[0]:.3f} / "
                        f"{statistics.median(v[1:]):.3f} s ({len(v) - 1} "
                        "again)" for n, v in secs.items())
            + f"; swap seconds first {per_model[PHI3]['swap_s']:.3f} s, "
            f"again {sorted(s['swap_s'] for s in swaps)[len(swaps) // 2]:.3f}"
            f" s (median of {len(swaps)}); TTFT p50 of the first chat after"
            f" a swap {out['swap_ttft_p50_s']:.3f} s; host anonymous "
            "memory's rise per load "
            f"max {max(ld['rss_rise'] for ld in loads)} B; launches "
            f"{launches}; phase wall {time.monotonic() - t_phase:.1f} s")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel never ran on the path: "
                                 f"{launches}")
    finally:
        cli.load_params, cli.init_params = real_load, real_init
        if node is not None:
            node[2].shutdown()
            node[2].server_close()
            for name in node[1].resident_names():
                node[1].evict(name)
        shutil.rmtree(ckdir, ignore_errors=True)
        _free()
    return out


# ---------------------------------------------------------------------------
# 4i. the scheduler, SLO accounting and /metrics: the Llama entry as written
# ---------------------------------------------------------------------------

FLOOD, FLOOD_SHED, CHATS = 80, 16, 16
FLOOD_PROMPT_TOKENS = 1500
# phases 4i and 4j serve the Llama entry at 8 of its 32 layers, a depth
# cut for the smoke's time limit (4i took 63-82 s and 4j 112-154 s at 32;
# at 16, since phase 4o joined, 50 s and 120 s in a whole run of 1079 s
# once phase 4p had joined); 4j compares its ids with 4i's, so both cut
NODE_LAYERS = 8


def _node_depth(prof: dict) -> dict:
    """``prof`` with its Llama entry cut to ``NODE_LAYERS``."""
    for m in prof["models"]:
        if m["name"] == MODEL:
            m["model_overrides"] = {**m.get("model_overrides", {}),
                                    "num_layers": NODE_LAYERS}
    return prof
# the uncontended 8-chat batch of phases 4i and 4j
NODE_PROMPTS = [f"Chat {i}: tell me about the history of the printing "
                "press in a few short lines please." for i in range(8)]


def _tenant_chat(base, content, max_tokens, tenant, cls) -> dict:
    """One streamed chat with the tenant and class headers: its status,
    TTFT, token count and finish reason, or the 429's Retry-After and
    error body."""
    body = {"model": MODEL, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "messages": [{"role": "user",
                                          "content": content}]}
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "X-Helix-Tenant": tenant, "X-Helix-Class": cls})
    t0 = time.monotonic()
    out = {"tenant": tenant, "status": 200, "ttft": None, "tokens": 0,
           "finish": None}
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                frame = json.loads(line[6:])
                if "error" in frame:
                    raise AssertionError(f"stream failed: {frame}")
                ch = frame["choices"][0]
                if ch["delta"].get("content") and out["ttft"] is None:
                    out["ttft"] = time.monotonic() - t0
                out["tokens"] += ch["delta"].get("content", "").count("<")
                out["finish"] = ch["finish_reason"] or out["finish"]
    except urllib.error.HTTPError as e:
        out.update(status=e.code, retry_after=e.headers.get("Retry-After"),
                   error=json.loads(e.read())["error"])
    return out


def _flood_prompt(i) -> str:
    """~FLOOD_PROMPT_TOKENS tokens under the byte tokenizer."""
    head = f"Batch job {i}: summarise this log. "
    return head + "x" * (FLOOD_PROMPT_TOKENS - len(head) - 40)


def _tenant_traffic(base, loop, tag) -> dict:
    """Phase 4i's contended traffic, with the loop held as ``_gated_batch``
    holds it: tenant ``flood`` (class ``batch``) submits FLOOD requests of
    ~1500 tokens one after another, then tenant ``chat`` (class
    ``interactive``) submits CHATS short chats; then the loop is released.
    /metrics is scraped every 0.5 s until every request has answered.
    Returns the answers, the admission order (tenant per confirmed
    admission), the scrapes and the wall seconds."""
    order = []
    note = loop.sched.note_admitted

    def spy(req):
        order.append(req.tenant)
        note(req)

    loop.sched.note_admitted = spy
    answers, threads = [], []

    def send(content, max_tokens, tenant, cls):
        answers.append(_tenant_chat(base, content, max_tokens, tenant, cls))

    def submit_one(args):
        n0, a0 = loop._inbox.qsize(), len(answers)
        threads.append(threading.Thread(target=send, args=args))
        threads[-1].start()
        deadline = time.monotonic() + 60
        while loop._inbox.qsize() == n0 and len(answers) == a0:
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: a request was neither queued "
                                     "nor answered")
            time.sleep(0.002)

    scrapes, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            t0 = time.monotonic()
            text = urllib.request.urlopen(base + "/metrics",
                                          timeout=60).read().decode()
            scrapes.append({"ms": (time.monotonic() - t0) * 1e3,
                            "text": text,
                            "budget": loop.saturation()[
                                "prefill_budget_tokens"],
                            "shrinks": loop.sched.budget_shrinks,
                            "burn": loop.slo.latency_fast_burn()})
            stop.wait(0.5)

    try:
        with _held_inbox(loop) as release:
            for i in range(FLOOD):
                submit_one((_flood_prompt(i), 8, "flood", "batch"))
            n_flood_answered = len(answers)
            for i in range(CHATS):
                submit_one((f"Chat {i}: say hello in one line.", 16,
                            "chat", "interactive"))
            scr = threading.Thread(target=scraper)
            scr.start()
            t0 = time.monotonic()
            release()
            for t in threads:
                t.join(600)
            wall = time.monotonic() - t0
            stop.set()
            scr.join(60)
    finally:
        stop.set()
        loop.sched.note_admitted = note
    return {"answers": answers, "order": order, "scrapes": scrapes,
            "wall": wall, "early_answers": n_flood_answered}


def _pcts(xs) -> tuple:
    xs = sorted(xs)
    if not xs:
        return (float("nan"), float("nan"))
    return (xs[len(xs) // 2], xs[min(len(xs) - 1, int(len(xs) * 0.95))])


def _traced_batch(base, loop, prompts, max_tokens) -> tuple:
    """``_gated_batch`` under ``torch.profiler``: (texts, seconds, the
    device-busy ms summed over kernels, the idle share of the wall)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        texts, secs, _ = _gated_batch(base, loop, prompts, max_tokens)
        torch.cuda.synchronize()
    busy = sum(_kernel_ms(prof).values())
    return texts, secs, busy, 1.0 - busy / (secs * 1e3)


# host seconds and batch counts of each loop's SLO notes, by id(loop.slo)
SLO_NOTES: dict = {}


def _time_slo_notes() -> None:
    """Time every loop's SLO notes from outside the loop: the per-token
    ``_observe_emit`` (latency histograms, the first-token note) and the
    per-batch ``note_tokens``, summed per delivery batch."""
    from helix_tpu_torch.obs.slo import SLOObserver
    from helix_tpu_torch.serving.engine_loop import EngineLoop

    observe, deliver = EngineLoop._observe_emit, EngineLoop._deliver
    note_tokens = SLOObserver.note_tokens

    def _charge(key, seconds, batches=0):
        acc = SLO_NOTES.setdefault(key, [0.0, 0])
        acc[0] += seconds
        acc[1] += batches

    def timed_observe(self, req, finished):
        t0 = time.perf_counter()
        try:
            return observe(self, req, finished)
        finally:
            _charge(id(self.slo), time.perf_counter() - t0)

    def timed_note_tokens(self, tenant, n):
        t0 = time.perf_counter()
        try:
            return note_tokens(self, tenant, n)
        finally:
            _charge(id(self), time.perf_counter() - t0)

    def counted_deliver(self, events):
        _charge(id(self.slo), 0.0, 1)
        return deliver(self, events)

    EngineLoop._observe_emit = timed_observe
    EngineLoop._deliver = counted_deliver
    SLOObserver.note_tokens = timed_note_tokens


def _host_snapshot(loop) -> dict:
    """The loop's scheduler-pass seconds and passes (``stats()``) and its
    SLO-note seconds and batches (``_time_slo_notes``)."""
    h = dict(loop.stats()["host_seconds"])
    h["slo_notes"], h["slo_note_batches"] = SLO_NOTES.get(id(loop.slo),
                                                          (0.0, 0))
    return h


def _host_us(loop, before: dict) -> dict:
    """Host µs per scheduler pass and per SLO-note batch since ``before``
    (a ``_host_snapshot``)."""
    now = _host_snapshot(loop)
    passes = now["sched_passes"] - before["sched_passes"]
    notes = now["slo_note_batches"] - before["slo_note_batches"]
    return {"sched_pass_us": (now["sched_pass"] - before["sched_pass"])
            / max(1, passes) * 1e6, "sched_passes": passes,
            "slo_note_us": (now["slo_notes"] - before["slo_notes"])
            / max(1, notes) * 1e6, "slo_note_batches": notes}


def _metric(text, name, **labels) -> float:
    want = name + "{" + ",".join(f'{k}="{v}"' for k, v in labels.items())
    for line in text.splitlines():
        if line.startswith(want + "}") or line.startswith(want + ",") \
                or (not labels and line.startswith(name + " ")):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} {labels} not in the scrape")


def _poisoned_script(loop, mod, prompts, max_tokens, poison=True) -> dict:
    """8 chats and (with ``poison``) one request whose id contains
    ``poison`` submitted in process, admitted together; returns
    ``{id: (tokens, finish_reason, error)}``."""
    from helix_tpu_torch.engine.engine import Request
    from helix_tpu_torch.engine.sampling import SamplingParams

    out, done = {}, {}

    def collector(rid):
        toks = []

        def on_event(ev):
            if ev.token_id >= 0 and not ev.error:
                toks.append(ev.token_id)
            if ev.finished:
                out[rid] = (toks, ev.finish_reason, ev.error)
                done[rid].set()
        return on_event

    ids = [f"q-{i}" for i in range(len(prompts))]
    if poison:
        ids.append("q-poison")
    with _held_inbox(loop) as release:
        for i, rid in enumerate(ids):
            done[rid] = threading.Event()
            loop.submit(Request(
                id=rid, prompt_tokens=list(prompts[i % len(prompts)]),
                sampling=SamplingParams(temperature=0.0,
                                        max_tokens=max_tokens)),
                collector(rid))
        release()
        for rid in ids:
            if not done[rid].wait(300):
                raise AssertionError(f"{mod}: {rid} never finished")
    return out


@_timed
def phase_slo(smi) -> dict:
    """The ``v5e1-hotswap`` Llama entry exactly as the profile writes it
    (int8 weights and KV, 16 slots, 3968 pages, spec 4, the 16 GiB host
    tier, 8 adapter slots of rank 16, and its ``slo`` block with the WFQ
    ``sched``), served through ``serve-node``'s profile path with random
    weights (Phi-3 keeps phase 4f's 1024-page cut).  Steps: (1) the
    node's served config; (2) 8 greedy chats admitted together give the
    same ids as on a node whose Llama entry drops ``slo``, both traced;
    (3) a flood of 80 ~1500-token batch requests from tenant ``flood``:
    exactly 16 get 429 ``queue_full``, then 16 interactive chats of
    tenant ``chat`` get none; (4) every chat is admitted before any flood
    request, every admitted request finishes, the prefill budget stays in
    [512, 4096], and the same traffic under ``HELIX_SCHED_POLICY=fifo``
    admits the flood first; (5) a poisoned request among 8 chats is
    quarantined alone (``helix_quarantine_evictions_total`` 1), and at 2
    layers in float32 the survivors' tokens equal an unpoisoned run's;
    (6) every scrape under load parses and each family has the listed
    name, type and label keys."""
    import tempfile

    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.serving.engine_loop import EngineLoop
    from helix_tpu_torch.testing import faults
    from helix_tpu_torch.testing.metric_families import check_scrape

    t_phase = time.monotonic()
    tag = f"[slo] ({smi})"
    _time_slo_notes()   # before any loop binds its delivery
    prof, cuts = _hotswap_copy(llama_as_written=True)
    _node_depth(prof)
    cuts.append(f"{MODEL}: {NODE_LAYERS} of 32 layers (a depth cut for the "
                "smoke's time limit)")
    for c in cuts:
        log(f"{tag} cut: {c}")

    def build(**kw):
        served = build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        return served

    def node(p, name):
        registry, mgr, httpd, base, _ = _node(p, tmpdir, name, build)
        served = registry.get(MODEL)   # a synchronous load
        return mgr, httpd, base, served.loop

    def close(n):
        mgr, httpd, _base, _loop = n
        httpd.shutdown()
        httpd.server_close()
        for name in mgr.resident_names():
            mgr.evict(name)
        _free()

    tmpdir = tempfile.mkdtemp(prefix="helix-slo-")
    out = {"cuts": cuts}
    _free()
    a = node(prof, "slo")
    b = None
    try:
        _mgr, _httpd, base, loop = a
        eng = loop.engine
        sc = loop.sched.cfg
        served_cfg = {
            "policy": sc.policy, "default_class": sc.default_class,
            "max_tenant_queue_depth": sc.max_tenant_queue_depth,
            "prefill_budget_tokens": sc.prefill_budget_tokens,
            "prefill_budget_min_tokens": sc.prefill_budget_min_tokens,
            "slo_targets": loop.slo.targets.to_dict(),
            "engine": {k: getattr(eng.cfg, k) for k in (
                "max_decode_batch", "num_pages", "kv_cache_dtype",
                "enable_spec_decode", "spec_tokens", "host_pool_bytes",
                "adapter_pool_slots", "adapter_rank")},
            "weights": str(eng.params["layers"]["wq"]["weight"].dtype),
        }
        log(f"{tag} (1) served config: {json.dumps(served_cfg)}")
        if (sc.policy, sc.prefill_budget_tokens, sc.prefill_budget_min_tokens,
                sc.max_tenant_queue_depth) != ("wfq", 4096, 512, 64):
            raise AssertionError(f"{tag} served config {served_cfg}")
        if eng.adapter_pool is None or eng.spec is None \
                or eng.host_pool is None:
            raise AssertionError(f"{tag} the entry lost a field")
        # (2) an uncontended batch: the same ids with slo on and off.
        # The slo path's launches are counted from 0 over its own runs
        # (this batch and the flood), never over the no-slo node's.
        prompts = NODE_PROMPTS
        h0 = _host_snapshot(loop)
        K1.launches = K1_INT8.launches = K2.launches = 0
        on_texts, on_s, on_busy, on_idle = _traced_batch(base, loop,
                                                         prompts, 32)
        launches = {"ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches,
                    "ragged_paged_attention": K1.launches}
        host = _host_us(loop, h0)
        b = node(_node_depth(_hotswap_copy()[0]), "no-slo")
        off_texts, off_s, off_busy, off_idle = _traced_batch(
            b[2], b[3], prompts, 32)
        close(b)
        b = None
        same = sum(x == y for x, y in zip(on_texts, off_texts))
        log(f"{tag} (2) 8 chats admitted together: ids equal slo on / off "
            f"{same} of 8; wall {on_s:.3f} / {off_s:.3f} s; traced "
            f"device-busy {on_busy:.1f} / {off_busy:.1f} ms, idle share "
            f"{on_idle:.4f} / {off_idle:.4f}; host per step: scheduler pass "
            f"{host['sched_pass_us']:.1f} us ({host['sched_passes']} "
            f"passes), SLO notes {host['slo_note_us']:.1f} us "
            f"({host['slo_note_batches']} batches)")
        if same != 8:
            raise AssertionError(f"{tag} the scheduler changed tokens")
        # (3)-(4) the flood under WFQ
        h0 = _host_snapshot(loop)
        K1.launches = K1_INT8.launches = K2.launches = 0
        wfq = _tenant_traffic(base, loop, tag)
        launches["ragged_paged_attention_int8"] += K1_INT8.launches
        launches["flash_attention"] += K2.launches
        launches["ragged_paged_attention"] += K1.launches
        host_load = _host_us(loop, h0)
        # (5) quarantine at full width, in process
        if loop.step_failures or loop.quarantine_evictions:
            raise AssertionError(f"{tag} a step failed before the fault")
        rng = np.random.default_rng(12)
        qprompts = [[int(t) for t in rng.integers(4, 100_000, size=300)]
                    for _ in range(8)]
        faults.arm(seed=1, rules=[{"point": "engine_step",
                                   "request_id_contains": "poison"}])
        t_q = time.monotonic()
        try:
            q = _poisoned_script(loop, "full width", qprompts, 16)
        finally:
            faults.disarm()
        q_wall = time.monotonic() - t_q
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        q_evict = _metric(text, "helix_quarantine_evictions_total",
                          model=MODEL)
        q_retry = _metric(text, "helix_step_retries_total", model=MODEL)
        q_err = q["q-poison"][2] or ""
        q_fin = sorted({r for k, (_t, r, e) in q.items() if k != "q-poison"})
        log(f"{tag} (5) quarantine at full width: poisoned request error "
            f"{q_err[:90]!r}; others finished {q_fin}; "
            f"helix_quarantine_evictions_total {q_evict:g}, "
            f"helix_step_retries_total {q_retry:g}; wall {q_wall:.2f} s")
        if not q_err.startswith("request quarantined: engine step failed "
                                "while scheduled (") \
                or q_fin != sorted(set(q_fin) & {"stop", "length"}) \
                or any(q[k][2] for k in q if k != "q-poison") \
                or q_evict != 1 or q_retry < 1:
            raise AssertionError(f"{tag} quarantine: {q_err!r} {q_fin} "
                                 f"{q_evict} {q_retry}")
    finally:
        if b is not None:
            close(b)
        close(a)
    # (4, FIFO) the same traffic with the policy overridden
    os.environ["HELIX_SCHED_POLICY"] = "fifo"
    try:
        c = node(prof, "fifo")
    finally:
        del os.environ["HELIX_SCHED_POLICY"]
    try:
        if c[3].sched.name != "fifo":
            raise AssertionError(f"{tag} HELIX_SCHED_POLICY was not read")
        fifo = _tenant_traffic(c[2], c[3], tag)
    finally:
        close(c)
    # the checks of steps 3, 4 and 6
    rows = {}
    for name, run in (("wfq", wfq), ("fifo", fifo)):
        ans = run["answers"]
        shed = [x for x in ans if x["status"] == 429]
        other = [x for x in ans if x["status"] not in (200, 429)]
        unfinished = [x for x in ans if x["status"] == 200
                      and x["finish"] not in ("stop", "length")]
        ttft = {t: _pcts([x["ttft"] for x in ans if x["tenant"] == t
                          and x["status"] == 200 and x["ttft"]])
                for t in ("chat", "flood")}
        order = run["order"]
        chats_first = (order.index("flood") > max(
            i for i, t in enumerate(order) if t == "chat"))
        flood_first = (order.index("chat") > max(
            i for i, t in enumerate(order) if t == "flood"))
        rows[name] = dict(shed=len(shed), shed_tenants=sorted(
            {x["tenant"] for x in shed}), other=other, unfinished=len(
            unfinished), ttft=ttft, chats_first=chats_first,
            flood_first=flood_first, wall=run["wall"], shed_example=(
                shed[0] if shed else None), early=run["early_answers"])
        log(f"{tag} ({name}) {FLOOD} flood + {CHATS} chat requests: 429s "
            f"{len(shed)} (tenants {rows[name]['shed_tenants']}, answered "
            f"before the release {run['early_answers']}), other errors "
            f"{len(other)}, admitted but unfinished {len(unfinished)}; "
            f"chat TTFT p50 {ttft['chat'][0]:.3f} s p95 "
            f"{ttft['chat'][1]:.3f} s, flood TTFT p50 {ttft['flood'][0]:.3f}"
            f" s p95 {ttft['flood'][1]:.3f} s; every chat admitted before "
            f"any flood {chats_first}, every flood before any chat "
            f"{flood_first}; wall {run['wall']:.2f} s")
    ex = rows["wfq"]["shed_example"]
    want_msg = ("queue_full: tenant 'flood' already has 64 request(s) "
                "queued (max_tenant_queue_depth=64)")
    for name, r in rows.items():
        if r["shed"] != FLOOD_SHED or r["shed_tenants"] != ["flood"] \
                or r["other"] or r["unfinished"] or r["early"] != FLOOD_SHED:
            raise AssertionError(f"{tag} {name}: {r}")
    if ex["retry_after"] != "1" or ex["error"]["type"] != "overloaded_error" \
            or ex["error"]["message"] != want_msg:
        raise AssertionError(f"{tag} 429: {ex}")
    if not rows["wfq"]["chats_first"] or not rows["fifo"]["flood_first"]:
        raise AssertionError(f"{tag} admission order: {rows}")
    budgets = [x["budget"] for x in wfq["scrapes"]]
    bad = [x for x in wfq["scrapes"] if check_scrape(x["text"])]
    scrape_ms = _pcts([x["ms"] for x in wfq["scrapes"]])
    burn_max = max((x["burn"] for x in wfq["scrapes"]), default=0.0)
    last = wfq["scrapes"][-1]["text"]
    burns = {w: _metric(last, "helix_slo_burn_rate", model=MODEL,
                        slo="ttft_p95", window=w) for w in ("fast", "slow")}
    shrinks = _metric(last, "helix_sched_prefill_budget_shrinks_total",
                      model=MODEL)
    grows = _metric(last, "helix_sched_prefill_budget_grows_total",
                    model=MODEL)
    runs = []
    for x in budgets:
        if runs and runs[-1][0] == x:
            runs[-1][1] += 1
        else:
            runs.append([x, 1])
    log(f"{tag} (4) prefill budget every 0.5 s under WFQ ({len(budgets)} "
        f"scrapes, as [value, scrapes] runs): {runs}; TTFT fast burn max "
        f"{burn_max:.3f} (passed 1: {burn_max > 1.0}); budget shrinks {shrinks:g}, grows {grows:g}; "
        f"burn at the end: ttft_p95 fast {burns['fast']:.3f} slow "
        f"{burns['slow']:.3f}; host per step under the flood: scheduler "
        f"pass {host_load['sched_pass_us']:.1f} us, SLO notes "
        f"{host_load['slo_note_us']:.1f} us")
    log(f"{tag} (6) {len(wfq['scrapes'])} scrapes under load: "
        f"{len(bad)} with a problem; families in the last "
        f"{len(last.split('# TYPE ')) - 1}; scrape wall p50 "
        f"{scrape_ms[0]:.1f} ms p95 {scrape_ms[1]:.1f} ms")
    if bad:
        raise AssertionError(f"{tag} scrape: {check_scrape(bad[0]['text'])}")
    if not budgets or any(not 512 <= x <= 4096 for x in budgets):
        raise AssertionError(f"{tag} budget left [512, 4096]: {budgets}")
    if launches["ragged_paged_attention_int8"] <= 0 \
            or launches["flash_attention"] <= 0:
        raise AssertionError(f"{tag} the kernels did not run: {launches}")
    # (5, exact) 2 layers in float32: the survivors equal a clean run
    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2, dtype="float32")
    params = init_params(cfg, 2, device="cuda")
    runs = {}
    for poison in (False, True):
        eng2 = Engine(cfg, params, EngineConfig(
            max_decode_batch=16, page_size=16, num_pages=512,
            max_pages_per_seq=64, max_prefill_len=2048), device="cuda")
        loop2 = EngineLoop(eng2, "slo-exact").start()
        if poison:
            faults.arm(seed=1, rules=[{"point": "engine_step",
                                       "request_id_contains": "poison"}])
        try:
            runs[poison] = (_poisoned_script(loop2, "f32", qprompts, 16,
                                             poison=poison),
                            loop2.quarantine_evictions)
        finally:
            faults.disarm()
            loop2.stop()
    (clean, _), (dirty, n_evict) = runs[False], runs[True]
    equal = sum(clean[k][0] == dirty[k][0] for k in clean)
    log(f"{tag} (5) 2 layers float32: survivors' tokens equal the "
        f"unpoisoned run's {equal} of {len(clean)}; evictions {n_evict}")
    if equal != len(clean) or n_evict != 1 \
            or not (dirty["q-poison"][2] or "").startswith(
                "request quarantined"):
        raise AssertionError(f"{tag} f32 survivors differ")
    del params
    _free()
    wall = time.monotonic() - t_phase
    log(f"{tag} phase wall {wall:.1f} s")
    out.update(launches=launches, rows=rows, budgets=budgets,
               burn_max=burn_max, host=host, host_load=host_load,
               trace={"on": (on_busy, on_idle), "off": (off_busy, off_idle)},
               scrape_ms=scrape_ms, quarantine_s=q_wall, wall=wall,
               chat_prompts=prompts, chat_texts=on_texts)
    return out


# ---------------------------------------------------------------------------
# 4j. the node agent: heartbeats, apply, diff re-apply, drain, the routes
# ---------------------------------------------------------------------------

# the drain wave: 8 greedy streams and one seeded one, long enough to be
# in flight when the drain's window (HELIX_DRAIN_SECONDS) closes
DRAIN_TOKENS = 200
WITNESS_TOKENS = 400      # the drain's witness at 2 layers
DRAIN_WINDOW_S = "1"


def _node_args(stub_url, runner_id, profile=None,
               random_weights=True) -> argparse.Namespace:
    """``serve-node --runner-id <id> [--control-plane <stub>]
    --heartbeat-interval 1 [--random-weights] [--profile <path>]`` on the
    card."""
    return argparse.Namespace(
        profile=profile, model=None, runner_id=runner_id, host="127.0.0.1",
        port=0, control_plane=stub_url, heartbeat_interval=1.0,
        advertise=None, device="cuda", engine=None, seed=0, no_warmup=False,
        random_weights=random_weights, tunnel=False)


def _stream_client(base, body, peers=None) -> dict:
    """A streamed chat read to its end.  A ``migrated ... peer=`` frame
    is followed, when ``peers`` maps the peer's id to its address, by
    ``/v1/migrate/resume`` there with the characters already seen.
    Returns the text seen from ``base``, the resumed text, the finish
    reason, the peer, the engine request id and the error frames."""
    req = urllib.request.Request(
        base + "/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    out = {"seen": "", "finish": None, "errors": [], "resumed": "",
           "peer": None, "request_id": None}
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            frame = json.loads(line[6:])
            if "error" in frame:
                out["errors"].append(frame["error"])
                continue
            ch = frame["choices"][0]
            out["seen"] += ch["delta"].get("content", "")
            out["finish"] = ch["finish_reason"] or out["finish"]
    from helix_tpu_torch.serving.migration import parse_migrated_peer

    err = next((e for e in out["errors"] if e.get("code") == "migrated"),
               None)
    if err is None or peers is None:
        return out
    out["peer"] = parse_migrated_peer(err["message"])
    out["request_id"] = err["request_id"]
    with urllib.request.urlopen(urllib.request.Request(
            peers[out["peer"]] + "/v1/migrate/resume",
            data=json.dumps({"request_id": err["request_id"],
                             "emitted_chars": len(out["seen"])}).encode(),
            headers={"Content-Type": "application/json"}),
            timeout=900) as r:
        frames = [json.loads(f[6:]) for f in r.read().decode().split("\n\n")
                  if f.startswith("data: {")]
    out["resumed"] = "".join(f.get("delta", "") for f in frames)
    out["finish"] = frames[-1].get("finish_reason")
    return out


def _status_of(url, body, token=None) -> int:
    """The HTTP status of a POST (with ``X-Runner-Token`` when given)."""
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-Runner-Token"] = token
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps(body).encode(), headers=headers),
                timeout=600) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _drain_wave(stub, rid, agent, agent_b, bodies, drained,
                lead_s=2.0) -> dict:
    """``bodies`` streamed undrained on node B (``agent_b``), then in
    flight on node ``rid`` (``agent``, which polls its assignment) when,
    ``lead_s`` after their release, the stub answers its poll with
    ``drain: true``: the survivors ship to B (the stub's migration
    targets) and each client resumes there.  Both nodes first serve one
    short chat, so the chat template's first page is a prefix-cache hit
    on both.  ``drained`` is the list ``agent.on_drain`` appends to.
    Returns the drain's readings: when the draining heartbeat and B's
    first import came, snapshots shipped, the streams migrated whole
    with every token once (4e.3's check), those that ended on A before
    the deadline as undrained, those lost, the seeded (last) stream's
    agreement with the undrained wave, the greedy streams equal to it
    and each one's (first difference, tokens made on A)."""
    from helix_tpu_torch.serving import migration

    loop = agent.registry.get(MODEL).loop
    loop_b = agent_b.registry.get(MODEL).loop
    for ag in (agent, agent_b):
        _chat(ag.address, "warm the template page", 4)
    outs, errs, threads, _t0 = _gated_calls(
        loop_b, len(bodies),
        lambda i: _stream_client(agent_b.address, bodies[i]), wait=False)
    for t in threads:
        t.join(900)
    if errs:
        raise errs[0]
    undrained = [o["seen"] for o in outs]
    # the drained wave: spies on A's wires and B's imports
    wires, b_events, b_first = {}, {}, []
    to_wire = migration.snapshot_to_wire
    on_event = migration.ImportedStream.on_event
    submit_import = loop_b.submit_import

    def spy_wire(snap):
        w = to_wire(snap)
        wires[w["request_id"]] = w
        return w

    def spy_event(stream, ev):
        b_events.setdefault(stream.request_id, []).append(ev)
        on_event(stream, ev)

    def spy_import(*a, **kw):
        b_first.append(time.monotonic())
        return submit_import(*a, **kw)

    migration.snapshot_to_wire = spy_wire
    migration.ImportedStream.on_event = spy_event
    loop_b.submit_import = spy_import
    os.environ["HELIX_DRAIN_SECONDS"] = DRAIN_WINDOW_S
    try:
        peers = {t["id"]: t["address"]
                 for t in stub._targets(rid)["targets"]}
        outs, errs, threads, t_rel = _gated_calls(
            loop, len(bodies),
            lambda i: _stream_client(agent.address, bodies[i], peers),
            wait=False)
        while time.monotonic() - t_rel < lead_s:
            time.sleep(0.05)
        t_req, t_req_wall = time.monotonic(), time.time()
        stub.request_drain(rid)
        for t in threads:
            t.join(900)
        if errs:
            raise errs[0]
        deadline = time.monotonic() + 300
        while not drained and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        migration.snapshot_to_wire = to_wire
        migration.ImportedStream.on_event = on_event
        loop_b.submit_import = submit_import
        os.environ.pop("HELIX_DRAIN_SECONDS", None)
    time.sleep(1.0)
    announce = next(((t, b) for t, b in stub.heartbeats(rid)
                     if t > t_req and b["draining"]), None)
    eos = set(loop.engine.cfg.eos_token_ids)
    migrated, finished, lost = 0, 0, []
    for i, o in enumerate(outs):
        req_id = o.get("request_id")
        if req_id is None:
            # ended on A before the deadline: whole, as undrained
            if not o["errors"] and o["finish"] in ("stop", "length") \
                    and o["seen"] == undrained[i]:
                finished += 1
            else:
                lost.append(i)
            continue
        prior = [t for t in wires[req_id]["output_tokens"] if t not in eos]
        new = [ev.token_id for ev in b_events.get(req_id, ())
               if not ev.error and ev.token_id not in eos]
        seen_ids, full = _ids(o["seen"]), _ids(o["seen"] + o["resumed"])
        o["prior"] = len(prior)
        if seen_ids == prior[:len(seen_ids)] and full == prior + new \
                and o["finish"] in ("stop", "length"):
            migrated += 1
        else:
            lost.append(i)

    def first_diff(o, u):
        a, b = _ids(o["seen"] + o["resumed"]), _ids(u)
        return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))

    return {
        "announce_s": announce[0] - t_req if announce else float("nan"),
        "announced": announce is not None and announce[1]["draining"],
        "deadline_s": (announce[1]["drain_deadline_ts"] - t_req_wall
                       if announce else float("nan")),
        "announce_before_import": bool(announce and b_first
                                       and announce[0] <= b_first[0]),
        "first_import_s": b_first[0] - t_req if b_first else float("nan"),
        "shipped": sum(st.get("exported", 0)
                       for st in agent._drain_stats.values()),
        "migrated": migrated, "finished": finished, "lost": lost,
        "n": len(outs),
        "seeded_equal": _ids(outs[-1]["seen"] + outs[-1]["resumed"])
        == _ids(undrained[-1]),
        "seeded_diff": (first_diff(outs[-1], undrained[-1]),
                        outs[-1].get("prior")),
        "greedy_equal": sum(o["seen"] + o["resumed"] == u for o, u in
                            zip(outs[:-1], undrained[:-1])),
        "greedy_diffs": [(first_diff(o, u), o.get("prior"))
                         for o, u in zip(outs[:-1], undrained[:-1])],
        "drain_s": drained[0] - t_req if drained else float("nan"),
        "on_drain": len(drained),
    }


def _drain_line(d) -> str:
    """One log line of ``_drain_wave``'s readings."""
    return (f"the draining heartbeat {d['announce_s']:.3f} s after the "
            f"request (draining {d['announced']}, deadline "
            f"+{d['deadline_s']:.3f} s), first import on B "
            f"{d['first_import_s']:.3f} s after it; snapshots shipped "
            f"{d['shipped']}; streams migrated to B whole, every token "
            f"once: {d['migrated']}, ended on A before the deadline as "
            f"undrained: {d['finished']}, of {d['n']} (lost {d['lost']}); "
            f"the seeded stream equals the undrained wave's "
            f"{d['seeded_equal']} ((first difference, tokens made on A) "
            f"{d['seeded_diff']}); greedy streams equal to it "
            f"{d['greedy_equal']} of {d['n'] - 1} ({d['greedy_diffs']}); "
            f"on_drain calls {d['on_drain']}; drain {d['drain_s']:.2f} s "
            "(request to on_drain)")


def _drain_held(d) -> bool:
    """The drain's demands: draining announced with a future deadline
    before any snapshot landed on B, nothing lost, every stream that did
    not end on A shipped and migrated whole, ``on_drain`` once."""
    return (d["announced"] and d["deadline_s"] > 0
            and d["announce_before_import"] and not d["lost"]
            and d["migrated"] > 0 and d["shipped"] == d["migrated"]
            and d["on_drain"] == 1)


def _apply_and_watch(stub, base, rid, prof, name, get_state=None) -> dict:
    """Assign ``prof`` to ``rid`` and wait for its heartbeat to say
    ``running`` under ``name``, reading ``/api/v1/state`` meanwhile
    (``get_state()`` in place of ``base``'s route when given).
    Returns the statuses the state route showed, the apply seconds (from
    the poll that answered the profile to the first ``running`` beat,
    which goes out one interval after the apply ends, and to the state
    route's first ``running``) and the longest gap between heartbeats
    over the apply."""
    t_assign = time.monotonic()
    stub.assign(rid, prof)
    states, t_state_run = [], None
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline:
        doc = get_state() if get_state is not None else json.loads(
            urllib.request.urlopen(base + "/api/v1/state", timeout=60)
            .read())
        st = doc["profile"]["status"] if doc["profile"]["name"] == name \
            else "assigning"
        if not states or states[-1] != st:
            states.append(st)
            if st == "running":
                t_state_run = time.monotonic()
        beats = [(t, b) for t, b in stub.heartbeats(rid) if t > t_assign
                 and b["profile"]["name"] == name
                 and b["profile"]["status"] in ("running", "failed")]
        if beats:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"{rid}: {name} was never applied")
    t_run, body = beats[0]
    if body["profile"]["status"] != "running":
        raise AssertionError(f"{rid}: {name} failed: "
                             f"{body['profile']['error'][:400]}")
    seen = [t for t, pname, _d in stub.polls[rid]
            if t > t_assign and pname == name][0]
    times = [t for t, _b in stub.heartbeats(rid)]
    gaps = [b - a for a, b in zip(times, times[1:])
            if b >= seen and a <= t_run]
    return {"states": states, "apply_s": t_run - seen,
            "state_s": (t_state_run or t_run) - seen,
            "max_gap_s": max(gaps, default=0.0), "beat": body}


@_timed
def phase_node_agent(smi, agent_free=None) -> dict:
    """The node agent (A7b) at full width on one card, against a
    stand-in control plane (``helix_tpu_torch/testing/control_stub.py``,
    the reference's runner endpoints on the standard library): (1) the
    card's inventory refuses ``profiles/v5e1-hotswap.yaml`` as written
    (a ``tpu`` chip) and fits its copy with ``{vendor: nvidia, chips:
    1}``; (2) node A (``serve-node --runner-id a --control-plane <stub>``,
    no profile, 1 s heartbeats) applies ``node-1``, the Llama entry as
    written (int8, spec 4, the 16 GiB host tier, 8 adapter slots of rank
    16, ``slo`` with WFQ): ``/api/v1/state`` goes ``loading`` ->
    ``running``, the heartbeat carries the card and exactly
    ``SATURATION_KEYS``; (3) 8 greedy chats admitted together give the
    agent-free node's ids (phase 4i's, or a node built here under
    ``--phase node``), a seeded request twice the same text,
    ``/v1/messages`` the chat's text, tenant traffic a ``tenants`` block
    of ``TENANT_KEYS`` and an adapter ``model@a1`` in ``adapters``; (4)
    ``node-2`` adds Phi-3-mini (bf16, 1024 pages as 4f cuts it) while a
    Llama stream runs across the apply and ends whole, the Llama loop is
    the same object, Phi-3 answers, and ``node-3`` drops Phi-3 with >=
    95% of its measured bytes freed; (6) ``/admin/profiler`` for 2 s
    during a chat wave gives a trace naming K1-int8 and K2, a second
    capture meanwhile 409, no token 403, ``/logs`` holds the agent's
    build line, ``/api/v1/state`` equals a heartbeat body but for ``ts``
    and ``disk``; (5) node B (the same entry and seed, host tier cut)
    heartbeats; 9 streams (8 greedy, 1 seeded) in flight on A when the
    stub answers A's poll with ``drain: true``: A's next heartbeat says
    ``draining`` before any snapshot ships, the survivors ship to B, each
    client's text is A's emitted tokens and B's new ones, every token
    once (the seeded stream's agreement with the undrained wave is
    recorded), ``on_drain`` runs once; a ``serve-node`` process drained
    by the stub exits 0; and the same drain between two nodes at 2
    layers in float32 with a float32 KV pool (the witness) gives 8 of 8
    greedy streams equal to the undrained wave's.  Recorded: apply
    seconds, the longest heartbeat gap in an apply, host µs per
    heartbeat body with 16 slots busy, drain seconds and snapshots
    shipped, decode tok/s with and without a capture, and the K1-int8 /
    K2 launches from node A's start to the end of its drain."""
    import logging
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.control.profile import (
        ServingProfile,
        check_compatibility,
    )
    from helix_tpu_torch.device import detect_accelerators
    from helix_tpu_torch.engine.residency import release_served_model
    from helix_tpu_torch.obs.flight import SATURATION_KEYS
    from helix_tpu_torch.obs.slo import TENANT_KEYS
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.testing.control_stub import ControlStub

    t_phase = time.monotonic()
    tag = f"[node] ({smi})"
    out = {}
    # serve-node's log level (``python -m helix_tpu_torch`` sets INFO)
    logging.getLogger("helix_tpu_torch").setLevel(logging.INFO)
    tmpdir = tempfile.mkdtemp(prefix="helix-node-")
    stub = ControlStub().start()
    # the exit of a drained serve-node process, started now to overlap
    # its start-up (a tiny model: the exit path is what it shows)
    sub_env = {**os.environ, "HELIX_DRAIN_SECONDS": "0.5"}
    stub.assign("c", {"name": "exit-1", "requirement": {
        "vendor": "nvidia", "chips": 1}, "models": [{
            "name": "tiny-chat", "engine": {
                "max_decode_batch": 2, "num_pages": 64,
                "max_pages_per_seq": 16, "max_prefill_len": 64}}]})
    sub_log = open(os.path.join(tmpdir, "serve-node-c.log"), "w+")
    sub = subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch", "serve-node", "--device",
         "cuda", "--port", "0", "--host", "127.0.0.1", "--runner-id", "c",
         "--control-plane", stub.url, "--heartbeat-interval", "0.5"],
        stdout=sub_log, stderr=subprocess.STDOUT, text=True, env=sub_env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    # (1) compatibility
    with open(HOTSWAP_PROFILE) as f:
        written = ServingProfile.from_yaml(f.read())
    inv = [a.to_dict() for a in detect_accelerators()]
    doc = cli._load_profile(HOTSWAP_PROFILE)
    _node_depth(doc)
    llama = next(m for m in doc["models"] if m["name"] == MODEL)
    phi = next(m for m in doc["models"] if m["name"] == PHI3)
    phi["engine"]["num_pages"] = PHI3_CUT_PAGES

    def profile(name, models):
        return {"name": name, "requirement": {"vendor": "nvidia",
                                              "chips": 1},
                "models": models}

    node1 = profile("node-1", [llama])
    node2 = profile("node-2", [llama, phi])
    node3 = profile("node-3", [llama])
    v_written = [v.to_dict() for v in check_compatibility(written, inv)]
    v_copy = [v.to_dict() for v in check_compatibility(
        ServingProfile.from_dict(node2), inv)]
    log(f"{tag} (1) inventory {json.dumps(inv)}; as written: "
        f"{v_written}; the nvidia copy: {v_copy}")
    if v_written != [{"constraint": "chips", "want": ">=1 tpu",
                      "have": "0"}] or v_copy:
        raise AssertionError(f"{tag} compatibility {v_written} {v_copy}")
    cuts = [f"node-2/{PHI3}: engine.num_pages 2048 -> {PHI3_CUT_PAGES}",
            "node-b: engine.host_pool_bytes -> 0 (two 16 GiB pinned tiers "
            "are not needed to show the drain)",
            "the exit check's serve-node process serves tiny-chat",
            f"{MODEL}: {NODE_LAYERS} of 32 layers (a depth cut for the "
            "smoke's time limit)"]
    for c in cuts:
        log(f"{tag} cut: {c}")

    def build(**kw):
        served = cli.build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        return served

    # the node without a control plane (serve-node --profile): phase
    # 4i's, or built here
    if agent_free is None:
        reg, _mgr, httpd0, base0, _ = _node(node1, tmpdir, "agent-free",
                                            build)
        loop0 = reg.get(MODEL).loop
        free_texts, _s, free_busy, _i = _traced_batch(base0, loop0,
                                                      NODE_PROMPTS, 32)
        httpd0.shutdown()
        httpd0.server_close()
        served0 = reg.get(MODEL)
        reg.unregister(MODEL)
        release_served_model(served0)
        del loop0, reg, served0
        agent_free = {"texts": free_texts, "busy_ms": free_busy,
                      "from": "built here"}
    # (2) node A applies its assignment; the phase's launches count
    # from here
    K1.launches = K1_INT8.launches = K2.launches = 0
    args_a = _node_args(stub.url, "a")
    agent, httpd = cli.make_node(args_a, build_model=build)
    drained = []
    agent.on_drain = lambda: drained.append(time.monotonic())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = agent.address
    b_side = None
    try:
        stub.wait_for("a", lambda b: True, 60)
        a1 = _apply_and_watch(stub, base, "a", node1, "node-1")
        beat = a1["beat"]
        acc = beat["accelerators"][0]
        _free_b, total = torch.cuda.mem_get_info()
        log(f"{tag} (2) node-1: state route {a1['states']}; heartbeat "
            f"statuses {[b['profile']['status'] for _t, b in stub.heartbeats('a')][:4]}...; "
            f"apply {a1['apply_s']:.2f} s, longest heartbeat gap "
            f"{a1['max_gap_s']:.2f} s (state route running after "
            f"{a1['state_s']:.2f} s); accelerators[0] "
            f"{json.dumps(acc)}")
        if a1["states"][-2:] != ["loading", "running"] \
                or acc["vendor"] != "nvidia" \
                or acc["device_kind"] != torch.cuda.get_device_name(0) \
                or acc["total_memory_bytes"] != total \
                or list(beat["saturation"]) != list(SATURATION_KEYS) \
                or beat["profile"]["models"] != [MODEL]:
            raise AssertionError(f"{tag} node-1 heartbeat {beat}")
        loop = agent.registry.get(MODEL).loop
        eng = loop.engine
        if eng.adapter_pool is None or eng.spec is None \
                or eng.host_pool is None or loop.sched.name != "wfq":
            raise AssertionError(f"{tag} the entry lost a field")
        # (3) traffic
        texts, secs, busy, idle = _traced_batch(base, loop, NODE_PROMPTS, 32)
        same = sum(a == b for a, b in zip(texts, agent_free["texts"]))
        seeded = [_seeded(base, MODEL) for _ in range(2)]
        msg_body = {"model": MODEL, "max_tokens": 16, "temperature": 0,
                    "messages": [{"role": "user",
                                  "content": "Say something short."}]}
        # the first chat caches the prompt's pages; the three compared
        # after it all start from that prefix-cache hit (a cold prefill
        # is other bf16 arithmetic)
        _post(base + "/v1/chat/completions", msg_body)
        chat_text = json.loads(_post(base + "/v1/chat/completions",
                                     msg_body))["choices"][0]["message"][
            "content"]
        msg = json.loads(_post(base + "/v1/messages", msg_body))
        raw = _post(base + "/v1/messages", {**msg_body, "stream": True})
        events = [blk.split("\n") for blk in raw.strip().split("\n\n")]
        stream_text = "".join(
            json.loads(d[6:])["delta"]["text"] for n, d in events
            if n == "event: content_block_delta")
        log(f"{tag} (3) 8 chats admitted together: ids equal the "
            f"agent-free node's ({agent_free['from']}) {same} of 8; traced "
            f"device-busy {busy:.1f} ms (agent-free "
            f"{agent_free['busy_ms']:.1f} ms), idle share {idle:.4f}, wall "
            f"{secs:.3f} s; seeded twice equal {seeded[0] == seeded[1]}; "
            f"/v1/messages text equals the chat's: non-stream "
            f"{msg['content'][0]['text'] == chat_text}, stream "
            f"{stream_text == chat_text} ({events[-1][0]}, stop "
            f"{msg['stop_reason']})")
        if same != 8 or seeded[0] != seeded[1] \
                or msg["content"][0]["text"] != chat_text \
                or stream_text != chat_text or not chat_text \
                or events[0][0] != "event: message_start" \
                or events[-1][0] != "event: message_stop":
            raise AssertionError(f"{tag} traffic through the agent")
        for i, tenant in enumerate(("acme", "beta", "acme")):
            req = urllib.request.Request(
                base + "/v1/chat/completions",
                data=json.dumps({**msg_body, "messages": [{
                    "role": "user", "content": f"tenant chat {i}"}]})
                .encode(),
                headers={"Content-Type": "application/json",
                         "X-Helix-Tenant": tenant})
            urllib.request.urlopen(req, timeout=600).read()
        eng.publish_adapter("a1", _adapter_tree(eng.model_cfg, 31),
                            ADAPTER_SCALE)
        _chat(base, "an adapter chat", 8, model=f"{MODEL}@a1")
        t_traffic = time.monotonic()
        beat = stub.wait_for("a", lambda b: b["tenants"] and b["adapters"],
                             30, after=t_traffic)
        keys = {k for e in beat["tenants"]["top"] for k in e}
        log(f"{tag} (3) tenants block {json.dumps(beat['tenants'])[:300]}; "
            f"adapters {beat['adapters']}")
        if not keys <= set(TENANT_KEYS) | {"tenant"} \
                or not {"acme", "beta"} <= {
                    e["tenant"] for e in beat["tenants"]["top"]} \
                or beat["adapters"] != [f"{MODEL}@a1"]:
            raise AssertionError(f"{tag} heartbeat blocks {beat}")
        # (4) diff re-apply: Phi-3 added while a Llama stream runs
        across = {}
        t_stream = threading.Thread(target=lambda: across.update(
            _stream_client(base, {**msg_body, "max_tokens": 150, "messages": [
                {"role": "user", "content": "a stream across the apply"}]})))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t_stream.start()
        a2 = _apply_and_watch(stub, base, "a", node2, "node-2")
        t_stream.join(600)
        mem1 = torch.cuda.memory_allocated()
        same_loop = agent.registry.get(MODEL).loop is loop
        phi_chat = _chat(base, "Hello Phi", 16, model=PHI3)
        a3 = _apply_and_watch(stub, base, "a", node3, "node-3")
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        phi_bytes, freed = mem1 - mem0, mem1 - mem2
        log(f"{tag} (4) node-2: apply {a2['apply_s']:.2f} s (state route "
            f"{a2['state_s']:.2f} s), longest "
            f"heartbeat gap {a2['max_gap_s']:.2f} s, Llama loop kept "
            f"{same_loop}, the stream across the apply ended "
            f"{across.get('finish')} with {across.get('seen', '').count('<')}"
            f" tokens and errors {across.get('errors')}; Phi-3 answered "
            f"({phi_chat['usage']['completion_tokens']} tokens); node-3: "
            f"apply {a3['apply_s']:.2f} s (state route {a3['state_s']:.2f} "
            f"s), Phi-3 measured "
            f"{phi_bytes / 2**30:.3f} GiB, freed {freed / 2**30:.3f} GiB "
            f"({freed / max(1, phi_bytes):.4f}); models "
            f"{agent.registry.names()}")
        if not same_loop or agent.registry.get(MODEL).loop is not loop \
                or across.get("finish") not in ("stop", "length") \
                or across.get("errors") or freed < 0.95 * phi_bytes \
                or phi_bytes <= 0 or agent.registry.names() != [MODEL]:
            raise AssertionError(f"{tag} diff re-apply")
        # (6) logs, state, the profiler
        logs = json.loads(urllib.request.urlopen(
            base + "/logs?tail=50", timeout=60).read())["logs"]
        build_lines = [e["line"] for e in logs if "runner a: model " in
                       e["line"] and " built in " in e["line"]]
        # the accelerators block reads the whole card's memory, and the
        # serve-node process started with the phase shares the card: its
        # start-up must be over before two reads are compared
        stub.wait_for("c", lambda b: b["profile"]["status"] == "running",
                      300)
        os.environ["HELIX_TRACE_FEDERATION"] = "0"
        try:
            t_state = time.monotonic()
            state = json.loads(urllib.request.urlopen(
                base + "/api/v1/state", timeout=60).read())
            # the first body built after the state route's: one built
            # before it can still arrive after t_state
            nxt = stub.wait_for("a", lambda b: b["ts"] > state["ts"], 30,
                                after=t_state)
        finally:
            del os.environ["HELIX_TRACE_FEDERATION"]
        for d in (state, nxt):
            for k in ("ts", "disk"):
                d.pop(k)
            # wall-clock rates move between the two reads
            d["saturation"].pop("tokens_per_sec")
            for e in (d["tenants"] or {}).get("top", []):
                e.pop("goodput_tps")
        log(f"{tag} (6) /logs?tail=50: {len(logs)} lines, the agent's build "
            f"lines {build_lines}; /api/v1/state equals the next heartbeat "
            f"body (ts, disk and the tok/s rate aside) {state == nxt}")
        if not build_lines or state != nxt:
            differ = {k: [state.get(k), nxt.get(k)]
                      for k in sorted(set(state) | set(nxt))
                      if state.get(k) != nxt.get(k)}
            raise AssertionError(
                f"{tag} logs / state: {len(logs)} log lines, build lines "
                f"{build_lines}; state route != heartbeat in "
                f"{json.dumps(differ)[:3000]}")
        wave = [f"Wave {i}: describe a lighthouse in a few lines." for i in
                range(8)]
        _t, off_s, _r = _gated_batch(base, loop, wave, 64)
        off_tps = 8 * 64 / off_s
        os.environ["HELIX_RUNNER_TOKEN"] = "smoke-token"
        cap = {}
        try:
            def capture():
                req = urllib.request.Request(
                    base + "/admin/profiler",
                    data=json.dumps({"seconds": 2}).encode(),
                    headers={"Content-Type": "application/json",
                             "X-Runner-Token": "smoke-token"})
                t0 = time.monotonic()
                with urllib.request.urlopen(req, timeout=600) as r:
                    cap.update(json.loads(r.read()))
                cap["wall_s"] = time.monotonic() - t0

            k2_before = K2.launches
            t_cap = threading.Thread(target=capture)
            t_cap.start()
            deadline = time.monotonic() + 60
            while not httpd.RequestHandlerClass.api._profiler_lock.locked():
                if time.monotonic() > deadline:
                    raise AssertionError("the capture never started")
                time.sleep(0.01)
            busy_code = _status_of(base + "/admin/profiler",
                                   {"seconds": 1}, "smoke-token")
            anon_code = _status_of(base + "/admin/profiler",
                                   {"seconds": 1})
            wave2 = [f"Wave {i}: describe a harbour in a few lines." for i
                     in range(8)]
            # a chat's first page is the template's, cached by now, and a
            # prefill segment with any row that has history runs K1 for
            # all: a cold completion admitted on its own, once the wave
            # decodes, is K2's prefill
            def cold_probe():
                time.sleep(0.5)
                _post(base + "/v1/completions", {
                    "model": MODEL, "max_tokens": 8, "temperature": 0,
                    "prompt": "Capture probe: a cold prompt of some forty "
                              "bytes or more, unlike any before it."})

            cold = threading.Thread(target=cold_probe)
            cold.start()
            _t, on_s, _r = _gated_batch(base, loop, wave2, 64)
            cold.join(600)
            k2_wave = K2.launches - k2_before
            t_cap.join(600)
        finally:
            del os.environ["HELIX_RUNNER_TOKEN"]
        on_tps = 8 * 64 / on_s
        with open(os.path.join(cap["log_dir"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernel_events = sum(e.get("cat") == "kernel" for e in events)
        attn_names = sorted(n[:120] for n in names if "flash" in n.lower()
                            or "ragged" in n.lower())
        k1_int8_names = sorted(n for n in names if "ragged_split_kernel" in n
                               and "signed char" in n)
        k2_names = sorted(n for n in names if "flash_" in n and "kernel" in n)
        trace_mb = os.path.getsize(os.path.join(cap["log_dir"],
                                                "trace.json")) / 2**20
        log(f"{tag} (6) /admin/profiler 2 s: {cap.get('log_dir')} "
            f"({trace_mb:.1f} MiB, reply after {cap.get('wall_s', 0):.2f} "
            f"s); trace kernels K1-int8 {[n[:60] for n in k1_int8_names]}, "
            f"K2 {[n[:60] for n in k2_names]}; a second capture meanwhile "
            f"{busy_code}, without the token {anon_code}; decode tok/s of "
            f"8 chats x 64 tokens without a capture {off_tps:.1f}, during "
            f"one {on_tps:.1f}; K2 launches during the wave {k2_wave}; "
            f"kernel events {kernel_events}; attention names {attn_names}")
        if busy_code != 409 or anon_code != 403 or not k1_int8_names \
                or not k2_names or cap.get("seconds") != 2:
            raise AssertionError(f"{tag} profiler")
        # host µs of one heartbeat body with 16 slots busy
        hb_us = []
        sixteen = [f"Busy {i}: count slowly to fifty." for i in range(16)]
        res16 = {}
        t16 = threading.Thread(target=lambda: res16.update(
            r=_gated_batch(base, loop, sixteen, 48)))
        t16.start()
        deadline = time.monotonic() + 120
        while sum(s is not None for s in eng.slots) < 16:
            if time.monotonic() > deadline:
                raise AssertionError("16 slots never busy")
            time.sleep(0.005)
        busy16 = []
        for _ in range(20):
            t0 = time.perf_counter()
            body16 = agent.heartbeat_payload()
            hb_us.append((time.perf_counter() - t0) * 1e6)
            busy16.append(body16["saturation"]["slots_busy"])
            time.sleep(0.01)
        t16.join(600)
        hb_p50, hb_p95 = _pcts(hb_us)
        idle_us = []
        for _ in range(20):
            t0 = time.perf_counter()
            agent.heartbeat_payload()
            idle_us.append((time.perf_counter() - t0) * 1e6)
        idle_p50, idle_p95 = _pcts(idle_us)
        log(f"{tag} (7) heartbeat body with 16 slots busy "
            f"({min(busy16)}-{max(busy16)} seen): host {hb_p50:.1f} us p50, "
            f"{hb_p95:.1f} us p95 over {len(hb_us)} builds; idle "
            f"{idle_p50:.1f} us p50, {idle_p95:.1f} us p95")
        # (5) the drain to node B
        node_b = profile("node-b", [{**llama, "engine": {
            **llama["engine"], "host_pool_bytes": 0}}])
        path_b = os.path.join(tmpdir, "node-b.json")
        with open(path_b, "w") as f:
            json.dump(node_b, f)
        agent_b, httpd_b = cli.make_node(_node_args(stub.url, "b", path_b),
                                         build_model=build)
        threading.Thread(target=httpd_b.serve_forever, daemon=True).start()
        b_side = (agent_b, httpd_b)
        stub.wait_for("b", lambda b: b["profile"]["status"] == "running",
                      300)
        bodies = [{"model": MODEL, "max_tokens": DRAIN_TOKENS,
                   "temperature": 0, "messages": [{
                       "role": "user", "content": f"Drain {i}: tell a long "
                       "story about a lighthouse keeper."}]}
                  for i in range(8)]
        bodies.append({"model": MODEL, "max_tokens": DRAIN_TOKENS,
                       "temperature": 0.8, "seed": 4321, "messages": [{
                           "role": "user", "content": "Drain seeded: a long "
                           "story."}]})
        dr = _drain_wave(stub, "a", agent, agent_b, bodies, drained)
        log(f"{tag} (5) drain: " + _drain_line(dr))
        # the seeded stream's equality is recorded, not demanded: its keys
        # are spent per drafted position and the acceptance EMA that
        # decides the drafts is not in the snapshot (ROADMAP C)
        if not _drain_held(dr):
            raise AssertionError(f"{tag} drain: {dr}")
        stub.wait_for("c", lambda b: b["profile"]["status"] == "running",
                      300)
        stub.request_drain("c")
        rc = sub.wait(timeout=300)
        log(f"{tag} (5) serve-node process drained by the stub: exit code "
            f"{rc}")
        sub_log.seek(0)
        sub_out = sub_log.read()
        if rc != 0 or "control plane requested drain" not in sub_out:
            raise AssertionError(f"{tag} serve-node exited {rc}: "
                                 f"{sub_out[-2000:]}")
        launches = {"ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches,
                    "ragged_paged_attention": K1.launches}
        log(f"{tag} (7) launches over the phase {launches}")
        if launches["ragged_paged_attention_int8"] <= 0 \
                or launches["flash_attention"] <= 0:
            raise AssertionError(f"{tag} the kernels did not run")
        out.update(launches=launches, cuts=cuts, apply=[a1, a2, a3],
                   busy_ms=busy, idle=idle, hb_us=(hb_p50, hb_p95),
                   drain=dr, tps=(off_tps, on_tps))
    finally:
        if sub.poll() is None:
            sub.kill()
        sub_log.close()
        for ag, hd in ((agent, httpd),) + ((b_side,) if b_side else ()):
            ag.stop()
            hd.shutdown()
            hd.server_close()
        stub.stop()
        _free()
    # (5) the drain's witness: the same wave and drain at 2 layers in
    # float32 with a float32 KV pool (speculation on, as the entry has
    # it).  There nothing rounds tiny differences of B's other batch
    # shapes into other tokens, so every greedy stream must equal the
    # undrained one: a difference at full depth in bf16 with int8 KV is
    # then that arithmetic, not a token lost or repeated by the drain
    # (a 2-layer step is short: the streams are longer and the drain
    # comes sooner, so that they are still running when it does)
    wit = profile("witness", [{
        **llama, "model_overrides": {"num_layers": 2, "dtype": "float32"},
        "engine": {**{k: v for k, v in llama["engine"].items()
                      if k != "kv_cache_dtype"}, "host_pool_bytes": 0}}])
    path_w = os.path.join(tmpdir, "witness.json")
    with open(path_w, "w") as f:
        json.dump(wit, f)
    stub = ControlStub().start()
    stub.assign("wa", wit)
    pair, w_drained = [], []
    try:
        for rid, path in (("wa", None), ("wb", path_w)):
            ag, hd = cli.make_node(_node_args(stub.url, rid, path),
                                   build_model=build)
            threading.Thread(target=hd.serve_forever, daemon=True).start()
            pair.append((ag, hd))
            stub.wait_for(rid, lambda b: b["profile"]["status"] == "running",
                          300)
        pair[0][0].on_drain = lambda: w_drained.append(time.monotonic())
        wd = _drain_wave(stub, "wa", pair[0][0], pair[1][0],
                         [{**b, "max_tokens": WITNESS_TOKENS}
                          for b in bodies], w_drained, lead_s=0.5)
        log(f"{tag} (5) witness, 2 layers float32, float32 KV: "
            + _drain_line(wd))
        if not _drain_held(wd) or wd["greedy_equal"] != len(bodies) - 1:
            raise AssertionError(f"{tag} the drain's witness: {wd}")
        out["witness"] = wd
    finally:
        for ag, hd in pair:
            ag.stop()
            hd.shutdown()
            hd.server_close()
        stub.stop()
        _free()
    log(f"{tag} phase wall {time.monotonic() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 4k. the reverse tunnel and the embedding entry
# ---------------------------------------------------------------------------

BGE = "BAAI/bge-base-en-v1.5"
BGE_TEXTS = 64           # one request of texts, 8-512 tokens
BGE_TIMED = (64, 512)    # the timed batch: rows x tokens
BGE_CPU_ROWS = 16        # texts held to the CPU's plain path
# card vs the CPU's plain path, float32, TF32 off: per component of the
# unit vectors, and the least cosine.  The same texts with TF32 on (the
# control) must break a limit: the limits tell the two apart
BGE_ABS_TOL = 1e-5
BGE_COS_MIN = 0.999999
SIGTERM_STREAMS, SIGTERM_TOKENS = 4, 64
# the caller that stops reading: tokens asked for, and the most the
# engine may make before the hang-up aborts the request
CLOSE_TOKENS, CLOSE_MAX_MADE = 400, 100


def _bge_texts(tok, n=BGE_TEXTS, lo=8, hi=512) -> list:
    """``n`` texts whose token counts under ``tok`` spread evenly over
    [lo, hi]: words of the fixtures' system prompt, added while the count
    stays within the target (a word's pieces do not depend on its
    neighbours under BERT's pre-tokenizer)."""
    from helix_tpu_torch.testing.tokenizer_fixtures import system_prompt

    words = system_prompt(60).split()
    counts = [len(tok.encode(w)) for w in words]
    out = []
    for target in np.linspace(lo, hi, n).round().astype(int):
        picked, have, i = [], 0, 0
        while have < target:
            w, c = words[i % len(words)], counts[i % len(words)]
            i += 1
            if have + c > target:
                continue
            picked.append(w)
            have += c
        out.append(" ".join(picked))
    return out


def _sse_frames(raw: bytes) -> list:
    return [json.loads(x[6:]) for x in raw.split(b"\n\n")
            if x.startswith(b"data: {")]


def _tunnel_stream(stub, rid, body, out=None) -> dict:
    """A streamed chat through the stub's tunnel to ``rid``: the frames,
    when the first chunk came, the chunks (OP_BODY frames) received and
    the tunnel's error, if any (``out`` is filled as they come)."""
    from helix_tpu_torch.control.tunnel import TunnelClosed

    out = {} if out is None else out
    out.update(frames=[], first=None, chunks=0, error=None)
    try:
        status, _h, chunks = stub.tunnel_request(
            rid, "POST", "/v1/chat/completions",
            {"Content-Type": "application/json"},
            json.dumps({**body, "stream": True}).encode())
        if status != 200:
            raise AssertionError(f"tunnel chat answered {status}")
        for c in chunks:
            out["chunks"] += 1
            if out["first"] is None:
                out["first"] = time.monotonic()
            out["frames"] += _sse_frames(c)
    except TunnelClosed as e:
        out["error"] = str(e)
    return out


def _unix_stream(path, body) -> dict:
    """The same chat direct to the node's unix socket."""
    from helix_tpu_torch.control.tunnel import UnixHTTPConnection

    out = {"frames": [], "first": None, "chunks": 0, "error": None}
    conn = UnixHTTPConnection(path)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps({**body, "stream": True}).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = b""
        while True:
            c = r.read1(1 << 16)
            if not c:
                break
            out["chunks"] += 1
            if out["first"] is None:
                out["first"] = time.monotonic()
            raw += c
        out["frames"] = _sse_frames(raw)
    finally:
        conn.close()
    return out


def _vec_gap(got, want) -> tuple:
    """(max abs, least cosine) of two stacks of vectors."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(want, axis=1)
    return float(np.abs(got - want).max()), float(cos.min())


def _closed_early(stub, rid, loop, body) -> tuple:
    """A stream through the stub's tunnel whose caller stops after the
    first chunk, which sends ``OP_CLOSE`` with the tunnel up: (tokens the
    engine made for it, seconds from the close until every slot was
    free)."""
    made: dict = {}
    submit = loop.submit

    def counting(req, on_event, *a, **kw):
        made[req.id] = 0

        def ev(e):
            if e.token_id >= 0 and not e.error:
                made[req.id] += 1
            on_event(e)
        return submit(req, ev, *a, **kw)

    eng = loop.engine
    loop.submit = counting
    try:
        status, _h, chunks = stub.tunnel_request(
            rid, "POST", "/v1/chat/completions",
            {"Content-Type": "application/json"}, json.dumps(body).encode())
        if status != 200:
            raise AssertionError(f"the stream answered {status}")
        next(chunks)
        chunks.close()
        t0 = time.monotonic()
        while (any(r is not None for r in eng.slots) or eng.waiting) \
                and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        close_s = time.monotonic() - t0
    finally:
        loop.submit = submit
    if len(made) != 1:
        raise AssertionError(f"requests submitted: {made}")
    return next(iter(made.values())), close_s


def _ids_of(frames) -> list:
    """Token ids of a stream's frames (``_IdTokenizer`` writes ``<id>``)."""
    text = "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames)
    return [int(x) for x in re.findall(r"<(\d+)>", text)]


def _tunnel_json(stub, rid, method, path, body=None) -> tuple:
    status, _h, chunks = stub.tunnel_request(
        rid, method, path, {"Content-Type": "application/json"},
        json.dumps(body).encode() if body is not None else b"")
    return status, json.loads(b"".join(chunks) or b"{}")


@_timed
def phase_tunnel(smi) -> dict:
    """4k: ``serve-node --tunnel`` and the embedding entry, every request
    through the stand-in control plane's reverse tunnel
    (``testing/control_stub.py``: the runner endpoint ``/api/v1/runners/
    {id}/tunnel`` and ``tunnel_request``).  (1) A bge-base checkpoint
    (``EncoderConfig``'s defaults: 30522 x 768, 12 layers, 12 heads,
    3072, 512 positions, float32, seed 0) with the 30522-entry synthetic
    WordPiece ``tokenizer.json`` is written to a temporary directory.
    (2) Node T (``cli.make_node`` + ``cli.make_tunnel``: serve-node
    ``--tunnel``'s own wiring, in process so its kernel counts are read)
    is assigned the ``v5e1-hotswap`` Llama entry as 4j serves it (its
    checkpoint path dropped: random weights from seed 0, as
    ``--random-weights``) and ``BAAI/bge-base-en-v1.5`` from that
    checkpoint, ``kind: embedding``, ``engine: {max_batch: 64}``; the
    poll-to-``running`` apply and the tunnel's dials are printed.  (4) 64
    texts of 8-512 tokens in one ``/v1/embeddings`` request: max abs and
    least cosine against the plain path on the CPU with the same weights
    (16 of them; the same 16 on the card with TF32 on, the control, must
    break a limit), a 64 x 512 batch timed (median ms, texts/s, tokens/s),
    the entry's bytes beside the reference's 256 MiB estimate.  (5) 8
    greedy chats through the tunnel and the same 8 direct to the unix
    socket, each batch admitted together: ids equal, time to the first
    SSE frame, frames and chunks per stream; K1-int8 and K2 must run.
    (6) A caller stops reading after its first chunk (``OP_CLOSE``, the
    tunnel up): the engine aborts the request long before its
    max_tokens, with no new dial.  The stub closes the websocket
    mid-stream: its caller gets the
    error, the runner dials again, the next chat answers, the slot frees
    and the server's ``handle_error`` (a traceback) never runs.  (7)
    ``python -m helix_tpu_torch serve-node --tunnel`` (process S, its
    host tier off, ``HELIX_DRAIN_SECONDS=60``) serves the same profile:
    the 64 texts give T's vectors, then SIGTERM with 4 streams in flight:
    each ends with its ``finish_reason`` (or a ``migrated`` frame), one
    frame per token, and the process exits 0 with no traceback."""
    import logging
    import signal
    import statistics
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.engine.residency import served_model_bytes, tree_bytes
    from helix_tpu_torch.models import bge
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8
    from helix_tpu_torch.serving.tokenizer import load_tokenizer
    from helix_tpu_torch.testing.control_stub import ControlStub
    from helix_tpu_torch.testing.hf_checkpoint import write_encoder_checkpoint
    from helix_tpu_torch.testing.tokenizer_fixtures import bert_tokenizer_json

    t_phase = time.monotonic()
    tag = f"[tunnel] ({smi})"
    out = {}
    logging.getLogger("helix_tpu_torch").setLevel(logging.INFO)
    tmpdir = tempfile.mkdtemp(prefix="helix-tunnel-")
    stub = ControlStub().start()
    # process S starts now, so its start-up overlaps T's work
    sub_log = open(os.path.join(tmpdir, "serve-node-s.log"), "w+")
    sub = subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch", "serve-node", "--tunnel",
         "--control-plane", stub.url, "--runner-id", "s", "--device",
         "cuda", "--heartbeat-interval", "0.5"],
        stdout=sub_log, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "HELIX_KV_HOST_POOL_BYTES": "0",
             "HELIX_DRAIN_SECONDS": "60"},
        cwd=os.path.dirname(os.path.abspath(__file__)))
    agent = httpd = tunnel = None
    try:
        # (1) the bge-base checkpoint
        t0 = time.monotonic()
        ecfg = bge.EncoderConfig(name=BGE)
        ckpt = os.path.join(tmpdir, "bge-base-en-v1.5")
        drawn = bge.init_params(ecfg, seed=0, device="cpu")
        write_encoder_checkpoint(ckpt, ecfg, drawn)
        with open(os.path.join(ckpt, "tokenizer.json"), "w",
                  encoding="utf-8") as f:
            f.write(bert_tokenizer_json(ecfg.vocab_size))
        n_params = tree_bytes(drawn) // 4
        log(f"{tag} (1) checkpoint {ckpt}: {n_params} parameters, "
            f"{os.path.getsize(os.path.join(ckpt, 'model.safetensors'))} B "
            f"float32, 30522-entry WordPiece tokenizer.json, written in "
            f"{time.monotonic() - t0:.2f} s")
        del drawn
        doc = cli._load_profile(HOTSWAP_PROFILE)
        llama = {k: v for k, v in next(
            m for m in doc["models"] if m["name"] == MODEL).items()
            if k != "checkpoint"}
        prof = {"name": "tunnel-1",
                "requirement": {"vendor": "nvidia", "chips": 1},
                "models": [llama, {"name": BGE, "checkpoint": ckpt,
                                   "kind": "embedding",
                                   "engine": {"max_batch": 64}}]}
        log(f"{tag} cuts: the Llama entry's checkpoint path dropped "
            "(random weights from seed 0, as --random-weights); process S "
            "with HELIX_KV_HOST_POOL_BYTES=0 (a second 16 GiB pinned tier "
            "is not needed to show the exit)")
        stub.assign("s", prof)

        # (2) node T
        def build(**kw):
            served = cli.build_served_model(**kw)
            if served.loop is not None:
                served.tokenizer = _IdTokenizer(served.tokenizer)
            return served

        args = _node_args(stub.url, "t", random_weights=False)
        args.tunnel = True
        args.unix_socket = os.path.join(tmpdir, "t.sock")
        agent, httpd = cli.make_node(args, build_model=build)
        traces = []
        httpd.handle_error = lambda request, address: traces.append(address)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        tunnel = cli.make_tunnel(args, agent, httpd).start()
        stub.wait_for("t", lambda b: b["address"] == "", 60)

        def state():
            return _tunnel_json(stub, "t", "GET", "/api/v1/state")[1]

        a1 = _apply_and_watch(stub, None, "t", prof, "tunnel-1",
                              get_state=state)
        log(f"{tag} (2) node T: apply (poll -> running beat) "
            f"{a1['apply_s']:.2f} s, state route {a1['states']}, longest "
            f"heartbeat gap {a1['max_gap_s']:.2f} s; heartbeat address "
            f"{a1['beat']['address']!r}, models "
            f"{a1['beat']['profile']['models']}; tunnel dials "
            f"{tunnel.connects} (stub {stub.dials.get('t')})")
        if a1["beat"]["address"] != "" or tunnel.connects != 1:
            raise AssertionError(f"{tag} node T's heartbeat or dial")
        served_e = agent.registry.get(BGE)
        runner = served_e.embedder
        loop = agent.registry.get(MODEL).loop

        # (4) embeddings
        tok = load_tokenizer(ckpt, BGE)
        texts = _bge_texts(tok)
        lens = [len(tok.encode(t)) for t in texts]
        t0 = time.monotonic()
        status, edoc = _tunnel_json(stub, "t", "POST", "/v1/embeddings",
                                    {"model": BGE, "input": texts})
        e_s = time.monotonic() - t0
        if status != 200:
            raise AssertionError(f"{tag} embeddings answered {status}: "
                                 f"{edoc}")
        vecs = np.array([d["embedding"] for d in edoc["data"]], np.float32)
        pick = list(range(0, BGE_TEXTS, BGE_TEXTS // BGE_CPU_ROWS))
        t0 = time.monotonic()
        # one row per forward: no padding for the CPU to compute
        on_cpu = runner.to("cpu")
        on_cpu.max_batch = 1
        plain = on_cpu.embed_texts([texts[i] for i in pick])
        del on_cpu
        cpu_s = time.monotonic() - t0
        diff, cos = _vec_gap(vecs[pick], plain)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            c_diff, c_cos = _vec_gap(
                runner.embed_texts([texts[i] for i in pick]), plain)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        norms = np.linalg.norm(vecs, axis=1)
        log(f"{tag} (4) /v1/embeddings: {len(texts)} texts of "
            f"{min(lens)}-{max(lens)} tokens in {e_s * 1e3:.1f} ms through "
            f"the tunnel, shape {vecs.shape}, |v| in [{norms.min():.6f}, "
            f"{norms.max():.6f}], usage {edoc['usage']}; {len(pick)} of "
            f"them against the CPU's plain path ({cpu_s:.1f} s): max abs "
            f"{diff:.3e} (limit {BGE_ABS_TOL}), least cosine {cos:.10f} "
            f"(limit {BGE_COS_MIN}), allow_tf32 {tf32}; the control with "
            f"TF32 on: max abs {c_diff:.3e}, least cosine {c_cos:.10f}")
        if vecs.shape != (BGE_TEXTS, 768) or not np.isfinite(vecs).all() \
                or tf32 or diff > BGE_ABS_TOL or cos < BGE_COS_MIN \
                or edoc["usage"]["prompt_tokens"] != sum(lens):
            raise AssertionError(f"{tag} embeddings disagree")
        if c_diff <= BGE_ABS_TOL and c_cos >= BGE_COS_MIN:
            raise AssertionError(f"{tag} the limits pass TF32's vectors")
        rows = [list(r) for r in np.random.default_rng(1).integers(
            1000, ecfg.vocab_size, BGE_TIMED)]
        runner.embed_tokens(rows)
        times = []
        for _ in range(5):
            t0 = time.monotonic()
            runner.embed_tokens(rows)
            times.append(time.monotonic() - t0)
        med = statistics.median(times)
        held = tree_bytes(runner.params)
        log(f"{tag} (4) a {BGE_TIMED[0]} x {BGE_TIMED[1]} batch: median "
            f"{med * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} "
            f"(wall, host copies in), {BGE_TIMED[0] / med:.1f} texts/s, "
            f"{BGE_TIMED[0] * BGE_TIMED[1] / med:.0f} tokens/s; the entry "
            f"holds {held} B on the card (served_model_bytes "
            f"{served_model_bytes(served_e)} with 10% headroom) against "
            f"the reference's estimate {cli.EMBEDDING_ESTIMATE_BYTES} B")
        out["embed"] = {"max_abs": diff, "cos_min": cos,
                        "tf32_max_abs": c_diff, "tf32_cos_min": c_cos,
                        "median_ms":
                        med * 1e3, "texts_s": BGE_TIMED[0] / med,
                        "tokens_s": BGE_TIMED[0] * BGE_TIMED[1] / med,
                        "bytes": held}

        # (5) chats through the tunnel, then direct; launches from here
        bodies = [{"model": MODEL, "max_tokens": 32, "temperature": 0,
                   "messages": [{"role": "user", "content": p}]}
                  for p in NODE_PROMPTS]
        # the first wave through the tunnel prefills cold (K2); the next
        # two, through the tunnel and direct, start from the same cached
        # prompt pages (int8 KV: a hit reads quantized history), so their
        # shapes and inputs are the same
        K1.launches = K1_INT8.launches = K2.launches = 0
        first = _gated_calls(
            loop, 8, lambda i: _tunnel_stream(stub, "t", bodies[i]))[0]
        tun, _e, _t, t_rel = _gated_calls(
            loop, 8, lambda i: _tunnel_stream(stub, "t", bodies[i]))
        direct, _e, _t, d_rel = _gated_calls(
            loop, 8, lambda i: _unix_stream(args.unix_socket, bodies[i]))
        launches = {"ragged_paged_attention": K1.launches,
                    "ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches}
        same = sum(_ids_of(a["frames"]) == _ids_of(b["frames"])
                   and len(_ids_of(a["frames"])) > 0
                   for a, b in zip(tun, direct))
        ttf = [(o["first"] - t_rel) * 1e3 for o in tun]
        ttf_d = [(o["first"] - d_rel) * 1e3 for o in direct]
        cold = sum(_ids_of(a["frames"]) == _ids_of(b["frames"])
                   for a, b in zip(first, tun))
        log(f"{tag} (5) 8 greedy chats x 32 in 3 waves (tunnel cold, "
            f"tunnel, direct): ids equal through the tunnel and direct: "
            f"{same} of 8 (the cold wave's equal the next: {cold} of 8, "
            f"recorded); first SSE frame p50 "
            f"{statistics.median(ttf):.1f} ms through the tunnel, "
            f"{statistics.median(ttf_d):.1f} ms direct (from the "
            f"release); frames per stream {[len(o['frames']) for o in tun]}"
            f", chunks per stream through the tunnel "
            f"{[o['chunks'] for o in tun]}; launches {launches}")
        if same != 8 or launches["ragged_paged_attention_int8"] <= 0 \
                or launches["flash_attention"] <= 0:
            raise AssertionError(f"{tag} chats or launches: {same} "
                                 f"{launches}")
        out["chats"] = {"same": same, "cold_same": cold,
                        "ttf_ms": statistics.median(ttf),
                        "ttf_direct_ms": statistics.median(ttf_d)}
        out["launches"] = launches

        # (6) the caller stops reading (OP_CLOSE, the tunnel stays up),
        # then the stub hangs up mid-stream
        dials = stub.dials["t"]
        eng = loop.engine
        made, close_s = _closed_early(stub, "t", loop, {
            **bodies[3], "max_tokens": CLOSE_TOKENS, "stream": True})
        freed = all(r is None for r in eng.slots) and not eng.waiting
        log(f"{tag} (6) the caller stopped after its first chunk (OP_CLOSE"
            f"): the engine made {made} of {CLOSE_TOKENS} tokens (limit "
            f"{CLOSE_MAX_MADE}), slots freed {freed} after {close_s:.2f} "
            f"s; dials {stub.dials['t']} (was {dials}), connects "
            f"{tunnel.connects}; server tracebacks {len(traces)}")
        if not 0 < made <= CLOSE_MAX_MADE or not freed \
                or stub.dials["t"] != dials or tunnel.connects != 1 \
                or traces:
            raise AssertionError(f"{tag} OP_CLOSE did not abort")
        out["op_close"] = {"made": made, "freed_s": close_s}
        from helix_tpu_torch.control.tunnel import TunnelClosed

        status, _h, chunks = stub.tunnel_request(
            "t", "POST", "/v1/chat/completions", {}, json.dumps(
                {**bodies[1], "max_tokens": 400, "stream": True}).encode())
        next(chunks)
        stub.drop_tunnel("t")
        caller = None
        try:
            for _c in chunks:
                pass
        except TunnelClosed as e:
            caller = str(e)
        t0 = time.monotonic()
        while stub.dials.get("t", 0) < dials + 1 \
                and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        redial = time.monotonic() - t0
        status, after = _tunnel_json(stub, "t", "POST",
                                     "/v1/chat/completions",
                                     {**bodies[2], "max_tokens": 8})
        t1 = time.monotonic()
        while (any(r is not None for r in eng.slots) or eng.waiting) \
                and time.monotonic() - t1 < 30:
            time.sleep(0.05)
        freed = all(r is None for r in eng.slots) and not eng.waiting
        log(f"{tag} (6) the stub closed the websocket mid-stream: the "
            f"caller got {caller!r}; the runner dialed again after "
            f"{redial:.2f} s (dials {dials} -> {stub.dials['t']}, "
            f"connects {tunnel.connects}); the next chat {status} with "
            f"{after.get('usage', {}).get('completion_tokens')} tokens; "
            f"slots freed {freed}; server tracebacks {len(traces)}")
        if caller is None or stub.dials["t"] != dials + 1 \
                or status != 200 or not freed or traces:
            raise AssertionError(f"{tag} the hang-up")

        # (7) process S: the same vectors, then SIGTERM mid-stream
        stub.wait_for("s", lambda b: b["profile"]["name"] == "tunnel-1"
                      and b["profile"]["status"] in ("running", "failed"),
                      300)
        if stub.last("s")["profile"]["status"] != "running":
            raise AssertionError(f"{tag} process S: "
                                 f"{stub.last('s')['profile']['error']}")
        status, sdoc = _tunnel_json(stub, "s", "POST", "/v1/embeddings",
                                    {"model": BGE, "input": texts})
        svecs = np.array([d["embedding"] for d in sdoc["data"]], np.float32)
        s_diff = float(np.abs(svecs - vecs).max())
        results = [{} for _ in range(SIGTERM_STREAMS)]
        body = {"model": MODEL, "max_tokens": SIGTERM_TOKENS,
                "temperature": 0,
                "messages": [{"role": "user", "content": "Tell a story."}]}
        threads = [threading.Thread(target=_tunnel_stream,
                                    args=(stub, "s", body, results[i]))
                   for i in range(SIGTERM_STREAMS)]
        for t in threads:
            t.start()
        # every stream has its first frame before the signal
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120 and not all(
                r.get("first") for r in results):
            time.sleep(0.005)
        sub.send_signal(signal.SIGTERM)
        t_sig = time.monotonic()
        for t in threads:
            t.join(300)
        rc = sub.wait(300)
        exit_s = time.monotonic() - t_sig
        sub_log.seek(0)
        s_text = sub_log.read()
        ends = []
        for r in results:
            fr = r["frames"]
            fin = fr[-1]["choices"][0].get("finish_reason") if fr and \
                "choices" in fr[-1] else None
            mig = any(f.get("error", {}).get("code") == "migrated"
                      for f in fr)
            tokens = sum(1 for f in fr if "choices" in f)
            whole = (mig or fin == "stop"
                     or (fin == "length" and tokens == SIGTERM_TOKENS))
            ends.append((fin, mig, tokens, r["error"], whole))
        log(f"{tag} (7) process S: 64 vectors against T's max abs "
            f"{s_diff:.3e}; SIGTERM with {SIGTERM_STREAMS} streams in "
            f"flight: (finish_reason, migrated, frames, error, whole) "
            f"{ends}; "
            f"exit code {rc} after {exit_s:.2f} s; tracebacks in its "
            f"output {s_text.count('Traceback')}")
        if status != 200 or s_diff > 1e-5 or rc != 0 \
                or "Traceback" in s_text or any(
                    e[3] is not None or not e[4] or e[2] > SIGTERM_TOKENS
                    for e in ends):
            raise AssertionError(f"{tag} process S:\n{s_text[-3000:]}")
        out["sigterm"] = {"exit": rc, "ends": ends, "exit_s": exit_s}
    finally:
        if sub.poll() is None:
            sub.kill()
        sub_log.close()
        if tunnel is not None:
            tunnel.stop(join=True)
        if agent is not None:
            agent.stop()
            httpd.shutdown()
            httpd.server_close()
        stub.stop()
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
        _free()
    log(f"{tag} phase wall {time.monotonic() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 4l. the disaggregated prefill handoff and the persistent KV filestore
# ---------------------------------------------------------------------------

DISAGG_CHATS = 8
DISAGG_TOKENS = 32            # new tokens per chat at the measured depth
# the measured run's depth: 16 of the entry's 32 layers, a cut for the
# smoke's time limit since phase 4o joined it (4l took 69-100 s at 32)
DISAGG_LAYERS = 16
DISAGG_WITNESS_TOKENS = 64    # at 2 layers in float32
# the restarted node's chat: the wave's system prompt, a user turn no chat
# of the wave had
DISAGG_RESTART_TURN = 10
DISAGG_SOLO_TURN = 11


def _disagg_msgs(i):
    """Chat ``i`` of 4l: the one shared ~1500-token system prompt
    (``_system_prompt(0)``) and a user turn of its own."""
    return _msgs(0, f"Question {i}: what does rule {i} ask for?")


@contextlib.contextmanager
def _launches_by_thread(*forms):
    """Attribute every launch the kernel counters ``forms`` count to the
    thread that made it (each node's engine thread: 4l runs its nodes in
    one process).  Yields ``{(counter name, thread): launches}``;
    each counter still counts every launch as its wrapper adds it."""
    counts: dict = {}
    swapped = []

    def attributed(base, name):
        def get(self):
            return self.__dict__["_launch_n"]

        def put(self, v):
            d = v - self.__dict__.get("_launch_n", 0)
            self.__dict__["_launch_n"] = v
            if d > 0:
                # keyed by the thread object, which the dict keeps alive:
                # an ident is reused once its thread has ended
                key = (name, threading.current_thread())
                counts[key] = counts.get(key, 0) + d

        return type(base.__name__, (base,), {"launches": property(get, put)})

    for form in forms:
        base = type(form)
        form.__dict__["_launch_n"] = form.__dict__.pop("launches")
        form.__class__ = attributed(base, form.name)
        swapped.append((form, base))
    try:
        yield counts
    finally:
        for form, base in swapped:
            n = form.__dict__.pop("_launch_n")
            form.__class__ = base
            form.launches = n


def _ttft_msgs(base, body) -> tuple:
    """A streamed chat of ``body``: (seconds to the first content frame,
    the text, the finish reason)."""
    req = urllib.request.Request(
        base + "/v1/chat/completions",
        data=json.dumps({"model": MODEL, **body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    ttft, text, finish = None, "", None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            frame = json.loads(line[6:])
            if "error" in frame:
                raise AssertionError(f"stream failed: {frame}")
            ch = frame["choices"][0]
            if ch["delta"].get("content") and ttft is None:
                ttft = time.monotonic() - t0
            text += ch["delta"].get("content", "")
            finish = ch["finish_reason"] or finish
    return ttft, text, finish


def _timed_calls(obj, name, log_to: list) -> None:
    """Wrap ``obj.<name>`` (an instance attribute from then on) so each
    call appends (seconds, its positional arguments) to ``log_to``."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.monotonic()
        try:
            return fn(*a, **kw)
        finally:
            log_to.append((time.monotonic() - t0, a))

    setattr(obj, name, run)


def _disagg_run(tag, profs, build, max_tokens, full) -> dict:
    """One run of 4l on ``profs`` (``p``, ``d`` and ``w``: the prefill,
    decode and restarted nodes' profiles), in process against the stub:
    (1) P and D apply their profiles; (2) the handoff wave and the same 8
    chats colocated on D; (3, ``full`` only) the degrade rungs; (4) the
    filestore: P's blobs, P stopped, a restarted node W on the directory
    against a cold node C without it, and (``full`` only) a fresh node X
    after a blob was torn.  Returns the readings and each node's engine
    thread, for the launch counts."""
    import glob
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.engine.kv_cache import PrefixCache
    from helix_tpu_torch.serving import migration
    from helix_tpu_torch.serving.kv_filestore import KVFilestore
    from helix_tpu_torch.serving.tokenizer import ByteTokenizer
    from helix_tpu_torch.testing import faults
    from helix_tpu_torch.testing.control_stub import ControlStub

    out = {"threads": {}}
    fsdir = tempfile.mkdtemp(prefix="helix-kvfs-")
    tmpdir = tempfile.mkdtemp(prefix="helix-disagg-")
    os.environ["HELIX_FILESTORE_KV_DIR"] = fsdir
    stub = ControlStub().start()
    live: dict = {}      # node -> (stop, its HTTP server)
    agents: dict = {}
    bodies = [{"messages": _disagg_msgs(i), "temperature": 0,
               "max_tokens": max_tokens} for i in range(DISAGG_CHATS)]

    def stop(rid):
        halt, httpd = live.pop(rid)
        halt()
        httpd.shutdown()
        httpd.server_close()

    def start_node(rid, prof, dir_on=True):
        """A node serving ``prof`` (serve-node --profile's wiring, no
        control plane), with or without the filestore directory."""
        if dir_on:
            os.environ["HELIX_FILESTORE_KV_DIR"] = fsdir
        else:
            os.environ.pop("HELIX_FILESTORE_KV_DIR", None)
        m0 = torch.cuda.memory_allocated()
        reg, _mgr, httpd, base, _p = _node(prof, tmpdir, rid, build)
        os.environ["HELIX_FILESTORE_KV_DIR"] = fsdir
        loop = reg.get(MODEL).loop
        out["threads"][rid] = loop._thread
        live[rid] = (lambda: reg.unregister(MODEL), httpd)
        return loop, base, torch.cuda.memory_allocated() - m0

    try:
        # (1) P and D through the stub's assignment poll
        mem = {}
        for rid in ("p", "d"):
            m0 = torch.cuda.memory_allocated()
            agent, httpd = cli.make_node(_node_args(stub.url, rid),
                                         build_model=build)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            live[rid] = (agent.stop, httpd)
            agents[rid] = agent
            stub.wait_for(rid, lambda b: True, 60)
            _apply_and_watch(stub, agent.address, rid, profs[rid],
                             profs[rid]["name"])
            mem[rid] = torch.cuda.memory_allocated() - m0
            out["threads"][rid] = agent.registry.get(MODEL).loop._thread
        agent_p, agent_d = agents.pop("p"), agents.pop("d")
        lp = agent_p.registry.get(MODEL).loop
        ld = agent_d.registry.get(MODEL).loop
        roles = (stub.last("p")["role"], stub.last("d")["role"])
        fs_p = lp.engine.kv_filestore
        log(f"{tag} (1) nodes: P role {roles[0]}, D role {roles[1]}; "
            f"device bytes P {mem['p']}, D {mem['d']} (together "
            f"{torch.cuda.memory_allocated()}); P's host tier "
            f"{lp.engine.cfg.host_pool_bytes} B, D's "
            f"{ld.engine.cfg.host_pool_bytes} B; filestore {fsdir} "
            f"(namespace {fs_p.namespace if fs_p else None})")
        if roles != ("prefill", "decode") or fs_p is None \
                or ld.engine.kv_filestore is None:
            raise AssertionError(f"{tag} roles {roles} / filestore "
                                 f"{fs_p}")
        # (2) the handoff wave, with spies on P's export and D's imports
        writes, puts = [], []
        _timed_calls(fs_p.store, "write", writes)
        _timed_calls(fs_p, "put", puts)
        exports = []
        _timed_calls(lp.engine, "export_prefill", exports)
        base_p = agent_p.address
        sample = {}     # the first handoff's wire, for (2)'s codec costs
        eos = set(lp.engine.cfg.eos_token_ids)

        def handoffs(n, body_of):
            """``n`` chats through the stub's plan, admitted together on
            P, spied: (the plan's outputs, the counters' rises, per
            handoff readings, the number delivered exactly once)."""
            wires, d_import, d_events = {}, {}, {}
            to_wire = migration.snapshot_to_wire
            on_event = migration.ImportedStream.on_event
            submit_import = ld.submit_import

            def spy_wire(snap):
                t0 = time.monotonic()
                w = to_wire(snap)
                wires[w["request_id"]] = (w, time.monotonic() - t0)
                sample.setdefault("wire", w)
                return w

            def spy_event(stream, ev):
                d_events.setdefault(stream.request_id, []).append(
                    (time.monotonic(), ev))
                on_event(stream, ev)

            def spy_import(snap, *a, **kw):
                d_import[snap.request_id] = time.monotonic()
                return submit_import(snap, *a, **kw)

            def scrape():
                return _metric(urllib.request.urlopen(
                    base_p + "/metrics", timeout=60).read().decode(),
                    "helix_xfer_prefill_handoffs_total")

            m0, x0 = scrape(), migration.XFER_STATS.snapshot()
            st0 = (lp.stats()["migration"], ld.stats()["migration"])
            migration.snapshot_to_wire = spy_wire
            migration.ImportedStream.on_event = spy_event
            ld.submit_import = spy_import
            try:
                outs, _e, _t, _t0 = _gated_calls(
                    lp, n, lambda i: stub.disagg_request(
                        MODEL, body_of(i), "p", "d"))
            finally:
                migration.snapshot_to_wire = to_wire
                migration.ImportedStream.on_event = on_event
                ld.submit_import = submit_import
            x1 = migration.XFER_STATS.snapshot()
            st1 = (lp.stats()["migration"], ld.stats()["migration"])
            n_ok = max(1, x1["attempts"]["ok"] - x0["attempts"]["ok"])
            rise = {"prefill_exports": st1[0]["prefill_exports"]
                    - st0[0]["prefill_exports"],
                    "imported": st1[1]["imported"] - st0[1]["imported"],
                    "handoffs_metric": scrape() - m0,
                    "ship_s": (x1["ship_seconds"] - x0["ship_seconds"])
                    / n_ok,
                    "wire_b64_bytes": (x1["shipped_bytes"]
                                       - x0["shipped_bytes"]) / n_ok}
            once, per = 0, []
            for o in outs:
                rid = o["request_id"]
                if rid not in wires:
                    per.append(None)
                    continue
                wire, enc_s = wires[rid]
                prior = [t for t in wire["output_tokens"] if t not in eos]
                evs = d_events.get(rid, [])
                new = [ev.token_id for _t, ev in evs
                       if not ev.error and ev.token_id not in eos]
                if _ids(o["text"]) == prior + new and not o["errors"] \
                        and o["finish"] in ("stop", "length"):
                    once += 1
                exp_s = next(s for s, a in exports if a[0] == rid)
                per.append({"export_ms": 1e3 * (exp_s + enc_s),
                            "pages": len(wire["pages"]),
                            "import_to_first_ms": (
                                1e3 * (evs[0][0] - d_import[rid])
                                if evs and rid in d_import
                                else float("nan")),
                            "ttft_s": o["ttft_s"]})
            rise["wire_json_bytes"] = (len(json.dumps(
                next(iter(wires.values()))[0])) if wires else 0)
            return outs, rise, per, once

        def colocated(n, body_of):
            """The same chats on D, admitted together, D's filestore
            tier off (so that P's chats alone write the blobs)."""
            fs_d, ld.engine.kv_filestore = ld.engine.kv_filestore, None
            try:
                got, _e, _t, _t0 = _gated_calls(
                    ld, n, lambda i: _ttft_msgs(agent_d.address,
                                                body_of(i)))
            finally:
                ld.engine.kv_filestore = fs_d
            return got

        outs, rise, per, once = handoffs(DISAGG_CHATS, lambda i: bodies[i])
        colo = colocated(DISAGG_CHATS, lambda i: bodies[i])
        rungs = [o["rung"] for o in outs]
        wave = {**rise, "rungs": rungs, "once": once, "per": per,
                "equal_colocated": sum(_ids(o["text"]) == _ids(c[1])
                                       for o, c in zip(outs, colo)),
                "ttft_handoff": _pcts([o["ttft_s"] for o in outs]),
                "ttft_colocated": _pcts([c[0] for c in colo])}
        out["wave"] = wave
        pcts = {k: _pcts([q[k] for q in per if q])
                for k in ("export_ms", "import_to_first_ms")}
        log(f"{tag} (2) handoff wave of {DISAGG_CHATS} (admitted together "
            f"on P): rungs {rungs}; every token once (client = P's "
            f"emitted + D's new) {once} of {DISAGG_CHATS}; P "
            f"prefill_exports +{wave['prefill_exports']}, D imported "
            f"+{wave['imported']}, helix_xfer_prefill_handoffs_total "
            f"+{wave['handoffs_metric']:.0f} on P's /metrics; per "
            f"handoff: engine-thread export (gather, blake2b, encode) ms "
            f"p50/p95 {pcts['export_ms'][0]:.1f}/{pcts['export_ms'][1]:.1f},"
            f" pages {per[0]['pages'] if per[0] else '?'}, wire "
            f"{wave['wire_json_bytes']} B JSON ({wave['wire_b64_bytes']:.0f}"
            f" B of base64 pages), ship {wave['ship_s']:.3f} s, D's import "
            f"to first token ms p50/p95 "
            f"{pcts['import_to_first_ms'][0]:.1f}/"
            f"{pcts['import_to_first_ms'][1]:.1f}; client TTFT p50/p95 "
            f"through the handoff {wave['ttft_handoff'][0]:.3f}/"
            f"{wave['ttft_handoff'][1]:.3f} s, colocated on D "
            f"{wave['ttft_colocated'][0]:.3f}/"
            f"{wave['ttft_colocated'][1]:.3f} s; ids equal to colocated "
            f"(recorded) {wave['equal_colocated']} of {DISAGG_CHATS}")
        if rungs != ["handoff"] * DISAGG_CHATS or once != DISAGG_CHATS \
                or wave["prefill_exports"] != DISAGG_CHATS \
                or wave["imported"] != DISAGG_CHATS \
                or wave["handoffs_metric"] != DISAGG_CHATS:
            raise AssertionError(f"{tag} handoff wave {wave}")
        # one chat alone (its system prompt cached on both nodes): the
        # handoff's costs without seven others contending for the host
        solo_body = {"messages": _disagg_msgs(DISAGG_SOLO_TURN),
                     "temperature": 0, "max_tokens": max_tokens}
        s_outs, s_rise, s_per, s_once = handoffs(1, lambda i: solo_body)
        s_colo = colocated(1, lambda i: solo_body)
        solo = {**s_rise, "once": s_once, "rung": s_outs[0]["rung"],
                **(s_per[0] or {}), "ttft_colocated": s_colo[0][0],
                "equal_colocated": _ids(s_outs[0]["text"])
                == _ids(s_colo[0][1])}
        out["solo"] = solo
        log(f"{tag} (2) one chat alone, its system prompt cached on P and "
            f"D: rung {solo['rung']}, every token once {s_once == 1}; "
            f"engine-thread export {solo.get('export_ms', float('nan')):.1f}"
            f" ms, ship {solo['ship_s']:.3f} s, D's import to first token "
            f"{solo.get('import_to_first_ms', float('nan')):.1f} ms; client "
            f"TTFT through the handoff {solo.get('ttft_s') or float('nan'):.3f}"
            f" s, colocated on D {solo['ttft_colocated']:.3f} s; ids equal "
            f"(recorded) {solo['equal_colocated']}")
        if solo["rung"] != "handoff" or s_once != 1:
            raise AssertionError(f"{tag} solo handoff {solo}")
        if full:
            codec = out["codec"] = _codec_costs(sample.pop("wire"))
            log(f"{tag} (2) one handoff's wire codec on this host, the "
                f"engines idle (best of 3): serialise "
                f"{codec['json_bytes_ms']:.1f} ms (json.dumps "
                f"{codec['dumps_ms']:.1f}), parse with the "
                f"page decode {codec['json_loads_ms']:.1f} ms (json.loads "
                f"{codec['loads_ms']:.1f}), encode (snapshot_to_wire) "
                f"{codec['encode_ms']:.1f} ms; bytes and pages equal")
        # (3) the degrade rungs: every ship attempt dropped, then every
        # one corrupt; each stream is served whole on P
        if full:
            out["rungs"] = {}
            for k, rule in enumerate(({"mode": "drop"},
                                      {"mode": "corrupt", "page": 0})):
                body = {"messages": _disagg_msgs(DISAGG_CHATS + k),
                        "temperature": 0, "max_tokens": max_tokens}
                d0 = (ld.engine.allocator.free_pages,
                      ld.stats()["migration"]["imported"],
                      ld.migration_failures)
                x0 = migration.XFER_STATS.snapshot()
                faults.arm(seed=0, rules=[{"point": "transfer",
                                           "peer": "d", **rule}])
                try:
                    o = stub.disagg_request(MODEL, body, "p", "d")
                finally:
                    faults.disarm()
                x1 = migration.XFER_STATS.snapshot()
                d1 = (ld.engine.allocator.free_pages,
                      ld.stats()["migration"]["imported"],
                      ld.migration_failures)
                att = {a: x1["attempts"][a] - x0["attempts"][a]
                       for a in x1["attempts"]}
                r = {"rung": o["rung"], "errors": o["errors"],
                     "finish": o["finish"], "tokens": len(_ids(o["text"])),
                     "attempts": att, "d_before": d0, "d_after": d1,
                     "d_idle": not ld.engine.has_work()}
                out["rungs"][rule["mode"]] = r
                log(f"{tag} (3) transfer {rule['mode']} on every attempt: "
                    f"rung {r['rung']}, {r['tokens']} tokens, finish "
                    f"{r['finish']}, errors {r['errors']}; ship attempts "
                    f"{ {a: n for a, n in att.items() if n} }; D (free "
                    f"pages, imported, migration failures) {d0} -> {d1}, "
                    f"idle {r['d_idle']}")
                want_fail = 0 if rule["mode"] == "drop" else \
                    att.get("rejected", 0)
                if r["rung"] != "prefill_local" or r["errors"] \
                        or r["finish"] not in ("stop", "length") \
                        or r["tokens"] == 0 or d1[:2] != d0[:2] \
                        or d1[2] - d0[2] != want_fail \
                        or not r["d_idle"] \
                        or att["ok"] != 0 or (att["unreachable"] if
                                              rule["mode"] == "drop"
                                              else att["rejected"]) == 0:
                    raise AssertionError(f"{tag} degrade rung {r}")
        # (4) the filestore: P's blobs, then P stops
        fs_p.flush(300)
        blobs = glob.glob(os.path.join(fsdir, KVFilestore.OWNER,
                                       fs_p.namespace, "*", "*.json"))
        sizes = [os.path.getsize(b) for b in blobs]
        raw_page = lp.engine.cache_cfg.page_bytes(lp.engine.model_cfg)
        w_bytes = sum(len(a[2]) for _s, a in writes)
        fst = fs_p.stats()
        w_s = sum(s for s, _a in writes)
        put_ms = _pcts([1e3 * s for s, _a in puts])
        log(f"{tag} (4) P's filestore after the flush: {len(blobs)} blobs, "
            f"{np.mean(sizes):.0f} B per page as JSON (raw page "
            f"{raw_page} B); stats {fst}; {len(writes)} disk writes (blobs "
            f"and the usage ledger) of {w_bytes} B in {w_s:.3f} s, "
            f"{w_bytes / max(w_s, 1e-9) / 1e6:.1f} MB/s; the writer's put "
            f"(copy off the card, blake2b, encode, write) ms p50/p95 "
            f"{put_ms[0]:.1f}/{put_ms[1]:.1f} over {len(puts)} calls")
        out["filestore"] = {"blobs": len(blobs),
                            "bytes_per_page": float(np.mean(sizes)),
                            "raw_page": raw_page, "stats": fst,
                            "write_s": w_s, "write_bytes": w_bytes,
                            "put_ms": put_ms}
        if not blobs or fst["stores"] < len(blobs) or fst["corrupt"]:
            raise AssertionError(f"{tag} filestore {fst}")
        t_stop = time.monotonic()
        drain = agent_p.graceful_shutdown(drain=0.5)
        _halt, httpd_p = live.pop("p")
        httpd_p.shutdown()
        httpd_p.server_close()
        log(f"{tag} (4) P stopped through serve-node's SIGTERM path "
            f"(graceful_shutdown, in process) in "
            f"{time.monotonic() - t_stop:.2f} s: {drain}")
        stop("d")
        del lp, ld, agent_p, agent_d, fs_p
        _free()
        # the restarted node W on the directory, the cold node C without
        tok = ByteTokenizer()
        body = {"messages": _disagg_msgs(DISAGG_RESTART_TURN),
                "temperature": 0, "max_tokens": max_tokens}
        ids_w = tok.apply_chat_template(body["messages"],
                                        add_generation_prompt=True)
        ids_0 = tok.apply_chat_template(bodies[0]["messages"],
                                        add_generation_prompt=True)
        common = next((j for j, (a, b) in enumerate(zip(ids_w, ids_0))
                       if a != b), min(len(ids_w), len(ids_0)))
        ps = profs["w"]["models"][0]["engine"]["page_size"]
        shared_pages = common // ps
        lw, base_w, mem_w = start_node("w", profs["w"])
        gets = []
        _timed_calls(lw.engine.kv_filestore, "get", gets)
        ttft_w, text_w, fin_w = _ttft_msgs(base_w, body)
        ew = lw.engine
        rs = {"restored": ew.filestore_restored_pages,
              "hits": ew.kv_filestore.hits,
              "read_ms_per_page": 1e3 * sum(s for s, _d in gets)
              / max(1, len(gets)),
              "restore_ms_per_page": 1e3 * ew.restore_seconds
              / max(1, ew.filestore_restored_pages)}
        stop("w")
        del lw, ew
        _free()
        lc, base_c, _m = start_node("c", {**profs["w"], "name": "cold"},
                                    dir_on=False)
        cold_armed = lc.engine.kv_filestore is not None
        ttft_c, text_c, _f = _ttft_msgs(base_c, body)
        stop("c")
        del lc
        _free()
        rs.update(ttft_warm=ttft_w, ttft_cold=ttft_c,
                  equal=_ids(text_w) == _ids(text_c),
                  shared_pages=shared_pages)
        out["restart"] = rs
        log(f"{tag} (4) restarted node W on the directory (device bytes "
            f"{mem_w}): filestore_restored_pages {rs['restored']} (the "
            f"shared prompt's full pages: {shared_pages}), hits "
            f"{rs['hits']}, blob read + verify {rs['read_ms_per_page']:.2f} "
            f"ms and restore {rs['restore_ms_per_page']:.3f} ms per page; "
            f"TTFT warm {ttft_w:.3f} s against a cold node without the "
            f"directory {ttft_c:.3f} s; greedy ids equal the cold node's "
            f"{rs['equal']} ({'demanded' if not full else 'recorded'})")
        if rs["restored"] < shared_pages or rs["hits"] < shared_pages \
                or fin_w not in ("stop", "length") or cold_armed \
                or (not full and not rs["equal"]):
            raise AssertionError(f"{tag} restart {rs}")
        if full:
            # tear the chain's first blob: a fresh node X counts it
            # corrupt, deletes it, recomputes the prompt and answers
            first = PrefixCache.page_hashes(ids_w, ps,
                                            (len(ids_w) - 1) // ps)[0].hex()
            ns = next(iter(os.listdir(os.path.join(fsdir,
                                                   KVFilestore.OWNER))))
            path = os.path.join(fsdir, KVFilestore.OWNER, ns, first[:2],
                                first + ".json")
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            lx, base_x, _m = start_node("x", {**profs["w"],
                                              "name": "torn"})
            _t, text_x, fin_x = _ttft_msgs(base_x, body)
            fx = lx.engine.kv_filestore
            fx.flush(120)
            tr = {"corrupt": fx.corrupt,
                  "restored": lx.engine.filestore_restored_pages,
                  "stores": fx.stores, "finish": fin_x,
                  "rewritten": KVFilestore(fsdir, ns).get(first)
                  is not None,
                  "equal_cold": _ids(text_x) == _ids(text_c)}
            stop("x")
            del lx, fx
            _free()
            out["torn"] = tr
            log(f"{tag} (4) first blob of the chain torn in half: fresh "
                f"node X counted corrupt {tr['corrupt']}, restored "
                f"{tr['restored']} pages, recomputed and answered "
                f"({tr['finish']}), wrote {tr['stores']} blobs (the torn "
                f"one again, verifying: {tr['rewritten']}); ids equal the "
                f"cold node's {tr['equal_cold']}")
            if tr["corrupt"] != 1 or tr["restored"] != 0 \
                    or tr["finish"] not in ("stop", "length") \
                    or not tr["rewritten"]:
                raise AssertionError(f"{tag} torn blob {tr}")
    finally:
        os.environ.pop("HELIX_FILESTORE_KV_DIR", None)
        for rid in list(live):
            stop(rid)
        stub.stop()
        _free()
    return out


def _codec_costs(wire: dict, reps: int = 3) -> dict:
    """Host ms of one wire's serialise, parse with the page decode, and
    encode, best of ``reps``: the port's ``json_bytes`` / ``json_loads``
    against ``json.dumps`` / ``json.loads`` on the same document, whose
    bytes and decoded pages must agree."""
    from helix_tpu_torch.serving import migration

    def best(fn):
        dts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            dts.append(time.perf_counter() - t0)
        return got, 1e3 * min(dts)

    text, dumps_ms = best(lambda: json.dumps(wire).encode())
    fast, bytes_ms = best(lambda: migration.json_bytes(wire))
    if fast != text:
        raise AssertionError("json_bytes differs from json.dumps")
    del fast
    want, loads_ms = best(
        lambda: migration.wire_to_snapshot(json.loads(text)))
    got, fast_ms = best(
        lambda: migration.wire_to_snapshot(migration.json_loads(text)))
    if any((a[f] is None) != (b[f] is None) or (
            a[f] is not None and not torch.equal(a[f], b[f]))
           for a, b in zip(got.pages, want.pages) for f in a):
        raise AssertionError("json_loads decoded other pages")
    _w, encode_ms = best(lambda: migration.snapshot_to_wire(got))
    return {"dumps_ms": dumps_ms, "json_bytes_ms": bytes_ms,
            "loads_ms": loads_ms, "json_loads_ms": fast_ms,
            "encode_ms": encode_ms, "bytes": len(text)}


@_timed
def phase_disagg(smi) -> dict:
    """4l: the disaggregated prefill handoff and the persistent KV
    filestore tier (A12), in process against the stand-in control plane
    (``testing/control_stub.py``, whose ``disagg_request`` plays the
    reference control plane's one handoff attempt).  Node P applies the
    ``v5e1-hotswap`` Llama entry as written with ``role: prefill``, node
    D the same entry and seed with ``role: decode`` (speculation on, as
    written; its host tier cut), both with one ``HELIX_FILESTORE_KV_DIR``.
    (2) 8 greedy streamed chats over one ~1500-token system prompt go
    through the handoff, admitted together on P: each is exported at its
    first token, shipped to D and resumed there; every token reaches the
    client once (P's emitted tokens, then D's new ones), P's
    ``prefill_exports``, D's ``imported`` and
    ``helix_xfer_prefill_handoffs_total`` rise by 8; the same 8 are then
    sent colocated to D (admitted together, its filestore tier off), and
    their ids' agreement is recorded (bf16 ids depend on the batch shape:
    ROADMAP C).  (3) A transfer dropped on every attempt, and a page
    corrupted on every attempt: each stream is served whole on P, D's
    pool and queue unchanged, both rungs counted.  (4) P's writer is
    flushed (blobs, bytes per page, write MB/s), P stops through
    serve-node's SIGTERM path, a restarted node W on the directory
    restores the shared prompt's pages from disk (TTFT against a cold
    node C without it), and after the chain's first blob is torn a fresh
    node X counts it corrupt, recomputes and answers.  (5) The same wave
    and restart at 2 layers in float32 (the witness): handoff and
    colocated ids 8 of 8 equal, warm equal to cold.  (6) K2 and K1-int8
    launches on P, on D and on the restarted node, from their engine
    threads."""
    import logging

    from helix_tpu_torch import cli
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8

    tag = f"[disagg] ({smi})"
    logging.getLogger("helix_tpu_torch").setLevel(logging.INFO)
    doc = cli._load_profile(HOTSWAP_PROFILE)
    llama = next(m for m in doc["models"] if m["name"] == MODEL)

    def profile(name, role, entry):
        return {"name": name, "role": role,
                "requirement": {"vendor": "nvidia", "chips": 1},
                "models": [entry]}

    written = llama
    llama = {**written, "model_overrides": {"num_layers": DISAGG_LAYERS}}
    log(f"{tag} cut: the measured run at {DISAGG_LAYERS} of 32 layers (a "
        "depth cut for the smoke's time limit)")
    cut = {**llama, "engine": {**llama["engine"], "host_pool_bytes": 0}}
    profs = {"p": profile("disagg-p", "prefill", llama),
             "d": profile("disagg-d", "decode", cut),
             "w": profile("disagg-w", "prefill", llama)}
    wit_entry = {**written,
                 "model_overrides": {"num_layers": 2, "dtype": "float32"},
                 "engine": {**{k: v for k, v in llama["engine"].items()
                               if k != "kv_cache_dtype"},
                            "host_pool_bytes": 0}}
    wit = {"p": profile("wit-p", "prefill", wit_entry),
           "d": profile("wit-d", "decode", wit_entry),
           "w": profile("wit-w", "prefill", wit_entry)}
    log(f"{tag} cut: node D's engine.host_pool_bytes -> 0 (P keeps its "
        "16 GiB tier; two are not needed for the handoff)")
    from helix_tpu_torch.engine.residency import estimate_model_bytes
    from helix_tpu_torch.models.common import CATALOG

    est = estimate_model_bytes(
        dataclasses.replace(CATALOG[MODEL], num_layers=DISAGG_LAYERS),
        llama["engine"], "int8", headroom=0.0)
    log(f"{tag} memory reckoned before the builds: a node holds "
        f"{est} B (int8 weights and 3968 int8 pages of 1,081,344 B, the "
        f"reference's estimate without headroom); P and D together "
        f"{2 * est} B of the card's {torch.cuda.mem_get_info()[1]} B")

    def build(**kw):
        served = cli.build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        return served

    K1.launches = K1_INT8.launches = K2.launches = 0
    with _launches_by_thread(K1, K1_INT8, K2) as by_thread:
        full = _disagg_run(tag, profs, build, DISAGG_TOKENS, full=True)
        launches = {"ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches,
                    "ragged_paged_attention": K1.launches}
        node_launches = {
            rid: {name: by_thread.get((name, thread), 0)
                  for name in ("ragged_paged_attention_int8",
                               "flash_attention")}
            for rid, thread in full["threads"].items()}
    log(f"{tag} (6) launches over the full-width run {launches}; by "
        f"node's engine thread {node_launches}")
    for rid in ("p", "d", "w"):
        if node_launches[rid]["ragged_paged_attention_int8"] <= 0:
            raise AssertionError(f"{tag} K1-int8 never ran on {rid}")
    for rid in ("p", "d"):
        if node_launches[rid]["flash_attention"] <= 0:
            raise AssertionError(f"{tag} K2 never ran on {rid}")
    witness = _disagg_run(tag + " witness, 2 layers float32", wit, build,
                          DISAGG_WITNESS_TOKENS, full=False)
    if witness["wave"]["equal_colocated"] != DISAGG_CHATS:
        raise AssertionError(f"{tag} witness: handoff ids equal to "
                             f"colocated {witness['wave']['equal_colocated']}"
                             f" of {DISAGG_CHATS}")
    log(f"{tag} (5) witness: handoff ids equal to colocated "
        f"{witness['wave']['equal_colocated']} of {DISAGG_CHATS}; warm "
        f"equal to cold {witness['restart']['equal']}")
    return {"launches": launches, "nodes": node_launches, "full": full,
            "witness": witness}


# ---------------------------------------------------------------------------
# 4m. tiered long context and the context-caching API
# ---------------------------------------------------------------------------

CTX_HOT_PAGES = 32
# the measured run's depth: 4 of the entry's 32 layers, a cut for the
# smoke's time limit (at 32 the tiered wave's re-stages took 97-105 s and
# the phase 190 s of a 967 s smoke; 8 until phase 4o joined it, PERF.md);
# widths, pages and the host tier stay the entry's
CTX_LAYERS = 4
# (a)'s wave: 4 chats, not 8 -- with 8 the whole-middle re-stages took
# 109 s of host time and the phase ran past ~180 s on the card (PERF.md)
CTX_CHATS = 4
CTX_API_CHATS = 8            # (b)'s chats carrying context_id
CTX_PROMPT_BYTES = 7850      # ~7880 tokens with the chat template
CTX_NEW_TOKENS = 32
CTX_PREFIX_BYTES = 6000      # (b)'s context
CTX_TENANT_CAP = 8000        # HELIX_CTX_TENANT_TOKENS in (b)


def _ctx_text(rng, n) -> str:
    return "".join(chr(c) for c in rng.integers(97, 123, size=n))


def _ctx_node(tag, entry, tiered, tmpdir, build):
    """A node serving ``entry`` through serve-node's profile path, with
    the operator's ``HELIX_CTX_HOT_PAGES`` set to ``CTX_HOT_PAGES``
    (``tiered``) or 0, and ``HELIX_MAX_PAGES_PER_SEQ`` to the model's
    8192-token context (the entry names no ``context_length``, so its
    tables would stop at the engine's default 128 pages)."""
    os.environ["HELIX_CTX_HOT_PAGES"] = str(CTX_HOT_PAGES if tiered else 0)
    os.environ["HELIX_MAX_PAGES_PER_SEQ"] = str(8192 // 16)
    try:
        prof = {"name": tag, "requirement": {"vendor": "nvidia", "chips": 1},
                "models": [entry]}
        registry, mgr, httpd, base, _path = _node(prof, tmpdir, tag, build)
    finally:
        del os.environ["HELIX_CTX_HOT_PAGES"]
        del os.environ["HELIX_MAX_PAGES_PER_SEQ"]
    return registry.get(MODEL), mgr, httpd, base


def _ctx_close(served, httpd) -> None:
    _stop_side(httpd, served)
    _free()


def _ctx_wave(base, loop, prompts, max_tokens) -> dict:
    """``prompts`` as streamed chats admitted together: TTFTs, texts
    (token ids), seconds, every chat answered with every token once."""
    def send(i):
        body = {"model": MODEL, "max_tokens": max_tokens, "temperature": 0,
                "stream": True,
                "messages": [{"role": "user", "content": prompts[i]}]}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.monotonic()
        ttft, text, finish, frames = None, "", None, 0
        with urllib.request.urlopen(req, timeout=900) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                frame = json.loads(line[6:])
                if "error" in frame:
                    raise AssertionError(f"stream failed: {frame}")
                ch = frame["choices"][0]
                piece = ch["delta"].get("content", "")
                if piece:
                    frames += 1
                    ttft = time.monotonic() - t0 if ttft is None else ttft
                text += piece
                finish = ch["finish_reason"] or finish
        return ttft, text, finish, frames, time.monotonic() - t0

    outs, _e, _t, t0 = _gated_calls(loop, len(prompts), send)
    seconds = time.monotonic() - t0
    for i, (_ttft, text, finish, frames, _s) in enumerate(outs):
        n = text.count("<")
        if frames != n or not (n == max_tokens or finish == "stop"):
            raise AssertionError(
                f"chat {i}: {n} tokens in {frames} frames, finish {finish}")
    ttfts = sorted(o[0] for o in outs)
    toks = sum(o[1].count("<") for o in outs)
    decode_s = max(o[4] for o in outs) - ttfts[0]
    return {"texts": [o[1] for o in outs], "ttft_p50": ttfts[len(ttfts) // 2],
            "ttfts": ttfts, "seconds": seconds,
            "decode_tok_s": (toks - len(outs)) / max(decode_s, 1e-9)}


def _ctx_counts(eng) -> dict:
    return {"demoted": eng.num_ctx_demoted_pages,
            "chunks": eng.num_ctx_stream_chunks,
            "restages": eng.num_ctx_restages,
            "restage_bytes": eng.ctx_restage_bytes,
            "restage_s": eng.ctx_restage_seconds}


def _ctx_phase(tag, entry, build, tmpdir, full: bool) -> dict:
    """(a) and (b) of phase 4m on ``entry``; ``full``: at full width (the
    measured run) or the 2-layer float32 witness, which also demands
    equal ids and plants a corrupt cold page."""
    from helix_tpu_torch.ops.paged_kernel import (
        K1_COLD,
        K1_INT8,
        K1_INT8_COLD,
    )
    from helix_tpu_torch.ops import paged_kernel
    from helix_tpu_torch.testing import faults

    rng = np.random.default_rng(41)
    prompts = [_ctx_text(rng, CTX_PROMPT_BYTES) for _ in range(CTX_CHATS)]
    cold_forms = (K1_COLD, K1_INT8_COLD)
    out = {}
    # (a) the wave, tiered, then the same wave on the same entry resident
    waves = {}
    for tiered in (True, False):
        served, mgr, httpd, base = _ctx_node(
            f"ctx-{'tiered' if tiered else 'resident'}"
            f"{'' if full else '-2l'}", entry, tiered, tmpdir, build)
        loop = served.loop
        eng = loop.engine
        eng.allocator.peak_used = eng.allocator.used_pages
        c0 = _ctx_counts(eng)
        for f in cold_forms:
            f.launches = 0
        plain_calls = [0]
        plain = paged_kernel.ragged_paged_attention_plain

        def counted(*a, **k):
            plain_calls[0] += 1
            return plain(*a, **k)

        paged_kernel.ragged_paged_attention_plain = counted
        tiered_calls = [0]
        attn = eng._paged_attn

        def spy(*a, **k):
            if (len(a) > 8 and a[8] is not None) or k.get("cold"):
                tiered_calls[0] += 1
            return attn(*a, **k)

        eng._paged_attn = spy
        rec0 = loop.window.recorded
        prof = None
        try:
            if full and tiered:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    wave = _ctx_wave(base, loop, prompts, CTX_NEW_TOKENS)
                    torch.cuda.synchronize()
            else:
                wave = _ctx_wave(base, loop, prompts, CTX_NEW_TOKENS)
        finally:
            paged_kernel.ragged_paged_attention_plain = plain
            eng._paged_attn = attn
        c1 = _ctx_counts(eng)
        d = {k: c1[k] - c0[k] for k in c0}
        wave.update(d, peak_pages=eng.allocator.peak_used,
                    cold_launches=sum(f.launches for f in cold_forms),
                    forms={f.name: f.launches for f in cold_forms},
                    tiered_attn_calls=tiered_calls[0],
                    plain_calls=plain_calls[0])
        flight = loop.flight.records(recent=4096)
        wave["flight_cold_max"] = max(
            (r.get("kv_cold_pages", 0) for r in flight), default=0)
        wave["flight_chunks"] = sum(r.get("ctx_stream_chunks", 0)
                                    for r in flight)
        wave["steps"] = loop.window.recorded - rec0
        if prof is not None:
            by_kernel = _kernel_ms(prof)
            busy = sum(by_kernel.values())
            wave["busy_ms"] = busy
            wave["idle_share"] = 1.0 - busy / (wave["seconds"] * 1e3)
            # the cold form by name: its pre-pass, main and merge kernels
            wave["cold_kernel_ms"] = {
                name: sum(t for k, t in by_kernel.items() if name in k)
                for name in ("cold_worklist_kernel", "cold_attend_kernel",
                             "cold_merge_kernel")}
        waves["tiered" if tiered else "resident"] = wave
        if tiered:
            if wave["demoted"] <= 0 or wave["chunks"] <= 0:
                raise AssertionError(f"{tag} nothing demoted or streamed")
            if wave["cold_launches"] <= 0 or wave["plain_calls"]:
                raise AssertionError(
                    f"{tag} cold launches {wave['cold_launches']}, plain "
                    f"op calls {wave['plain_calls']}")
            if wave["cold_launches"] != wave["tiered_attn_calls"]:
                raise AssertionError(
                    f"{tag} {wave['cold_launches']} cold launches for "
                    f"{wave['tiered_attn_calls']} tiered attention calls")
            if wave["flight_chunks"] <= 0 or wave["flight_cold_max"] <= 0:
                raise AssertionError(f"{tag} the flight record shows no "
                                     "cold pages")
            if "cold_kernel_ms" in wave:
                ck = wave["cold_kernel_ms"]
                log(f"{tag} (a) K1-int8-tiered traced by name at "
                    f"{CTX_LAYERS} layers: "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in ck.items())
                    + f", {sum(ck.values()):.3f} ms in all "
                    f"({sum(ck.values()) / wave['busy_ms']:.4f} of the "
                    f"wave's device busy time) over "
                    f"{wave['forms']['ragged_paged_attention_int8_cold']} "
                    "launches")
                if min(ck.values()) <= 0:
                    raise AssertionError(f"{tag} the trace misses a cold "
                                         f"kernel: {ck}")
            log(f"{tag} (a) restages (chunks, bytes, s, of which read "
                "back and verified, of which packed): "
                + ", ".join(f"({n}, {b}, {s:.3f}, {v:.3f}, {p:.3f})"
                            for n, b, s, v, p in
                            list(eng.ctx_restage_log)[-d["restages"]:]))
            # (c) the corrupt cold page, witness only
            if not full:
                out["corrupt"] = _ctx_corrupt(tag, base, eng, prompts[0])
            # (b) the context-caching API on the tiered node
            out["context"] = _ctx_api(tag, base, loop, eng, rng, full)
        elif not full:
            # the witness: context chats inline on the resident node
            out["context_inline"] = _ctx_inline(base, loop, out["context"])
        _ctx_close(served, httpd)
    t, r = waves["tiered"], waves["resident"]
    same = sum(a == b for a, b in zip(t["texts"], r["texts"]))
    # tokens each tiered chat shares with its resident run before they
    # part
    agree = [next((i for i, (x, y) in enumerate(zip(a.split(">"),
                                                    b.split(">")))
                   if x != y), a.count("<"))
             for a, b in zip(t["texts"], r["texts"])]
    out.update(waves=waves, equal=same, agree=agree)
    log(f"{tag} (a) {CTX_CHATS} chats of ~{CTX_PROMPT_BYTES} tokens, "
        f"{CTX_NEW_TOKENS} new each: tiered demoted {t['demoted']} pages, "
        f"streamed {t['chunks']} chunks, {t['restages']} re-stages "
        f"({t['restage_bytes'] / 1e9:.3f} GB, {t['restage_s']:.3f} s); "
        f"peak pool pages tiered {t['peak_pages']} vs resident "
        f"{r['peak_pages']}; TTFT p50 {t['ttft_p50']:.3f} s vs "
        f"{r['ttft_p50']:.3f} s; decode {t['decode_tok_s']:.1f} vs "
        f"{r['decode_tok_s']:.1f} tok/s; wave {t['seconds']:.2f} s vs "
        f"{r['seconds']:.2f} s; kv_cold_pages in the flight record up to "
        f"{t['flight_cold_max']}; cold launches {t['cold_launches']} = "
        f"tiered attention calls {t['tiered_attn_calls']}, plain op calls "
        f"{t['plain_calls']}; tiered ids equal to resident {same} of "
        f"{CTX_CHATS} (tokens shared before they part: {agree})"
        + (f"; traced busy {t['busy_ms']:.1f} ms, idle share "
           f"{t['idle_share']:.3f}" if "busy_ms" in t else ""))
    if 2 * t["peak_pages"] > r["peak_pages"]:
        raise AssertionError(f"{tag} tiered peak {t['peak_pages']} is more "
                             f"than half the resident {r['peak_pages']}")
    if not full:
        if same != CTX_CHATS:
            raise AssertionError(f"{tag} tiered ids equal resident {same} "
                                 f"of {CTX_CHATS}")
        ci = out["context_inline"]
        log(f"{tag} (c) completions through the handle equal the prompts "
            f"written out {ci['equal']} of {CTX_API_CHATS}")
        if ci["equal"] != CTX_API_CHATS:
            raise AssertionError(f"{tag} context completions equal inline "
                                 f"{ci['equal']} of {CTX_API_CHATS}")
    return out


def _ctx_corrupt(tag, base, eng, prompt) -> dict:
    """A streamed chat alone; once it has emitted tokens, its next cold
    read finds a page corrupted: the stream must end in an error naming
    the cold page (the loop retries, the page is gone, the request is
    evicted), not run to its end."""
    from helix_tpu_torch.testing import faults

    body = {"model": MODEL, "max_tokens": 64, "temperature": 0,
            "stream": True, "messages": [{"role": "user",
                                          "content": prompt}]}
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    c0 = eng.host_pool.corrupt_pages
    f0 = len(STEP_FAILURES)
    n, error = 0, None
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                frame = json.loads(line[6:])
                if "error" in frame:
                    error = frame["error"]["message"]
                    break
                n += frame["choices"][0]["delta"].get("content",
                                                      "").count("<")
                if n and faults.active() is None:
                    faults.arm(rules=[{"point": "host_pool",
                                       "op": "restore", "mode": "corrupt",
                                       "times": 1}])
    finally:
        faults.disarm()
    corrupt = eng.host_pool.corrupt_pages - c0
    planted = STEP_FAILURES[f0:]
    CORRUPT_PAGE_FAILURES.extend(f for f in planted if "ColdPageError" in f[2])
    if error is None or "cold KV page" not in error or corrupt < 1 \
            or len(CORRUPT_PAGE_FAILURES) != len(planted):
        raise AssertionError(f"{tag} corrupt cold page: {n} tokens, error "
                             f"{error!r}, corrupt pages {corrupt}")
    log(f"{tag} (c) corrupt cold page: the stream ended after {n} of 64 "
        f"tokens with {error[:200]!r}; corrupt pages counted {corrupt}")
    return {"tokens": n, "error": error, "corrupt_pages": corrupt}


def _ctx_turns(rng) -> list:
    return [f"Question {i}: " + _ctx_text(rng, 40)
            for i in range(CTX_API_CHATS)]


def _ctx_api(tag, base, loop, eng, rng, full) -> dict:
    """(b): a ~6000-token context created twice (the second ``cached``),
    listed, then 8 chats carrying its ``context_id`` (admitted together),
    a quota 429, an unknown handle's 404 and the ``helix_ctx_*``
    series."""
    prefix = [{"role": "system", "content": _ctx_text(rng, CTX_PREFIX_BYTES)}]
    body = {"model": MODEL, "messages": prefix}
    t0 = time.monotonic()
    first = json.loads(_post(base + "/v1/context", body))
    create_s = time.monotonic() - t0
    again = json.loads(_post(base + "/v1/context", body))
    if first["cached"] or not again["cached"] or again["id"] != first["id"]:
        raise AssertionError(f"{tag} create {first} then {again}")
    listed = json.loads(urllib.request.urlopen(base + "/v1/context",
                                               timeout=60).read())
    if first["id"] not in [e["id"] for e in listed["data"]]:
        raise AssertionError(f"{tag} the handle is not listed: {listed}")
    turns = _ctx_turns(rng)
    hits0 = eng.prefix_hit_tokens_by_adapter.get("", 0)

    def send(i):
        t = time.monotonic()
        got = json.loads(_post(base + "/v1/chat/completions", {
            "model": MODEL, "max_tokens": 16, "temperature": 0,
            "context_id": first["id"],
            "messages": [{"role": "user", "content": turns[i]}]}))
        return got, time.monotonic() - t

    outs, _e, _t, _t0 = _gated_calls(loop, CTX_API_CHATS, send)
    # the engine's TTFT of each chat (submit to first token)
    ttfts = sorted(list(eng.recent_ttfts)[-CTX_API_CHATS:])
    hit_tokens = eng.prefix_hit_tokens_by_adapter.get("", 0) - hits0
    full_pages = (first["tokens"] - 1) // 16
    usage = [o[0]["usage"]["prompt_tokens"] for o in outs]
    if any(u <= first["tokens"] for u in usage):
        raise AssertionError(f"{tag} usage does not charge the span: "
                             f"{usage}")
    if hit_tokens < CTX_API_CHATS * full_pages * 16:
        raise AssertionError(f"{tag} prefix-hit tokens {hit_tokens} < "
                             f"{CTX_API_CHATS} x {full_pages} pages x 16")
    lat = sorted(o[1] for o in outs)
    status, err = _error_of(base, {
        "model": MODEL, "context_id": "ctx-" + "0" * 24,
        "messages": [{"role": "user", "content": "hi"}]})
    if status != 404 or err["error"].get("code") != "context_not_found":
        raise AssertionError(f"{tag} unknown handle: {status} {err}")
    status_q, err_q = _error_of(base, {
        "model": MODEL, "messages": [{"role": "system", "content":
                                      _ctx_text(rng, 3000)}]},
        path="/v1/context")
    if status_q != 429 or err_q["error"].get("code") != \
            "context_quota_exceeded":
        raise AssertionError(f"{tag} quota: {status_q} {err_q}")
    metrics = urllib.request.urlopen(base + "/metrics",
                                     timeout=60).read().decode()
    ctx_lines = [ln for ln in metrics.splitlines()
                 if ln.startswith("helix_ctx_")]
    vals = {ln.split()[0]: float(ln.split()[1]) for ln in ctx_lines}
    if vals.get("helix_ctx_hits_total", 0) < CTX_API_CHATS or \
            vals.get("helix_ctx_quota_rejects_total", 0) < 1 or \
            vals.get("helix_ctx_misses_total", 0) < 1:
        raise AssertionError(f"{tag} helix_ctx_* {vals}")
    texts = [o[0]["choices"][0]["message"]["content"] for o in outs]
    extra = {}
    if not full:
        # the witness: a text prefix as another tenant's context, and 8
        # completions through its handle (held to the same prompts
        # written out on the resident node)
        text_prefix = _ctx_text(rng, CTX_PREFIX_BYTES)
        req = urllib.request.Request(
            base + "/v1/context", data=json.dumps(
                {"model": MODEL, "prompt": text_prefix}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Helix-Tenant": "witness"})
        with urllib.request.urlopen(req, timeout=600) as r:
            handle = json.loads(r.read())["id"]
        extra = {"text_prefix": text_prefix, "completions":
                 _ctx_completions(base, loop, text_prefix, turns, handle)}
    log(f"{tag} (b) context {first['id']} of {first['tokens']} tokens: "
        f"create {create_s:.3f} s, again cached, listed; {CTX_API_CHATS} "
        f"chats with context_id: prefix-hit tokens {hit_tokens} (>= "
        f"{CTX_API_CHATS} "
        f"x {full_pages} pages x 16), usage prompt_tokens {usage}, TTFT "
        f"p50 {ttfts[len(ttfts) // 2]:.3f} s and latency p50 "
        f"{lat[len(lat) // 2]:.3f} s (16 tokens each) vs the create's "
        f"{create_s:.3f} s; 404 {err['error']['code']}, 429 "
        f"{err_q['error']['code']}; /metrics {vals}")
    return {"id": first["id"], "prefix": prefix, "turns": turns,
            "texts": texts, "create_s": create_s, "hit_tokens": hit_tokens,
            "latency_p50": lat[len(lat) // 2],
            "ttft_p50": ttfts[len(ttfts) // 2], "metrics": vals, **extra}


def _ctx_completions(base, loop, prefix, turns, context_id=None) -> list:
    """Completions of ``prefix + turn`` (the byte tokenizer encodes by
    concatenation), the prefix by ``context_id`` when given, else written
    out; admitted together.  Their texts (token ids)."""
    def send(i):
        body = {"model": MODEL, "max_tokens": 16, "temperature": 0,
                "prompt": turns[i] if context_id else prefix + turns[i]}
        if context_id:
            body["context_id"] = context_id
        got = json.loads(_post(base + "/v1/completions", body))
        return got["choices"][0]["text"]

    texts, _e, _t, _t0 = _gated_calls(loop, len(turns), send)
    return texts


def _ctx_inline(base, loop, ctx) -> dict:
    """The witness's context completions again with the prefix written
    out (no handle) on the resident node: their ids against the
    handle's."""
    texts = _ctx_completions(base, loop, ctx["text_prefix"], ctx["turns"])
    return {"equal": sum(a == b for a, b in zip(texts, ctx["completions"]))}


@_timed
def phase_context(smi) -> dict:
    """4m: tiered long context and the context-caching API on the
    ``v5e1-hotswap`` Llama entry at ``CTX_LAYERS`` (4) of its 32 layers,
    served through serve-node's profile path with
    ``HELIX_CTX_HOT_PAGES=32`` and ``HELIX_MAX_PAGES_PER_SEQ=512`` (int8
    weights and KV, 3968 pages, its 16 GiB host tier, speculation on).
    (a) ``CTX_CHATS`` (4) streamed chats of distinct ~7,880-token
    prompts, 32 new tokens each, admitted together, then the same wave on
    the entry with tiering off: every chat answered with every token once; demoted pages, cold
    chunks streamed, slab re-stages (count, bytes, seconds, each one),
    peak pool pages (the tiered peak at most half the resident one), TTFT
    p50, decode tok/s, the tiered wave's traced device busy time and idle
    share, ``kv_cold_pages`` from the flight record; every tiered
    attention call launches K1's cold form, the plain op never runs.
    Tiered ids against resident are recorded (bf16 with int8 KV depends
    on the shapes: ROADMAP C).  (b) ``POST /v1/context`` of a ~6000-token
    prefix twice (the same id, ``cached: true``), ``GET`` listing it, 8
    chats with ``context_id`` (prefix-hit tokens, ``usage``, latency
    against the create's), a 429 past ``HELIX_CTX_TENANT_TOKENS``, an
    unknown handle's 404, ``helix_ctx_*`` at ``/metrics``.  (c) the same
    at 2 layers in float32, where tiered ids must equal resident (all of
    the wave), 8 completions through a text context's handle must equal
    the same prompts written out on the resident node, and a corrupt cold
    page must end its stream with the ``ColdPageError`` text."""
    import tempfile

    from helix_tpu_torch import cli

    tag = f"[context] ({smi})"
    doc = cli._load_profile(HOTSWAP_PROFILE)
    written = next(m for m in doc["models"] if m["name"] == MODEL)
    llama = {**written, "model_overrides": {"num_layers": CTX_LAYERS}}
    log(f"{tag} cut: the measured run at {CTX_LAYERS} of 32 layers (a "
        f"depth cut for the smoke's time limit)")
    wit = {**written, "model_overrides": {"num_layers": 2,
                                        "dtype": "float32"},
           "engine": {k: v for k, v in llama["engine"].items()
                      if k != "kv_cache_dtype"}}

    def build(**kw):
        served = cli.build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        return served

    res = {}
    tmp = tempfile.mkdtemp(prefix="helix-ctx-")
    try:
        for key, entry, full in (("full", llama, True),
                                 ("witness", wit, False)):
            fs = os.path.join(tmp, f"fs-{key}")
            os.environ["HELIX_FILESTORE_KV_DIR"] = fs
            os.environ["HELIX_CTX_TENANT_TOKENS"] = str(CTX_TENANT_CAP)
            try:
                res[key] = _ctx_phase(
                    tag + ("" if full else " witness, 2 layers float32"),
                    entry, build, tmp, full)
            finally:
                del os.environ["HELIX_FILESTORE_KV_DIR"]
                del os.environ["HELIX_CTX_TENANT_TOKENS"]
    finally:
        # the filestore writers may still close files: a best effort
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(res["full"]["waves"]["tiered"]["forms"])
    for name, n in res["witness"]["waves"]["tiered"]["forms"].items():
        launches[name] = launches[name] or n
    return {"launches": launches, "result": res}


# ---------------------------------------------------------------------------
# 4n. Qwen2-VL vision serving
# ---------------------------------------------------------------------------

VL_MODEL = "Qwen/Qwen2-VL-7B-Instruct"
VL_EMBED = "Qwen/Qwen2-VL-7B-Instruct:vision-embedding"
VL_PROFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "profiles", "v5e8-llama3-plus-embed.yaml")
# (height, width) of the generated images: 1280x960 resizes to 840x1148,
# 4,920 patches and 1,230 image tokens
VL_SIZES = ((224, 224), (448, 448), (480, 640), (960, 1280))
VL_TOKENS = 64
VL_WITNESS_TOKENS = 16
# one layer of each tower: the witness's CPU half took 61-77 s at 2
# (a depth cut for the smoke's time since phase 4o joined it)
VL_WITNESS_LAYERS = 1
# the measured run's depth: 14 of the text tower's 28 layers and 14 of
# the vision tower's 32 blocks, a cut for the smoke's time limit since
# phase 4o joined it (4n took 117-132 s at full depth)
VL_LAYERS = 14
# the profile entry's 128-page tables stop at 2048 tokens, below its
# max_prefill_len 4096: the operator knob widens them so a prompt past
# max_prefill_len meets the VL refusal, as phase 4m widens its entry's
VL_MAX_PAGES_PER_SEQ = "512"


def _vl_configs(layers=None, dtype="bfloat16") -> tuple:
    """Qwen/Qwen2-VL-7B-Instruct's text and vision configs, from its
    public config.json; ``layers`` cuts both towers' depth."""
    from helix_tpu_torch.models.common import ModelConfig
    from helix_tpu_torch.models.qwen2_vl import VisionConfig

    text = ModelConfig(
        vocab_size=152064, hidden_size=3584, num_layers=layers or 28,
        num_heads=28, num_kv_heads=4, head_dim=128,
        intermediate_size=18944, rope_theta=1e6, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_bias=True,
        max_position_embeddings=32768, mrope_sections=(16, 24, 24),
        dtype=dtype, name=VL_MODEL)
    vision = VisionConfig(depth=layers or 32, embed_dim=1280,
                          hidden_size=3584, num_heads=16, mlp_ratio=4,
                          patch_size=14, spatial_merge_size=2,
                          temporal_patch_size=2)
    return text, vision


def _vl_entry(checkpoint, kind="vision", name=VL_MODEL) -> dict:
    """The profile's Qwen2-VL entry with only its mesh cut to ``{tp: 1}``
    (and its checkpoint path pointing at the written one)."""
    from helix_tpu_torch.cli import _load_profile

    doc = _load_profile(VL_PROFILE)
    (entry,) = [m for m in doc["models"] if m["name"] == VL_MODEL]
    return {**entry, "name": name, "kind": kind, "mesh": {"tp": 1},
            "checkpoint": checkpoint}


def _vl_spec(entry) -> dict:
    from helix_tpu_torch import cli
    from helix_tpu_torch.control.profile import ServingProfile

    (spec,) = cli.model_specs(ServingProfile.from_dict(
        {"name": "vl", "models": [entry]}))
    return spec


def _png_url(png: bytes) -> str:
    import base64

    return "data:image/png;base64," + base64.b64encode(png).decode()


def _vl_chats(pngs, model=VL_MODEL) -> list:
    """The 8 chats of the wave: one image each at the four sizes, two
    more at 224 and 1280x960 (other images), two images in one chat,
    and one of text only."""
    def img(k):
        return {"type": "image_url", "image_url": {"url": _png_url(pngs[k])}}

    parts = [[img(0)], [img(1)], [img(2)], [img(3)], [img(4)], [img(5)],
             [img(1), img(2)], []]
    out = []
    for i, p in enumerate(parts):
        text = {"type": "text", "text": f"Chat {i}: describe what you see "
                                        "in one line."}
        out.append({"model": model, "messages": [
            {"role": "user", "content": [text] + p if p else text["text"]}]})
    return out


def _vl_images(rng) -> list:
    from helix_tpu_torch.testing.png import random_png

    sizes = list(VL_SIZES) + [(224, 224), (960, 1280)]
    return [random_png(rng, h, w) for h, w in sizes]


def _host_image_ms(pngs, vcfg) -> list:
    """Host milliseconds per image size: PNG decode, the bicubic resize
    alone, and patchify (the resize, normalise and patch order), 3 runs
    each, the least."""
    from helix_tpu_torch.serving.vision import (
        decode_image,
        patchify,
        resize_bicubic,
        smart_resize,
    )

    out = []
    for (h, w), png in zip(VL_SIZES, pngs):
        best = [float("inf")] * 3
        for _ in range(3):
            t0 = time.perf_counter()
            img = decode_image(png)
            t1 = time.perf_counter()
            h2, w2 = smart_resize(h, w, vcfg.patch_size
                                  * vcfg.spatial_merge_size)
            resize_bicubic(img, w2, h2)
            t2 = time.perf_counter()
            patches, grid = patchify(img)
            t3 = time.perf_counter()
            best = [min(a, b) for a, b in zip(best, (
                t1 - t0, t2 - t1, t3 - t2))]
        out.append({"size": f"{h}x{w}", "resized": f"{h2}x{w2}",
                    "patches": int(patches.shape[0]),
                    "decode_ms": best[0] * 1e3, "resize_ms": best[1] * 1e3,
                    "patchify_ms": best[2] * 1e3})
    return out


def _tower_ms(runner, pngs) -> list:
    """Device milliseconds of the vision tower per image size (CUDA
    events, mean of 3 after one warm call) and its peak memory rise."""
    from helix_tpu_torch.models.qwen2_vl import vision_forward
    from helix_tpu_torch.serving.vision import decode_image, patchify

    out = []
    for (h, w), png in zip(VL_SIZES, pngs):
        patches, grid = patchify(decode_image(png))
        x = torch.from_numpy(patches).to("cuda")

        def run():
            with torch.no_grad():
                return vision_forward(runner.vparams, runner.vcfg, x, [grid])

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, 3, warmup=1, queued=False)
        out.append({"size": f"{h}x{w}", "patches": int(patches.shape[0]),
                    "tower_ms": ms, "peak_rise_gib":
                    (torch.cuda.max_memory_allocated() - base) / 2**30})
    return out


def _vl_ids(text) -> list:
    return [int(t) for t in re.findall(r"<(\d+)>", text)]


# the witness's max-abs limit on image embeddings: phase 4k's 1e-5, or
# this many times the CPU's own float32 spread where that is larger.  The
# tower's outputs are not unit vectors (values up to ~7.5 at 2 layers,
# where 4k's vectors are ~0.05), and the same float32 function summed in
# another order already moves them by a few 1e-6: the spread is measured
# by running the CPU's tower with its residual width permuted
# (``_permuted_vision_params``), which reorders every reduction over it
# and changes nothing else.  The card's GEMMs block the sums in yet other
# orders, each about as far from exact
VL_SPREAD_FACTOR = 4.0


def _permuted_vision_params(vp, vcfg, seed=0) -> dict:
    """The tower's parameters with its residual width E permuted by a
    seeded permutation: the same function (outputs equal in exact
    arithmetic), every sum over E taken in another order."""
    E = vcfg.embed_dim
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(E))
    full = torch.cat([perm + j * E
                      for j in range(vcfg.spatial_merge_size**2)])
    b = vp["blocks"]
    m = vp["merger"]

    def cols(d):
        return {"weight": d["weight"][..., perm], "bias": d["bias"][..., perm]}

    return {
        "patch_embed": {"weight": vp["patch_embed"]["weight"][:, perm]},
        "blocks": {
            "norm1": cols(b["norm1"]), "norm2": cols(b["norm2"]),
            "qkv": {"weight": b["qkv"]["weight"][:, perm],
                    "bias": b["qkv"]["bias"]},
            "proj": cols(b["proj"]),
            "fc1": {"weight": b["fc1"]["weight"][:, perm],
                    "bias": b["fc1"]["bias"]},
            "fc2": cols(b["fc2"]),
        },
        "merger": {"ln_q": cols(m["ln_q"]),
                   "mlp0": {"weight": m["mlp0"]["weight"][full],
                            "bias": m["mlp0"]["bias"]},
                   "mlp2": m["mlp2"]},
    }


def _vl_witness(pngs, smi) -> dict:
    """4n's float32 witness: the entry at ``VL_WITNESS_LAYERS`` (1) of both
    towers in float32 (TF32 off), random weights of seed 0 on the card
    and the same weights copied to the CPU; each of the 8 chats prepared
    by both runners (image embeddings held to max abs <= 1e-5, or 4x the
    CPU's own float32 spread where larger (``VL_SPREAD_FACTOR``: the CPU
    tower with its residual width permuted against it), and least cosine
    >= 0.999999; the same on the card with TF32 on, the control, must
    break a limit) and decoded greedily: on the card by a server of the
    entry that gets the 8 chats at once (each one's tower launched on
    its handler thread while the engine thread steps the others), on the
    CPU by one engine; the ids must agree 8 of 8."""
    from helix_tpu_torch import cli
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.llama import init_params, params_to
    from helix_tpu_torch.models.qwen2_vl import init_vision_params
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1
    from helix_tpu_torch.serving.registry import ServedModel
    from helix_tpu_torch.serving.tokenizer import ByteTokenizer
    from helix_tpu_torch.serving.vision import VisionRunner

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, vcfg = _vl_configs(VL_WITNESS_LAYERS, "float32")
    params = init_params(cfg, 0, device="cuda")
    vparams = init_vision_params(vcfg, 1, device="cuda")
    cpu_params, cpu_vparams = params_to(params, "cpu"), params_to(
        vparams, "cpu")
    ids = dict(image_pad_id=264, vision_start_id=265, vision_end_id=266)
    tok = ByteTokenizer()
    chats = _vl_chats(pngs)
    ecfg = EngineConfig(**_vl_entry(None)["engine"])
    eos = set(tok.eos_ids)
    # the card: the 8 chats sent at once to a server of the entry, each
    # prepared (the tower launched) on its handler thread while the
    # engine thread steps the chats admitted before it
    runner = VisionRunner(vcfg, vparams, **ids)
    served = ServedModel(
        name=VL_MODEL, loop=cli.make_engine_loop(
            Engine(cfg, params, ecfg, device="cuda"), VL_MODEL),
        tokenizer=_IdTokenizer(tok), kind="vision", vision=runner)
    httpd, base, registry = _start_server(served)
    k0 = (K1.launches, K2.launches)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda c: json.loads(_post(
                base + "/v1/chat/completions",
                {**c, "max_tokens": VL_WITNESS_TOKENS, "temperature": 0})),
                chats))
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.loop.stop()
        registry.unregister(VL_MODEL)
    runs = {"card": {
        "fields": [runner.prepare(c["messages"], tok) for c in chats],
        "ids": [_vl_ids(o["choices"][0]["message"]["content"])
                for o in outs],
        "launches": (K1.launches - k0[0], K2.launches - k0[1])}}
    # the CPU: the same chats in one engine, stepped to the end (a chat
    # without images takes the chat template, as the server gives it)
    cpu_runner = VisionRunner(vcfg, cpu_vparams, **ids)
    fields = [cpu_runner.prepare(c["messages"], tok) for c in chats]
    prompts = [f if f["image_embeds"] is not None else {
        "prompt_tokens": tok.apply_chat_template(c["messages"])}
        for f, c in zip(fields, chats)]
    eng = Engine(cfg, cpu_params, ecfg, device="cpu")
    reqs = [Request(id=f"w{i}", stop_token_ids=tuple(eos),
                    sampling=SamplingParams(temperature=0.0,
                                            max_tokens=VL_WITNESS_TOKENS),
                    **f) for i, f in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    runs["cpu"] = {"fields": fields, "ids": [
        [t for t in r.output_tokens if t not in eos] for r in reqs]}
    del eng, served
    embeds = [(a["image_embeds"], b["image_embeds"]) for a, b in zip(
        runs["card"]["fields"], runs["cpu"]["fields"])
        if a["image_embeds"] is not None]
    got = np.concatenate([a.cpu().numpy() for a, _ in embeds])
    want = np.concatenate([b.numpy() for _, b in embeds])
    diff, cos = _vec_gap(got, want)
    # the CPU's own float32 spread on the same images
    permuted = VisionRunner(vcfg, _permuted_vision_params(cpu_vparams, vcfg),
                            **ids)
    alt = np.concatenate([f["image_embeds"].numpy() for f in (
        permuted.prepare(c["messages"], tok) for c in chats)
        if f["image_embeds"] is not None])
    spread = float(np.abs(alt - want).max())
    abs_limit = max(BGE_ABS_TOL, VL_SPREAD_FACTOR * spread)
    # the control: the card's tower with TF32 on
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runner = VisionRunner(vcfg, vparams, **ids)
        ctl = np.concatenate([runner.prepare(c["messages"], tok)[
            "image_embeds"].cpu().numpy() for c in chats
            if runs["cpu"]["fields"][chats.index(c)]["image_embeds"]
            is not None])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    c_diff, c_cos = _vec_gap(ctl, want)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    agree = sum(a == b for a, b in zip(runs["card"]["ids"],
                                       runs["cpu"]["ids"]))
    log(f"[vision witness] {smi}: {VL_WITNESS_LAYERS} layer(s) float32, "
        f"{len(got)} image "
        f"tokens (values up to {np.abs(want).max():.2f}): the CPU's own "
        f"spread {spread:.3e} (its residual width permuted), "
        f"card vs CPU max abs {diff:.3e} (limit {abs_limit:.3e}), "
        f"least cosine {cos:.10f} (limit {BGE_COS_MIN}); TF32 on (control) "
        f"max abs {c_diff:.3e}, least cosine {c_cos:.10f}; greedy ids "
        f"{agree}/8 equal to the CPU run; card launches K1 "
        f"{runs['card']['launches'][0]}, K2 {runs['card']['launches'][1]}")
    if not (diff <= abs_limit and cos >= BGE_COS_MIN):
        raise AssertionError("vision witness: the card's image embeddings "
                             "are past the limits")
    if c_diff <= abs_limit and c_cos >= BGE_COS_MIN:
        raise AssertionError("vision witness: TF32's embeddings pass the "
                             "limits")
    if agree != 8:
        raise AssertionError(f"vision witness: {agree}/8 greedy id lists "
                             "equal the CPU run's")
    if min(runs["card"]["launches"]) <= 0:
        raise AssertionError("vision witness: a kernel did not run")
    del params, vparams, cpu_params, cpu_vparams
    _free()
    return {"max_abs": diff, "abs_limit": abs_limit, "cpu_spread": spread,
            "min_cos": cos, "control_max_abs": c_diff,
            "control_min_cos": c_cos, "ids_equal": agree}


@_timed
def phase_vision(smi) -> dict:
    """4n: ``profiles/v5e8-llama3-plus-embed.yaml``'s Qwen2-VL entry
    (``kind: vision``, its engine block; only ``mesh`` cut to ``{tp:
    1}``) at full width and depth: a random-init bf16 Qwen2-VL-7B-Instruct
    checkpoint of seed 0 written here in HF names (removed at the end),
    served through ``cli.model_specs`` / ``build_served_model`` beside a
    tiny text chat model and a tiny text encoder, and the same checkpoint
    as a ``kind: vision-embedding`` entry.  Demands: the 8-chat image
    wave (admitted together) answered whole, K1 and K2 launched in it and
    named by the traced wave; a seeded image chat reproduced; the
    reference's 400s (a text model given an image, a JPEG, a prompt past
    max_prefill_len); 16 mixed inputs embedded in order as unit vectors;
    the text encoder's image 400; the 2-layer float32 witness
    (``_vl_witness``).  Records host ms per image (decode, resize,
    patchify), tower ms per size, TTFT p50 with an image and text-only,
    the wave's tok/s, traced device-busy ms and idle share, the entry's
    bytes against the reference's estimate."""
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.engine.residency import served_model_bytes
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.models.qwen2_vl import init_vision_params
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry
    from helix_tpu_torch.testing.hf_checkpoint import (
        write_qwen2_vl_checkpoint,
    )
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    pngs = _vl_images(rng)
    root = os.environ.get("HELIX_SMOKE_CKPT_DIR") or tempfile.gettempdir()
    ckpt = tempfile.mkdtemp(prefix="helix-qwen2vl-", dir=root)
    old_env = os.environ.get("HELIX_MAX_PAGES_PER_SEQ")
    os.environ["HELIX_MAX_PAGES_PER_SEQ"] = VL_MAX_PAGES_PER_SEQ
    registry = httpd = None
    try:
        cfg, vcfg = _vl_configs(VL_LAYERS)
        log(f"[vision] cut: the measured run at {VL_LAYERS} of 28 text "
            f"layers and {VL_LAYERS} of 32 vision blocks (a depth cut for "
            "the smoke's time limit)")
        t0 = time.monotonic()
        params = init_params(cfg, 0, device="cuda")
        vparams = init_vision_params(vcfg, 1, device="cuda",
                                     dtype="bfloat16")
        files = write_qwen2_vl_checkpoint(ckpt, cfg, params, vcfg, vparams)
        ck_bytes = sum(os.path.getsize(f) for f in files)
        write_s = time.monotonic() - t0
        del params, vparams
        _free()
        entry = _vl_entry(ckpt)
        spec = _vl_spec(entry)
        t0 = time.monotonic()
        served = cli.build_served_model(device="cuda", seed=0, **spec)
        build_s = time.monotonic() - t0
        served.tokenizer = _IdTokenizer(served.tokenizer)
        eng, loop = served.loop.engine, served.loop
        measured = served_model_bytes(served)
        estimate = cli.spec_bytes(spec)
        text_model = cli.build_served_model(
            "tiny-chat", device="cuda", seed=0, warmup=False,
            engine=dict(max_decode_batch=2, num_pages=64,
                        max_prefill_len=256))
        text_enc = cli.build_served_model("tiny-embed", device="cuda",
                                          kind="embedding")
        registry = ModelRegistry()
        for m in (served, text_model, text_enc):
            registry.register(m)
        httpd = OpenAIServer(registry).start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        log(f"[vision] {smi}: checkpoint {ck_bytes / 1e9:.2f} GB written in "
            f"{write_s:.1f} s; served in {build_s:.1f} s "
            f"({served.build_seconds}); entry bytes measured "
            f"{measured / 2**30:.3f} GiB vs the reference's estimate "
            f"{estimate / 2**30:.3f} GiB (text tower only: the vision "
            "tower is not counted, ROADMAP C)")

        host = _host_image_ms(pngs, vcfg)
        for r in host:
            log(f"[vision] host {r['size']} -> {r['resized']} "
                f"({r['patches']} patches): decode {r['decode_ms']:.1f} ms, "
                f"resize {r['resize_ms']:.1f} ms, patchify (resize "
                f"included) {r['patchify_ms']:.1f} ms")
        tower = _tower_ms(served.vision, pngs)
        for r in tower:
            log(f"[vision] {smi}: tower {r['size']} ({r['patches']} "
                f"patches): {r['tower_ms']:.2f} ms on the device, peak "
                f"+{r['peak_rise_gib']:.2f} GiB")

        chats = _vl_chats(pngs)
        K1.launches = K2.launches = 0
        texts, secs, _ = _gated_batch(base, loop, None, VL_TOKENS,
                                      bodies=chats)
        launches = {"ragged_paged_attention": K1.launches,
                    "flash_attention": K2.launches}
        n_ids = [len(_vl_ids(t)) for t in texts]
        log(f"[vision] {smi}: 8 chats (6 with images, one with two, one "
            f"text only) x {VL_TOKENS} tokens in {secs:.2f} s, "
            f"{sum(n_ids) / secs:.1f} tok/s; launches {launches}")
        if n_ids != [VL_TOKENS] * 8:
            raise AssertionError(f"vision wave: token counts {n_ids}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"vision wave: launches {launches}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            texts2, secs2, _ = _gated_batch(base, loop, None, VL_TOKENS,
                                            bodies=chats)
            torch.cuda.synchronize()
        by_kernel = _kernel_ms(prof)
        busy = sum(by_kernel.values())
        names = " ".join(by_kernel)
        same = sum(a == b for a, b in zip(texts, texts2))
        log(f"[vision] {smi}: traced wave {secs2:.2f} s, device busy "
            f"{busy:.1f} ms, idle share {1 - busy / (secs2 * 1e3):.3f}; "
            f"K1 {sum(t for k, t in by_kernel.items() if 'ragged_' in k):.1f}"
            f" ms, K2 {sum(t for k, t in by_kernel.items() if 'flash_' in k):.1f}"
            f" ms; ids equal to the untraced wave {same}/8")
        if "ragged_split_kernel" not in names or "flash_" not in names:
            raise AssertionError("vision trace does not name K1 and K2")

        seeded = {"model": VL_MODEL, "max_tokens": 24, "temperature": 0.8,
                  "seed": 1234, "messages": chats[1]["messages"]}
        outs = [json.loads(_post(base + "/v1/chat/completions", seeded))[
            "choices"][0]["message"]["content"] for _ in range(2)]
        if not outs[0] or outs[0] != outs[1]:
            raise AssertionError(f"seeded image chat: {outs}")

        img_ttft, txt_ttft = [], []
        for i in range(4):
            img_ttft.append(_ttft_msgs(base, {**chats[i % 4],
                                              "max_tokens": 4,
                                              "temperature": 0})[0])
            txt_ttft.append(_ttft_msgs(base, {**chats[7], "max_tokens": 4,
                                              "temperature": 0})[0])
        log(f"[vision] {smi}: TTFT p50 with an image (224..1280x960) "
            f"{_pcts(img_ttft)[0] * 1e3:.1f} ms, text only "
            f"{_pcts(txt_ttft)[0] * 1e3:.1f} ms")

        # the reference's 400s
        st, err = _error_of(base, {**chats[0], "model": "tiny-chat"})
        want = "model 'tiny-chat' does not accept image input"
        if st != 400 or err["error"]["message"] != want:
            raise AssertionError(f"text model given an image: {st} {err}")
        jpeg = {"type": "image_url", "image_url": {
            "url": "data:image/jpeg;base64,/9j/4AAQSkZJRgABAQAAAQABAAD/"}}
        st, err = _error_of(base, {"model": VL_MODEL, "messages": [
            {"role": "user", "content": [jpeg]}]})
        msg = err["error"]["message"]
        if st != 400 or not msg.startswith("image processing failed: "
                                           "JPEG") or "A17c" not in msg:
            raise AssertionError(f"JPEG: {st} {err}")
        long_text = "lorem ipsum " * 360
        st, err = _error_of(base, {"model": VL_MODEL, "max_tokens": 4,
                                   "messages": [{"role": "user",
                                                 "content": long_text}]})
        n_long = len(served.tokenizer.apply_chat_template(
            [{"role": "user", "content": long_text}]))
        want = (f"vision prompt ({n_long} tokens) exceeds max_prefill_len "
                f"{eng.cfg.max_prefill_len}")
        if want not in json.dumps(err):
            raise AssertionError(f"long VL prompt: {st} {err}")
        log(f"[vision] 400s: {want!r} ({st}), the JPEG's A17c text, the text "
            "model's image refusal")

        # the vision-embedding entry on the same checkpoint
        espec = _vl_spec(_vl_entry(ckpt, "vision-embedding", VL_EMBED))
        embed_served = cli.build_served_model(device="cuda", seed=0,
                                              **espec)
        registry.register(embed_served)
        inputs = []
        for i in range(8):
            inputs += [f"query {i}: a picture of something",
                       {"image": _png_url(pngs[i % len(pngs)])}]
        t0 = time.monotonic()
        out = json.loads(_post(base + "/v1/embeddings",
                               {"model": VL_EMBED, "input": inputs}))
        embed_s = time.monotonic() - t0
        vecs = np.asarray([d["embedding"] for d in out["data"]])
        runner = embed_served.embedder
        want_vecs = np.empty_like(vecs)
        want_vecs[0::2] = runner.embed_texts(inputs[0::2])
        want_vecs[1::2] = runner.embed_images([x["image"] for x in
                                               inputs[1::2]])
        norms = np.linalg.norm(vecs, axis=1)
        gap = float(np.abs(vecs - want_vecs).max())
        if [d["index"] for d in out["data"]] != list(range(16)) or \
                np.abs(norms - 1).max() > 1e-5 or gap > 1e-6:
            raise AssertionError(f"vision embeddings: norms {norms}, gap "
                                 f"{gap}")
        st, err = _error_of(base, {"model": "tiny-embed",
                                   "input": [inputs[1]]}, "/v1/embeddings")
        if st != 400 or "cannot embed images" not in err["error"]["message"]:
            raise AssertionError(f"text encoder given an image: {st} {err}")
        log(f"[vision] {smi}: 16 mixed inputs embedded in {embed_s:.2f} s "
            f"in order (max |norm - 1| {np.abs(norms - 1).max():.2e}, "
            f"order gap {gap:.1e}); the text encoder's image 400")
        registry.unregister(VL_EMBED)
        embed_served.embedder.params = embed_served.embedder.vparams = None
        del embed_served, runner
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if registry is not None:
            for name in registry.names():
                registry.unregister(name)
        if old_env is None:
            os.environ.pop("HELIX_MAX_PAGES_PER_SEQ", None)
        else:
            os.environ["HELIX_MAX_PAGES_PER_SEQ"] = old_env
        shutil.rmtree(ckpt, ignore_errors=True)
    served = text_model = text_enc = eng = loop = None
    _free()
    witness = _vl_witness(pngs, smi)
    return {"launches": launches, "host": host, "tower": tower,
            "witness": witness, "ttft_image": img_ttft,
            "ttft_text": txt_ttft, "busy_ms": busy}


# ---------------------------------------------------------------------------
# 4o. mixture of experts: the v5e8-mixtral entry on one card
# ---------------------------------------------------------------------------

MOE_MODEL = "mistralai/Mixtral-8x7B-Instruct-v0.1"
MOE_PROFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "profiles", "v5e8-mixtral.yaml")
MOE_TOKENS = 64
# the long chat's bytes, past the entry's max_prefill_len 2048: two chunks
MOE_LONG_BYTES = 2300
MOE_SHARED_BYTES = 600         # the system prompt a primer and chat 1 share
MOE_WITNESS_LAYERS = 2
MOE_WITNESS_TOKENS = 8
# the witness's capacity factor: the entry's 1.5 lowered until its
# prefills drop assignments
MOE_WITNESS_FACTOR = 0.5
# the witness's limit on first-token logits, card against CPU, both
# float32: the two sum in other orders (~1e-5 apart); TF32's 10-bit
# mantissa moves a 4096-term logit by ~4e-4
MOE_LOGIT_TOL = 1e-4
MOE_CKPT_LAYERS = 2


def _moe_profile() -> tuple:
    """``profiles/v5e8-mixtral.yaml`` with this phase's changes: the mesh
    cut to one device, the requirement copied for nvidia, and speculation
    asked for on the entry (the engine must log it off).  Returns
    (profile, the changes)."""
    from helix_tpu_torch.cli import _load_profile

    doc = _load_profile(MOE_PROFILE)
    (entry,) = doc["models"]
    changes = [f"mesh {entry['mesh']} -> {{'tp': 1}}",
               f"requirement {doc['requirement']} -> "
               "{'vendor': 'nvidia', 'chips': 1}",
               "engine.enable_spec_decode true, spec_tokens 4 added (logged "
               "off for MoE)"]
    entry = {**entry, "mesh": {"tp": 1},
             "engine": {**entry["engine"], "enable_spec_decode": True,
                        "spec_tokens": 4}}
    return ({"name": doc["name"], "requirement": {"vendor": "nvidia",
                                                  "chips": 1},
             "models": [entry]}, changes)


def _moe_chats(rng, tag="") -> list:
    """The 8-chat wave: chat 0 past max_prefill_len (chunked), chat 1 on
    the primer's system prompt (a prefix-cache hit), six short ones."""
    shared = _ctx_text(np.random.default_rng(77), MOE_SHARED_BYTES)
    out = []
    for i in range(8):
        if i == 0:
            msgs = [{"role": "user",
                     "content": _ctx_text(rng, MOE_LONG_BYTES)}]
        elif i == 1:
            msgs = [{"role": "system", "content": shared},
                    {"role": "user", "content": f"{tag}Question B."}]
        else:
            msgs = [{"role": "user", "content": f"{tag}Chat {i}: "
                     + _ctx_text(rng, int(rng.integers(20, 400)))}]
        out.append({"model": MOE_MODEL, "messages": msgs})
    return out


def _moe_witness(smi) -> dict:
    """4o(b): the entry at 2 layers in float32 (full widths, TF32 off,
    ``expert_capacity_factor`` 0.5), random weights of seed 0 on the card
    and the same weights copied to the CPU; 8 prompts of 30-300 tokens
    decoded greedily (``MOE_WITNESS_TOKENS``) by one engine on each: ids
    8 of 8, prefill drops
    (> 0) equal, first-token logits within ``MOE_LOGIT_TOL``; the card
    again with TF32 on (the control) must break that limit."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params, params_to
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1
    from helix_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(
        CATALOG[MOE_MODEL], num_layers=MOE_WITNESS_LAYERS, dtype="float32",
        expert_capacity_factor=MOE_WITNESS_FACTOR)
    prof, _ = _moe_profile()
    engine = {k: v for k, v in prof["models"][0]["engine"].items()
              if k not in ("enable_spec_decode", "spec_tokens")}
    ecfg = EngineConfig(**engine)
    tok = ByteTokenizer()
    rng = np.random.default_rng(5)
    prompts = [tok.apply_chat_template([{"role": "user", "content":
               _ctx_text(rng, n)}]) for n in (10, 25, 40, 70, 100, 160,
                                              220, 280)]
    sp = SamplingParams(temperature=0.0, max_tokens=MOE_WITNESS_TOKENS)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    params = init_params(cfg, 0, device="cuda")
    cpu_params = params_to(params, "cpu")

    def run(dev, p):
        eng = Engine(cfg, p, ecfg, device=dev)
        firsts = []
        eng.logits_hook = lambda kind, x: firsts.append(
            x.float().cpu()) if kind == "prefill" else None
        k0 = (K1.launches, K2.launches)
        t0 = time.monotonic()
        ids = eng.generate(prompts, sp)
        secs = time.monotonic() - t0
        eng._drain_moe_drops()
        out = {"ids": ids, "drops": eng.moe_dropped_tokens,
               "logits": torch.cat(firsts), "seconds": secs,
               "launches": (K1.launches - k0[0], K2.launches - k0[1])}
        eng.release()
        return out

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = run("cuda", params)
        torch.backends.cuda.matmul.allow_tf32 = True
        ctl = run("cuda", params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = run("cpu", cpu_params)
    err = float((card["logits"] - cpu["logits"]).abs().max())
    c_err = float((ctl["logits"] - cpu["logits"]).abs().max())
    agree = sum(a == b for a, b in zip(card["ids"], cpu["ids"]))
    c_agree = sum(a == b for a, b in zip(ctl["ids"], cpu["ids"]))
    log(f"[moe witness] {smi}: {MOE_WITNESS_LAYERS} layers float32, "
        f"capacity factor {MOE_WITNESS_FACTOR}, 8 prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens x "
        f"{MOE_WITNESS_TOKENS}: greedy ids {agree}/8 equal to the CPU's; "
        f"prefill drops card {card['drops']} / CPU {cpu['drops']}; "
        f"first-token logits max abs {err:.3e} (limit {MOE_LOGIT_TOL:.0e}, "
        f"values up to {float(cpu['logits'].abs().max()):.2f}); TF32 on "
        f"(control) {c_err:.3e}, ids {c_agree}/8, drops {ctl['drops']}; "
        f"card {card['seconds']:.2f} s, CPU {cpu['seconds']:.2f} s; card "
        f"launches K1 {card['launches'][0]}, K2 {card['launches'][1]}")
    if agree != 8:
        raise AssertionError(f"moe witness: {agree}/8 greedy id lists equal "
                             "the CPU's")
    if card["drops"] != cpu["drops"] or cpu["drops"] <= 0:
        raise AssertionError(f"moe witness: drops {card['drops']} / "
                             f"{cpu['drops']}")
    if not err <= MOE_LOGIT_TOL:
        raise AssertionError(f"moe witness: logits differ by {err}")
    if c_err <= MOE_LOGIT_TOL:
        raise AssertionError("moe witness: TF32's logits pass the limit")
    if min(card["launches"]) <= 0:
        raise AssertionError(f"moe witness: launches {card['launches']}")
    del params, cpu_params
    _free()
    return {"ids_equal": agree, "drops": card["drops"], "max_abs": err,
            "control_max_abs": c_err, "control_ids_equal": c_agree}


def _moe_checkpoint(smi) -> dict:
    """4o(c): a 2-layer full-width Mixtral checkpoint in HF names
    (``block_sparse_moe.gate``, ``experts.{e}.w1|w2|w3``), bf16 of seed 0,
    written under the temp dir (or ``HELIX_SMOKE_CKPT_DIR``) and loaded
    with ``quantization="int8"``: byte-equal to the as-drawn int8
    build."""
    import tempfile

    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.models.loader import load_params
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    cfg = dataclasses.replace(CATALOG[MOE_MODEL], num_layers=MOE_CKPT_LAYERS)
    root = os.environ.get("HELIX_SMOKE_CKPT_DIR") or tempfile.gettempdir()
    d = tempfile.mkdtemp(prefix="helix-mixtral-", dir=root)
    try:
        params = init_params(cfg, 0, device="cuda")
        t0 = time.monotonic()
        files = write_checkpoint(d, cfg, params, model_type="mixtral")
        write_s = time.monotonic() - t0
        ck_bytes = sum(os.path.getsize(f) for f in files)
        del params
        _free()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        got_cfg, got = load_params(d, device="cuda", quantization="int8",
                                   stats=stats)
        rise = torch.cuda.max_memory_allocated() - base
        want = init_params(cfg, 0, device="cuda", quantization="int8")
        n, bad = _tree_diff(got, want)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"[moe checkpoint] {smi}: {MOE_CKPT_LAYERS} layers at full width, "
        f"{ck_bytes / 1e9:.2f} GB bf16 in {len(files) - 1} files written in "
        f"{write_s:.1f} s; int8 load {stats['seconds']:.1f} s (read "
        f"{_gbps(stats['bytes'], stats['read_seconds'])}, upload "
        f"{_gbps(stats['bytes'], stats['upload_seconds'])}), device rise "
        f"{rise / 2**30:.2f} GiB; {n} tensors (per layer) against the "
        f"as-drawn int8 build, {len(bad)} differ; experts "
        f"{got_cfg.num_experts}")
    if bad or got_cfg.num_experts != 8:
        raise AssertionError(f"moe checkpoint: {bad[:5]}")
    del got, want
    _free()
    return {"bytes": ck_bytes, "write_s": write_s, "load_s": stats["seconds"],
            "tensors": n}


@_timed
def phase_moe(smi) -> dict:
    """4o: ``profiles/v5e8-mixtral.yaml``'s entry,
    ``mistralai/Mixtral-8x7B-Instruct-v0.1`` (32 layers, 8 experts, top 2,
    E 4096, F 14336, H 32, KVH 8, D 128, V 32000) with int8 weights of
    seed 0 at full width and depth, through serve-node's profile path
    (``cli.make_node``, ``--random-weights``) with the mesh cut to one
    device and speculation asked for.  (a) a primer chat, then 8 chats of
    64 tokens admitted together (one past max_prefill_len, chunked; one
    on the primer's system prompt, a prefix-cache hit): all answered
    whole, K1 and K2 launched; the seeded chat twice, the same text;
    ``/metrics`` parsed with ``helix_moe_dropped_tokens_total``; the
    speculation warning logged, no verify step; a traced wave of 8 fresh
    chats (busy ms, idle share, the largest kernels with the int8 casts,
    K1 / K2 named).  Printed: the build's seconds and device peak, the
    entry's measured bytes beside the reference's estimate (ROADMAP C),
    TTFT p50, decode tok/s.  (b) the 2-layer float32 witness
    (``_moe_witness``).  (c) the 2-layer checkpoint (``_moe_checkpoint``)."""
    import logging
    import tempfile

    from helix_tpu_torch import cli
    from helix_tpu_torch.control.profile import ServingProfile
    from helix_tpu_torch.engine.residency import served_model_bytes
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1
    from helix_tpu_torch.testing.metric_families import check_scrape
    from torch.profiler import ProfilerActivity, profile

    tag = f"[moe] ({smi})"
    prof, changes = _moe_profile()
    log(f"{tag} the profile's entry as written, changed: "
        + "; ".join(changes))
    (spec,) = cli.model_specs(ServingProfile.from_dict(prof),
                              random_weights=True)
    estimate = cli.spec_bytes(spec)
    warned = []

    class _Warnings(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    handler = _Warnings(level=logging.WARNING)
    eng_log = logging.getLogger("helix_tpu_torch.engine.engine")
    eng_log.addHandler(handler)

    def build(**kw):
        served = cli.build_served_model(**kw)
        served.tokenizer = _IdTokenizer(served.tokenizer)
        return served

    tmp = tempfile.mkdtemp(prefix="helix-moe-")
    httpd = served = None
    try:
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        registry, _mgr, httpd, base, _path = _node(prof, tmp, "moe", build)
        build_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        served = registry.get(MOE_MODEL)
        loop, eng = served.loop, served.loop.engine
        measured = served_model_bytes(served, headroom=0.0)
        weights = measured - sum(nbytes(t) for t in eng.cache.carry())
        log(f"{tag} built in {build_s:.1f} s ({served.build_seconds}), "
            f"device peak {peak / 2**30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
            f"; weights {weights / 1e9:.2f} GB, with the pool "
            f"{measured / 1e9:.2f} GB (x1.1 {measured * 1.1 / 1e9:.2f} GB) "
            f"against the reference's estimate {estimate / 1e9:.2f} GB "
            "(one FFN per layer: ROADMAP C)")
        spec_warned = [w for w in warned if "not supported for MoE" in w]
        if eng.spec is not None or not spec_warned:
            raise AssertionError(f"speculation on an MoE entry: {warned}")

        rng = np.random.default_rng(0)
        chats = _moe_chats(rng)
        primer = {"model": MOE_MODEL, "messages": [
            chats[1]["messages"][0],
            {"role": "user", "content": "Question A."}]}
        ttft0, _t, _f = _ttft_msgs(base, {**primer, "max_tokens": 4,
                                          "temperature": 0})
        hits0 = eng.prefix_cache.hits
        mixed0, chunk_tokens0 = eng.num_mixed_steps, eng.num_prefill_tokens
        K1.launches = K2.launches = 0
        texts, secs, _ = _gated_batch(base, loop, None, MOE_TOKENS,
                                      bodies=chats)
        launches = {"ragged_paged_attention": K1.launches,
                    "flash_attention": K2.launches}
        n_ids = [len(_vl_ids(t)) for t in texts]
        hits = eng.prefix_cache.hits - hits0
        log(f"{tag} 8 chats (chat 0 past max_prefill_len, chat 1 on the "
            f"primer's prefix) x {MOE_TOKENS}"
            f" tokens in {secs:.2f} s, {sum(n_ids) / secs:.1f} tok/s; "
            f"prefix-hit pages {hits}, mixed steps "
            f"{eng.num_mixed_steps - mixed0}, prefill tokens "
            f"{eng.num_prefill_tokens - chunk_tokens0}; spec steps "
            f"{eng.num_spec_steps}; launches {launches}")
        if n_ids != [MOE_TOKENS] * 8:
            raise AssertionError(f"moe wave: token counts {n_ids}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"moe wave: launches {launches}")
        if hits <= 0 or eng.num_mixed_steps - mixed0 <= 0:
            raise AssertionError("moe wave: no prefix hit or no chunk "
                                 "beside decode rows")
        if eng.num_spec_steps:
            raise AssertionError("moe wave: a verify step ran")

        seeded = [_seeded(base, MOE_MODEL) for _ in range(2)]
        if seeded[0] != seeded[1]:
            raise AssertionError(f"seeded moe chat: {seeded}")
        ttfts = [ttft0] + [_ttft_msgs(base, {
            "model": MOE_MODEL, "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": f"TTFT {i}: "
                          + _ctx_text(rng, 200)}]})[0] for i in range(4)]
        ttft_p50 = _pcts(ttfts)[0]
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        problems = check_scrape(text)
        drops = _metric(text, "helix_moe_dropped_tokens_total",
                        model=MOE_MODEL)
        if problems:
            raise AssertionError(f"moe /metrics: {problems[:3]}")
        log(f"{tag} seeded chat twice: identical ({len(_vl_ids(seeded[0]))} "
            f"ids); TTFT p50 {ttft_p50 * 1e3:.1f} ms over {len(ttfts)} "
            f"chats; /metrics parses, helix_moe_dropped_tokens_total "
            f"{drops:.0f} (engine {eng.moe_dropped_tokens}); speculation "
            f"warned: {spec_warned[0]!r}")

        fresh = _moe_chats(np.random.default_rng(9), "traced ")
        dec0 = eng.num_decode_tokens
        k0 = (K1.launches, K2.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            _t2, secs2, _ = _gated_batch(base, loop, None, 32,
                                         bodies=fresh)
            torch.cuda.synchronize()
        traced_launches = (K1.launches - k0[0], K2.launches - k0[1])
        by_kernel = _kernel_ms(trace)
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        copy_ms = sum(t for k, t in by_kernel.items() if "direct_copy" in k)
        k1_ms = sum(t for k, t in by_kernel.items() if "ragged_" in k)
        k2_ms = sum(t for k, t in by_kernel.items() if "flash_" in k)
        log(f"{tag} traced wave of 8 fresh chats x 32 tokens: {secs2:.2f} s, "
            f"{(eng.num_decode_tokens - dec0) / secs2:.1f} decode tok/s, "
            f"device busy {busy:.1f} ms, idle share "
            f"{1 - busy / (secs2 * 1e3):.3f}; direct_copy (int8 casts) "
            f"{copy_ms:.1f} ms, K1 {k1_ms:.1f} ms ({traced_launches[0]} "
            f"launches), K2 {k2_ms:.1f} ms ({traced_launches[1]}); "
            "largest: " + "; ".join(f"{k[:60]} {t:.1f}" for k, t in top))
        if k1_ms <= 0 or k2_ms <= 0 or min(traced_launches) <= 0:
            raise AssertionError("moe trace does not name K1 and K2")
        result = {"launches": launches, "build_s": build_s,
                  "peak_gib": peak / 2**30, "measured": measured,
                  "estimate": estimate, "tok_s": sum(n_ids) / secs,
                  "ttft_p50": ttft_p50, "busy_ms": busy,
                  "idle": 1 - busy / (secs2 * 1e3), "copy_ms": copy_ms}
    finally:
        eng_log.removeHandler(handler)
        if served is not None:
            _stop_side(httpd, served)
        elif httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    served = eng = loop = registry = None
    _free()
    result["witness"] = _moe_witness(smi)
    result["checkpoint"] = _moe_checkpoint(smi)
    return result


# ---------------------------------------------------------------------------
# 2b. K2-backward (training)
# ---------------------------------------------------------------------------

# H100 SXM data sheet: float32 outside the tensor cores
PEAK_F32_FLOPS = 67e12
# the training batch of phase 4p (the CLI's defaults)
TRAIN_B, TRAIN_S = 8, 1024
# K2's LSE against torch.logsumexp of the plain version's scores: an f32
# online softmax against one f32 softmax
LSE_ATOL = 1e-4


def _chat_layout(B, S, rng, lo=100, hi=500) -> tuple:
    """Positions and segment ids of B rows of S tokens as
    ``training.data.pack_examples`` packs chats of lo-hi tokens
    (positions restart per segment, padding segment 0 at position 0)."""
    from helix_tpu_torch.training.data import SFTExample, pack_examples

    lens = rng.integers(lo, hi, size=4 * B * S // lo)
    exs = [SFTExample(input_ids=[1] * int(n), loss_mask=[1] * int(n))
           for n in lens]
    b = next(pack_examples(exs, B, S, shuffle_seed=0))
    return b.positions, b.segment_ids


def _live_pairs(pos, seg) -> int:
    """(query, key) pairs K2's mask keeps, per head: same segment,
    query position >= key position."""
    total = 0
    for b in range(pos.shape[0]):
        for s_id in np.unique(seg[b]):
            p = np.sort(pos[b][seg[b] == s_id])
            total += int(np.searchsorted(p, p, side="right").sum())
    return total


def _k2b_planted(fault, q, k, v, out, lse, dout, kw):
    """K2-backward with one defect planted through its inputs, to be held
    against the plain version of the true inputs: every query head read
    against the next KV head (k and v rolled over their heads), the
    causal mask dropped, Delta left out (O = 0); the cap's derivative,
    which no input can drop (P is recomputed from the capped scores),
    through the wrapper's check-only switch."""
    from helix_tpu_torch.ops.attention import flash_attention_backward

    if fault == "wrong_kv_head":
        k, v = k.roll(1, dims=2), v.roll(1, dims=2)
    if fault == "no_causal":
        kw = {**kw, "causal": False}
    if fault == "no_delta":
        out = torch.zeros_like(out)
    return flash_attention_backward(
        q, k, v, out, lse, dout, **kw,
        _drop_cap_derivative=fault == "no_cap_derivative")


def _k2b_case(label, B, S, heads, dtype, gen, rng, cap=None, faults=()):
    """K2 with its LSE and K2-backward on one packed batch.  K2's output
    is held to the plain version per element (``flash_error_limit`` in
    bf16, 1e-5 + 1e-5 |want| in f32) and a dropped diagonal key must
    break that; its LSE to ``torch.logsumexp`` within ``LSE_ATOL``.
    K2-backward is held to the plain version per element within
    ``flash_backward_error_limit``, each planted fault breaking it.
    Returns (K2 row, K2-backward row), each timed beside its plain
    version, SDPA with the same mask (uncapped cases) and its bound."""
    from helix_tpu_torch.ops.attention import (
        ERR_ATOL,
        F32_RTOL,
        flash_attention_backward,
        flash_attention_lse,
        flash_attention_lse_plain,
        flash_backward_error_limit,
        flash_backward_plain,
        flash_error_limit,
    )

    Hh, KVHh, Dh = heads
    dev = "cuda"
    pos, seg = _chat_layout(B, S, rng)
    pos_t = torch.from_numpy(pos).to(dev)
    seg_t = torch.from_numpy(seg).to(dev)
    q = torch.randn((B, S, Hh, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KVHh, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KVHh, Dh), generator=gen, device=dev).to(dtype)
    dout = torch.randn((B, S, Hh, Dh), generator=gen, device=dev).to(dtype)
    kw = dict(q_positions=pos_t, kv_positions=pos_t, q_segment_ids=seg_t,
              kv_segment_ids=seg_t, logits_soft_cap=cap)
    out, lse = flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    # K2's forward at this shape: output and LSE
    out_want, lse_want = flash_attention_lse_plain(q, k, v, **kw)
    if dtype == torch.bfloat16:
        fwd_lim = flash_error_limit(q, k, v, **kw)
    else:
        fwd_lim = ERR_ATOL + F32_RTOL * out_want.float().abs()
    fwd_err, fwd_ratio = check(f"K2 forward {label}", out, out_want,
                               fwd_lim)
    fwd_fault = planted(
        f"K2 forward {label} diagonal key dropped",
        flash_attention_lse(q, k, v, **{**kw, "kv_positions": pos_t + 1})[0],
        out_want, fwd_lim)
    del out_want, fwd_lim
    lse_err = (lse - lse_want).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"K2 LSE {label}: {lse_err:.3e} > {LSE_ATOL}")
    del lse_want
    # K2-backward
    got = flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    want = flash_backward_plain(q, k, v, dout, **kw)
    limits = flash_backward_error_limit(q, k, v, dout, want, **kw)
    errs, ratios = zip(*(check(f"K2-backward {label} {n}", g, w, lim)
                         for n, g, w, lim in zip(("dq", "dk", "dv"), got,
                                                 want, limits)))
    fault_ratio = {}
    for f in faults:
        bad = _k2b_planted(f, q, k, v, out, lse, dout, kw)
        fault_ratio[f] = max(tol_ratio(b, w, lim)
                             for b, w, lim in zip(bad, want, limits))
        if not fault_ratio[f] > 1.0:
            raise AssertionError(
                f"planted fault {f} passed the K2-backward check "
                f"({fault_ratio[f]:.2f}x the limit): the limit is too loose")
    del want, limits
    ms = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                  **kw), 5)
    fwd_ms = cuda_ms(lambda: flash_attention_lse(q, k, v, **kw), 5)
    plain_ms = cuda_ms(lambda: flash_backward_plain(q, k, v, dout, **kw),
                       2, 1)
    fwd_plain_ms = cuda_ms(lambda: flash_attention_lse_plain(q, k, v, **kw),
                           2, 1)
    library_ms = fwd_library_ms = fwd_bwd_library_ms = None
    if cap is None:
        # library yardstick: SDPA with the same mask -- its backward alone
        # (autograd on a retained graph: the function K2-backward
        # computes), its forward, and the two together
        G = Hh // KVHh
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.repeat_interleave(G, 2).transpose(1, 2).detach() \
            .requires_grad_()
        vt = v.repeat_interleave(G, 2).transpose(1, 2).detach() \
            .requires_grad_()
        go = dout.transpose(1, 2)
        mask = ((pos_t[:, :, None] >= pos_t[:, None, :])
                & (seg_t[:, :, None] == seg_t[:, None, :]))[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            o = sdpa(qt, kt, vt, attn_mask=mask)
            torch.autograd.grad(o, (qt, kt, vt), go)

        def lib_fwd():
            with torch.no_grad():
                sdpa(qt, kt, vt, attn_mask=mask)

        o_lib = sdpa(qt, kt, vt, attn_mask=mask)

        def lib_bwd():
            torch.autograd.grad(o_lib, (qt, kt, vt), go, retain_graph=True)

        fwd_bwd_library_ms = cuda_ms(lib, 5)
        fwd_library_ms = cuda_ms(lib_fwd, 5)
        library_ms = cuda_ms(lib_bwd, 5)
        del o_lib
    pairs = _live_pairs(pos, seg)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS

    def bound_of(flops, nbytes_):
        t_ops, t_bytes = flops / peak * 1e3, nbytes_ / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else \
            (t_bytes, "bytes")

    meta_bytes = 4 * B * S * 4      # four int32 [B, S] position / segment rows
    # forward: QK^T and PV, 4 D FLOPs per live (query, key, head); q, k, v
    # and the meta read once, O and the LSE written once
    fb_ms, fb_by = bound_of(4.0 * Dh * Hh * pairs,
                            nbytes(q, k, v, out, lse) + meta_bytes)
    # backward: dP, dV, dQ, dK, 8 D FLOPs per live (query, key, head); q,
    # k, v, O, dO, the LSE and the meta read once, the gradients written once
    b_ms, b_by = bound_of(8.0 * Dh * Hh * pairs,
                          nbytes(q, k, v, out, dout, lse, *got) + meta_bytes)
    fwd_row = dict(case=f"{label} (forward with LSE)", max_abs_err=fwd_err,
                   tol_ratio=fwd_ratio, planted_fault_ratio=fwd_fault,
                   lse_max_abs_err=lse_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                   library_ms=fwd_library_ms, bound_ms=fb_ms,
                   bound_by=fb_by, live_pairs=pairs)
    row = dict(case=label, max_abs_err=max(errs), tol_ratio=max(ratios),
               planted_fault_ratio=fault_ratio, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_fwd_bwd_ms=fwd_bwd_library_ms, bound_ms=b_ms,
               bound_by=b_by, live_pairs=pairs)

    def fmt(x):
        return "None" if x is None else f"{x:.4f}"

    log(f"[K2 forward with LSE] {label}: max_abs_err {fwd_err:.3e}, "
        f"{fwd_ratio:.3f}x the limit ("
        + ("flash_error_limit" if dtype == torch.bfloat16
           else "1e-5 + 1e-5 |want|")
        + f"); LSE {lse_err:.3e}; planted fault {fwd_fault:.1f}x; kernel_ms "
        f"{fwd_ms:.4f} plain_ms {fwd_plain_ms:.4f} library_ms "
        f"{fmt(fwd_library_ms)} bound_ms {fb_ms:.4f} ({fb_by}; {pairs} "
        "live pairs a head)")
    log(f"[K2-backward] {label}: max_abs_err {max(errs):.3e}, "
        f"{max(ratios):.3f}x the limit (flash_backward_error_limit; dq/dk/dv "
        f"{', '.join(f'{r:.3f}' for r in ratios)}); "
        f"planted faults {json.dumps(fault_ratio)}; kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {fmt(library_ms)} (SDPA "
        f"backward alone; forward + backward {fmt(fwd_bwd_library_ms)}) "
        f"bound_ms {b_ms:.4f} ({b_by}; {pairs} live pairs a head)")
    return fwd_row, row


@_timed
def phase_k2_backward() -> tuple:
    """2b: K2 with its LSE and K2-backward at the training shape, in
    float32 and soft-capped.  Returns (K2 rows, K2-backward rows)."""
    from helix_tpu_torch.ops.attention import flash_backward_kernel_info

    for dtype, form in ((torch.bfloat16, "bf16 (wgmma)"),
                        (torch.float32, "float32 (FMA)")):
        for which, info in flash_backward_kernel_info(
                D, dtype, S=TRAIN_S).items():
            log(f"[build] flash_attention_backward {form} {which} kernel at "
                f"D {D}, S {TRAIN_S}: {info['regs']} registers, "
                f"{info['spill_bytes']} B local (spill) memory, "
                f"{info['smem_bytes']} B shared memory per block, "
                f"{info['blocks_per_sm']} blocks per SM")
            if info["blocks_per_sm"] < 1:
                raise AssertionError(f"K2-backward {form} {which}: a block "
                                     "does not fit an SM")
            if dtype == torch.bfloat16 and info["spill_bytes"]:
                raise AssertionError(f"K2-backward {form} {which} spills "
                                     f"{info['spill_bytes']} B")
    gen = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.default_rng(6)
    pairs = [
        _k2b_case(f"train: B {TRAIN_B} S {TRAIN_S} H 32 KVH 8 D 128 bf16, "
                  "packed chats", TRAIN_B, TRAIN_S, (H, KVH, D),
                  torch.bfloat16, gen, rng,
                  faults=("wrong_kv_head", "no_causal", "no_delta")),
        _k2b_case("float32: B 2 S 300 H 8 KVH 2 D 64, packed", 2, 300,
                  (8, 2, 64), torch.float32, gen, rng,
                  faults=("wrong_kv_head", "no_causal", "no_delta")),
        _k2b_case("soft cap 2.0: B 2 S 512 H 32 KVH 8 D 128 bf16, packed",
                  2, 512, (H, KVH, D), torch.bfloat16, gen, rng, cap=2.0,
                  faults=("wrong_kv_head", "no_causal", "no_delta",
                          "no_cap_derivative")),
    ]
    _free()
    return [f for f, _ in pairs], [b for _, b in pairs]


# ---------------------------------------------------------------------------
# 4p. LoRA SFT at full width, publish, serve
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20
# peak learning rate: AdamW moves each adapter entry by up to lr a step;
# at 1e-3 a 1024-token batch's loss fell 0.75 in one step in a probe
# (random weights), far past the step-to-step noise of the data
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
TRAIN_ROWS = 400          # chat rows of the phase's JSONL
TRAIN_CHATS = 8
TRAIN_NEW_TOKENS = 32
# the 2-layer float32 witness: card vs CPU, 3 steps of 2 x 256 tokens,
# the same sums in other orders on both sides:
# - each step's loss within 1e-6 relative (a mean of ~500 float32 token
#   losses: ~1e-7 apart);
# - the adapters' update (end - start) within 2% of its L2 norm.  Not per
#   element, nor Adam's moments: Adam's first step of an entry is
#   lr g / (|g| + eps), +-lr, so an entry whose gradient lies inside the
#   two sides' summation noise may step the other way (2 lr), and the next
#   step's gradients see that; k such entries among the N = 852k of two
#   layers move the norm by ~2 sqrt(k / N), 2% at ~90 of them.
# TF32 (10-bit GEMM inputs, ~1e-3 relative) must break one of them.
TRAIN_WITNESS = dict(batch=2, seq=256, steps=3)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_UPDATE_RTOL = 2e-2
TRAIN_WORDS = (
    "the model serves each request on one card while the adapter learns "
    "a short house style for replies tokens stream back through the "
    "engine and the scheduler keeps every tenant within its budget so a "
    "chat stays fast when the batch is full").split()


def _train_rows(rng, n) -> list:
    """Chat rows of the phase's JSONL: a system prompt, a user turn of
    8-40 words and an assistant turn of 40-300 words."""
    def words(lo, hi):
        return " ".join(rng.choice(TRAIN_WORDS, int(rng.integers(lo, hi))))

    return [{"messages": [
        {"role": "system", "content": "You are a helpful assistant."},
        {"role": "user", "content": words(8, 40)},
        {"role": "assistant", "content": words(40, 300)}]}
        for _ in range(n)]


def _update_gap(got: dict, want: dict, start: dict) -> float:
    """||got - want|| / ||want - start|| over every adapter entry: the
    relative L2 gap of the two sides' updates."""
    num = den = 0.0
    for t in want:
        for n in want[t]:
            g, w = got[t][n].float().cpu(), want[t][n].float().cpu()
            num += float(((g - w) ** 2).sum())
            den += float(((w - start[t][n].float()) ** 2).sum())
    return (num / den) ** 0.5


def _train_witness(smi, examples, tmpdir) -> dict:
    """4p.3: 2 layers at full width in float32: three trainer steps on
    the card and on the CPU from the same adapter (TF32 off, the default)
    agree within the limits above; TF32 on (the control) breaks them.
    Then the card's witness adapter, saved, gives the same greedy tokens
    through the adapter pool (``POST /v1/adapters``' store path) as the
    build that merges it at apply (``build_served_model(adapter=...)``,
    the profile's ``adapter:``)."""
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.engine.engine import Engine, EngineConfig, Request
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params, params_to
    from helix_tpu_torch.training.checkpoint import save_checkpoint
    from helix_tpu_torch.training.data import pack_examples
    from helix_tpu_torch.training.lora import init_lora_params
    from helix_tpu_torch.training.sft import SFTConfig, SFTTrainer

    w = TRAIN_WITNESS
    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2, dtype="float32")
    params = init_params(cfg, 3, device="cuda")
    conf = SFTConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                     total_steps=w["steps"], batch_size=w["batch"],
                     seq_len=w["seq"])
    batch = next(pack_examples(examples, w["batch"], w["seq"],
                               shuffle_seed=0))
    start = init_lora_params(cfg, conf.lora, 0, device="cpu")

    def run(p, dev):
        tr = SFTTrainer(cfg, p, conf)
        tr.lora_params = {t: {n: x.to(dev).clone() for n, x in f.items()}
                          for t, f in start.items()}
        t0 = time.monotonic()
        losses = [tr.train_step(batch) for _ in range(w["steps"])]
        return losses, tr.lora_params, time.monotonic() - t0

    card_l, card_p, card_s = run(params, "cuda")
    cpu_l, cpu_p, cpu_s = run(params_to(params, "cpu"), "cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf_l, tf_p, _ = run(params, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def gaps(losses, lora):
        return (max(abs(x - y) / abs(y) for x, y in zip(losses, cpu_l)),
                _update_gap(lora, cpu_p, start))

    def within(g):
        return g[0] <= TRAIN_LOSS_RTOL and g[1] <= TRAIN_UPDATE_RTOL

    f32_gaps, tf_gaps = gaps(card_l, card_p), gaps(tf_l, tf_p)
    log(f"[train witness] ({smi}) 2 layers full width f32, {w['steps']} "
        f"steps of {w['batch']} x {w['seq']}: losses card {card_l} cpu "
        f"{cpu_l}; loss gap {f32_gaps[0]:.3e} (limit {TRAIN_LOSS_RTOL} "
        f"relative), update gap {f32_gaps[1]:.3e} (limit "
        f"{TRAIN_UPDATE_RTOL}); TF32 (the control) {tf_gaps[0]:.3e}, "
        f"{tf_gaps[1]:.3e}; card {card_s:.2f} s, cpu {cpu_s:.2f} s")
    if not within(f32_gaps):
        raise AssertionError(f"card trainer differs from the CPU's: "
                             f"{f32_gaps}")
    if within(tf_gaps):
        raise AssertionError("TF32 (the control) stayed within the "
                             "witness limits: they cannot see a rounding")
    ck = os.path.join(tmpdir, "witness")
    save_checkpoint(ck, w["steps"], card_p, {"count": w["steps"]},
                    lora_scaling=conf.lora.scaling)
    geo = dict(max_decode_batch=4, page_size=16, num_pages=256,
               max_pages_per_seq=64, max_prefill_len=512,
               eos_token_ids=(1,))
    pooled = Engine(cfg, params, EngineConfig(**geo, adapter_pool_slots=2,
                                              adapter_rank=16),
                    device="cuda")
    pooled.adapter_store.publish_checkpoint("w", ck)
    merged = build_served_model(
        MODEL, device="cuda", seed=3, warmup=False, engine=geo,
        model_overrides={"num_layers": 2, "dtype": "float32"}, adapter=ck)
    merged.loop.stop()
    sp = SamplingParams(temperature=0.0, max_tokens=16)

    def greedy(eng, prompt, adapter=""):
        r = Request(id=f"w{adapter}{len(prompt)}", prompt_tokens=prompt,
                    sampling=sp, adapter=adapter)
        eng.add_request(r)
        while eng.has_work():
            eng.step()
        return r.output_tokens

    prompts = [list(e.input_ids[:48]) for e in examples[:4]]
    same = [greedy(pooled, p, "w") == greedy(merged.loop.engine, p)
            for p in prompts]
    moved = sum(greedy(pooled, p) != greedy(merged.loop.engine, p)
                for p in prompts)
    log(f"[train witness] f32 greedy tokens through the pool = the "
        f"merge-at-apply build: {sum(same)} of {len(same)}; the base "
        f"model's differ in {moved} of {len(prompts)}")
    if not all(same):
        raise AssertionError(f"pool tokens differ from the merge-at-apply "
                             f"build: {same}")
    del pooled, merged, params
    _free()
    return {"gaps": f32_gaps, "tf32_gaps": tf_gaps,
            "pool_equals_merged": sum(same)}


@_timed
def phase_train(smi) -> dict:
    """4p: LoRA SFT of Llama-3-8B at full width, publish, serve; then the
    2-layer float32 witness (``_train_witness``)."""
    from torch.profiler import ProfilerActivity, profile

    from helix_tpu_torch.cli import make_engine_loop
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.attention import K2, K2B
    from helix_tpu_torch.serving.registry import ServedModel
    from helix_tpu_torch.serving.tokenizer import HFTokenizer
    from helix_tpu_torch.testing.tokenizer_fixtures import FIXTURES
    from helix_tpu_torch.training.checkpoint import save_checkpoint
    from helix_tpu_torch.training.data import load_jsonl, pack_examples
    from helix_tpu_torch.training.sft import SFTConfig, SFTTrainer

    tmpdir = tempfile.mkdtemp(prefix="helix-train-")
    rng = np.random.default_rng(16)
    try:
        tok = HFTokenizer(os.path.join(FIXTURES["llama3"], "tokenizer.json"),
                          MODEL)
        data = os.path.join(tmpdir, "chats.jsonl")
        with open(data, "w") as f:
            for row in _train_rows(rng, TRAIN_ROWS):
                f.write(json.dumps(row) + "\n")
        t0 = time.monotonic()
        examples = load_jsonl(data, tok)
        tok_s = time.monotonic() - t0
        cfg = CATALOG[MODEL]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device="cuda")
        conf = SFTConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                         seq_len=TRAIN_S)
        trainer = SFTTrainer(cfg, params, conf)

        def batches():
            epoch = 0
            while True:
                yield from pack_examples(examples, TRAIN_B, TRAIN_S,
                                         shuffle_seed=epoch)
                epoch += 1

        live = []        # non-padding tokens of each step's batch

        def counted():
            for b in batches():
                live.append(int((b.segment_ids > 0).sum()))
                yield b

        stamps, trace = [time.monotonic()], {}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def on_step(n):
            stamps.append(time.monotonic())
            if n == TRAIN_STEPS - 1:       # trace the last step alone
                prof.__enter__()
                trace["t0"] = time.monotonic()
            elif n == TRAIN_STEPS:
                prof.__exit__(None, None, None)
                trace["wall_ms"] = (stamps[-1] - trace["t0"]) * 1e3

        K2.launches = K2B.launches = 0
        history = trainer.train(counted(), log_every=1, on_step=on_step,
                                on_log=lambda m: log(f"[train] {m}"))
        launches = {"flash_attention": K2.launches,
                    "flash_attention_backward": K2B.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        by_kernel = _kernel_ms(prof)
        busy = sum(by_kernel.values())
        idle = 1.0 - busy / trace["wall_ms"]
        # K2-backward's kernels in the traced step, by name
        k2b_ms = {n: t for n, t in by_kernel.items() if "flash_bwd_" in n}
        for n, t in sorted(k2b_ms.items(), key=lambda kv: -kv[1]):
            log(f"[train] traced step: {t:.3f} ms in {n[:90]}")
        for form in ("flash_bwd_dkdv_wgmma_kernel",
                     "flash_bwd_dq_wgmma_kernel", "flash_bwd_delta_kernel"):
            if not any(form in n for n in k2b_ms):
                raise AssertionError(f"the traced step ran no {form}: "
                                     f"{sorted(k2b_ms)}")
        steps = np.diff(stamps)
        # the first step warms up cuBLAS, the traced (last) one runs slower
        steady = range(1, TRAIN_STEPS - 1)
        step_ms = float(np.median([steps[i] for i in steady])) * 1e3
        live_tps = float(np.median([live[i] / steps[i] for i in steady]))
        log(f"[train] ({smi}) {MODEL} full width, {cfg.num_layers} layers, "
            f"bf16, LoRA r {conf.lora.rank} alpha {conf.lora.alpha} on "
            f"{'/'.join(conf.lora.targets)}: {TRAIN_STEPS} steps of "
            f"{TRAIN_B} x {TRAIN_S} ({len(examples)} chats tokenized in "
            f"{tok_s:.2f} s); loss {history[0]:.4f} -> {history[-1]:.4f}; "
            f"step ms median {step_ms:.1f} (first {steps[0] * 1e3:.1f}), "
            f"{TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} tokens/s "
            f"({live_tps:.0f} live); peak {peak:.2f} GiB; one traced step "
            f"{trace['wall_ms']:.1f} ms, device busy {busy:.1f} ms, idle "
            f"share {idle:.3f}, K2-backward {sum(k2b_ms.values()):.1f} ms "
            f"of it; launches {launches}")
        want = TRAIN_STEPS * cfg.num_layers
        if launches != {"flash_attention": want,
                        "flash_attention_backward": want}:
            raise AssertionError(f"training launches {launches}: every "
                                 f"attention forward and backward of "
                                 f"{TRAIN_STEPS} steps x {cfg.num_layers} "
                                 "layers must launch K2 and K2-backward")
        if not history[-1] < history[0]:
            raise AssertionError(f"the loss did not fall: {history}")
        ck = os.path.join(tmpdir, "sft")
        save_checkpoint(ck, trainer.step_num, trainer.lora_params,
                        trainer.opt_state, lora_scaling=conf.lora.scaling)
        del trainer
        _free()

        # 4p.2: the same base tensors served with an adapter pool
        eng = Engine(cfg, params, EngineConfig(
            max_decode_batch=TRAIN_CHATS, page_size=16, num_pages=2048,
            max_pages_per_seq=128, max_prefill_len=1024,
            adapter_pool_slots=8, adapter_rank=16,
            eos_token_ids=tuple(tok.eos_ids)), device="cuda")
        served = ServedModel(name=MODEL, loop=make_engine_loop(eng, MODEL),
                             tokenizer=_IdTokenizer(tok),
                             context_length=eng.max_context_len)
        httpd, base, registry = _start_server(served)
        try:
            t0 = time.monotonic()
            pub = json.loads(_post(base + "/v1/adapters", {
                "model": MODEL, "name": "sft", "checkpoint": ck}))
            pub_s = time.monotonic() - t0
            if (pub["id"], pub["object"], pub["parent"], pub["rank"],
                    pub["scale"]) != (f"{MODEL}@sft", "model", MODEL, 16,
                                      conf.lora.scaling):
                raise AssertionError(f"publish answered {pub}")
            bodies = [{"model": f"{MODEL}@sft", "messages": [
                {"role": "system", "content": "You are a helpful assistant."},
                {"role": "user", "content": " ".join(
                    rng.choice(TRAIN_WORDS, 12))}]}
                for _ in range(TRAIN_CHATS)]
            tuned, t_s, _ = _gated_batch(base, served.loop, None,
                                         TRAIN_NEW_TOKENS, bodies=bodies)
            plain, p_s, _ = _gated_batch(
                base, served.loop, None, TRAIN_NEW_TOKENS,
                bodies=[{**b, "model": MODEL} for b in bodies])
        finally:
            _unserve(served, httpd, registry)
        differ = sum(a != b for a, b in zip(tuned, plain))
        log(f"[train] POST /v1/adapters {pub_s * 1e3:.1f} ms ({pub}); "
            f"{TRAIN_CHATS} chats to {MODEL}@sft in {t_s:.2f} s, "
            f"{sum(len(t) > 0 for t in tuned)} answered, {differ} unlike "
            f"the base model's ({p_s:.2f} s)")
        if not all(tuned) or differ != TRAIN_CHATS:
            raise AssertionError(f"adapter chats: {sum(map(bool, tuned))} "
                                 f"answered, {differ} unlike the base's")
        del eng, served, params
        _free()
        witness = _train_witness(smi, examples, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return {"launches": launches, "loss": history, "step_ms": step_ms,
            "peak_gib": peak, "idle_share": idle,
            "k2_backward_traced_ms": k2b_ms, "witness": witness}


# ---------------------------------------------------------------------------
# 3f / 4q. tensor parallel on one host
# ---------------------------------------------------------------------------

# a tp 4 shard of Llama-3-8B's attention: 8 query heads, 2 KV heads
TP = 4
TP_HEADS = (H // TP, KVH // TP, D)
TP_PROFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "profiles", "v5e8-llama3-plus-embed.yaml")
# the profile's Llama entry's engine block and context length as written
TP_ENTRY = dict(max_decode_batch=32, num_pages=15872, page_size=16,
                max_prefill_len=4096, kv_cache_dtype="int8",
                enable_async_loop=True)
TP_CONTEXT = 8192
TP_CHATS = 16
TP_PROMPT_TOKENS = 1500
TP_NEW_TOKENS = 64
TP_TRACE_CHATS, TP_TRACE_TOKENS = 4, 16
TP_WITNESS_LAYERS = 2
TP_WITNESS_TOKENS = 32
TP_SUM_REPS = 3
MEM_TOL = 0.05               # a card's bytes against its shards' share
MEM_SLACK = 64 << 20         # what a card but the first may hold beyond


@_timed
def phase_tp_kernels() -> tuple:
    """3f. K2 and K1-int8 at a tp 4 shard's shape (H 8, KVH 2, D 128,
    group 4), as phase 4q's engine calls them on each card: K2 on a cold
    prefill wave of two ~1500-token prompts (packed, S 3072); K1-int8
    with 32 decode rows at histories 1,500-1,564 and a 1,024-token chunk
    row (history 2,048) beside 31 decode rows, on a shard's int8 pool of
    the entry's 15,872 pages [32, 15872, 16, 2, 128].  Same limits,
    planted faults and timings as the full-width cases.  Returns (K2
    rows, K1-int8 rows)."""
    from helix_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(19)
    rng = np.random.default_rng(19)
    k2 = [_k2_case("tp 4 shard: packed S=3072, 2 prompts of 1536, H=8, "
                   "KVH=2", [1536, 1536], gen, TP_HEADS)]
    L, N, P = 32, TP_ENTRY["num_pages"], 16
    shape = (L, N, P, TP_HEADS[1], TP_HEADS[2])
    pools = [torch.empty(shape, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.empty(shape[:-1], dtype=torch.float32, device=dev)
              for _ in range(2)]
    for lyr in range(L):
        for pool, sc in zip(pools, scales):
            pool[lyr], sc[lyr] = quantize_kv(torch.randn(
                shape[1:], generator=gen, device=dev))
    k1 = [
        _k1_case("tp 4 shard: decode 32 rows, hist 1500-1564, 15872 "
                 "pages, H=8, KVH=2", [1] * 32,
                 rng.integers(1500, 1564, size=32), tuple(pools), gen,
                 rng, tuple(scales), heads=TP_HEADS),
        _k1_case("tp 4 shard: 1024-token chunk (hist 2048) + 31 decode "
                 "rows, 15872 pages", [1024] + [1] * 31,
                 [2048] + list(rng.integers(1500, 1564, size=31)),
                 tuple(pools), gen, rng, tuple(scales), heads=TP_HEADS),
    ]
    del pools, scales
    torch.cuda.empty_cache()
    return k2, k1


def _tp_devices() -> list:
    """Cards 0-3 when four are visible, else card 0 four times (each
    entry one shard)."""
    n = torch.cuda.device_count()
    if n >= TP:
        return [torch.device("cuda", i) for i in range(TP)]
    return [torch.device("cuda", 0)] * TP


def _tp_prompts(n=TP_CHATS, seed=41) -> list:
    """``n`` chats of ~TP_PROMPT_TOKENS byte-tokenizer tokens, distinct
    from their first page (no two share a prefix-cache page)."""
    rng = np.random.default_rng(seed)
    words = ["press", "ink", "type", "paper", "guild", "folio", "quire",
             "platen", "forme", "serif", "vellum", "matrix"]
    out = []
    for i in range(n):
        text = f"Chat {i}: {rng.integers(10**8)} "
        while len(text) < TP_PROMPT_TOKENS - 40:
            text += words[int(rng.integers(len(words)))] + " "
        out.append(text)
    return out


def _card_bytes(devs) -> dict:
    return {d.index: torch.cuda.memory_allocated(d) for d in set(devs)}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return nbytes(tree)


def _whole_bytes(cfg) -> int:
    """The unsharded dense model's bf16 weight bytes, from its shapes:
    the embedding and ``lm_head``, every layer's two norms and seven
    projections, the final norm."""
    E, V, F = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = 2 * E + E * q + 2 * E * kv + q * E + 3 * E * F
    heads = V * E * (1 if cfg.tie_word_embeddings else 2)
    return 2 * (heads + cfg.num_layers * layer + E)


def _rounded(ms: dict) -> dict:
    return {k: round(v, 1) for k, v in ms.items()}


def _kind_of(name: str) -> str:
    """A device event's class: K1's split kernel, K2, a GEMM, a copy or
    other (K1's merge pass among them)."""
    low = name.lower()
    if "ragged_split_kernel" in name:
        return "k1"
    if "flash_kernel" in name or "flash_wgmma_kernel" in name:
        return "k2"
    if "memcpy" in low:
        return "copy"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def _card_trace(prof, wall_ms: float) -> tuple:
    """Per card of a ``torch.profiler`` capture: the device-busy ms (each
    event's duration summed; a copy beside a kernel counts twice), its
    split by ``_kind_of``, the K1 (``ragged_split_kernel``) and K2
    (``flash_``) kernels run, and the idle share of ``wall_ms``; with the
    host's CUDA runtime calls, total ms by name."""
    cards, host = {}, {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            if name.startswith("cuda"):
                host[name] = host.get(name, 0.0) + e.duration_ns() / 1e6
            continue
        c = cards.setdefault(e.device_index(), {
            "busy_ms": 0.0, "k1": 0, "k2": 0,
            "ms": {k: 0.0 for k in ("gemm", "k1", "k2", "copy", "other")}})
        ms = e.duration_ns() / 1e6
        kind = _kind_of(name)
        c["busy_ms"] += ms
        c["ms"][kind] += ms
        # one K1 launch = one split kernel (and its merge pass); one K2
        # launch = one flash kernel
        if kind in ("k1", "k2"):
            c[kind] += 1
    for c in cards.values():
        c["idle_share"] = 1.0 - c["busy_ms"] / wall_ms
    return cards, host


def _tp_trace(base, eng, devs, prompts) -> dict:
    """``prompts`` (TP_TRACE_TOKENS new tokens each) under
    ``torch.profiler``: per card, the device-busy ms, the idle share of
    the wall, and the K1 and K2 kernels it ran; with the engine's
    attention forwards meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    a0 = dict(eng.attn_forwards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            list(ex.map(lambda p: _chat(base, p, TP_TRACE_TOKENS), prompts))
        for d in set(devs):
            torch.cuda.synchronize(d)
        wall = (time.monotonic() - t0) * 1e3
    cards, _host = _card_trace(prof, wall)
    calls = {k: eng.attn_forwards.get(k, 0) - a0.get(k, 0)
             for k in ("k1", "k2")}
    return {"wall_ms": wall, "cards": cards, "attn_forwards": calls}


def _tp_chunk_split(eng, devs) -> dict:
    """One cold 4096-token prefill chunk through ``forward_sharded``
    (K2 on every shard, hidden states only; ``forward`` at tp 1, when
    ``devs`` is None), timed whole on the host's clock with every card
    synchronised, against the same 64 sums of ``[4096, 4096]`` float32
    partials alone: compute = whole - sums.  Then one chunk under
    ``torch.profiler``: each card's busy ms by kind and idle share, the
    host's ms until the forward returned (its issue time, a layer's share
    of it) and its CUDA runtime calls by time."""
    from torch.profiler import ProfilerActivity, profile

    from helix_tpu_torch.models.llama import (
        forward,
        forward_sharded,
        prefill_attn_fn,
    )
    from helix_tpu_torch.parallel import collectives

    cfg, mesh = eng.model_cfg, eng.mesh
    devs = devs or [eng.device]
    S = TP_ENTRY["max_prefill_len"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    tok = torch.randint(4, cfg.vocab_size, (1, S), generator=gen,
                        device=devs[0])
    pos = torch.arange(S, device=devs[0])[None]
    segs = [torch.ones((1, S), dtype=torch.int32, device=d) for d in devs]

    def attn_of(seg):
        return lambda q, k, v, c, p: (prefill_attn_fn(
            q, k, v, None, p, segment_ids=seg), c[0])

    def sync():
        for d in set(devs):
            torch.cuda.synchronize(d)

    def whole():
        if mesh is None:
            forward(eng.params, cfg, tok, pos, return_hidden=True,
                    attn_fn=lambda q, k, v, c, p: prefill_attn_fn(
                        q, k, v, None, p, segment_ids=segs[0]))
            return
        forward_sharded(eng.params, cfg, tok, pos,
                        attn_fns=[attn_of(s) for s in segs],
                        carry_caches=[None] * len(devs), mesh=mesh,
                        return_hidden=True)

    parts = [torch.randn((1, S, cfg.hidden_size), generator=gen,
                         device="cuda").to(d) for d in devs]

    def sums():
        for _ in range(2 * cfg.num_layers):
            collectives.all_reduce(parts, devs, torch.bfloat16)

    def timed(fn):
        fn()
        sync()
        out = []
        for _ in range(TP_SUM_REPS):
            t0 = time.monotonic()
            fn()
            sync()
            out.append((time.monotonic() - t0) * 1e3)
        return sorted(out)[len(out) // 2]

    out = {"chunk_ms": timed(whole),
           "sums_ms": timed(sums) if mesh is not None else 0.0}
    out["compute_ms"] = out["chunk_ms"] - out["sums_ms"]
    out["sums_share"] = out["sums_ms"] / out["chunk_ms"]
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        whole()
        issued = time.monotonic()
        sync()
        wall = (time.monotonic() - t0) * 1e3
    cards, host = _card_trace(prof, wall)
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:5])
    out["trace"] = {"wall_ms": wall, "issue_ms": (issued - t0) * 1e3,
                    "host_ms_per_layer": (issued - t0) * 1e3
                    / cfg.num_layers, "cards": cards, "host_calls_ms": top}
    return out


def _tp_run(tag, devs, prompts, smi) -> dict:
    """The entry served (tp 4 over ``devs``, or tp 1 when ``devs`` is
    None) behind the OpenAI server: the 16-chat wave admitted together,
    the seeded request twice, the traced wave and (tp 4) the chunk's
    split.  Per card: bytes after the build against the shards' share."""
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1, K1_INT8

    _free()
    cards = sorted(set(devs or [torch.device("cuda", 0)]),
                   key=lambda d: d.index)
    before = _card_bytes(cards)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    mesh = build_mesh(MeshSpec(tp=TP), devs) if devs else None
    t0 = time.monotonic()
    served = build_served_model(
        MODEL, device="cuda", seed=0, engine=dict(TP_ENTRY),
        context_length=TP_CONTEXT, mesh=mesh)
    build_s = time.monotonic() - t0
    served.tokenizer = _IdTokenizer(served.tokenizer)
    eng, loop = served.loop.engine, served.loop
    httpd, base, registry = _start_server(served)
    grew = {i: b - before[i] for i, b in _card_bytes(cards).items()}
    peak = {d.index: torch.cuda.max_memory_allocated(d) for d in cards}
    cfg = CATALOG[MODEL]
    whole = _whole_bytes(cfg) + eng.cache_cfg.total_bytes(cfg)
    shards = eng.params if devs else [eng.params]
    pools = eng.caches
    per_card = {}
    for tree, pool in zip(shards, pools):
        i = pool.k_pages.device.index
        per_card[i] = per_card.get(i, 0) + _tree_bytes(tree) + sum(
            nbytes(t) for t in pool.carry())
    n = len(shards)
    share = {i: whole * sum(1 for p in pools if p.k_pages.device.index
                            == i) / n for i in per_card}
    log(f"[{tag}] built {'tp ' + str(TP) if devs else 'tp 1'} over "
        f"{[str(d) for d in (devs or cards)]} in {build_s:.1f} s; whole "
        f"model {whole / 1e9:.3f} GB (weights + pool); per card: "
        + "; ".join(f"cuda:{i} grew {grew[i] / 1e9:.3f} GB, its shards "
                    f"{per_card[i] / 1e9:.3f} GB, share {share[i] / 1e9:.3f}"
                    f" GB ({grew[i] / share[i]:.4f}x), build peak "
                    f"{peak[i] / 1e9:.2f} GB" for i in sorted(grew))
        + f" ({smi})")
    try:
        K1.launches = K1_INT8.launches = K2.launches = 0
        a0 = dict(eng.attn_forwards)
        c0 = eng.num_decode_tokens
        eng.recent_ttfts.clear()
        texts, batch_s, _ = _gated_batch(base, loop, prompts,
                                         TP_NEW_TOKENS)
        ttfts = sorted(eng.recent_ttfts)
        decode_tokens = eng.num_decode_tokens - c0
        seeded = _seeded_twice(base)
        for d in cards:
            torch.cuda.synchronize(d)
        launches = {"ragged_paged_attention": K1.launches,
                    "ragged_paged_attention_int8": K1_INT8.launches,
                    "flash_attention": K2.launches}
        calls = {k: eng.attn_forwards.get(k, 0) - a0.get(k, 0)
                 for k in ("k1", "k2")}
        # fresh prompts: the traced wave runs K2 as well as K1
        trace = _tp_trace(base, eng, devs or cards,
                          _tp_prompts(TP_TRACE_CHATS, seed=42))
        chunk = _tp_chunk_split(eng, devs)
    finally:
        _unserve(served, httpd, registry)
    out = {"texts": texts, "answered": sum(1 for t in texts if t),
           "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3 if ttfts
           else float("nan"),
           "decode_tok_s": decode_tokens / batch_s, "batch_s": batch_s,
           "seeded": seeded, "launches": launches, "attn_forwards": calls,
           "trace": trace, "chunk": chunk, "grew": grew,
           "per_card": per_card, "share": share, "peak": peak,
           "build_s": build_s, "layers": cfg.num_layers, "shards": n}
    del served, eng, loop, registry
    _free()
    return out


def _tp_witness(devs, smi) -> dict:
    """(c) 2 layers at full width in float32 (TF32 off), the same
    weights: tp 4 over ``devs`` against tp 1 on the card, 8 chats of
    40-700 tokens (one chunked), greedy ids demanded equal."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params, param_logical_axes
    from helix_tpu_torch.parallel.sharding import shard_params

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(CATALOG[MODEL],
                                  num_layers=TP_WITNESS_LAYERS,
                                  dtype="float32")
        params = init_params(cfg, 0, device="cuda")
        ecfg = dict(max_decode_batch=8, page_size=16, num_pages=512,
                    max_pages_per_seq=64, max_prefill_len=512)
        rng = np.random.default_rng(43)
        prompts = [[int(x) for x in rng.integers(4, 120000, n)]
                   for n in (40, 700, 90, 300, 17, 450, 260, 128)]
        s = SamplingParams(temperature=0.0, max_tokens=TP_WITNESS_TOKENS)
        one = Engine(cfg, params, EngineConfig(**ecfg), device="cuda")
        want = one.generate(prompts, s)
        del one
        mesh = build_mesh(MeshSpec(tp=TP), devs)
        shards = shard_params(params, mesh, param_logical_axes(cfg))
        del params
        tp = Engine(cfg, shards, EngineConfig(**ecfg), mesh=mesh)
        got = tp.generate(prompts, s)
        del tp, shards
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    same = sum(a == b for a, b in zip(got, want))
    log(f"[tp witness] {TP_WITNESS_LAYERS} layers at full width, float32, "
        f"TF32 off: tp {TP} over {[str(d) for d in devs]} against tp 1: "
        f"{same} of {len(prompts)} greedy streams of {TP_WITNESS_TOKENS} "
        f"tokens equal ({smi})")
    _free()
    if same != len(prompts):
        raise AssertionError(f"tp witness: {same} of {len(prompts)} greedy "
                             "streams equal to tp 1")
    return {"equal": same, "of": len(prompts)}


def _tp_profile_cut() -> tuple:
    """The v5e8 profile cut to its Llama entry as written, for nvidia
    cards: (profile dict, cuts)."""
    from helix_tpu_torch.cli import _load_profile

    prof = _load_profile(TP_PROFILE)
    cuts = [f"dropped {m['name']}" for m in prof["models"]
            if m["name"] != MODEL]
    prof["models"] = [m for m in prof["models"] if m["name"] == MODEL]
    cuts.append(f"requirement {prof['requirement']} -> "
                f"{{'vendor': 'nvidia', 'chips': {TP}}}")
    prof["requirement"] = {"vendor": "nvidia", "chips": TP}
    return prof, cuts


def _tp_node(smi, tmpdir) -> dict:
    """(b) ``serve-node --profile <cut> --random-weights`` in process
    (``cli.make_node``): on four cards the entry is served tensor
    parallel over cards 0-3, 8 chats are answered and the trace shows K1
    and K2 on every card; on fewer the apply fails with the reference's
    ``slice_devices`` text and nothing is built."""
    from helix_tpu_torch import cli

    prof, cuts = _tp_profile_cut()
    path = os.path.join(tmpdir, "tp-node.json")
    with open(path, "w") as f:
        json.dump(prof, f)
    n = torch.cuda.device_count()
    before = torch.cuda.memory_allocated(0)
    agent, httpd = cli.make_node(_node_args(None, "tp-node", path))
    serving = False
    try:
        if n < TP:
            want = (f"MeshSpec wants devices [0, {TP}) but only {n} "
                    "devices are visible")
            ok = (agent.state.status == "failed"
                  and want in agent.state.error
                  and agent.registry.names() == []
                  and torch.cuda.memory_allocated(0) == before)
            log(f"[tp node] {n} card(s) visible: the cut profile "
                f"({'; '.join(cuts)}) is refused with the reference's "
                f"text {want!r}: {ok} (status {agent.state.status}, nothing "
                "built)")
            if not ok:
                raise AssertionError(f"tp node: expected the refusal, got "
                                     f"{agent.state.status}: "
                                     f"{agent.state.error[:300]}")
            return {"refused": True}
        if agent.state.status != "running":
            raise AssertionError(f"tp node: apply failed: "
                                 f"{agent.state.error}")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        serving = True
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        served = agent.registry.get(MODEL)
        eng = served.loop.engine
        devs = list(eng.mesh.devices)
        outs = _concurrent(base, [[{"role": "user", "content": p}]
                                  for p in _tp_prompts(8)], 32)
        trace = _tp_trace(base, eng, devs, _tp_prompts(TP_TRACE_CHATS,
                                                       seed=43))
        L = eng.model_cfg.num_layers
        calls = trace["attn_forwards"]
        log(f"[tp node] the cut profile ({'; '.join(cuts)}) applied over "
            f"{[str(d) for d in devs]}: {len(outs)} of 8 chats answered; "
            "traced per card: " + "; ".join(
                f"cuda:{i} K1 {c['k1']} K2 {c['k2']} busy "
                f"{c['busy_ms']:.1f} ms idle {c['idle_share']:.3f}"
                for i, c in sorted(trace["cards"].items()))
            + f" (attention forwards {calls}) ({smi})")
        bad = [i for i in range(TP)
               if trace["cards"].get(i, {}).get("k1", 0) != L * calls["k1"]
               or trace["cards"].get(i, {}).get("k2", 0) != L * calls["k2"]]
        if len(outs) != 8 or bad:
            raise AssertionError(f"tp node: {len(outs)} of 8 answered; "
                                 f"cards with launches unlike L x calls: "
                                 f"{bad}")
        return {"refused": False, "trace": trace}
    finally:
        agent.stop()
        if serving:
            httpd.shutdown()
        httpd.server_close()
        agent.apply_profile(None)
        _free()


def _tp_links(devs) -> dict:
    """Between the first card and each other one (``nvidia-smi topo -m``
    may not run in a sandbox): whether it has peer access, and the rate
    of a 256 MiB copy each way (CUDA events on the sending card, the
    median of 5)."""
    out = {}
    first = devs[0]
    for d in sorted(set(devs[1:]) - {first}, key=lambda d: d.index):
        row = {"peer": torch.cuda.can_device_access_peer(first.index,
                                                         d.index)}
        for a, b in ((first, d), (d, first)):
            src = torch.empty(256 << 20, dtype=torch.uint8, device=a)
            dst = torch.empty_like(src, device=b)
            times = []
            for _ in range(6):
                torch.cuda.synchronize(a)
                torch.cuda.synchronize(b)
                t0 = time.monotonic()
                dst.copy_(src)
                torch.cuda.synchronize(a)
                torch.cuda.synchronize(b)
                times.append(time.monotonic() - t0)
            row[f"{a.index}->{b.index} GB/s"] = round(
                src.numel() / sorted(times[1:])[2] / 1e9, 1)
        out[f"cuda:{first.index}-cuda:{d.index}"] = row
    return out


@_timed
def phase_tp(smi) -> dict:
    """4q. Tensor parallel on one host: ``profiles/v5e8-llama3-plus-
    embed.yaml``'s Llama entry at tp 4 (see the module docstring)."""
    devs = _tp_devices()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(f"[tp] tp_cards {[str(d) for d in devs]} "
        f"({torch.cuda.device_count()} visible); nvidia-smi topo -m:\n"
        + topo)
    links = _tp_links(devs)
    prompts = _tp_prompts()
    run4 = _tp_run("tp a", devs, prompts, smi)
    run1 = _tp_run("tp a, tp 1", None, prompts, smi)
    L, n = run4["layers"], run4["shards"]
    agree = sum(a == b for a, b in zip(run4["texts"], run1["texts"]))
    tok_same = tok_all = 0
    for a, b in zip(run4["texts"], run1["texts"]):
        ta, tb = re.findall(r"<\d+>", a), re.findall(r"<\d+>", b)
        tok_all += len(tb)
        k = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 min(len(ta), len(tb)))
        tok_same += k
    ch = run4["chunk"]
    log(f"[tp a] tp {TP}: answered {run4['answered']} of {TP_CHATS} chats "
        f"of ~{TP_PROMPT_TOKENS} tokens x {TP_NEW_TOKENS}; TTFT p50 "
        f"{run4['ttft_p50_ms']:.1f} ms (tp 1 {run1['ttft_p50_ms']:.1f}); "
        f"decode {run4['decode_tok_s']:.1f} tok/s (tp 1 "
        f"{run1['decode_tok_s']:.1f}, ratio "
        f"{run4['decode_tok_s'] / run1['decode_tok_s']:.3f}); wave "
        f"{run4['batch_s']:.2f} s (tp 1 {run1['batch_s']:.2f}); seeded "
        f"request reproduced ({run4['seeded'].count('<')} tokens); bf16 "
        f"greedy streams equal to tp 1's: {agree} of {TP_CHATS} (recorded, "
        f"not demanded; the common prefix holds {tok_same} of {tok_all} "
        f"tokens); launches {run4['launches']}, attention forwards "
        f"{run4['attn_forwards']}; traced {TP_TRACE_CHATS} chats x "
        f"{TP_TRACE_TOKENS}: wall {run4['trace']['wall_ms']:.1f} ms, per "
        "card " + "; ".join(
            f"cuda:{i} K1 {c['k1']} K2 {c['k2']} busy {c['busy_ms']:.1f} ms "
            f"idle {c['idle_share']:.3f}"
            for i, c in sorted(run4["trace"]["cards"].items()))
        + f" (tp 1: busy {run1['trace']['cards'][0]['busy_ms']:.1f} ms, idle "
        f"{run1['trace']['cards'][0]['idle_share']:.3f}); one "
        f"{TP_ENTRY['max_prefill_len']}-token prefill chunk "
        f"{ch['chunk_ms']:.1f} ms = compute {ch['compute_ms']:.1f} + "
        f"{2 * L} sums {ch['sums_ms']:.1f} ms ({ch['sums_share']:.3f}; "
        f"tp 1 {run1['chunk']['chunk_ms']:.1f} ms, traced: wall "
        f"{run1['chunk']['trace']['wall_ms']:.1f}, issued in "
        f"{run1['chunk']['trace']['issue_ms']:.1f} ms, busy "
        f"{_rounded(run1['chunk']['trace']['cards'][0]['ms'])}); "
        f"traced chunk: wall {ch['trace']['wall_ms']:.1f} ms, the host "
        f"issued it in {ch['trace']['issue_ms']:.1f} ms "
        f"({ch['trace']['host_ms_per_layer']:.2f} ms a layer), host CUDA "
        f"calls (ms) {_rounded(ch['trace']['host_calls_ms'])}, per card "
        + "; ".join(
            f"cuda:{i} busy {c['busy_ms']:.1f} ms {_rounded(c['ms'])} idle "
            f"{c['idle_share']:.3f}"
            for i, c in sorted(ch["trace"]["cards"].items()))
        + f"; links {links} ({smi})")
    problems = []
    if run4["answered"] != TP_CHATS or run1["answered"] != TP_CHATS:
        problems.append(f"answered {run4['answered']} / {run1['answered']}"
                        f" of {TP_CHATS}")
    # the counters over the wave and the seeded pair: every forward ran
    # every layer on every shard
    want_k1 = n * L * run4["attn_forwards"]["k1"]
    want_k2 = n * L * run4["attn_forwards"]["k2"]
    if run4["launches"]["ragged_paged_attention_int8"] != want_k1 \
            or run4["launches"]["flash_attention"] != want_k2 \
            or want_k1 <= 0 or want_k2 <= 0:
        problems.append(f"launches {run4['launches']} against shards x "
                        f"layers x forwards {want_k1} / {want_k2}")
    # the profiler's per-card counts: each card = its shards x layers x
    # the traced attention forwards
    calls = run4["trace"]["attn_forwards"]
    for i, c in run4["trace"]["cards"].items():
        k = sum(1 for d in devs if d.index == i)
        if c["k1"] != k * L * calls["k1"] or c["k2"] != k * L * calls["k2"]:
            problems.append(f"cuda:{i} traced K1 {c['k1']} / K2 {c['k2']} "
                            f"against {k} x {L} x {calls}")
    for i, g in run4["grew"].items():
        if abs(g - run4["share"][i]) > MEM_TOL * run4["share"][i]:
            problems.append(f"cuda:{i} grew {g} B, not within "
                            f"{MEM_TOL:.0%} of its share "
                            f"{run4['share'][i]:.0f} B")
        if i != devs[0].index and g > run4["per_card"][i] + MEM_SLACK:
            problems.append(f"cuda:{i} holds {g} B beyond its shards "
                            f"{run4['per_card'][i]} B")
    if problems:
        raise AssertionError("tp a: " + "; ".join(problems))
    with tempfile.TemporaryDirectory(prefix="helix-tp-") as tmp:
        node = _tp_node(smi, tmp)
    witness = _tp_witness(devs, smi)
    return {"launches": run4["launches"], "run4": run4, "run1": run1,
            "node": node, "witness": witness, "links": links}


@_timed
def phase_parity(int8: bool = False) -> dict:
    """Full width, 2 layers, same weights; prefill + 8 decode steps with
    the kernels and with the plain versions.  Logits are compared while
    the two token streams agree (random weights give near-tied argmaxes,
    so the streams may part; the step where they part is still compared,
    its inputs being identical).  Tolerance LOGIT_TOL: logits of std
    ~1.3 from bf16 activations whose attention outputs differ by up to a
    bf16 ulp per layer, and logits that round once from f32.  With
    ``int8`` (int8 weights quantized on the card, int8 KV pool) the plain
    version also rounds the dequantized history to bf16 where the kernel
    keeps it in f32: one more bf16 rounding of the attention inputs, of
    the same size, under the same tolerance."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.ops.quant import quantize_params

    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2)
    params = init_params(cfg, 1, device="cuda")
    extra = {}
    if int8:
        params = quantize_params(params)
        extra["kv_cache_dtype"] = "int8"
    prompt = [int(x) for x in np.random.default_rng(5).integers(
        4, 260, size=300)]
    runs = []
    for backend in (None, "reference"):     # kernels, then plain versions
        eng = Engine(cfg, params, EngineConfig(
            max_decode_batch=8, page_size=16, num_pages=512,
            max_pages_per_seq=64, max_prefill_len=512,
            attn_backend=backend, **extra), device="cuda")
        logits = []
        eng.logits_hook = lambda kind, x: logits.append(x[:1].float().clone())
        toks = eng.generate([prompt], SamplingParams(temperature=0.0,
                                                     max_tokens=9))[0]
        runs.append((toks, logits))
    (tk, lk), (tp, lp) = runs
    n_same = next((i for i, (a, b) in enumerate(zip(tk, tp)) if a != b),
                  len(tk))
    compared = min(n_same + 1, len(lk), len(lp))
    errs = [(lk[i] - lp[i]).abs().max().item() for i in range(compared)]
    err = max(errs)
    tag = "parity int8" if int8 else "parity"
    log(f"[{tag}] 2-layer full width: {compared} logit steps compared "
        f"(tokens agree for {n_same} of {len(tk)}), max |dlogit| {err:.4f} "
        f"(tol {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"engine logits differ by {err} > {LOGIT_TOL}")
    return {"steps": compared, "max_abs_logit_err": err}


# ---------------------------------------------------------------------------


def kernel_line(k1_rows, k1_int8_rows, k2_rows, launches, infos,
                by_path=None, cold_rows=(), cold_int8_rows=(),
                k2b_rows=()) -> dict:
    """The kernels JSON line: ``launches`` is the count on the first main
    path that runs the kernel, ``launches_by_path`` each path's own."""
    by_path = by_path or {}

    def entry(name, source, replaces, rows):
        head = rows[0]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(name),
            "launches_by_path": by_path.get(name, {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "smem_bytes": infos[name]["smem_bytes"],
            "regs": infos[name]["regs"],
            "blocks_per_sm": infos[name]["blocks_per_sm"],
            "design": DESIGN[name],
            "cases": rows,
        }

    return {"kernels": [
        entry("ragged_paged_attention",
              "helix_tpu_torch/csrc/ragged_paged_attention.cu",
              "helix_tpu/ops/paged_kernel.py:452", k1_rows),
        entry("ragged_paged_attention_int8",
              "helix_tpu_torch/csrc/ragged_paged_attention.cu",
              "helix_tpu/ops/paged_kernel.py:452 (quantized)", k1_int8_rows),
        entry("flash_attention",
              "helix_tpu_torch/csrc/flash_attention.cu",
              "helix_tpu/ops/attention.py:258", k2_rows),
        entry("ragged_paged_attention_cold",
              "helix_tpu_torch/csrc/ragged_paged_attention_cold.cu",
              "helix_tpu/ops/paged.py:132 (tiered; no Pallas form)",
              cold_rows),
        entry("ragged_paged_attention_int8_cold",
              "helix_tpu_torch/csrc/ragged_paged_attention_cold.cu",
              "helix_tpu/ops/paged.py:132 (tiered, int8; no Pallas form)",
              cold_int8_rows),
        entry("flash_attention_backward",
              "helix_tpu_torch/csrc/flash_attention_bwd.cu",
              "helix_tpu/ops/attention.py:258 (its gradient: no Pallas "
              "backward, JAX differentiates it, helix_tpu/training/"
              "sft.py:102)", k2b_rows),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "hotswap", "adapters",
                             "checkpoint", "slo", "node", "tunnel",
                             "disagg", "context", "vision", "moe",
                             "train", "tp"),
                    default="all",
                    help="'kernels': build + kernel checks only; "
                         "'hotswap' / 'adapters' / 'checkpoint' / 'slo' / "
                         "'node' / 'tunnel' / 'disagg' / 'context' / "
                         "'vision' / 'moe' / 'train' / 'tp': those and the "
                         "hot-swap / adapter / checkpoint / scheduler / "
                         "node-agent / tunnel and embedding / disagg "
                         "handoff and filestore / tiered context / "
                         "Qwen2-VL / Mixtral / LoRA SFT / tensor-parallel "
                         "phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import helix_tpu_torch  # noqa: F401  (fails outside a checkout)

    _watch_step_failures()
    dev = phase_device()
    k2_rows = phase_k2()
    k1_rows = phase_k1()
    k1_int8_rows = phase_k1_int8()
    k2_phi3, k1_int8_phi3 = phase_phi3_kernels()
    k2_rows += k2_phi3
    k1_int8_rows += k1_int8_phi3
    k2_vl, k1_vl = phase_vl_kernels()
    k2_rows += k2_vl
    k1_rows += k1_vl
    cold_rows, cold_int8_rows = phase_k1_cold()
    k2_train, k2b_rows = phase_k2_backward()
    k2_rows += k2_train
    k2_tp, k1_int8_tp = phase_tp_kernels()
    k2_rows += k2_tp
    k1_int8_rows += k1_int8_tp
    launches, by_path = {}, {}
    if args.phase == "hotswap":
        swap = phase_hotswap(dev["smi"])
        launches = dict(swap["launches"])
        by_path = {k: {"hotswap": n} for k, n in launches.items()}
    if args.phase == "adapters":
        ad = phase_adapters(dev["smi"])
        phase_adapter_exact(dev["smi"])
        launches = dict(ad["launches"])
        by_path = {k: {"adapters": n} for k, n in launches.items()}
    if args.phase == "checkpoint":
        ck = phase_checkpoint(dev["smi"])
        launches = dict(ck["launches"])
        by_path = {k: {"checkpoint": n} for k, n in launches.items()}
    if args.phase == "slo":
        slo = phase_slo(dev["smi"])
        launches = {k: n for k, n in slo["launches"].items() if n}
        by_path = {k: {"slo": n} for k, n in launches.items()}
    if args.phase == "node":
        node = phase_node_agent(dev["smi"])
        launches = {k: n for k, n in node["launches"].items() if n}
        by_path = {k: {"node": n} for k, n in launches.items()}
    if args.phase == "tunnel":
        tun = phase_tunnel(dev["smi"])
        launches = {k: n for k, n in tun["launches"].items() if n}
        by_path = {k: {"tunnel": n} for k, n in launches.items()}
    if args.phase == "disagg":
        dis = phase_disagg(dev["smi"])
        launches = {k: n for k, n in dis["launches"].items() if n}
        by_path = {k: {"disagg": n} for k, n in launches.items()}
    if args.phase == "context":
        ctx = phase_context(dev["smi"])
        launches = dict(ctx["launches"])
        by_path = {k: {"context": n} for k, n in launches.items()}
    if args.phase == "vision":
        vis = phase_vision(dev["smi"])
        launches = dict(vis["launches"])
        by_path = {k: {"vision": n} for k, n in launches.items()}
    if args.phase == "moe":
        moe = phase_moe(dev["smi"])
        launches = dict(moe["launches"])
        by_path = {k: {"moe": n} for k, n in launches.items()}
    if args.phase == "train":
        tr = phase_train(dev["smi"])
        launches = dict(tr["launches"])
        by_path = {k: {"train": n} for k, n in launches.items()}
    if args.phase == "tp":
        tpr = phase_tp(dev["smi"])
        launches = {k: n for k, n in tpr["launches"].items() if n}
        by_path = {k: {"tp": n} for k, n in launches.items()}
    if args.phase == "all":
        # each path's own launches: the bf16 phase's for the float forms,
        # the int8 phase's for K1's int8 form
        bf16 = phase_e2e("bf16")
        phase_async(bf16)
        int8 = phase_e2e("int8", quantization="int8", kv_cache_dtype="int8")
        phase_spec()
        phase_oracle()
        phase_oracle(int8=True)
        phase_host_tier(dev["smi"])
        phase_host_exact(dev["smi"])
        phase_host_exact(dev["smi"], int8=True)
        swap = phase_hotswap(dev["smi"])
        ad = phase_adapters(dev["smi"])
        phase_adapter_exact(dev["smi"])
        ck = phase_checkpoint(dev["smi"])
        slo = phase_slo(dev["smi"])
        node = phase_node_agent(dev["smi"], agent_free={
            "texts": slo["chat_texts"], "busy_ms": slo["trace"]["on"][0],
            "from": "phase 4i"})
        tun = phase_tunnel(dev["smi"])
        dis = phase_disagg(dev["smi"])
        ctx = phase_context(dev["smi"])
        vis = phase_vision(dev["smi"])
        moe = phase_moe(dev["smi"])
        tr = phase_train(dev["smi"])
        tpr = phase_tp(dev["smi"])
        launches = {
            "ragged_paged_attention":
                bf16["launches"]["ragged_paged_attention"],
            "flash_attention": bf16["launches"]["flash_attention"],
            "ragged_paged_attention_int8":
                int8["launches"]["ragged_paged_attention_int8"],
            "ragged_paged_attention_int8_cold":
                ctx["launches"]["ragged_paged_attention_int8_cold"],
            "ragged_paged_attention_cold":
                ctx["launches"]["ragged_paged_attention_cold"],
            "flash_attention_backward":
                tr["launches"]["flash_attention_backward"],
        }
        by_path = {
            "ragged_paged_attention": {
                "bf16": bf16["launches"]["ragged_paged_attention"],
                "vision": vis["launches"]["ragged_paged_attention"],
                "moe": moe["launches"]["ragged_paged_attention"]},
            "flash_attention": {
                "bf16": bf16["launches"]["flash_attention"],
                "hotswap": swap["launches"]["flash_attention"],
                "adapters": ad["launches"]["flash_attention"],
                "checkpoint": ck["launches"]["flash_attention"],
                "slo": slo["launches"]["flash_attention"],
                "node": node["launches"]["flash_attention"],
                "tunnel": tun["launches"]["flash_attention"],
                "disagg": dis["launches"]["flash_attention"],
                "vision": vis["launches"]["flash_attention"],
                "moe": moe["launches"]["flash_attention"],
                "train": tr["launches"]["flash_attention"],
                "tp": tpr["launches"]["flash_attention"]},
            "ragged_paged_attention_int8": {
                "int8": int8["launches"]["ragged_paged_attention_int8"],
                "hotswap":
                    swap["launches"]["ragged_paged_attention_int8"],
                "adapters":
                    ad["launches"]["ragged_paged_attention_int8"],
                "checkpoint":
                    ck["launches"]["ragged_paged_attention_int8"],
                "slo": slo["launches"]["ragged_paged_attention_int8"],
                "node": node["launches"]["ragged_paged_attention_int8"],
                "tunnel":
                    tun["launches"]["ragged_paged_attention_int8"],
                "disagg":
                    dis["launches"]["ragged_paged_attention_int8"],
                "tp": tpr["launches"]["ragged_paged_attention_int8"]},
            "ragged_paged_attention_int8_cold": {
                "context":
                    ctx["launches"]["ragged_paged_attention_int8_cold"]},
            "ragged_paged_attention_cold": {
                "context witness, 2 layers float32":
                    ctx["launches"]["ragged_paged_attention_cold"]},
            "flash_attention_backward": {
                "train": tr["launches"]["flash_attention_backward"]},
        }
        phase_parity()
        phase_parity(int8=True)
    _check_step_failures()
    log(json.dumps(kernel_line(k1_rows, k1_int8_rows, k2_rows, launches,
                               dev["infos"], by_path, cold_rows,
                               cold_int8_rows, k2b_rows)))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
