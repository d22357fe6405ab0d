#!/usr/bin/env python3
"""Chip smoke test of helix_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phase kernels # build + kernel checks only

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit (``nvidia-smi``), the CUDA
   version, and an ``nvcc`` build of both kernels from ``helix_tpu_torch/
   csrc/`` (one process per source, started together);
2. K2 (flash attention) and 3. K1 (ragged paged attention): each kernel's
   wrapper on the card at Llama-3-8B attention widths (H 32, KVH 8, D 128,
   bf16) and at the shapes the serving path gives it, held against its
   plain PyTorch version (per element, one bf16 ulp of the plain value;
   live tokens only) and shown to fail that check on planted faults (a
   key too many or too few), timed
   with CUDA events beside the plain version, one PyTorch library call
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take (``bound_ms``);
4. end to end: ``meta-llama/Meta-Llama-3-8B-Instruct`` at full width and
   depth in bf16 with random weights made on the card, served by the
   port's engine, loop and OpenAI HTTP server; chat (plain and SSE),
   completion, 8 concurrent chats, a prompt longer than max_prefill_len
   (chunked, mixed with a decoding request) and the same prompt again (a
   prefix-cache hit).  The kernels' launch counters are zeroed just
   before and read just after: both must have run;
5. parity: the engine at full width and 2 layers, kernels vs plain
   versions on the same weights, logits compared within a bf16
   tolerance.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` line,
and last the device JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
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
H, KVH, D = 32, 8, 128
MODEL = "meta-llama/Meta-Llama-3-8B-Instruct"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def tol_ratio(got, want) -> float:
    """Worst |got - want| / (BF16_ATOL + BF16_RTOL |want|): 1 is the limit."""
    got, want = got.float(), want.float()
    ratio = ((got - want).abs() / (BF16_ATOL + BF16_RTOL * want.abs()))
    ratio = ratio.max().item()
    if not np.isfinite(ratio):
        raise AssertionError("non-finite kernel output on live tokens")
    return ratio


def check(label, got, want) -> tuple:
    """(max_abs_err, worst tolerance ratio); raises past the limit."""
    err, ratio = max_err(got, want), tol_ratio(got, want)
    if ratio > 1.0:
        raise AssertionError(
            f"{label}: error {ratio:.2f}x the limit (max_abs_err {err:.3e}, "
            f"limit {BF16_ATOL} + {BF16_RTOL} |want|)")
    return err, ratio


def planted(label, got, want) -> float:
    """A deliberately wrong input must fail ``check``: shows the limit is
    tight enough to see a key too many or too few."""
    ratio = tol_ratio(got, want)
    if ratio <= 1.0:
        raise AssertionError(
            f"planted fault {label} passed the check ({ratio:.2f}x the "
            "limit): the limit is too loose")
    return ratio


# ---------------------------------------------------------------------------
# 1. device + build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    from helix_tpu_torch.kernels.build import build_all
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    compile_s = build_all([K1, K2])
    log(f"[build] nvcc for both kernels: {compile_s:.1f} s compile, "
        f"{time.monotonic() - t0:.1f} s incl. load")
    for k in (K1, K2):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                           k.build_log)]
        spills = re.findall(r"(\d+) bytes spill stores", k.build_log)
        if regs:
            log(f"[build] {k.name}: {len(regs)} instantiations, at most "
                f"{max(regs)} registers, spill stores "
                f"{max(int(s) for s in spills) if spills else 0} bytes")
    return {"smi": smi, "kind": name}


# ---------------------------------------------------------------------------
# 2. K2 flash attention
# ---------------------------------------------------------------------------


def _k2_case(label, seg_lens, gen):
    """One packed batch row: segments of ``seg_lens``, positions restart
    per segment (one segment = plain causal)."""
    from helix_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_plain,
    )

    dev = "cuda"
    S = sum(seg_lens)
    i32 = torch.int32
    pos = torch.cat([torch.arange(n, dtype=i32) for n in seg_lens])
    pos = pos[None].to(dev)
    seg = torch.cat([torch.full((n,), i + 1, dtype=i32) for i, n in
                     enumerate(seg_lens)])[None].to(dev)
    q = torch.randn((1, S, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, S, KVH, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, S, KVH, D), generator=gen, device=dev).bfloat16()
    kw = dict(q_positions=pos, kv_positions=pos)
    meta = [pos, pos]
    if len(seg_lens) > 1:
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
        meta += [seg, seg]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    err, ratio = check(f"K2 {label}", got, want)
    # planted fault: every query loses its own (diagonal) key
    fault = planted("K2 diagonal key dropped", flash_attention(
        q, k, v, **{**kw, "kv_positions": pos + 1}), want)
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
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
    pairs = sum(n * (n + 1) // 2 for n in seg_lens)
    b_ms, b_by = bound(4.0 * H * D * pairs, nbytes(q, k, v, got, *meta))
    row = dict(case=label, max_abs_err=err, tol_ratio=ratio,
               planted_fault_ratio=fault, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[K2] {label}: max_abs_err {err:.3e}, {ratio:.3f}x the limit "
        f"(sdpa {lib_err:.3e}; planted fault {fault:.1f}x) kernel_ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return row


def phase_k2() -> list:
    gen = torch.Generator(device="cuda").manual_seed(2)
    return [
        _k2_case("packed S=512, 4 segments", [140, 100, 152, 120], gen),
        _k2_case("causal S=2048", [2048], gen),
    ]


# ---------------------------------------------------------------------------
# 3. K1 ragged paged attention
# ---------------------------------------------------------------------------


def _k1_case(label, q_lens, hists, pool, gen, rng):
    from helix_tpu_torch.ops.paged_kernel import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    dev = "cuda"
    kp, vp = pool
    L, N, P = kp.shape[:3]
    maxP = 256
    R = len(q_lens)
    q_lens = np.asarray(q_lens, np.int32)
    hists = np.asarray(hists, np.int32)
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum())
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    meta = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
            for x in (t0, q_lens, hists, tables)]
    q = torch.randn((T, H, D), generator=gen, device=dev).bfloat16()
    kn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((T, KVH, D), generator=gen, device=dev).bfloat16()
    layer = 7
    args = (q, kn, vn, kp, vp, layer, *meta)
    got = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    want = ragged_paged_attention_plain(*args)
    err, ratio = check(f"K1 {label}", got, want)
    # planted faults: every row reads one history slot too few / too many
    faults = [planted(f"K1 hist{d:+d}", ragged_paged_attention(
        *args[:8], meta[2] + d, meta[3]), want) for d in (-1, 1)]
    ms = cuda_ms(lambda: ragged_paged_attention(*args), 20)
    plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args), 3, 1)
    # library yardstick: SDPA over each row's gathered history + fresh
    # tokens, rows padded to one batch (the gather is not timed)
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
    # bytes: the history K/V walked, the page-table entries walked
    # (ceil(hist / P) per row), the row metadata, q, fresh K/V and out
    hist_bytes = int(hists.sum()) * KVH * D * 2 * kp.element_size()
    table_bytes = int(sum(-(-int(h) // P) for h in hists)) * 4
    fresh_pairs = int(sum(n * (n + 1) // 2 for n in q_lens))
    flops = 4.0 * H * D * (int((q_lens * hists).sum()) + fresh_pairs)
    b_ms, b_by = bound(flops, hist_bytes + table_bytes
                       + nbytes(q, kn, vn, got, *meta[:3]))
    row = dict(case=label, max_abs_err=err, tol_ratio=ratio,
               planted_fault_ratio=min(faults), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[K1] {label}: max_abs_err {err:.3e}, {ratio:.3f}x the limit "
        f"(planted faults hist-1 {faults[0]:.1f}x, hist+1 {faults[1]:.1f}x)"
        f" kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    return row


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
    pool = (kp, vp)
    rows = [
        _k1_case("decode 8 rows, hist 1000-4000", [1] * 8,
                 rng.integers(1000, 4000, size=8), pool, gen, rng),
        _k1_case("mixed 256-token row (hist 512) + 7 decode rows",
                 [256] + [1] * 7,
                 [512] + list(rng.integers(1000, 4000, size=7)),
                 pool, gen, rng),
    ]
    del kp, vp, pool
    torch.cuda.empty_cache()
    return rows


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


def _chat(base, content, max_tokens, stream=False):
    body = {"model": MODEL, "max_tokens": max_tokens, "temperature": 0,
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


def phase_e2e() -> dict:
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.ops.attention import K2
    from helix_tpu_torch.ops.paged_kernel import K1
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry

    t0 = time.monotonic()
    served = build_served_model(
        MODEL, device="cuda", seed=0,
        engine=dict(max_decode_batch=8, page_size=16, num_pages=4096,
                    max_pages_per_seq=256, max_prefill_len=512),
    )
    eng = served.loop.engine
    cfg = eng.model_cfg
    log(f"[e2e] {MODEL}: L {cfg.num_layers} E {cfg.hidden_size} H "
        f"{cfg.num_heads} KVH {cfg.num_kv_heads} D {cfg.head_dim} F "
        f"{cfg.intermediate_size} V {cfg.vocab_size} {cfg.dtype}; built + "
        f"warmed in {time.monotonic() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    registry = ModelRegistry()
    registry.register(served)
    httpd = OpenAIServer(registry).start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    answered = 0
    try:
        # the main path starts here: counters to 0
        K1.launches = K2.launches = 0
        hits0, mixed0 = eng.prefix_cache_hits, eng.num_mixed_steps
        eng.recent_ttfts.clear()
        _chat(base, "Say hello in one line.", 16)
        _chat(base, "Count to five.", 16, stream=True)
        out = json.loads(_post(base + "/v1/completions", {
            "model": MODEL, "prompt": "The capital of France is",
            "max_tokens": 16, "temperature": 0}))
        assert out["object"] == "text_completion", out
        answered += 3
        # 8 concurrent chats of ~200 prompt tokens, 64 new tokens each
        prompts = [f"Request {i}: " + "summarise the history of the "
                   "printing press in plain words please. " * 3
                   for i in range(8)]
        dec0 = eng.num_decode_tokens
        t_b = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda p: _chat(base, p, 64), prompts))
        batch_s = time.monotonic() - t_b
        decode_tps = (eng.num_decode_tokens - dec0) / batch_s
        answered += len(outs)
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
        torch.cuda.synchronize()
        launches = {"ragged_paged_attention": K1.launches,
                    "flash_attention": K2.launches}
    finally:
        httpd.shutdown()
        httpd.server_close()
        registry.unregister(MODEL)
    ttfts = sorted(eng.recent_ttfts)
    ttft_p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else float("nan")
    mixed = eng.num_mixed_steps - mixed0
    hits = eng.prefix_cache_hits - hits0
    log(f"[e2e] requests answered {answered}; TTFT p50 {ttft_p50:.1f} ms "
        f"over {len(ttfts)} requests; decode {decode_tps:.1f} tok/s over "
        f"the 8-chat batch ({batch_s:.2f} s); mixed steps {mixed}; prefix "
        f"hits {hits}; launches {launches}")
    if launches["ragged_paged_attention"] <= 0:
        raise AssertionError("K1 never launched on the serving path")
    if launches["flash_attention"] <= 0:
        raise AssertionError("K2 never launched on the serving path")
    if mixed <= 0:
        raise AssertionError("no mixed step ran")
    if hits <= 0:
        raise AssertionError("no prefix-cache hit")
    del served, eng, registry
    torch.cuda.empty_cache()
    return {"launches": launches, "answered": answered,
            "ttft_p50_ms": ttft_p50, "decode_tokens_per_s": decode_tps}


# ---------------------------------------------------------------------------
# 5. parity: kernels vs plain versions inside the engine
# ---------------------------------------------------------------------------


def phase_parity() -> dict:
    """Full width, 2 layers, same weights; prefill + 8 decode steps with
    the kernels and with the plain versions.  Logits are compared while
    the two token streams agree (random weights give near-tied argmaxes,
    so the streams may part; the step where they part is still compared,
    its inputs being identical).  Tolerance LOGIT_TOL: logits of std
    ~1.3 from bf16 activations whose attention outputs differ by up to a
    bf16 ulp per layer, and bf16-rounded logits (ulp 2**-5 at |x| >= 4)."""
    from helix_tpu_torch.engine.engine import Engine, EngineConfig
    from helix_tpu_torch.engine.sampling import SamplingParams
    from helix_tpu_torch.models.common import CATALOG
    from helix_tpu_torch.models.llama import init_params

    cfg = dataclasses.replace(CATALOG[MODEL], num_layers=2)
    params = init_params(cfg, 1, device="cuda")
    prompt = [int(x) for x in np.random.default_rng(5).integers(
        4, 260, size=300)]
    runs = []
    for backend in (None, "reference"):     # kernels, then plain versions
        eng = Engine(cfg, params, EngineConfig(
            max_decode_batch=8, page_size=16, num_pages=512,
            max_pages_per_seq=64, max_prefill_len=512,
            attn_backend=backend), device="cuda")
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
    log(f"[parity] 2-layer full width: {compared} logit steps compared "
        f"(tokens agree for {n_same} of {len(tk)}), max |dlogit| {err:.4f} "
        f"(tol {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"engine logits differ by {err} > {LOGIT_TOL}")
    return {"steps": compared, "max_abs_logit_err": err}


# ---------------------------------------------------------------------------


def kernel_line(k1_rows, k2_rows, launches) -> dict:
    def entry(name, source, replaces, rows):
        head = rows[0]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(name),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "cases": rows,
        }

    return {"kernels": [
        entry("ragged_paged_attention",
              "helix_tpu_torch/csrc/ragged_paged_attention.cu",
              "helix_tpu/ops/paged_kernel.py:452", k1_rows),
        entry("flash_attention",
              "helix_tpu_torch/csrc/flash_attention.cu",
              "helix_tpu/ops/attention.py:258", k2_rows),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all",
                    help="'kernels': build + kernel checks only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import helix_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = phase_device()
    k2_rows = phase_k2()
    k1_rows = phase_k1()
    launches = {}
    if args.phase == "all":
        e2e = phase_e2e()
        launches = e2e["launches"]
        phase_parity()
    log(json.dumps(kernel_line(k1_rows, k2_rows, launches)))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
