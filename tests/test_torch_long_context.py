"""Tiered KV residency (ROADMAP A14): the port against the JAX package.

- the op: the plain version's tiered form (a demoted span per row, the
  staged cold chunks merged in) against
  ``helix_tpu.ops.paged.ragged_paged_attention_reference`` on the same
  inputs, float32 (1e-6) and int8 pools, bf16 (one bf16 ulp: rtol 2**-7,
  atol 1e-5, as ``tests/test_torch_ops.py``); a tiered call against the
  resident call on the same values;
- the engine: every ``TestTieredParity`` case of
  ``tests/test_long_context.py`` -- the port's tiered tokens equal its
  resident tokens and the JAX engine's tiered tokens (``attn_backend=
  "reference"``, float32);
- ``TestColdCorruption``'s fault on both engines, and through both engine
  loops, which end the request the same way;
- ``preempt`` / ``export_request`` refusing a tiered row as the reference
  does.

Inputs come from numpy seeds; weights are the JAX package's, converted.
"""

from __future__ import annotations

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine.kv_cache import ColdPageError as JColdPageError
from helix_tpu.engine.sampling import SamplingParams as JSamplingParams
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.ops import paged as jpaged
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.testing import faults as jfaults
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine.kv_cache import ColdPageError
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.ops import paged as tpaged
from helix_tpu_torch.ops.quant import quantize_kv
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.testing import faults as tfaults


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first: the JAX
    engine uploads host mirrors it goes on writing (an asynchronous copy
    on the CPU backend), so the reference runs on a snapshot taken at
    upload time."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


@pytest.fixture(autouse=True, scope="module")
def _reference_uploads_snapshot():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "jnp", _SnapshotJnp())
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


def _tiered_case(seed, L=2, N=160, P=4, KVH=2, D=16, H=4, maxP=24, Ct=8):
    """Rows of every kind: tiered decode and multi-token rows beside
    resident ones, a parked row, a tiered row whose span covers whole
    history pages from the first, chunks shorter than ``Ct`` and one
    chunk owned by no row.  Returns (resident case, tiered kwargs, the
    resident tables, the page-filled cold slab's source pages)."""
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    v_pages = rng.standard_normal((L, N, P, KVH, D)).astype(np.float32)
    q_len = np.array([1, 3, 0, 1, 5, 2], np.int32)
    hist = np.array([70, 60, 20, 40, 90, 33], np.int32)
    R = len(q_len)
    t0 = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    T = int(q_len.sum())
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    tables = tables.astype(np.int32)
    # page-aligned spans: rows 0, 1, 4 tiered (row 4 from page 0), 3 and
    # 5 resident
    span_lo = np.array([8, 4, 0, 0, 0, 0], np.int32)
    span_hi = np.array([48, 40, 0, 0, 64, 0], np.int32)
    owners, lens, src = [], [], []
    for r in range(R):
        for a in range(span_lo[r], span_hi[r], Ct):
            b = min(a + Ct, span_hi[r])
            owners.append(r)
            lens.append(b - a)
            src.append((r, a, b))
    owners.append(-1)
    lens.append(Ct)
    src.append(None)
    nC = len(owners)
    cold_k = rng.standard_normal((L, nC, Ct, KVH, D)).astype(np.float32)
    cold_v = rng.standard_normal((L, nC, Ct, KVH, D)).astype(np.float32)
    for c, s in enumerate(src):
        if s is None:
            continue
        r, a, b = s
        for j, tok in enumerate(range(a, b)):
            pg = tables[r, tok // P]
            cold_k[:, c, j] = k_pages[:, pg, tok % P]
            cold_v[:, c, j] = v_pages[:, pg, tok % P]
    tiered_tables = tables.copy()
    for r in range(R):
        tiered_tables[r, span_lo[r] // P:span_hi[r] // P] = 0
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((T, KVH, D)).astype(np.float32)
    base = (q, k_new, v_new, k_pages, v_pages, seed % L, t0, q_len, hist)
    cold = dict(span_lo=span_lo, span_hi=span_hi, cold_k=cold_k,
                cold_v=cold_v, cold_row=np.array(owners, np.int32),
                cold_len=np.array(lens, np.int32))
    return base, cold, tables, tiered_tables


def _live(t0, q_len):
    return np.concatenate(
        [np.arange(s, s + n) for s, n in zip(t0, q_len)]).astype(int)


def _quantized(base, cold):
    """The case with int8 pools and int8 cold chunks (codes + scales)."""
    q, k_new, v_new, kp, vp, *rest = base
    kq, ks = (x.numpy() for x in quantize_kv(_t(kp)))
    vq, vs = (x.numpy() for x in quantize_kv(_t(vp)))
    ckq, cks = (x.numpy() for x in quantize_kv(_t(cold["cold_k"])))
    cvq, cvs = (x.numpy() for x in quantize_kv(_t(cold["cold_v"])))
    return ((q, k_new, v_new, kq, vq, *rest), dict(k_scale=ks, v_scale=vs),
            dict(cold, cold_k=ckq, cold_v=cvq, cold_k_scale=cks,
                 cold_v_scale=cvs))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("int8", [False, True])
def test_tiered_op_matches_the_reference(seed, int8):
    base, cold, _tables, tiered = _tiered_case(seed)
    kw = {}
    if int8:
        base, kw, cold = _quantized(base, cold)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist = base
    want = np.asarray(jpaged.ragged_paged_attention_reference(
        q, k_new, v_new, kp, vp, jnp.int32(layer), jnp.asarray(t0),
        jnp.asarray(q_len), jnp.asarray(hist), jnp.asarray(tiered),
        **{k: jnp.asarray(v) for k, v in {**kw, **cold}.items()}))
    targs = (_t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
             _t(q_len), _t(hist), _t(tiered))
    tkw = {k: _t(v) for k, v in {**kw, **cold}.items()}
    live = _live(t0, q_len)
    for got in (tpaged.ragged_paged_attention(*targs, **tkw),
                tpaged.ragged_paged_attention_reference(*targs, **tkw)):
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                                   atol=1e-6)


def test_tiered_op_bf16_within_one_ulp():
    base, cold, _tables, tiered = _tiered_case(2)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist = base
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k_new, v_new, kp, vp)]
    jc = {k: (jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
              else jnp.asarray(v)) for k, v in cold.items()}
    want = jpaged.ragged_paged_attention_reference(
        *jb, jnp.int32(layer), jnp.asarray(t0), jnp.asarray(q_len),
        jnp.asarray(hist), jnp.asarray(tiered), **jc)
    tb = [_t(a).bfloat16() for a in (q, k_new, v_new, kp, vp)]
    tc = {k: (_t(v).bfloat16() if v.dtype == np.float32 else _t(v))
          for k, v in cold.items()}
    got = tpaged.ragged_paged_attention(
        *tb, layer, _t(t0), _t(q_len), _t(hist), _t(tiered), **tc)
    live = _live(t0, q_len)
    np.testing.assert_allclose(
        got.float().numpy()[live],
        np.asarray(want.astype(jnp.float32))[live], rtol=2.0 ** -7,
        atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_tiered_call_equals_the_resident_call(seed):
    """The same values, once resident (every page in the table) and once
    tiered (the span's pages zeroed and staged as chunks)."""
    base, cold, tables, tiered = _tiered_case(seed)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist = base
    head = (_t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
            _t(q_len), _t(hist))
    resident = tpaged.ragged_paged_attention(*head, _t(tables))
    got = tpaged.ragged_paged_attention(
        *head, _t(tiered), **{k: _t(v) for k, v in cold.items()})
    live = _live(t0, q_len)
    np.testing.assert_allclose(got.numpy()[live], resident.numpy()[live],
                               rtol=0, atol=1e-6)
    # a chunk's owner moved, or a span one page late, is another answer
    moved = dict(cold, cold_row=cold["cold_row"].copy())
    moved["cold_row"][0] = 1
    late = dict(cold, span_lo=cold["span_lo"] + 4)
    for bad in (moved, late):
        wrong = tpaged.ragged_paged_attention(
            *head, _t(tiered), **{k: _t(v) for k, v in bad.items()})
        assert np.abs(wrong.numpy()[live] - resident.numpy()[live]).max() \
            > 1e-3


def test_tiered_arguments_come_together():
    base, cold, _tables, tiered = _tiered_case(5)
    q, k_new, v_new, kp, vp, layer, t0, q_len, hist = base
    head = (_t(q), _t(k_new), _t(v_new), _t(kp), _t(vp), layer, _t(t0),
            _t(q_len), _t(hist), _t(tiered))
    part = {k: _t(v) for k, v in cold.items() if k != "cold_len"}
    with pytest.raises(ValueError, match="together"):
        tpaged.ragged_paged_attention(*head, **part)
    with pytest.raises(TypeError, match="unknown"):
        tpaged.ragged_paged_attention(*head, cold_slab=_t(cold["cold_k"]))


# ---------------------------------------------------------------------------
# the engine: the reference's TestTieredParity, three ways
# ---------------------------------------------------------------------------

# the reference test's workload: a 600-token prompt over a 64-token
# prefill window with a 2-page hot tail (most of its 38 pages demote
# mid-prefill)
LONG_P = [((i * 37) % 120) + 1 for i in range(600)]
SHORT_P = [5, 9, 2, 44, 7]
BASE = dict(max_decode_batch=2, page_size=16, num_pages=128,
            max_pages_per_seq=64, max_prefill_len=64)
TIER = dict(host_pool_bytes=64 << 20, ctx_hot_pages=2, ctx_stream_pages=2)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = JModelConfig.tiny(vocab_size=128, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=128, dtype="float32"), tp


def _sp(mod, **kw):
    return mod.SamplingParams(**kw)


def _generate(eng, prompts, sp):
    return eng.generate(prompts, sp)


def _three(tiny_lm, extra, prompts, sp_kw, twice=False):
    """(port resident, port tiered, JAX tiered) outputs and the port's
    tiered engine; ``twice``: each engine generates twice (the prefix-hit
    case)."""
    jcfg, jp, cfg, tp = tiny_lm
    runs = []
    for tiered in (False, True):
        eng = tengine.Engine(cfg, tp, tengine.EngineConfig(
            **BASE, **extra, **(TIER if tiered else {})), device="cpu")
        sp = SamplingParams(**sp_kw)
        out = [_generate(eng, prompts, sp)
               for _ in range(2 if twice else 1)]
        runs.append((out, eng))
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **BASE, **extra, **TIER, attn_backend="reference"))
    jsp = JSamplingParams(**sp_kw)
    jout = [jeng.generate(prompts, jsp) for _ in range(2 if twice else 1)]
    return runs[0][0], runs[1][0], jout, runs[1][1], jeng


GREEDY = dict(temperature=0.0, max_tokens=10)


@pytest.mark.parametrize("case", [
    "greedy", "seeded", "int8_kv", "spec_decode", "mixed_batch",
    "prefix_cache_hit", "decode_grown_cold_span",
])
def test_tiered_parity(tiny_lm, case):
    extra, prompts, sp, twice = {}, [LONG_P], GREEDY, False
    if case == "seeded":
        sp = dict(temperature=0.8, max_tokens=10, seed=7)
    elif case == "int8_kv":
        extra = dict(kv_cache_dtype="int8")
    elif case == "spec_decode":
        extra = dict(enable_spec_decode=True, spec_tokens=3)
    elif case == "mixed_batch":
        prompts = [LONG_P, SHORT_P]
    elif case == "prefix_cache_hit":
        extra, twice = dict(enable_prefix_cache=True), True
    elif case == "decode_grown_cold_span":
        prompts = [SHORT_P]
        sp = dict(temperature=0.7, max_tokens=120, seed=11)
    resident, tiered, jtiered, eng, jeng = _three(tiny_lm, extra, prompts,
                                                  sp, twice)
    assert tiered == resident
    assert tiered == jtiered
    assert eng.num_ctx_demoted_pages > 0
    assert eng.num_ctx_demoted_pages == jeng.num_ctx_demoted_pages
    assert eng.num_ctx_stream_chunks > 0
    assert eng.num_ctx_stream_chunks == jeng.num_ctx_stream_chunks
    if case == "greedy":
        # the residency win: the 38-page prompt never holds more than
        # hot tail + prefill window + growth margin on the device
        assert eng.allocator.peak_used < 20
        assert eng.allocator.peak_used == jeng.allocator.peak_used
    # everything demoted went back with the request
    assert eng.kv_cold_pages == 0 and eng.host_pool.pages == 0


def test_tiered_engine_admits_past_the_physical_pool(tiny_lm):
    """A tiered engine's limit is the page-table width, not the pool: the
    reference's ``max_context_len``; pinned and short rows stay
    resident."""
    jcfg, jp, cfg, tp = tiny_lm
    kw = dict(BASE, num_pages=24, max_pages_per_seq=64)
    for tier in ({}, TIER):
        t = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw, **tier),
                           device="cpu")
        j = jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **kw, **tier, attn_backend="reference"))
        assert t.max_context_len == j.max_context_len
    pinned = tengine.Request(id="pin", prompt_tokens=list(LONG_P[:100]),
                             sampling=SamplingParams(**GREEDY), ctx_pin=True)
    t.add_request(pinned)
    while t.has_work():
        t.step()
    assert pinned.finished and not t._tiered and t.num_ctx_demoted_pages == 0


# ---------------------------------------------------------------------------
# a corrupt cold page, and the rows a tiered engine will not move
# ---------------------------------------------------------------------------


def _until_demoted(eng, req):
    eng.add_request(req)
    for _ in range(200):
        if eng.num_ctx_demoted_pages > 0:
            return
        eng.step()
    raise AssertionError("nothing demoted")


def test_cold_corruption_raises_typed_error(tiny_lm):
    """The reference's TestColdCorruption on both engines: a flipped byte
    in a host-resident cold page surfaces as ColdPageError at stream time,
    the page counted corrupt, never attended."""
    jcfg, jp, cfg, tp = tiny_lm
    rule = [{"point": "host_pool", "op": "restore", "mode": "corrupt",
             "times": 1}]
    for eng, mod, flt, err in (
        (tengine.Engine(cfg, tp, tengine.EngineConfig(**BASE, **TIER),
                        device="cpu"), tengine, tfaults, ColdPageError),
        (jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **BASE, **TIER, attn_backend="reference")), jengine, jfaults,
         JColdPageError),
    ):
        sp = (SamplingParams if mod is tengine else JSamplingParams)(
            **GREEDY)
        _until_demoted(eng, mod.Request(id="cold-corrupt",
                                        prompt_tokens=list(LONG_P),
                                        sampling=sp))
        flt.arm(rules=rule)
        try:
            with pytest.raises(err, match="cold KV page"):
                for _ in range(200):
                    eng.step()
        finally:
            flt.disarm()
        assert eng.host_pool.corrupt_pages == 1


def _loop_run(loop_mod, req_mod, eng, flt, rule, prompt, sp):
    """One request through an engine loop with ``rule`` armed from the
    start: its events and the loop."""
    flt.arm(rules=rule)
    loop = loop_mod.EngineLoop(eng, "m").start()
    q: queue.Queue = queue.Queue()
    events = []
    try:
        loop.submit(req_mod.Request(id="r", prompt_tokens=list(prompt),
                                    sampling=sp), q.put)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            ev = q.get(timeout=300)
            events.append(ev)
            if ev.error or ev.finished:
                break
    finally:
        flt.disarm()
        loop.stop()
    return events, loop


def test_cold_corruption_through_the_loops(tiny_lm):
    """The same fault through both engine loops: the first cold read of
    the request's prefill finds its page corrupt, the retry finds it gone,
    the quarantine pulls the request (no token emitted yet) and re-admits
    it, and the re-prefill runs clean: both loops end it with the tokens
    of a run without the fault, one corrupt page counted, no token ever
    attended over it."""
    jcfg, jp, cfg, tp = tiny_lm
    rule = [{"point": "host_pool", "op": "restore", "mode": "corrupt",
             "times": 1}]
    clean = tengine.Engine(cfg, tp, tengine.EngineConfig(**BASE),
                           device="cpu").generate(
        [LONG_P], SamplingParams(**GREEDY))[0]
    got = {}
    for name, loop_mod, req_mod, eng, flt, sp in (
        ("port", tloop, tengine, tengine.Engine(cfg, tp, tengine.EngineConfig(
            **BASE, **TIER), device="cpu"), tfaults,
         SamplingParams(**GREEDY)),
        ("ref", jloop, jengine, jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **BASE, **TIER, attn_backend="reference")), jfaults,
         JSamplingParams(**GREEDY)),
    ):
        events, loop = _loop_run(loop_mod, req_mod, eng, flt, rule, LONG_P,
                                 sp)
        got[name] = ([e.token_id for e in events if not e.error],
                     [e.error for e in events if e.error],
                     eng.host_pool.corrupt_pages, loop.step_failures,
                     loop.quarantine_evictions)
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (clean, [], 1)
    assert got["port"][3] >= 2


def test_tiered_rows_are_not_preempted_or_exported(tiny_lm):
    jcfg, jp, cfg, tp = tiny_lm
    out = []
    for mod, eng, sp in (
        (tengine, tengine.Engine(cfg, tp, tengine.EngineConfig(
            **BASE, **TIER), device="cpu"), SamplingParams),
        (jengine, jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **BASE, **TIER, attn_backend="reference")), JSamplingParams),
    ):
        req = mod.Request(id="t", prompt_tokens=list(SHORT_P),
                          sampling=sp(temperature=0.0, max_tokens=200))
        eng.add_request(req)
        while eng.num_ctx_demoted_pages == 0:
            eng.step()
        assert req.slot in eng._tiered and not req.finished
        out.append((eng.preempt("t"), eng.export_request("t"),
                    eng.kv_cold_pages))
    assert out[0] == out[1]
    assert out[0][0] is False and out[0][1] is None and out[0][2] > 0
