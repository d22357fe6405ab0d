"""The port's host KV tier against the JAX engine (``tests/test_kv_tiering.py``
cases, each run through both packages on the same weights).

- **Spill and restore**: prefix pages evicted to the host tier restore
  for a later prompt and give the JAX engine's greedy tokens (float32
  and int8 KV), with prefetch, and under the ``alloc_fail`` / ``slow`` /
  ``corrupt`` faults (a corrupt page is a miss, never wrong KV).
- **Preemption by swap**: greedy and seeded temperature > 0 generations
  with penalties, preempted mid-decode with other traffic while parked,
  give the unpreempted tokens and the JAX engine's under the same
  preemption (float32 and int8 KV, speculation on too); the preempt
  gates, abort while parked, a corrupt parked page (``kv_restore_
  corrupt``), and the ladder in ``EngineLoop`` with the async loop on
  and off.
- **Allocator churn** with tiering, ``HostPagePool`` budget / LRU /
  checksum / prefetch, and ``gather_pages`` / ``restore_pages`` /
  ``page_checksum`` against the reference's on the same pool bytes.

Every comparison is exact.
"""

import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import kv_cache as jkv
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import kv_cache as tkv
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving.engine_loop import KV_EXHAUSTED, EngineLoop
from helix_tpu_torch.testing import faults

VOCAB = 512
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=64,
                max_pages_per_seq=16, max_prefill_len=64,
                host_pool_bytes=1 << 22)
SEEDED = dict(max_tokens=12, temperature=0.8, seed=123,
              presence_penalty=0.5, frequency_penalty=0.3)


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first (the JAX
    engine's asynchronous host-mirror upload, ROADMAP queue C)."""

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


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _port(weights, **kw):
    *_, cfg, tp = weights
    return tengine.Engine(cfg, tp, tengine.EngineConfig(
        **{**GEOMETRY, **kw}), device="cpu")


def _ref(weights, **kw):
    jcfg, jp, _, _ = weights
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **{**GEOMETRY, **kw}, attn_backend="reference"))


def _engines(weights, **kw):
    """(module, sampling module, engine) for the port and the JAX
    engine."""
    return [(tengine, tsampling, _port(weights, **kw)),
            (jengine, jsampling, _ref(weights, **kw))]


def _req(mod, smod, rid, prompt, **samp):
    return mod.Request(id=rid, prompt_tokens=list(prompt),
                       sampling=smod.SamplingParams(**samp),
                       stop_token_ids=(1,))


def _run(eng, req):
    eng.add_request(req)
    while eng.has_work():
        eng.step()
    return list(req.output_tokens)


def _scramble_free(eng) -> None:
    """Write ones over every free pool page: what a restore brings back
    must come from the host, not from pages that kept their bytes."""
    free = sorted(eng.allocator._free)
    if isinstance(eng, tengine.Engine):
        for t in eng.cache.carry():
            t[:, free] = 1
    else:
        eng.cache = jkv.PagedKVCache.from_carry(tuple(
            a.at[:, np.asarray(free)].set(1) for a in eng.cache.carry()))


def _spill_all(eng) -> int:
    """Evict every refcount-0 prefix page (to the host tier)."""
    cached = eng.prefix_cache.stats["pages"]
    assert cached >= 1
    assert eng._ensure_pages(eng.allocator.free_pages + cached)
    _scramble_free(eng)
    return cached


# ---------------------------------------------------------------------------
# spill -> restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_evicted_prefix_restores_with_greedy_parity(weights, kv_dtype,
                                                    seeded):
    sys_prompt = list(range(4, 24)) + [30, 31]   # 5 shareable pages
    outs = []
    for mod, smod, eng in _engines(weights, kv_cache_dtype=kv_dtype):
        g = (dict(SEEDED, max_tokens=6) if seeded
             else dict(max_tokens=6, temperature=0.0))
        ref = _run(eng, _req(mod, smod, "a", sys_prompt, **g))
        cached = _spill_all(eng)
        assert eng.host_pool.pages >= cached
        assert eng.host_pool.spilled_pages >= cached
        assert eng.prefix_cache.stats["pages"] == 0
        # the same prompt again: restored from the host, not prefilled
        r2 = _req(mod, smod, "b", sys_prompt, **g)
        out2 = _run(eng, r2)
        assert r2.cached_tokens >= 4 * cached
        assert out2 == ref
        assert eng.host_pool.restored_pages >= cached
        # the restored pages were re-adopted: a third request hits on
        # the device
        hits = eng.prefix_cache.hits
        assert _run(eng, _req(mod, smod, "c", sys_prompt, **g)) == ref
        assert eng.prefix_cache.hits > hits
        outs.append((ref, out2, r2.cached_tokens, eng.prefix_cache_hits,
                     eng.host_pool.stats()["restored_pages"]))
    assert outs[0] == outs[1]


def test_prefetch_overlaps_wait_then_claim_consumes(weights):
    sys_prompt = list(range(4, 24)) + [40]
    outs = []
    for mod, smod, eng in _engines(weights):
        g = dict(max_tokens=4, temperature=0.0)
        ref = _run(eng, _req(mod, smod, "a", sys_prompt, **g))
        cached = _spill_all(eng)
        r2 = _req(mod, smod, "b", sys_prompt, **g)
        eng._prefetch_host_prefix(r2)   # the blocked head's prefetch
        assert len(eng._prefetched) == cached
        out2 = _run(eng, r2)
        assert r2.cached_tokens >= 4 * cached and out2 == ref
        assert not eng._prefetched
        outs.append(out2)
    assert outs[0] == outs[1]


def test_alloc_fail_fault_degrades_to_plain_eviction(weights):
    eng = _port(weights)
    _run(eng, _req(tengine, tsampling, "a", list(range(4, 24)),
                   max_tokens=4, temperature=0.0))
    cached = eng.prefix_cache.stats["pages"]
    faults.arm(seed=1, rules=[{"point": "host_pool", "op": "spill",
                               "mode": "alloc_fail"}])
    assert eng._ensure_pages(eng.allocator.free_pages + cached)
    # nothing spilled, the pages still freed: the behaviour without a tier
    assert eng.host_pool.pages == 0
    assert eng.host_pool.alloc_failures >= cached


def test_slow_restore_fault_still_correct(weights):
    eng = _port(weights)
    sys_prompt = list(range(4, 24)) + [50]
    g = dict(max_tokens=4, temperature=0.0)
    ref = _run(eng, _req(tengine, tsampling, "a", sys_prompt, **g))
    _spill_all(eng)
    faults.arm(seed=1, rules=[{"point": "host_pool", "op": "restore",
                               "mode": "slow", "delay": 0.02}])
    r2 = _req(tengine, tsampling, "b", sys_prompt, **g)
    assert _run(eng, r2) == ref
    assert r2.cached_tokens > 0


def test_corrupt_prefix_restore_is_a_miss_not_wrong_kv(weights):
    sys_prompt = list(range(4, 24)) + [60]
    outs = []
    for mod, smod, eng in _engines(weights):
        g = dict(max_tokens=4, temperature=0.0)
        ref = _run(eng, _req(mod, smod, "a", sys_prompt, **g))
        _spill_all(eng)
        # the reference engine reads its own fault switchboard
        arm = faults.arm if mod is tengine else _jfaults().arm
        arm(seed=1, rules=[{"point": "host_pool", "op": "restore",
                            "mode": "corrupt", "times": 1}])
        try:
            r2 = _req(mod, smod, "b", sys_prompt, **g)
            out2 = _run(eng, r2)
        finally:
            faults.disarm()
            _jfaults().disarm()
        # the corrupt page fell out of the chain (counted) and the rest
        # prefilled again: still the right tokens
        assert out2 == ref
        assert eng.host_pool.corrupt_pages == 1
        outs.append((out2, r2.cached_tokens))
    assert outs[0] == outs[1]


def _jfaults():
    from helix_tpu.testing import faults as jfaults

    return jfaults


# ---------------------------------------------------------------------------
# preemption by swap: exact resume
# ---------------------------------------------------------------------------


def _swap_run(mod, smod, eng, prompt, samp, cut, rid="pre"):
    """Decode ``rid`` to ``cut`` tokens, preempt it, run an interloper
    while it is parked (it claims pages and advances the engine's key
    counter), then finish both."""
    rp = _req(mod, smod, rid, prompt, **samp)
    eng.add_request(rp)
    while len(rp.output_tokens) < cut:
        eng.step()
    assert eng.preempt(rp.id)
    assert rp.slot is None and len(eng.preempted) == 1
    assert eng.host_pool.pages >= 1   # private pages parked on the host
    _scramble_free(eng)
    mid = _req(mod, smod, "mid", [9] * 5, max_tokens=3)
    eng.add_request(mid)
    while not rp.finished:
        eng.step()
    while eng.has_work():
        eng.step()
    assert mid.finished
    assert (eng.num_preemptions, eng.num_resumes) == (1, 1)
    return list(rp.output_tokens), list(mid.output_tokens)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_seeded_temp_generation_bit_identical_across_swap(weights,
                                                          kv_dtype):
    """Seeded temperature 0.8 with penalties (the evolved key AND the
    histogram matter), preempted after 5 tokens: the continuation equals
    the unpreempted run and the JAX engine's under the same swap."""
    ref = _run(_port(weights, kv_cache_dtype=kv_dtype),
               _req(tengine, tsampling, "ref", [7] * 6, **SEEDED))
    got = [_swap_run(mod, smod, eng, [7] * 6, SEEDED, 5)
           for mod, smod, eng in _engines(weights, kv_cache_dtype=kv_dtype)]
    assert got[0][0] == ref
    assert got[0] == got[1]


# settings under which the histogram decides tokens after a swap at 5
# tokens (a swap that dropped it changes the continuation)
PENALISED = [dict(max_tokens=16, temperature=0.0, presence_penalty=0.8,
                  frequency_penalty=0.4),
             dict(max_tokens=16, temperature=1.2, seed=9,
                  presence_penalty=-1.0)]


@pytest.mark.parametrize("samp", PENALISED, ids=["greedy", "seeded"])
def test_swap_restores_the_penalty_histogram(weights, samp):
    ref = _run(_port(weights), _req(tengine, tsampling, "ref", [7] * 6,
                                    **samp))
    got = [_swap_run(mod, smod, eng, [7] * 6, samp, 5)
           for mod, smod, eng in _engines(weights)]
    assert got[0][0] == ref
    assert got[0] == got[1]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_greedy_bit_identical_across_swap(weights, kv_dtype):
    g = dict(max_tokens=16, temperature=0.0)
    prompt = list(range(4, 12))
    ref = _run(_port(weights, kv_cache_dtype=kv_dtype),
               _req(tengine, tsampling, "ref", prompt, **g))
    got = [_swap_run(mod, smod, eng, prompt, g, 4)
           for mod, smod, eng in _engines(weights, kv_cache_dtype=kv_dtype)]
    assert got[0][0] == ref
    assert got[0] == got[1]


def test_swap_with_speculation_matches_reference(weights):
    """Speculation on: the drafter's per-request state stays across a
    swap (the reference keeps it), so tokens AND spec counters equal the
    JAX engine's under the same preemption."""
    prompt = [5, 6, 7, 8] * 4
    got = []
    for mod, smod, eng in _engines(weights, enable_spec_decode=True,
                                   spec_tokens=3):
        toks = _swap_run(mod, smod, eng, prompt,
                         dict(max_tokens=20, temperature=0.0), 6)
        got.append((toks, eng.num_spec_steps, eng.num_spec_drafted_tokens,
                    eng.num_spec_accepted_tokens))
    assert got[0] == got[1]
    assert got[0][1] > 0


def test_preempt_gates(weights):
    # no host tier: preemption unavailable
    eng0 = _port(weights, host_pool_bytes=0)
    r = _req(tengine, tsampling, "r", [5] * 4, max_tokens=8)
    eng0.add_request(r)
    eng0.step()
    assert eng0.host_pool is None and not eng0.preempt(r.id)
    # unknown / queued requests are not preemptible
    eng = _port(weights)
    assert not eng.preempt("nope")
    q = _req(tengine, tsampling, "q", [5] * 4, max_tokens=2)
    eng._requests[q.id] = q   # queued, no slot
    assert not eng.preempt(q.id)
    # a budget that cannot hold the private pages: refused whole
    small = _port(weights, host_pool_bytes=64)
    r = _req(tengine, tsampling, "s", [5] * 4, max_tokens=8)
    small.add_request(r)
    small.step()
    assert not small.preempt(r.id)
    assert r.slot is not None and small.host_pool.pages == 0
    assert small.host_pool.alloc_failures == 1


def test_preempt_waits_for_an_unreconciled_step(weights):
    """A dispatched, unreconciled decode step has advanced the position
    mirror but not the last-token mirror.  The port refuses to preempt
    (or export) until the step completes, then swaps exactly.  The
    reference preempts at once: the in-flight token is discarded at its
    completion and the resumed stream skips it (ROADMAP queue C; its
    loop never preempts with a step in flight, nor does the port's)."""
    samp = dict(SEEDED, max_tokens=10)
    prompt = list(range(4, 12))
    ref = _run(_port(weights), _req(tengine, tsampling, "ref", prompt,
                                    **samp))
    got = {}
    for mod, smod, eng in _engines(weights):
        rp = _req(mod, smod, "p", prompt, **samp)
        eng.add_request(rp)
        while len(rp.output_tokens) < 3:
            eng.step()
        emitted, pend = eng.step_dispatch()
        assert pend is not None and pend.kind == "decode"
        if mod is tengine:
            assert not eng.preempt(rp.id)
            assert eng.export_request(rp.id) is None
            eng.step_complete(pend, emitted)
            assert eng.preempt(rp.id)
        else:
            assert eng.preempt(rp.id)
            eng.step_complete(pend, emitted)
            assert not emitted   # the in-flight token is discarded
        while eng.has_work():
            eng.step()
        got[mod] = list(rp.output_tokens)
    assert got[tengine] == ref
    # the reference's stream lost the in-flight (4th) token
    assert got[jengine] != ref
    assert got[jengine][:3] + got[jengine][3:len(ref) - 1] == \
        ref[:3] + ref[4:]


def test_abort_while_parked_cleans_host_copies(weights):
    for mod, smod, eng in _engines(weights):
        rp = _req(mod, smod, "pre", [7] * 6, max_tokens=40, temperature=0.0)
        eng.add_request(rp)
        while len(rp.output_tokens) < 3:
            eng.step()
        assert eng.preempt(rp.id)
        parked = eng.host_pool.pages
        assert parked >= 1
        eng.abort(rp.id)
        assert rp.finished and not eng.preempted
        assert eng.host_pool.pages < parked
        assert _run(eng, _req(mod, smod, "after", [9] * 4, max_tokens=3))


def test_corrupt_parked_page_fails_the_resume(weights):
    eng = _port(weights)
    rp = _req(tengine, tsampling, "pre", [7] * 6, max_tokens=20,
              temperature=0.0)
    eng.add_request(rp)
    while len(rp.output_tokens) < 3:
        eng.step()
    assert eng.preempt(rp.id)
    faults.arm(seed=1, rules=[{"point": "host_pool", "op": "restore",
                               "mode": "corrupt", "times": 1}])
    eng.step()
    failed = eng.drain_resume_failures()
    assert [r.id for r, _ in failed] == ["pre"]
    assert failed[0][1].startswith("kv_restore_corrupt")
    assert rp.finished and rp.finish_reason == tengine.FinishReason.ABORT
    assert not eng.preempted and eng.host_pool.pages == 0
    assert eng.host_pool.corrupt_pages == 1
    assert eng.allocator.used_pages == eng.prefix_cache.stats["pages"]


# ---------------------------------------------------------------------------
# the ladder in the engine loop
# ---------------------------------------------------------------------------


class _Collector:
    def __init__(self):
        self.tokens, self.error = [], None
        self.done = threading.Event()

    def __call__(self, ev):
        if ev.error:
            self.error = ev.error
        else:
            self.tokens.append(ev.token_id)
        if ev.finished:
            self.done.set()


@pytest.mark.parametrize("async_on", [False, True])
def test_loop_preempts_under_pressure_and_resumes_exactly(weights,
                                                          async_on):
    """Two long decoders hold most of a small pool; a third request
    cannot get pages.  The ladder swaps the newest decoder out after the
    stall, the queued request runs, the victim resumes: every request
    finishes with the JAX engine's tokens for it unpressured (greedy and
    seeded), with the async loop off and on."""
    kw = dict(num_pages=21, max_pages_per_seq=16)
    specs = [("a", [5] * 6, dict(max_tokens=30, temperature=0.0)),
             ("b", [6] * 6, dict(max_tokens=30, **{
                 k: v for k, v in SEEDED.items() if k != "max_tokens"})),
             ("c", [8] * 6, dict(max_tokens=30, temperature=0.0))]
    ref = {rid: _run(_ref(weights), _req(jengine, jsampling, rid, p, **s))
           for rid, p, s in specs}
    eng = _port(weights, enable_async_loop=async_on, **kw)
    loop = EngineLoop(eng, name="ladder", preempt_stall_seconds=0.05,
                      admission_timeout=60.0).start()
    try:
        cols = {rid: _Collector() for rid, _p, _s in specs}
        for rid, p, s in specs[:2]:
            loop.submit(_req(tengine, tsampling, rid, p, **s), cols[rid])
        while eng.num_decode_tokens < 4:
            threading.Event().wait(0.01)
        rid, p, s = specs[2]
        loop.submit(_req(tengine, tsampling, rid, p, **s), cols[rid])
        for c in cols.values():
            assert c.done.wait(120)
        stats = loop.stats()
    finally:
        loop.stop()
    assert {rid: c.tokens for rid, c in cols.items()} == ref
    assert all(c.error is None for c in cols.values())
    assert stats["preemptions"] >= 1 and stats["resumes"] >= 1
    assert stats["preempted_parked"] == 0
    assert stats["host_pool"]["pages"] == 0


def test_loop_sheds_kv_exhausted_after_admission_timeout(weights):
    """No preemption rung: a request that cannot get pages outwaits the
    admission timeout and gets the typed kv_exhausted error."""
    eng = _port(weights, num_pages=33, max_pages_per_seq=32)
    loop = EngineLoop(eng, name="shed", admission_timeout=0.1).start()
    try:
        hog, late = _Collector(), _Collector()
        loop.submit(_req(tengine, tsampling, "hog", [5] * 6,
                         max_tokens=122, temperature=0.0), hog)
        while eng.num_decode_tokens < 2:
            threading.Event().wait(0.01)
        loop.submit(_req(tengine, tsampling, "late", [6] * 6,
                         max_tokens=8, temperature=0.0), late)
        assert late.done.wait(60) and hog.done.wait(120)
        stats = loop.stats()
    finally:
        loop.stop()
    assert late.error.startswith(KV_EXHAUSTED) and not late.tokens
    assert hog.error is None and len(hog.tokens) == 122
    assert stats["kv_exhausted_sheds"] == 1


# ---------------------------------------------------------------------------
# allocator invariants with tiering
# ---------------------------------------------------------------------------


def test_allocator_churn_preserves_used_plus_free():
    alloc = tkv.PageAllocator(num_pages=64, max_pages_per_seq=16)
    capacity = 63
    rng = random.Random(7)
    live: dict = {}
    detached: list = []
    for _ in range(600):
        op = rng.randrange(4)
        if op == 0:
            sid = f"s{rng.randrange(20)}"
            n = rng.randrange(1, 6)
            try:
                assert len(alloc.allocate(sid, n)) == n
                live[sid] = live.get(sid, 0) + n
            except MemoryError:
                pass
        elif op == 1 and live:
            sid = rng.choice(list(live))
            alloc.free(sid)
            del live[sid]
        elif op == 2 and live:
            sid = rng.choice(list(live))
            pages = alloc.seq_pages(sid)
            take = pages[: rng.randrange(1, len(pages) + 1)]
            alloc.detach(sid, take)
            detached.extend(take)
            live[sid] -= len(take)
            if live[sid] == 0:
                alloc.free(sid)
                del live[sid]
        elif op == 3 and detached:
            n = rng.randrange(1, len(detached) + 1)
            back, detached = detached[:n], detached[n:]
            alloc.give_back(back)
        assert alloc.used_pages + alloc.free_pages == capacity


def test_engine_churn_invariant_with_tiering(weights):
    """used + free == capacity after every step of a workload that
    spills, restores, preempts and resumes."""
    eng = _port(weights, num_pages=33, max_pages_per_seq=24,
                max_prefill_len=8)
    hog = _req(tengine, tsampling, "hog", list(range(4, 12)), max_tokens=60,
               temperature=0.0)
    eng.add_request(hog)
    preempted = False
    while eng.has_work():
        eng.step()
        assert eng.allocator.used_pages + eng.allocator.free_pages == 32
        if not preempted and len(hog.output_tokens) >= 3:
            assert eng.preempt(hog.id)
            preempted = True
            for i in range(3):
                eng.add_request(_req(
                    tengine, tsampling, f"m{i}",
                    [30 + 9 * i + j for j in range(8)], max_tokens=10,
                    temperature=0.0))
    assert hog.finished and eng.num_resumes == 1


# ---------------------------------------------------------------------------
# HostPagePool, page codec
# ---------------------------------------------------------------------------


def _page(seed, shape=(2, 4, 2, 8)):
    g = torch.Generator().manual_seed(seed)
    return {"k": torch.randn(shape, generator=g),
            "v": torch.randn(shape, generator=g),
            "k_scale": None, "v_scale": None}


def test_budget_lru_evicts_unpinned_only():
    page_bytes = sum(a.numel() * 4 for a in _page(0).values()
                     if a is not None)
    pool = tkv.HostPagePool(budget_bytes=page_bytes * 3)
    assert pool.put("pin", _page(1), pinned=True)
    assert pool.put("a", _page(2))
    assert pool.put("b", _page(3))
    assert pool.put("c", _page(4))   # evicts the LRU unpinned entry "a"
    assert not pool.contains("a")
    assert pool.contains("pin") and pool.contains("b")
    assert pool.evicted_pages == 1
    pool2 = tkv.HostPagePool(budget_bytes=page_bytes)
    assert pool2.put("p1", _page(5), pinned=True)
    assert not pool2.put("p2", _page(6), pinned=True)
    assert pool2.alloc_failures == 1


def test_checksum_detects_mutation():
    pool = tkv.HostPagePool(budget_bytes=1 << 20)
    assert pool.put("x", _page(0))
    assert pool.get("x") is not None
    pool._entries["x"].arrays["k"].reshape(-1)[0] += 1.0
    assert pool.get("x") is None
    assert pool.corrupt_pages == 1 and not pool.contains("x")


def test_take_restored_counts_and_removes():
    pool = tkv.HostPagePool(budget_bytes=1 << 20)
    page = _page(0)
    assert pool.put("x", page)
    got = pool.take_restored("x")
    assert torch.equal(got["k"], page["k"])
    assert pool.restored_pages == 1 and not pool.contains("x")
    assert pool.used_bytes == 0


def test_prefetch_serves_device_handles():
    pool = tkv.HostPagePool(budget_bytes=1 << 20)
    page = _page(0)
    assert pool.put("x", page)
    assert pool.prefetch("x")
    got = pool.take_restored("x")
    assert torch.equal(got["k"], page["k"])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_gather_restore_and_checksums_match_the_reference(kv_dtype):
    """The same pool bytes in both packages: ``gather_pages`` gives the
    reference's page buffers byte for byte with the same
    ``page_checksum``, and ``restore_pages`` into other pages gives the
    reference's pool, bytes and all."""
    cfg = ModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    cc = tkv.CacheConfig(num_pages=16, page_size=4, max_pages_per_seq=8,
                         dtype=kv_dtype)
    tcache = tkv.PagedKVCache.create(cfg, cc, "cpu")
    g = torch.Generator().manual_seed(3)
    for t in tcache.carry():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    jcache = jkv.PagedKVCache.create(jcfg, jkv.CacheConfig(
        num_pages=16, page_size=4, max_pages_per_seq=8, dtype=kv_dtype))
    jcache = jkv.PagedKVCache.from_carry(tuple(
        jnp.asarray(np.frombuffer(tkv.raw_bytes(t), dtype=j.dtype)
                    .reshape(j.shape))
        for t, j in zip(tcache.carry(), jcache.carry())))
    ids = [3, 7, 1, 12]
    tp = tkv.gather_pages(tcache, ids)
    jp = jkv.gather_pages(jcache, ids)
    for a, b in zip(tp, jp):
        b = {f: None if x is None else np.asarray(x) for f, x in b.items()}
        assert tkv.page_checksum(a) == jkv.page_checksum(b)
        for f in tkv.PAGE_FIELDS:
            assert (a[f] is None) == (b[f] is None)
            if a[f] is not None:
                assert tkv.raw_bytes(a[f]) == b[f].tobytes()
    targets = [5, 9, 2, 14]
    tkv.restore_pages(tcache, targets, tp)
    jcache = jkv.restore_pages(jcache, targets, jp)
    for t, j in zip(tcache.carry(), jcache.carry()):
        assert tkv.raw_bytes(t) == np.asarray(j).tobytes()


# ---------------------------------------------------------------------------
# the profile's host tier and the node's overrides
# ---------------------------------------------------------------------------


def test_profile_entry_keeps_its_host_pool_bytes():
    """``serve-node --profile profiles/v5e1-hotswap.yaml --random-weights``:
    both entries pass, the Llama entry with its ``slo`` block (A7).  Its
    engine block reaches ``EngineConfig`` with its 16 GiB
    ``host_pool_bytes`` and its 8 adapter slots of rank 16, Phi-3's with
    8 GiB.  Without ``--random-weights`` the entries' checkpoint
    directories, absent here, are refused before any weights are made."""
    import os

    from helix_tpu_torch.cli import _model_specs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = type("A", (), {
        "profile": os.path.join(root, "profiles", "v5e1-hotswap.yaml"),
        "engine": None, "model": None, "random_weights": True, "seed": 0})
    llama, phi = _model_specs(args)
    assert llama["name"] == "meta-llama/Meta-Llama-3-8B-Instruct"
    assert llama["slo"]["sched"]["policy"] == "wfq"
    assert llama["engine"]["host_pool_bytes"] == 17179869184
    cfg = tengine.EngineConfig(**llama["engine"])
    assert cfg.host_pool_bytes == 17179869184 and cfg.enable_spec_decode
    assert (cfg.adapter_pool_slots, cfg.adapter_rank) == (8, 16)
    assert tengine.EngineConfig(**phi["engine"]).host_pool_bytes == 1 << 33
    args.random_weights = False
    with pytest.raises(NotImplementedError,
                       match="llama3-8b-instruct.*does not exist"):
        _model_specs(args)


def test_node_overrides_reach_engine_and_loop(monkeypatch):
    from helix_tpu_torch.cli import build_served_model

    geo = dict(max_decode_batch=2, page_size=4, num_pages=32,
               max_pages_per_seq=8, max_prefill_len=16)
    monkeypatch.setenv("HELIX_KV_HOST_POOL_BYTES", str(1 << 20))
    monkeypatch.setenv("HELIX_PREEMPT_STALL_SECONDS", "0.5")
    monkeypatch.setenv("HELIX_ADMISSION_TIMEOUT", "7")
    served = build_served_model("tiny-x", device="cpu", warmup=False,
                                engine=geo)
    try:
        assert served.loop.engine.host_pool.budget_bytes == 1 << 20
        assert served.loop.preempt_stall_seconds == 0.5
        assert served.loop.admission_timeout == 7.0
    finally:
        served.loop.stop()
    # operator beats profile: 0 turns the profile's tier off
    monkeypatch.setenv("HELIX_KV_HOST_POOL_BYTES", "0")
    served = build_served_model("tiny-x", device="cpu", warmup=False,
                                engine={**geo, "host_pool_bytes": 1 << 22})
    try:
        assert served.loop.engine.host_pool is None
    finally:
        served.loop.stop()
