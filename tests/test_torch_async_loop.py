"""The port's step split and async pipelined loop.

- ``EngineLoop`` with ``enable_async_loop`` on and off: identical event
  streams (token ids, finished flags, finish reasons) for greedy and
  seeded temperature > 0 traffic with penalties, a chunked prompt whose
  first token defers, the mixed step, an int8 KV pool, a prefix hit and
  speculation (which the pipeline sits out); ``pipelined_steps > 0``
  where the pipeline can engage.  ``stats()["async_loop"]``,
  ``device_idle_ratio()`` and the per-step time split are present.
- The engines driven the way the loop drives them (dispatch step N+1
  before completing step N where ``pipeline_ready()``): the port gives
  the JAX engine's tokens, driven the same way.
- The chunk-final first token rides the next decode fetch: the port's
  emitted stream AND its count of host fetches equal the JAX engine's on
  a chunked prompt (``tests/test_async_loop.py:164``).
- ``discard_pending`` rolls a failed completion back so that the retry
  gives the unperturbed tokens, including a deferred first token and one
  that a retry carries into a mixed step (``tests/test_async_loop.py:
  339, 377, 411``).

Every comparison is exact: float32 tokens and counters.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.engine.engine import FinishReason, Request
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving.engine_loop import EngineLoop

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=32, max_prefill_len=8)
VOCAB = 512
LONG = [(7 * i) % (VOCAB - 2) + 2 for i in range(30)]
LONG_B = [(11 * i) % (VOCAB - 2) + 2 for i in range(30)]


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


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _port(weights, async_on=False, **extra):
    *_, cfg, tp = weights
    return tengine.Engine(cfg, tp, tengine.EngineConfig(
        **{**GEOMETRY, **extra}, enable_async_loop=async_on), device="cpu")


def _ref(weights, **extra):
    jcfg, jp, _, _ = weights
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **{**GEOMETRY, **extra}, attn_backend="reference"))


def _req(mod, smod, rid, prompt, max_tokens=16, **samp):
    return mod.Request(
        id=rid, prompt_tokens=list(prompt), stop_token_ids=(1,),
        sampling=smod.SamplingParams(max_tokens=max_tokens,
                                     **{"temperature": 0.0, **samp}),
    )


class _Collector:
    def __init__(self):
        self.events = []
        self.done = threading.Event()

    def __call__(self, ev):
        self.events.append((ev.token_id, ev.finished, ev.finish_reason,
                            ev.error))
        if ev.finished:
            self.done.set()


def _submit_together(loop, reqs, cols) -> None:
    """Submit ``reqs`` so that the loop takes them from its inbox in one
    pass, in order: the admission waves, and so every shape the engine
    computes, do not depend on thread timing (two runs then compare)."""
    drain = loop._drain_inbox
    gate = threading.Event()
    loop._drain_inbox = lambda: drain() if gate.is_set() else None
    try:
        for r in reqs:
            cols[r.id] = _Collector()
            loop.submit(r, cols[r.id])
    finally:
        gate.set()
        loop._drain_inbox = drain


def _run_loop(weights, async_on, waves, **extra):
    """Submit each wave of requests through an ``EngineLoop`` once the
    previous wave has finished; returns ({rid: events}, stats, loop,
    engine)."""
    eng = _port(weights, async_on, **extra)
    loop = EngineLoop(eng, name="alp-on" if async_on else "alp-off").start()
    try:
        cols = {}
        for wave in waves:
            _submit_together(loop, wave, cols)
            for rid, col in cols.items():
                assert col.done.wait(120), f"{rid} stuck"
        return ({rid: c.events for rid, c in cols.items()}, loop.stats(),
                loop, eng)
    finally:
        loop.stop(join=True)


def _treq(rid, prompt, **kw):
    return _req(tengine, tsampling, rid, prompt, **kw)


# name -> (waves of requests, engine options, whether the pipeline engages)
WORKLOADS = {
    "greedy": (lambda: [[_treq(f"g{j}", [20 + 3 * j + i for i in range(6)],
                               max_tokens=20) for j in range(3)]], {}, True),
    "seeded_penalties": (lambda: [[
        _treq(f"t{j}", [30 + 5 * j + i for i in range(6)], max_tokens=18,
              temperature=0.85, seed=100 + j, presence_penalty=0.5,
              frequency_penalty=0.3) for j in range(3)]], {}, True),
    "prefix_hit": (lambda: [
        [_treq("p1", list(range(4, 13)) + [40, 41], max_tokens=12)],
        [_treq("p2", list(range(4, 13)) + [50, 51], max_tokens=12),
         _treq("p3", [60, 61, 62], max_tokens=20)]], {}, True),
    "chunked_deferred_first": (lambda: [[
        _treq("s0", list(range(4, 10)), max_tokens=24),
        _treq("long", LONG, max_tokens=10),
        _treq("s1", list(range(14, 20)), max_tokens=24)]],
        {"enable_mixed_step": False}, True),
    "mixed": (lambda: [[
        _treq("d0", list(range(6, 12)), max_tokens=20),
        _treq("d1", list(range(9, 15)), max_tokens=20),
        _treq("lng", LONG, max_tokens=8)]], {}, True),
    "int8_kv": (lambda: [[
        _treq("i0", list(range(4, 10)), max_tokens=16),
        _treq("i1", list(range(24, 30)), max_tokens=16, temperature=0.8,
              seed=11, presence_penalty=0.4)]],
        {"kv_cache_dtype": "int8"}, True),
    "spec": (lambda: [[
        _treq("sp0", [5, 9, 7, 3] * 6, max_tokens=20),
        _treq("sp1", list(range(4, 10)), max_tokens=16)]],
        {"enable_spec_decode": True, "spec_tokens": 3}, False),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_loop_async_on_off_identical_events(weights, name):
    waves, extra, pipelines = WORKLOADS[name]
    off, st_off, _, eng_off = _run_loop(weights, False, waves(), **extra)
    on, st_on, _, eng_on = _run_loop(weights, True, waves(), **extra)
    assert on == off
    assert all(ev[-1] is None for evs in on.values() for ev in evs)
    assert st_on["async_loop"]["enabled"]
    assert not st_off["async_loop"]["enabled"]
    assert st_off["async_loop"]["pipelined_steps"] == 0
    if pipelines:
        assert st_on["async_loop"]["pipelined_steps"] > 0
    else:    # speculation: pipeline_ready() is False, the loop runs in order
        assert st_on["async_loop"]["pipelined_steps"] == 0
        assert eng_on.num_spec_steps == eng_off.num_spec_steps > 0
    if name == "mixed":
        assert eng_on.num_mixed_steps == eng_off.num_mixed_steps > 0
    if name == "prefix_hit":
        assert eng_on.prefix_cache_hits == eng_off.prefix_cache_hits == 1


def test_stats_idle_ratio_and_time_split(weights):
    reqs = [_treq(f"m{j}", [15 + 4 * j + i for i in range(6)], max_tokens=24)
            for j in range(3)]
    _, stats, loop, _ = _run_loop(weights, True, [reqs])
    al = stats["async_loop"]
    assert set(al) == {"enabled", "pipelined_steps", "device_idle_ratio",
                       "emit_queue_depth"}
    assert al["pipelined_steps"] > 0
    assert 0.0 <= loop.device_idle_ratio() <= 1.0
    recs = [r for r in loop.window._ring if r["kind"] == "decode"]
    assert recs
    for key in ("host_build_s", "device_wait_s", "emit_s", "idle_gap_s",
                "wall_s", "pipelined"):
        assert key in recs[-1], key
    assert any(r["pipelined"] for r in recs)


def test_emission_events_snapshot_at_push_time(weights):
    loop = EngineLoop(_port(weights, True), name="alp-snap")
    req = _treq("snap-1", list(range(4, 8)), max_tokens=4)
    events_a = loop._snapshot_events([(req, 7)])
    req.finished = True
    req.finish_reason = FinishReason.STOP
    events_b = loop._snapshot_events([(req, 9)])
    assert events_a[0][1] is False and events_a[0][2].finished is False
    assert events_b[0][2].finished is True
    assert events_b[0][2].finish_reason == "stop"
    multi = loop._snapshot_events([(req, 11), (req, 12)])
    assert [ev.finished for _r, _f, ev in multi] == [False, True]


def test_page_capacity_reconciles_instead_of_overrunning(weights):
    """A request whose in-flight window reaches its page allocation must
    reconcile and finish, not dispatch into the headroom check."""
    r = _treq("cap-1", list(range(4, 12)), max_tokens=120)
    r.stop_token_ids = ()
    out, stats, loop, _ = _run_loop(weights, True, [[r]])
    assert len([e for e in out["cap-1"] if e[0] >= 0]) == 120
    assert loop.step_failures == 0


# ---------------------------------------------------------------------------
# engines driven the way the loop drives them
# ---------------------------------------------------------------------------


def _drive_pipelined(eng):
    """Dispatch step N+1 before completing step N wherever
    ``pipeline_ready()`` allows, as ``EngineLoop._run`` does; returns
    the emitted (request id, token) stream and the pipelined count."""
    stream, inflight, piped = [], None, 0
    while eng.has_work() or inflight is not None:
        can_pipe = eng.pipeline_ready()
        if inflight is not None and (not can_pipe or not eng.has_work()):
            stream += [(q.id, t) for q, t in eng.step_complete(inflight)]
            inflight = None
            continue
        emitted, pend = eng.step_dispatch()
        if inflight is not None:
            emitted = eng.step_complete(inflight) + emitted
            inflight = None
        if pend is not None and can_pipe and pend.kind == "decode":
            inflight, piped = pend, piped + 1
        elif pend is not None:
            eng.step_complete(pend, emitted)
        stream += [(q.id, t) for q, t in emitted]
    return stream, piped


@pytest.mark.parametrize("sampled", [False, True])
def test_dispatch_before_complete_matches_reference(weights, sampled):
    samp = (dict(temperature=0.9, seed=7, presence_penalty=0.2,
                 frequency_penalty=0.1) if sampled else {})
    out = []
    for eng, mod, smod in ((_ref(weights), jengine, jsampling),
                           (_port(weights, True), tengine, tsampling)):
        for j in range(3):
            eng.add_request(_req(mod, smod, f"r{j}",
                                 [10 + 7 * j + i for i in range(5)],
                                 max_tokens=14 + j, **samp))
        out.append(_drive_pipelined(eng))
    (jstream, jpiped), (tstream, tpiped) = out
    assert tstream == jstream
    assert tpiped == jpiped > 0
    sync = _port(weights)
    for j in range(3):
        sync.add_request(_req(tengine, tsampling, f"r{j}",
                              [10 + 7 * j + i for i in range(5)],
                              max_tokens=14 + j, **samp))
    assert _drive_pipelined(sync)[0] == tstream


def _count_reference_fetches(je):
    """Count the JAX engine's host fetches: one per admission-wave batch,
    per step completion and per lone deferred-first-token flush."""
    n = {"fetches": 0}

    def counted(name, when=lambda: True):
        orig = getattr(je, name)

        def wrapper(*a, **kw):
            if when():
                n["fetches"] += 1
            return orig(*a, **kw)

        setattr(je, name, wrapper)

    for name in ("_finish_packed_admissions", "_decode_complete",
                 "_spec_complete", "_mixed_complete"):
        counted(name)
    counted("_flush_pending_first", lambda: bool(je._pending_first))
    return n


def test_chunk_final_first_token_rides_decode_fetch(weights):
    """Mixed step off, a long prompt chunking in beside two decoders: the
    final chunk's first token is fetched with the next decode step's
    tokens.  Emitted stream and host fetch count equal the reference."""
    streams = []
    je = _ref(weights, enable_mixed_step=False)
    ref_fetches = _count_reference_fetches(je)
    te = _port(weights, enable_mixed_step=False)
    for eng, mod, smod in ((je, jengine, jsampling),
                           (te, tengine, tsampling)):
        for r in (_req(mod, smod, "s0", range(4, 10), max_tokens=24),
                  _req(mod, smod, "long", LONG, max_tokens=10),
                  _req(mod, smod, "s1", range(14, 20), max_tokens=24)):
            eng.add_request(r)
        stream = []
        while eng.has_work():
            stream += [(q.id, t) for q, t in eng.step()]
        streams.append(stream)
    assert streams[1] == streams[0]
    assert te.num_host_fetches == ref_fetches["fetches"]
    assert len([t for rid, t in streams[1] if rid == "long"]) == 10


def test_chunk_alone_flushes_its_first_token(weights):
    """Nothing else decodes: the final chunk's first token is fetched on
    its own, once, as in the reference."""
    je = _ref(weights)
    ref_fetches = _count_reference_fetches(je)
    te = _port(weights)
    outs = []
    for eng, mod, smod in ((je, jengine, jsampling),
                           (te, tengine, tsampling)):
        r = _req(mod, smod, "long", LONG, max_tokens=6)
        eng.add_request(r)
        while eng.has_work():
            eng.step()
        outs.append(r.output_tokens)
    assert outs[1] == outs[0]
    assert te.num_host_fetches == ref_fetches["fetches"]


# ---------------------------------------------------------------------------
# discard_pending
# ---------------------------------------------------------------------------


def _unperturbed(weights, prompts, **extra):
    eng = _port(weights, **extra)
    reqs = [_treq(f"u{i}", p, max_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


def test_discard_pending_preserves_deferred_first_token(weights):
    want = _unperturbed(weights, [LONG], enable_mixed_step=False)[0]
    eng = _port(weights, True, enable_mixed_step=False)
    r = _treq("vic", LONG, max_tokens=6)
    eng.add_request(r)
    discarded, stream = False, []
    while eng.has_work():
        emitted, pend = eng.step_dispatch()
        if pend is not None:
            if not discarded and pend.pending_first:
                eng.discard_pending(pend)   # a failed completion
                discarded = True
                continue
            eng.step_complete(pend, emitted)
        stream += [t for q, t in emitted if q is r]
    assert discarded, "the deferred path never ran"
    assert r.output_tokens == want and stream == want


def test_step_rolls_back_on_completion_failure(weights, monkeypatch):
    want = _unperturbed(weights, [list(range(4, 10))])[0]
    eng = _port(weights)
    r = _treq("vic", list(range(4, 10)), max_tokens=6)
    eng.add_request(r)
    eng.step()   # admission + first decode
    orig = eng.step_complete
    armed = {"on": True}

    def boom(pend, emitted=None):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected completion failure")
        return orig(pend, emitted)

    monkeypatch.setattr(eng, "step_complete", boom)
    with pytest.raises(RuntimeError):
        eng.step()
    while eng.has_work():
        eng.step()
    assert r.output_tokens == want


def test_requeued_first_token_rides_mixed_step(weights):
    want = _unperturbed(weights, [LONG], enable_mixed_step=True)[0]
    eng = _port(weights, True, enable_mixed_step=True)
    ra = _treq("a", LONG, max_tokens=6)
    eng.add_request(ra)
    discarded, order = False, []
    while eng.has_work():
        emitted, pend = eng.step_dispatch()
        if pend is not None:
            if not discarded and pend.pending_first:
                eng.discard_pending(pend)
                discarded = True
                eng.add_request(_treq("b", LONG_B, max_tokens=4))
                continue
            eng.step_complete(pend, emitted)
        order += [t for q, t in emitted if q is ra]
    assert discarded, "the deferred path never ran"
    assert order == want and ra.output_tokens == want


def test_engine_counts_one_fetch_per_plain_decode_step(weights):
    """Steady-state decode: one host fetch per step, none at dispatch."""
    eng = _port(weights)
    eng.add_request(Request(id="f", prompt_tokens=[5, 6, 7],
                            sampling=SamplingParams(temperature=0.0,
                                                    max_tokens=8)))
    eng.step()
    before = eng.num_host_fetches
    _, pend = eng.step_dispatch()
    assert eng.num_host_fetches == before and pend.kind == "decode"
    eng.step_complete(pend)
    assert eng.num_host_fetches == before + 1


# ---------------------------------------------------------------------------
# the profile's engine fields reach the served engine
# ---------------------------------------------------------------------------


def test_profile_spec_and_async_fields_serve_over_http(tmp_path):
    """``enable_spec_decode``, ``spec_tokens`` and ``enable_async_loop``
    in a profile entry's ``engine:`` block reach ``EngineConfig`` through
    ``serve-node``'s profile path, and both engines answer over HTTP;
    ``host_pool_bytes`` builds the host tier and ``adapter_pool_slots`` /
    ``adapter_rank`` build the adapter pool."""
    import json
    import urllib.request

    from helix_tpu_torch.cli import _model_specs, build_served_model
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry

    geo = dict(max_decode_batch=2, page_size=4, num_pages=64,
               max_pages_per_seq=16, max_prefill_len=16)
    prof = tmp_path / "p.json"
    prof.write_text(json.dumps({"models": [
        {"name": "tiny-spec", "model_overrides": {"dtype": "float32"},
         "engine": {**geo, "enable_spec_decode": True, "spec_tokens": 4}},
        {"name": "tiny-async", "model_overrides": {"dtype": "float32"},
         "engine": {**geo, "enable_async_loop": True}},
    ]}))
    args = type("A", (), {"profile": str(prof), "engine": None,
                          "model": None})
    registry = ModelRegistry()
    for spec in _model_specs(args):
        registry.register(build_served_model(device="cpu", seed=1, **spec))
    httpd = OpenAIServer(registry, inter_token_timeout=60).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"
    try:
        assert registry.get("tiny-spec").loop.engine.spec is not None
        assert registry.get("tiny-async").loop.async_enabled
        for name in ("tiny-spec", "tiny-async"):
            body = {"model": name, "prompt": "ab ab ab ab", "max_tokens": 8,
                    "temperature": 0}
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["usage"]["completion_tokens"] >= 1, name
    finally:
        httpd.shutdown()
        httpd.server_close()
        for name in registry.names():
            registry.unregister(name)
    served = build_served_model("tiny-x", device="cpu", warmup=False,
                                engine={**geo, "host_pool_bytes": 1 << 20})
    try:
        assert served.loop.engine.host_pool.budget_bytes == 1 << 20
    finally:
        served.loop.stop()
    served = build_served_model("tiny-x", device="cpu", warmup=False,
                                engine={**geo, "adapter_pool_slots": 8,
                                        "adapter_rank": 16})
    try:
        pool = served.loop.engine.adapter_pool
        assert (pool.slots, pool.rank) == (8, 16)
        assert served.loop.stats()["adapters"]["slots"] == 8
    finally:
        served.loop.stop()
