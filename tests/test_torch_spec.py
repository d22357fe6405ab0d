"""Speculative decoding in the PyTorch port against the JAX reference.

- The drafter (``engine/spec.py``, the port's own copy): ``propose`` and
  ``SpecDecoder`` give the reference's drafts and EMA decisions on random
  token sequences and on the cases of ``tests/test_spec_decode.py``.
- The engine with ``enable_spec_decode=True, spec_tokens=4`` against the
  JAX ``Engine`` on the same tiny float32 weights (reference attention
  backend; the port on the CPU, where its kernel wrappers take their
  plain versions): identical tokens AND identical spec counters
  (``num_spec_steps``, ``num_spec_drafted_tokens``,
  ``num_spec_accepted_tokens``) and ``num_decode_device_steps``, for
  greedy, seeded temperature > 0 with penalties, an int8 KV pool, the
  mixed step, a prefix hit and the fused window.  Prompts repeat
  themselves so that drafts are accepted.  Only verify steps run
  W-wide state rows; a step in which no slot drafted runs them 1 wide.
- The state segment at width W = spec_tokens + 1 for fixed drafts (rows
  drafting 4, 2, 0 and sitting out with -1): the same sampled tokens,
  emit counts, positions, last tokens, penalty histograms and key words
  as the reference's unified step, and the verify logits within 1e-5 of
  the JAX model's forward over the whole sequence.

Tolerances: tokens, counters and device state are exact (float32 on both
sides); logits 1e-5 absolute (float32, attention summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.engine import spec as jspec
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import forward as jforward
from helix_tpu.models.llama import init_params as jinit
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.engine import spec as tspec
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=160,
                max_pages_per_seq=32, max_prefill_len=16)
SPEC = dict(enable_spec_decode=True, spec_tokens=4)
REP = [5, 6, 7, 8] * 5
REP2 = [11, 3, 9] * 5 + [11]
MIX = [9, 3, 1, 4, 1, 5, 9, 2]


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first: the
    JAX engine uploads host mirrors it goes on writing, and on the CPU
    backend the copy is asynchronous (ROADMAP queue C); the reference
    runs here with the upload it means."""

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
    """Tiny random float32 weights whose output head also leans toward a
    fixed successor of each token (1 -> 2 -> 3 -> 4 -> 1, 5 -> ... -> 8
    -> 5, ...): greedy streams fall into short cycles and sampled streams
    at temperature 0.8-1 repeat often enough for drafts to be accepted,
    while every draw is still a real draw."""
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = dict(jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32))
    emb = np.asarray(jp["embed"]["weight"])
    t = np.arange(emb.shape[0])
    succ = np.where(t > 0, (t - 1) // 4 * 4 + (t % 4) + 1, 0).clip(max=t[-1])
    head = np.asarray(jp["lm_head"]["weight"]).copy()
    head[:, succ] += 2.0 * (emb / np.linalg.norm(emb, axis=1,
                                                 keepdims=True)).T
    jp["lm_head"] = {"weight": jnp.asarray(head)}
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(dtype="float32"), tp


def _engines(weights, **extra):
    jcfg, jp, cfg, tp = weights
    kw = {**GEOMETRY, **SPEC, **extra}
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    return je, te


COUNTERS = ("num_spec_steps", "num_spec_drafted_tokens",
            "num_spec_accepted_tokens", "num_decode_device_steps",
            "num_decode_tokens", "num_mixed_steps", "prefix_cache_hits")


def _counters(eng):
    return {k: getattr(eng, k) for k in COUNTERS}


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

DRAFTER_CASES = [
    ([1, 2, 7, 8, 1, 2, 9, 9, 1, 2], 2, {}),
    ([3, 4, 8, 8, 4, 5, 5, 3, 4], 1, dict(max_ngram=4)),
    ([1, 2, 7, 0, 1, 2, 9, 0, 1, 2], 1, {}),
    ([1, 2, 3, 1, 2, 3, 1, 2, 3], 3, {}),
    ([1, 2, 3, 4, 5], 4, {}),
    ([1, 2, 9, 8, 7, 6, 1, 2], 2, {}),
    ([1, 2, 3], 0, {}),
    ([1], 4, {}),
    ([], 4, {}),
    ([4, 4, 4, 4], 3, dict(min_ngram=2)),
]


@pytest.mark.parametrize("tokens,k,kw", DRAFTER_CASES)
def test_propose_cases_match_reference(tokens, k, kw):
    assert tspec.propose(tokens, k, **kw) == jspec.propose(tokens, k, **kw)


@pytest.mark.parametrize("seed", range(6))
def test_propose_random_sequences_match_reference(seed):
    """Random sequences over a small alphabet (so n-grams recur), every
    prefix, every k and n-gram range."""
    rng = np.random.default_rng(seed)
    toks = [int(t) for t in rng.integers(0, 4 + seed, size=40)]
    for n in range(len(toks) + 1):
        for k in (1, 3, 4):
            for lo, hi in ((1, 4), (2, 3)):
                got = tspec.propose(toks[:n], k, max_ngram=hi, min_ngram=lo)
                assert got == jspec.propose(toks[:n], k, max_ngram=hi,
                                            min_ngram=lo), (n, k, lo, hi)


@pytest.mark.parametrize("seed", range(4))
def test_spec_decoder_ema_decisions_match_reference(seed):
    """A random schedule of draft/observe/forget calls over a few
    requests: identical drafts, enabled flags and disabled counts, so the
    acceptance EMA benches and re-probes at the same calls."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(spec_tokens=4, disable_below=0.3, ema_alpha=0.5,
              reprobe_after=3)
    port = tspec.SpecDecoder(tspec.SpecConfig(**kw))
    ref = jspec.SpecDecoder(jspec.SpecConfig(**kw))
    seqs = {f"r{i}": [int(t) for t in rng.integers(0, 5, size=30)]
            for i in range(3)}
    for _ in range(200):
        rid = f"r{int(rng.integers(3))}"
        op = rng.random()
        if op < 0.6:
            cap = int(rng.integers(0, 6))
            d = port.draft(rid, seqs[rid], cap)
            assert d == ref.draft(rid, seqs[rid], cap)
            acc = int(rng.integers(0, len(d) + 1)) if d else 0
            port.observe(rid, len(d), acc)
            ref.observe(rid, len(d), acc)
            seqs[rid].append(int(rng.integers(0, 5)))
        elif op < 0.95:
            n = int(rng.integers(0, 5))
            a = int(rng.integers(0, n + 1))
            port.observe(rid, n, a)
            ref.observe(rid, n, a)
        else:
            port.forget(rid)
            ref.forget(rid)
        assert port.enabled(rid) == ref.enabled(rid)
        assert port.disabled_count() == ref.disabled_count()


# ---------------------------------------------------------------------------
# the engine with speculation against the JAX engine
# ---------------------------------------------------------------------------


def _run(eng, mod, prompts, sps):
    reqs = [mod.Request(id=f"r{i}", prompt_tokens=list(p), sampling=s)
            for i, (p, s) in enumerate(zip(prompts, sps))]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


def _both(weights, prompts, kws, **extra):
    je, te = _engines(weights, **extra)
    want = _run(je, jengine, prompts,
                [jsampling.SamplingParams(**kw) for kw in kws])
    got = _run(te, tengine, prompts,
               [tsampling.SamplingParams(**kw) for kw in kws])
    return je, te, want, got


SPEC_CASES = {
    "greedy": (dict(), [dict(temperature=0.0, max_tokens=24)] * 3),
    "seeded_penalties": (dict(), [
        dict(temperature=0.9, seed=11, presence_penalty=0.4,
             frequency_penalty=0.3, max_tokens=20),
        dict(temperature=0.7, top_p=0.9, seed=12, max_tokens=20),
        dict(temperature=0.0, max_tokens=20, frequency_penalty=0.5),
    ]),
    "int8_kv": (dict(kv_cache_dtype="int8"),
                [dict(temperature=0.0, max_tokens=24)] * 3),
    "fused_window": (dict(decode_steps_per_sync=4,
                          adaptive_sync_max_streams=1),
                     [dict(temperature=0.0, max_tokens=30)] * 3),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_reference(weights, case):
    extra, kws = SPEC_CASES[case]
    je, te, want, got = _both(weights, [REP, MIX, REP2], kws, **extra)
    assert got == want
    assert _counters(te) == _counters(je)
    assert te.num_spec_accepted_tokens > 0       # drafts were accepted
    assert te.num_decode_device_steps < te.num_decode_tokens


def test_spec_mixed_step_matches_reference(weights):
    """A long prompt chunks in while repetitive requests verify drafts:
    mixed steps and verify steps interleave."""
    je, te = _engines(weights)
    long_p = [(5 * i) % 23 + 1 for i in range(40)]
    out = []
    for eng, mod, smod in ((je, jengine, jsampling),
                           (te, tengine, tsampling)):
        sp = smod.SamplingParams(temperature=0.0, max_tokens=24)
        r1 = mod.Request(id="a", prompt_tokens=list(REP), sampling=sp)
        eng.add_request(r1)
        for _ in range(3):
            eng.step()
        r2 = mod.Request(id="b", prompt_tokens=long_p, sampling=sp)
        eng.add_request(r2)
        while eng.has_work():
            eng.step()
        out.append((r1.output_tokens, r2.output_tokens))
    assert out[1] == out[0]
    assert _counters(te) == _counters(je)
    assert te.num_mixed_steps > 0 and te.num_spec_steps > 0


def test_spec_prefix_hit_keeps_shared_pages_safe(weights):
    """The second request claims the first one's prompt pages from the
    prefix cache and still speculates: the shared-page assertion of
    ``_spec_dispatch`` holds and tokens equal the cold run's, the JAX
    engine's and the spec-off engine's."""
    je, te = _engines(weights)
    prompt = REP + [2, 9]
    outs = []
    for eng, smod in ((je, jsampling), (te, tsampling)):
        sp = smod.SamplingParams(temperature=0.0, max_tokens=12)
        outs.append([eng.generate([prompt], sp)[0] for _ in range(2)])
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[1][1]
    assert te.prefix_cache_hits == je.prefix_cache_hits >= 1
    assert _counters(te) == _counters(je)
    assert te.num_spec_accepted_tokens > 0
    _, off = _engines(weights, enable_spec_decode=False)
    sp = tsampling.SamplingParams(temperature=0.0, max_tokens=12)
    assert off.generate([prompt], sp)[0] == outs[1][0]


def test_spec_off_on_greedy_identical_with_fewer_steps(weights):
    """Speculation changes which call produces a token, never the token:
    greedy output equals the spec-off port's, in fewer device steps."""
    sp = tsampling.SamplingParams(temperature=0.0, max_tokens=24)
    _, on = _engines(weights)
    _, off = _engines(weights, enable_spec_decode=False)
    assert on.generate([REP, REP2], sp) == off.generate([REP, REP2], sp)
    assert on.num_decode_device_steps < off.num_decode_device_steps
    assert on.num_decode_tokens == off.num_decode_tokens


def test_spec_plain_steps_run_one_wide(weights):
    """With speculation on, only verify steps run W-wide state rows: a
    step in which no slot drafted runs them 1 wide, as with speculation
    off.  Per active slot, a device step gives one token without
    speculation and more than one with accepted drafts."""
    sp = tsampling.SamplingParams(temperature=0.0, max_tokens=24)
    _, on = _engines(weights)
    _, off = _engines(weights, enable_spec_decode=False)
    widths = []
    state_rows = on._state_rows

    def record(W, *args, **kwargs):
        widths.append(W)
        return state_rows(W, *args, **kwargs)

    on._state_rows = record
    assert on.generate([MIX, REP], sp) == off.generate([MIX, REP], sp)
    assert widths.count(5) == on.num_spec_steps > 0
    assert widths.count(1) > 0 and set(widths) == {1, 5}
    assert off.num_decode_tokens == off.num_decode_slot_steps
    assert on.num_decode_tokens > on.num_decode_slot_steps


def test_spec_config_validation():
    with pytest.raises(ValueError, match="spec_tokens"):
        tengine.EngineConfig(enable_spec_decode=True, spec_tokens=0)
    assert tengine.EngineConfig(enable_spec_decode=True).spec_tokens == 4


# ---------------------------------------------------------------------------
# the state segment at width W for fixed drafts
# ---------------------------------------------------------------------------


def _jax_logits(weights, seq, W):
    """The reference model's logits at the last W positions of ``seq``
    (one plain causal forward over the whole sequence, no cache)."""
    jcfg, jp, _, _ = weights
    toks = jnp.asarray([seq], jnp.int32)
    pos = jnp.arange(len(seq), dtype=jnp.int32)[None]
    from helix_tpu.models.llama import prefill_attn_fn

    logits, _ = jforward(jp, jcfg, toks, pos,
                         attn_fn=lambda q, k, v, c, p: prefill_attn_fn(
                             q, k, v, c, p, backend="reference"))
    return np.asarray(logits[0, -W:])


@pytest.mark.parametrize("sampled", [False, True])
def test_state_segment_width_w_matches_reference_step(weights, sampled):
    """Four decoding slots, then ONE unified step with fixed drafts: slot
    0 drafts 4 tokens (its prompt's own continuation, mostly accepted),
    slot 1 drafts 2 unlikely tokens (rejected), slot 2 drafts 0 (a plain
    decode row at width W) and slot 3 sits the call out (-1)."""
    je, te = _engines(weights)
    prompts = [REP[:12], MIX, REP2[:12], [7, 1, 7, 1, 7]]   # no chunking
    kw = (dict(temperature=0.8, seed=5, presence_penalty=0.3,
               frequency_penalty=0.2, max_tokens=40) if sampled
          else dict(temperature=0.0, max_tokens=40))
    reqs = {}
    for eng, mod, smod in ((je, jengine, jsampling),
                           (te, tengine, tsampling)):
        reqs[eng] = [mod.Request(id=f"r{i}", prompt_tokens=list(p),
                                 sampling=smod.SamplingParams(**kw))
                     for i, p in enumerate(prompts)]
        for r in reqs[eng]:
            eng.add_request(r)
        eng.step()   # admission wave + one decode step
    assert [r.output_tokens for r in reqs[te]] == \
        [r.output_tokens for r in reqs[je]]
    W = 5
    drafts = np.zeros((4, W - 1), np.int32)
    seq0 = prompts[0] + reqs[te][0].output_tokens
    drafts[0] = tspec.propose(seq0, 4) or [1, 2, 3, 4]
    drafts[1, :2] = [250, 251]
    draft_len = np.array([4, 2, 0, -1], np.int32)
    logits = []
    te.logits_hook = lambda kind, x: logits.append((kind, x.clone()))
    _, js, je_emit, _, _ = je._ragged_step(drafts=drafts,
                                           draft_len=draft_len, n_extra=0)
    _, ts, te_emit, _ = te._ragged_step(drafts=drafts, draft_len=draft_len)
    np.testing.assert_array_equal(te_emit.numpy(), np.asarray(je_emit))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert sampled or int(te_emit[0]) >= 2     # greedy: drafts accepted
    assert int(te_emit[1]) == 1
    assert int(te_emit[2]) == 1 and int(te_emit[3]) == 0
    jst, tst = je._dstate, te._dstate
    for name in ("positions", "last_token", "token_counts"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(te._dkeys, np.asarray(jst.keys))
    # the verify logits of every drafting row, live positions only
    verify = [x for kind, x in logits if kind == "verify"]
    assert len(verify) == 1
    for b in range(3):
        out = reqs[te][b].output_tokens
        seq = prompts[b] + out + [int(t) for t in drafts[b, :draft_len[b]]]
        n = int(draft_len[b]) + 1
        want = _jax_logits(weights, seq, n)
        np.testing.assert_allclose(verify[0][b, :n].numpy(), want,
                                   atol=1e-5, rtol=0)
