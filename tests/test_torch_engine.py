"""Engine-level parity of the PyTorch port against the JAX ``Engine``.

Both engines serve the same tiny float32 weights (JAX-initialised, copied
with ``params_from_jax``) at the page geometry of
``tests/test_ragged_kernel.py``; the JAX engine runs its reference
attention backend, the port runs on the CPU (where its kernel wrappers
take their plain versions).  Greedy tokens must be IDENTICAL on every
caller shape of the unified step: packed prompts + decode, chunked
prefill, the mixed step, cold vs prefix-hit admission and the fused decode
window.

The same grid runs with int8 weights (``quantize_params`` in JAX,
converted) and an int8 KV pool on both sides.

Also here: allocator and prefix-cache invariants (mirroring
``tests/test_prefix_cache.py``), the sampler against JAX (greedy, top-k 1,
tiny top-p and penalties exact; temperature > 0 tiers also by a
chi-square test against each tier's exact distribution; bit-for-bit
seeded draws are ``tests/test_torch_sampling.py``), the copied
dataclasses, and the options this slice refuses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.ops.quant import quantize_params as jquantize
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.engine.kv_cache import PageAllocator, PrefixCache
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=16, max_prefill_len=16)
N_TOK = 8


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first.

    On the CPU backend ``jnp.asarray`` copies a numpy array to the device
    asynchronously, and a host write made before the copy lands shows up
    in the device array.  The JAX ``Engine`` uploads its host mirrors
    (last tokens, positions, page tables) that way and goes on updating
    them, so now and then a step reads a mirror one update ahead and the
    reference's tokens change (seen on the prefix-hit grid under load).
    The reference runs here with a snapshot taken at upload time, which
    is what the engine means by the upload."""

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
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(dtype="float32"), tp


@pytest.fixture(scope="module")
def int8_weights():
    """int8 weights quantized by the reference, converted to the port."""
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = jquantize(jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32))
    tp = params_from_jax(jax.device_get(jp))
    assert tp["layers"]["wq"]["weight"].dtype == torch.int8
    return jcfg, jp, ModelConfig.tiny(dtype="float32"), tp


def _engines(weights, **extra):
    jcfg, jp, cfg, tp = weights
    kw = {**GEOMETRY, **extra}
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    return je, te


def _greedy(n=N_TOK):
    return (jsampling.SamplingParams(temperature=0.0, max_tokens=n),
            tsampling.SamplingParams(temperature=0.0, max_tokens=n))


# ---------------------------------------------------------------------------
# greedy token identity against the JAX engine
# ---------------------------------------------------------------------------


def test_packed_prompts_and_decode(weights):
    je, te = _engines(weights)
    prompts = [[1, 2, 3, 4, 5], [10, 11, 12], [7, 3]]
    js, ts = _greedy()
    assert te.generate(prompts, ts) == je.generate(prompts, js)


def test_chunked_prefill(weights):
    je, te = _engines(weights)
    prompt = [(3 * i) % 29 + 1 for i in range(40)]   # 3 chunks of <= 16
    js, ts = _greedy()
    assert te.generate([prompt], ts) == je.generate([prompt], js)
    assert te.num_prefill_tokens == je.num_prefill_tokens == 40


def _mixed_run(eng, mod):
    r1 = mod.Request(id="r1", prompt_tokens=[1, 2, 3, 4, 5],
                     sampling=mod.SamplingParams(temperature=0.0,
                                                 max_tokens=10))
    eng.add_request(r1)
    for _ in range(3):
        eng.step()
    r2 = mod.Request(id="r2",
                     prompt_tokens=[(5 * i) % 23 + 1 for i in range(24)],
                     sampling=mod.SamplingParams(temperature=0.0,
                                                 max_tokens=N_TOK))
    eng.add_request(r2)
    while eng.has_work():
        eng.step()
    return r1.output_tokens, r2.output_tokens


def test_mixed_step(weights):
    """A long prompt admitted while another request decodes: chunk and
    decode rows share one step."""
    je, te = _engines(weights, enable_mixed_step=True)
    jmod = type("M", (), {"Request": jengine.Request,
                          "SamplingParams": jsampling.SamplingParams})
    tmod = type("M", (), {"Request": tengine.Request,
                          "SamplingParams": tsampling.SamplingParams})
    assert _mixed_run(te, tmod) == _mixed_run(je, jmod)
    assert te.num_mixed_steps == je.num_mixed_steps > 0


def test_cold_vs_prefix_hit(weights):
    """The same prompt cold (packed wave) and as a prefix-cache hit (its
    remainder attends the shared pages), and a long prompt re-admitted
    as a chunked hit: identical to JAX and to each other."""
    je, te = _engines(weights)
    prefix = [(7 * i) % 19 + 1 for i in range(12)]
    short = prefix + [2, 8]
    long = prefix + [(11 * i) % 27 + 1 for i in range(20)]
    js, ts = _greedy()
    want = [je.generate([p], js) for p in (short, short, long, long)]
    got = [te.generate([p], ts) for p in (short, short, long, long)]
    assert got == want
    assert got[0] == got[1] and got[2] == got[3]
    assert te.prefix_cache_hits == je.prefix_cache_hits >= 2


def test_fused_decode_window(weights):
    """decode_steps_per_sync > 1: several decode steps per host fetch give
    the same tokens as the JAX engine's fused window and as single
    steps."""
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8], [3, 3, 3, 3, 3]]
    js, ts = _greedy(10)
    je, te = _engines(weights, decode_steps_per_sync=4,
                      adaptive_sync_max_streams=1)
    got = te.generate(prompts, ts)
    assert got == je.generate(prompts, js)
    assert te.num_decode_device_steps < te.num_decode_tokens
    _, single = _engines(weights)
    assert single.generate(prompts, ts) == got


# ---------------------------------------------------------------------------
# int8 weights + int8 KV pool: greedy token identity against the JAX engine
# ---------------------------------------------------------------------------

INT8 = dict(kv_cache_dtype="int8")


def test_int8_packed_prompts_and_decode(int8_weights):
    je, te = _engines(int8_weights, **INT8)
    assert te.cache.quantized and te.cache.k_pages.dtype == torch.int8
    prompts = [[1, 2, 3, 4, 5], [10, 11, 12], [7, 3]]
    js, ts = _greedy()
    assert te.generate(prompts, ts) == je.generate(prompts, js)


def test_int8_chunked_prefill(int8_weights):
    je, te = _engines(int8_weights, **INT8)
    prompt = [(3 * i) % 29 + 1 for i in range(40)]
    js, ts = _greedy()
    assert te.generate([prompt], ts) == je.generate([prompt], js)


def test_int8_mixed_step(int8_weights):
    je, te = _engines(int8_weights, enable_mixed_step=True, **INT8)
    jmod = type("M", (), {"Request": jengine.Request,
                          "SamplingParams": jsampling.SamplingParams})
    tmod = type("M", (), {"Request": tengine.Request,
                          "SamplingParams": tsampling.SamplingParams})
    assert _mixed_run(te, tmod) == _mixed_run(je, jmod)
    assert te.num_mixed_steps == je.num_mixed_steps > 0


def test_int8_cold_vs_prefix_hit(int8_weights):
    je, te = _engines(int8_weights, **INT8)
    prefix = [(7 * i) % 19 + 1 for i in range(12)]
    short = prefix + [2, 8]
    long = prefix + [(11 * i) % 27 + 1 for i in range(20)]
    js, ts = _greedy()
    want = [je.generate([p], js) for p in (short, short, long, long)]
    got = [te.generate([p], ts) for p in (short, short, long, long)]
    assert got == want
    assert te.prefix_cache_hits == je.prefix_cache_hits >= 2


def test_int8_kv_with_float_weights(weights):
    """The int8 pool alone (float weights) serves the same tokens as the
    JAX engine's int8 pool."""
    je, te = _engines(weights, decode_steps_per_sync=4,
                      adaptive_sync_max_streams=1, **INT8)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8], [3, 3, 3, 3, 3]]
    js, ts = _greedy(10)
    assert te.generate(prompts, ts) == je.generate(prompts, js)


# ---------------------------------------------------------------------------
# allocator + prefix cache invariants
# ---------------------------------------------------------------------------


def test_allocator_invariants():
    alloc = PageAllocator(num_pages=16, max_pages_per_seq=6)
    cap = alloc.num_pages - 1
    a = alloc.allocate("a", 4)
    assert 0 not in a and alloc.used_pages + alloc.free_pages == cap
    with pytest.raises(MemoryError):
        alloc.allocate("a", 3)                 # per-seq cap, nothing taken
    assert alloc.used_pages == 4
    with pytest.raises(MemoryError):
        alloc.allocate("b", cap)               # pool short, nothing taken
    assert alloc.used_pages + alloc.free_pages == cap
    alloc.detach("a", a[:2])
    alloc.free("a")
    with pytest.raises(KeyError):
        alloc.free("a")                         # double free
    alloc.give_back(a[:2])
    with pytest.raises(ValueError):
        alloc.give_back(a[:1])                  # already free
    assert alloc.free_pages == cap and alloc.peak_used == 4


def test_prefix_cache_chain_and_refcounts():
    h = PrefixCache.page_hashes(list(range(10)), 4, max_pages=2)
    assert len(h) == 2
    h2 = PrefixCache.page_hashes(list(range(4)) + [99] * 6, 4, 2)
    assert h2[0] == h[0] and h2[1] != h[1]
    h3 = PrefixCache.page_hashes([7] * 4 + list(range(4, 8)), 4, 2)
    assert h3[1] != h[1]
    pc = PrefixCache()
    hashes = PrefixCache.page_hashes(list(range(12)), 4, 3)
    assert pc.adopt(hashes, [5, 6, 7]) == [5, 6, 7]
    assert pc.match_len(hashes) == 3
    assert pc.acquire(hashes) == [5, 6, 7]
    assert pc.evict(3) == []                    # refcounts protect
    pc.release([5, 6, 7])
    pc.release([5, 6, 7])
    assert sorted(pc.evict(2)) == [5, 6]
    assert pc.match_len(hashes) == 0            # chain head gone
    assert pc.adopt(hashes[2:], [7]) == []      # page already cached


def test_engine_pages_free_or_cached_after_work(weights):
    _, te = _engines(weights, num_pages=32, max_pages_per_seq=8)
    free0 = te.allocator.free_pages
    _, ts = _greedy(2)
    for i in range(6):
        te.generate([[100 + i] * 9 + [i]], ts)
    assert te.allocator.free_pages + te.prefix_cache.stats["pages"] == free0
    assert len(te.generate([[7] * 20], ts)[0]) == 2   # evicts, not fails


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _logits(B, V, seed):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


def _both(logits, params, seed=0):
    B = len(params)
    keys = np.stack([jengine._host_key(seed + i) for i in range(B)])
    want = jsampling.sample(
        jnp.asarray(logits), jsampling.SamplingState.from_params(params),
        jnp.asarray(keys),
    )
    got = tsampling.sample(
        torch.from_numpy(logits),
        tsampling.SamplingState.from_params(params), keys,
    )
    return got.numpy(), np.asarray(want)


def test_sample_greedy_exact():
    params = [tsampling.SamplingParams(temperature=0.0)] * 5
    got, want = _both(_logits(5, 300, 1), params)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-9)])
def test_sample_single_candidate_exact(kw):
    """top-k 1 and a tiny top-p keep one token: the draw is forced."""
    params = [tsampling.SamplingParams(temperature=0.8, **kw)] * 6
    got, want = _both(_logits(6, 300, 2), params, seed=9)
    np.testing.assert_array_equal(got, want)


def test_penalties_exact():
    rng = np.random.default_rng(3)
    logits = _logits(3, 50, 3)
    counts = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
    pres = np.array([0.0, 0.5, 1.5], np.float32)
    freq = np.array([0.2, 0.0, 0.7], np.float32)
    want = jsampling.apply_penalties(logits, counts, pres, freq)
    got = tsampling.apply_penalties(*(torch.from_numpy(a) for a in
                                      (logits, counts, pres, freq)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_keys_deterministic_and_distinct():
    keys = np.stack([jengine._host_key(i) for i in range(4)])
    c1, s1 = tsampling.split_keys(keys)
    c2, s2 = tsampling.split_keys(keys)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(c1, s1) and not np.array_equal(c1, keys)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _tier_case(name):
    """(logits [V], params, expected probs [V]) for one sampling tier."""
    V = 300
    order = np.arange(V)
    if name == "window":            # top-k inside the 64-token window
        logits = np.linspace(4, -4, V).astype(np.float32)
        p = tsampling.SamplingParams(temperature=0.7, top_k=5)
        exp = np.zeros(V)
        exp[:5] = _softmax(logits[:5] / 0.7)
    elif name == "categorical":     # open-ended, window mass < 1
        logits = np.where(order < 10, 2.0, -1.0).astype(np.float32)
        p = tsampling.SamplingParams(temperature=1.0)
        exp = _softmax(logits.astype(np.float64))
    else:                           # nucleus past the window's mass
        logits = np.linspace(0.5, -0.5, V).astype(np.float32)
        p = tsampling.SamplingParams(temperature=1.0, top_p=0.9)
        probs = _softmax(logits.astype(np.float64))
        cum = np.cumsum(probs)
        keep = (cum - probs) < 0.9
        exp = np.where(keep, probs, 0.0)
        exp /= exp.sum()
    return logits, p, exp


@pytest.mark.parametrize("tier", ["window", "categorical", "nucleus"])
def test_sample_temperature_tiers_chi_square(tier):
    """Temperature > 0 draws match each tier's exact distribution
    (chi-square over tokens, p > 1e-4)."""
    logits, p, exp = _tier_case(tier)
    n = 3000
    batch = np.tile(logits, (n, 1))
    keys = np.stack([jengine._host_key(1000 + i) for i in range(n)])
    got = tsampling.sample(
        torch.from_numpy(batch),
        tsampling.SamplingState.from_params([p] * n), keys,
    ).numpy()
    assert exp[got].min() > 0               # never outside the support
    # one bin per token expected >= 5 times, the rest of the support
    # pooled into one bin
    obs = np.bincount(got, minlength=len(exp))
    exp_c = exp * n
    small = (exp_c < 5) & (exp_c > 0)
    big = exp_c >= 5
    obs = np.append(obs[big], obs[small].sum())
    exp_c = np.append(exp_c[big], exp_c[small].sum())
    keep = exp_c > 0
    obs, exp_c = obs[keep], exp_c[keep]
    assert len(obs) >= 2
    assert stats.chisquare(obs, exp_c).pvalue > 1e-4


# ---------------------------------------------------------------------------
# copied dataclasses + refused options
# ---------------------------------------------------------------------------


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            v = f.default_factory()
            out[f.name] = v if isinstance(v, (list, dict, tuple)) else "fac"
        else:
            out[f.name] = "required"
    return out


@pytest.mark.parametrize("pair", [
    (JModelConfig, ModelConfig),
    (jengine.EngineConfig, tengine.EngineConfig),
    (jsampling.SamplingParams, tsampling.SamplingParams),
    (jengine.Request, tengine.Request),
])
def test_copied_dataclasses_match_reference(pair):
    ref, port = pair
    r, p = _fields(ref), _fields(port)
    assert list(p) == list(r)
    # SamplingParams defaults compare by value; Request's default factory
    # builds the package's own SamplingParams
    for name in r:
        if name == "sampling":
            assert dataclasses.asdict(port(id="x", prompt_tokens=[]).sampling)\
                == dataclasses.asdict(ref(id="x", prompt_tokens=[]).sampling)
        else:
            assert p[name] == r[name], name
    assert [e.value for e in tengine.FinishReason] == \
        [e.value for e in jengine.FinishReason]


@pytest.mark.parametrize("flag,item", [
    # tiered residency beside an adapter pool: accepted, as the reference
    # accepts it
    (dict(adapter_pool_slots=8, adapter_rank=16, ctx_hot_pages=4,
          host_pool_bytes=1 << 20), None),
    (dict(host_pool_bytes=1 << 20, ctx_hot_pages=4, ctx_stream_pages=0),
     "ctx_stream_pages"),
    (dict(ctx_hot_pages=4), "host_pool_bytes"),
])
def test_unported_engine_options_raise(weights, flag, item):
    """The reference's construction checks of tiered residency, case for
    case against the JAX engine: a host tier is required and
    ``ctx_stream_pages >= 1``."""
    jcfg, jp, cfg, tp = weights
    kw = {**GEOMETRY, **flag}
    if item is None:
        jengine.Engine(jcfg, jp, jengine.EngineConfig(**kw))
        eng = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw),
                             device="cpu")
        assert eng.max_context_len == eng.cache_cfg.max_seq_len
        return
    with pytest.raises(ValueError, match=item):
        jengine.Engine(jcfg, jp, jengine.EngineConfig(**kw))
    with pytest.raises(ValueError, match=item):
        tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")


def test_unported_models_and_mesh_raise(weights):
    """A mesh axis other than ``tp`` stays refused (A15b's later parts;
    tensor parallel is ``tests/test_torch_tp.py``).  An mrope config,
    refused until A17b, now builds: its prompts take the VL single-shot
    prefill and never the ragged prefill segment
    (``tests/test_torch_engine_vl.py`` holds it to the JAX engine).  MoE
    models, refused until A15a, are held to the JAX engine in
    ``tests/test_torch_moe.py``."""
    from helix_tpu_torch.device.mesh import MeshSpec, build_mesh

    *_, cfg, tp = weights
    ecfg = tengine.EngineConfig(**GEOMETRY)
    mesh = build_mesh(MeshSpec(dp=2), [torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="A15b"):
        tengine.Engine(cfg, [tp, tp], ecfg, mesh=mesh)
    vl = tengine.Engine(dataclasses.replace(cfg, mrope_sections=(2, 3, 3)),
                        tp, ecfg, device="cpu")
    out = vl.generate([[1, 2, 3]], tsampling.SamplingParams(
        temperature=0.0, max_tokens=2))
    assert len(out[0]) == 2 and vl.num_prefill_padding_tokens == 4 - 3
