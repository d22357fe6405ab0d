"""Seeded sampling of the PyTorch port against the JAX reference, bit for
bit.

The port draws with its own threefry (``helix_tpu_torch/engine/
threefry.py``), so the same keys give the same random bits as
``jax.random``:

- the key split and the raw bits are equal to ``jax.random.split`` and
  ``jax.random.bits`` bit for bit, the uniforms too;
- the Gumbel values ``-log(-log(u))`` agree within the two libraries'
  ``log`` errors: XLA's float32 ``log`` is within 1.11 ulp of the exact
  value and PyTorch's within 0.54 (my CPU runs), so the two may round one
  log up to 2 ulps apart; the bound is 2 ulps of the value plus 2 ulps of
  the inner log, relative (near ``-log(u) = 1`` the inner log's ulp is
  amplified, so a bound in ulps of the value alone cannot hold);
- ``sample`` gives the reference's tokens (``exact=True``) for fixed
  logits and keys over the temperature / top-p / top-k / penalty / tier
  grids of ``tests/test_sampling_exact.py``;
- seeded temperature > 0 requests through the JAX ``Engine``
  (reference attention, f32, ``ModelConfig.tiny``) and the port's
  ``Engine`` on the CPU give identical token lists on every workload of
  the unified step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.engine import threefry
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=16, max_prefill_len=16)
V = 8 * jsampling.TOPK_BOUND   # 512: the window is a real subset


def _keys(n, seed=0):
    """``n`` keys with the corner words in front: all-zero, all-ones,
    mixed."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[0] = 0
    keys[1] = 0xFFFF_FFFF
    keys[2] = [0, 0xFFFF_FFFF]
    keys[3] = [0xFFFF_FFFF, 0]
    return keys


def _vmap(fn, keys):
    return np.asarray(jax.vmap(fn)(jnp.asarray(keys)))


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def test_split_equals_jax():
    keys = _keys(300)
    first, second = threefry.split(threefry.as_keys(keys, "cpu"))
    want = _vmap(lambda k: jax.random.split(k, 2), keys)     # [n, 2, 2]
    np.testing.assert_array_equal(first.numpy(), want[:, 0])
    np.testing.assert_array_equal(second.numpy(), want[:, 1])
    carry, step = tsampling.split_keys(keys)
    jc, js = jsampling.split_keys(jnp.asarray(keys))
    assert carry.dtype == step.dtype == np.uint32
    np.testing.assert_array_equal(carry, np.asarray(jc))
    np.testing.assert_array_equal(step, np.asarray(js))


@pytest.mark.parametrize("n", [1, 63, 64, 257])
def test_random_bits_equal_jax(n):
    keys = _keys(300, seed=n)
    got = threefry.random_bits(threefry.as_keys(keys, "cpu"), n).numpy()
    want = _vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32), keys)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
def test_uniform_equals_jax(minval):
    keys = _keys(300, seed=1)
    got = threefry.uniform(threefry.as_keys(keys, "cpu"), 129, minval, 1.0)
    want = _vmap(lambda k: jax.random.uniform(k, (129,), jnp.float32,
                                              minval, 1.0), keys)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_gumbel_within_log_rounding_of_jax():
    keys = _keys(300, seed=2)
    got = threefry.gumbel(threefry.as_keys(keys, "cpu"), 129).numpy()
    want = _vmap(lambda k: jax.random.gumbel(k, (129,), jnp.float32), keys)
    bound = 2 * np.spacing(np.abs(want)) + 2.0 ** -22
    assert np.all(np.abs(got - want) <= bound)
    assert np.mean(got == want) > 0.5


def test_categorical_equals_jax():
    keys = _keys(64, seed=3)
    logits = np.random.default_rng(3).standard_normal((64, 300))
    logits = (logits * 2).astype(np.float32)
    logits[:, ::7] = -np.inf                # masked candidates
    got = threefry.categorical(threefry.as_keys(keys, "cpu"),
                               torch.from_numpy(logits))
    want = jax.vmap(jax.random.categorical)(jnp.asarray(keys),
                                            jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def _both(logits, params, counts=None, seed=0):
    """(port tokens, reference tokens) for the same logits, keys and
    (optionally) penalty histograms."""
    B = len(params)
    keys = np.stack([jengine._host_key(seed + i) for i in range(B)])
    jst = jsampling.SamplingState.from_params(params)
    tst = tsampling.SamplingState.from_params(params)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if counts is not None:
        jl = jsampling.apply_penalties(jl, jnp.asarray(counts),
                                       jst.presence, jst.frequency)
        tl = tsampling.apply_penalties(tl, torch.from_numpy(counts),
                                       tst.presence, tst.frequency)
    want = jsampling.sample(jl, jst, jnp.asarray(keys), exact=True)
    got = tsampling.sample(tl, tst, keys)
    return got.numpy(), np.asarray(want)


GRID = [
    dict(temperature=0.0),
    dict(temperature=0.7),
    dict(temperature=1.0),
    dict(temperature=2.0),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=1.0, top_p=0.5),
    dict(temperature=0.8, top_p=1e-9),
    dict(temperature=1.0, top_k=1),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.5, top_k=2 * jsampling.TOPK_BOUND),
    dict(temperature=1.2, top_p=0.95, top_k=200),
    dict(temperature=0.9, top_p=0.8, top_k=40),
]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_sample_equals_reference(kw):
    rng = np.random.default_rng(len(str(kw)))
    logits = (rng.standard_normal((48, V)) * 2).astype(np.float32)
    p = jsampling.SamplingParams(**kw)
    got, want = _both(logits, [p] * 48, seed=100)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logits_kind", ["flat", "peaked"])
def test_sample_tiers_equal_reference(logits_kind):
    """Flat logits put ~7/8 of the mass past the 64-token window (tier 2
    for open-ended rows, tier 3 for a nucleus), peaked logits keep it in
    the window (tier 1); a batch mixes every tier and greedy rows."""
    if logits_kind == "flat":
        logits = np.zeros((1, V), np.float32)
    else:
        logits = np.zeros((1, V), np.float32)
        logits[0, :8] = [8, 7.5, 7, 6.5, 6, 5.5, 5, 4.5]
    logits = np.tile(logits, (40, 1))
    params = [jsampling.SamplingParams(**kw) for kw in (
        dict(temperature=1.0),
        dict(temperature=1.0, top_p=0.9),
        dict(temperature=1.0, top_p=0.8),
        dict(temperature=1.5, top_k=2 * jsampling.TOPK_BOUND),
        dict(temperature=0.0),
    )] * 8
    got, want = _both(logits, params, seed=7)
    np.testing.assert_array_equal(got, want)
    if logits_kind == "flat":     # the draws really left the window
        assert (got[:8 * 5:5] >= jsampling.TOPK_BOUND).any()


def test_sample_with_penalties_equals_reference():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((32, V)) * 2).astype(np.float32)
    counts = rng.integers(0, 3, size=(32, V)).astype(np.int32)
    params = [jsampling.SamplingParams(temperature=0.9, presence_penalty=p,
                                       frequency_penalty=f, top_p=tp)
              for p, f, tp in ((0.5, 0.0, 1.0), (0.0, 0.7, 0.9),
                               (1.5, 0.3, 0.95), (0.2, 1.0, 1.0))] * 8
    got, want = _both(logits, params, counts=counts, seed=3)
    np.testing.assert_array_equal(got, want)


def test_sample_needs_keys_when_sampling():
    logits = torch.zeros((2, 8))
    st = tsampling.SamplingState.from_params(
        [tsampling.SamplingParams(temperature=1.0)] * 2)
    with pytest.raises(ValueError, match="keys"):
        tsampling.sample(logits, st)


# ---------------------------------------------------------------------------
# seeded requests through both engines
# ---------------------------------------------------------------------------


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first: the JAX
    ``Engine`` uploads host mirrors it goes on updating, and on the CPU
    backend the copy is asynchronous (ROADMAP queue C, the reference's
    host-mirror race; ``tests/test_torch_engine.py`` explains it)."""

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


def _engines(weights, **extra):
    jcfg, jp, cfg, tp = weights
    kw = {**GEOMETRY, **extra}
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    return je, te


def _run(eng, mod, script):
    """Drive ``eng`` through ``script``: (step_before_adding, prompt,
    sampling kwargs) per request; returns each request's tokens."""
    reqs = []
    for i, (wait, prompt, kw) in enumerate(script):
        for _ in range(wait):
            eng.step()
        r = mod.Request(id=f"r{i}", prompt_tokens=list(prompt),
                        sampling=mod.SamplingParams(**kw))
        eng.add_request(r)
        reqs.append(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


def _both_engines(weights, script, **extra):
    je, te = _engines(weights, **extra)
    jmod = type("M", (), {"Request": jengine.Request,
                          "SamplingParams": jsampling.SamplingParams})
    tmod = type("M", (), {"Request": tengine.Request,
                          "SamplingParams": tsampling.SamplingParams})
    return _run(te, tmod, script), _run(je, jmod, script), te, je


SEEDED = dict(temperature=0.8, seed=11, max_tokens=8)
NUCLEUS = dict(temperature=1.1, top_p=0.9, presence_penalty=0.4,
               frequency_penalty=0.2, seed=5, max_tokens=8)
UNSEEDED = dict(temperature=1.0, max_tokens=8)   # engine key stream
LONG = [(3 * i) % 29 + 1 for i in range(40)]     # 3 chunks of <= 16
PREFIX = [(7 * i) % 19 + 1 for i in range(12)]

WORKLOADS = {
    # three prompts packed into one wave, then decode
    "packed_decode": ([(0, [1, 2, 3, 4, 5], SEEDED),
                       (0, [10, 11, 12], NUCLEUS),
                       (0, [7, 3], UNSEEDED)], {}),
    # a prompt prefilled in chunks
    "chunked": ([(0, LONG, SEEDED)], {}),
    # a long prompt admitted while another request decodes
    "mixed": ([(0, [1, 2, 3, 4, 5], dict(SEEDED, max_tokens=10)),
               (3, [(5 * i) % 23 + 1 for i in range(24)], NUCLEUS)], {}),
    # the same prompt cold, then as prefix-cache hits (short and chunked)
    "prefix_hit": ([(0, PREFIX + [2, 8], SEEDED),
                    (12, PREFIX + [2, 8], SEEDED),
                    (12, PREFIX + LONG[:20], NUCLEUS)], {}),
    # several decode steps per host fetch
    "fused_window": ([(0, [1, 2, 3], SEEDED), (0, [4, 5, 6, 7], NUCLEUS),
                      (0, [9, 8], UNSEEDED), (0, [3, 3, 3, 3, 3], SEEDED)],
                     dict(decode_steps_per_sync=4,
                          adaptive_sync_max_streams=1)),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_seeded_requests_match_jax_engine(weights, name):
    script, extra = WORKLOADS[name]
    got, want, te, je = _both_engines(weights, script, **extra)
    assert got == want
    assert all(len(t) > 1 for t in got)
    if name == "mixed":
        assert te.num_mixed_steps == je.num_mixed_steps > 0
    if name == "prefix_hit":
        assert te.prefix_cache_hits == je.prefix_cache_hits >= 2
        assert got[0] == got[1]          # a seed reproduces across paths
    if name == "fused_window":
        assert te.num_decode_device_steps < te.num_decode_tokens
