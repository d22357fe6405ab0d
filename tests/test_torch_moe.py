"""The port's mixture-of-experts path against the JAX package, on the CPU.

- ``models/moe.py`` ``moe_ffn`` against ``helix_tpu.models.moe.moe_ffn``
  on seeded numpy inputs: float32 outputs within ``1e-5`` (the two
  libraries sum float32 products in different orders), bfloat16 outputs
  within one bf16 ulp of the output (``2**-8`` relative, ``1e-5``
  absolute), drop counts equal exactly; the cases of the reference's
  ``tests/test_moe.py``: capacity overflow drops the weakest choices
  (with a tie in the top-k, broken to the lower expert as
  ``jax.lax.top_k`` does), ``token_mask``, int8 experts, decode dropless.
- ``quantize_tensor`` of an ``[L, X, E, F]`` expert stack byte-equal to
  the reference's; the random-init int8 build byte-equal to
  ``quantize_params`` of the float build.
- ``forward`` logits on a tiny MoE config against
  ``helix_tpu.models.llama.forward`` (float32 ``1e-4``, as
  ``tests/test_torch_model.py``), and its drop count.
- The port's ``Engine`` against the JAX ``Engine`` (``attn_backend=
  "reference"``, float32, ``_SnapshotJnp``): greedy ids equal with the
  prefix cache on and off, with a chunked long prompt, alone against a
  burst, with an attention-only adapter pool, with prefill drops counted
  equal, and with ``enable_spec_decode`` logged off.  Every engine case
  records the least gap between the k-th and the (k+1)-th router logit
  of every routed token on the port's side and demands it above
  ``ROUTER_GAP_MIN``: no choice rides on a near tie the two libraries
  could break apart.
- The loader on a tiny HF Mixtral checkpoint equal to the reference's
  ``load_params`` (bfloat16 bit for bit, int8 byte for byte to its
  ``quantize_params``), and the residency estimate equal to the
  reference's figure (ROADMAP C: it counts one FFN per layer).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as st_np
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import residency as jresidency
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models import loader as jloader
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import forward as jforward
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.models.llama import prefill_attn_fn as jprefill_attn
from helix_tpu.models.moe import moe_ffn as jmoe_ffn
from helix_tpu.ops import quant as jquant
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import residency as tresidency
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.models import loader as tloader
from helix_tpu_torch.models import moe as tmoe
from helix_tpu_torch.models.common import CATALOG, ModelConfig
from helix_tpu_torch.ops import quant as tquant
from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

X, E, F = 4, 64, 128
F32_ATOL = 1e-5
LOGIT_ATOL = 1e-4
# the least k-th / (k+1)-th router logit gap the engine cases allow; the
# float32 sums of the two libraries differ by ~1e-7 on these widths
ROUTER_GAP_MIN = 1e-4
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=32, max_prefill_len=16)
N_TOK = 6


def _cfgs(**over):
    base = dict(num_experts=X, num_experts_per_tok=2,
                expert_capacity_factor=2.0, dtype="float32")
    base.update(over)
    return JModelConfig.tiny(**base), ModelConfig.tiny(**base)


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


# ---------------------------------------------------------------------------
# the layer: moe_ffn against the reference
# ---------------------------------------------------------------------------


# the reference's layer, jitted once per shape (op by op it dispatches
# hundreds of small computations)
_jmoe = jax.jit(lambda x, r, m, cfg, act, mask: jmoe_ffn(
    x, r, m, cfg, act, token_mask=mask, return_dropped=True),
    static_argnums=(3, 4))


def _layer_inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    router = (rng.standard_normal((E, X)) * 0.3).astype(np.float32)
    mats = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
            for k, s in (("w_gate", (X, E, F)), ("w_up", (X, E, F)),
                         ("w_down", (X, F, E)))}
    return x, router, mats


def _both(x, router, mats, dtype, token_mask=None, quantized=False, **over):
    """(reference out, reference drops, port out, port drops)."""
    jcfg, cfg = _cfgs(dtype=dtype, **over)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jm = {k: {"weight": jnp.asarray(v, jdt)} for k, v in mats.items()}
    if quantized:
        jm = {k: jquant.quantize_tensor(v["weight"]) for k, v in jm.items()}
    tm = {k: {kk: torch.from_numpy(np.array(vv)) if vv.dtype != jnp.bfloat16
              else torch.from_numpy(np.array(vv.astype(jnp.float32))).to(tdt)
              for kk, vv in v.items()} for k, v in jm.items()}
    jmask = None if token_mask is None else jnp.asarray(token_mask)
    tmask = None if token_mask is None else torch.from_numpy(token_mask)
    jo, jd = _jmoe(jnp.asarray(x, jdt), jnp.asarray(router), jm, jcfg,
                   jax.nn.silu, jmask)
    to, td = tmoe.moe_ffn(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(router), tm, cfg,
                          torch.nn.functional.silu, token_mask=tmask,
                          return_dropped=True)
    assert to.dtype == tdt and td.dtype == torch.int32
    return np.asarray(jo, np.float32), int(jd), to.float().numpy(), int(td)


@pytest.mark.parametrize("B,S,factor", [(2, 7, 2.0), (2, 9, 1.0),
                                        (1, 16, 0.5), (4, 1, 0.5)])
def test_moe_ffn_f32_matches_reference(B, S, factor):
    """Float32 within 1e-5, drops equal; the last case is a decode shape
    (S 1: dropless whatever the factor)."""
    x, router, mats = _layer_inputs(B * 100 + S, B, S)
    jo, jd, to, td = _both(x, router, mats, "float32",
                           expert_capacity_factor=factor)
    np.testing.assert_allclose(to, jo, atol=F32_ATOL, rtol=0)
    assert td == jd
    if S == 1:
        assert jd == 0
    if factor < 1.0 and S > 1:
        assert jd > 0


@pytest.mark.parametrize("B,S,factor", [(2, 9, 1.0), (1, 24, 0.5)])
def test_moe_ffn_bf16_within_one_ulp(B, S, factor):
    x, router, mats = _layer_inputs(7 + S, B, S)
    jo, jd, to, td = _both(x, router, mats, "bfloat16",
                           expert_capacity_factor=factor)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=2.0 ** -8)
    assert td == jd


def test_capacity_overflow_drops_weakest_and_ties_go_low():
    """The reference's case: six identical tokens, capacity 1, a router
    that prefers expert 0 and ties the other three.  Top-2 is expert 0
    and expert 1 (the tie to the lower index), so 12 assignments meet 2
    capacity-1 experts: exactly 10 drop, and only token 0 keeps both."""
    x = np.full((1, 6, E), 0.3, np.float32)
    router = np.zeros((E, X), np.float32)
    router[:, 0] = 0.1
    mats = {k: np.full(s, 0.01, np.float32)
            for k, s in (("w_gate", (X, E, F)), ("w_up", (X, E, F)),
                         ("w_down", (X, F, E)))}
    jo, jd, to, td = _both(x, router, mats, "float32",
                           expert_capacity_factor=0.01)
    assert td == jd == 10
    np.testing.assert_allclose(to, jo, atol=F32_ATOL, rtol=0)
    assert np.abs(to[0, 5]).sum() < np.abs(to[0, 0]).sum()
    vals, idx = tmoe.top_k_lower_index(
        torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.5, 2.0, 0.5, 2.0]]), 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    assert vals.tolist() == [[1.0, 0.0], [2.0, 2.0]]


def test_token_mask_takes_no_capacity():
    """Masked tokens are routed nowhere: no capacity, no drop, a zero
    output; the valid tokens' outputs are those of a call without them
    only when the capacity (which follows T) is the same."""
    x, router, mats = _layer_inputs(11, 2, 8)
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    mask[1, 2:] = False
    jo, jd, to, td = _both(x, router, mats, "float32", token_mask=mask,
                           expert_capacity_factor=0.5)
    np.testing.assert_allclose(to, jo, atol=F32_ATOL, rtol=0)
    assert td == jd
    assert np.all(to[~mask] == 0)
    one = np.zeros((1, 6), bool)
    one[0, 0] = True
    _, jd1, _, td1 = _both(x[:1, :6], router, mats, "float32",
                           token_mask=one, expert_capacity_factor=0.01)
    assert td1 == jd1 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_experts_match_reference(dtype):
    """int8 expert stacks with per-expert output-channel scales: the
    product in float32 and the scale in float32, as the reference's
    ``_expert_dense``."""
    x, router, mats = _layer_inputs(21, 2, 10)
    jo, jd, to, td = _both(x, router, mats, dtype, quantized=True,
                           expert_capacity_factor=1.0)
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=2.0 ** -8)
    assert td == jd


def test_expert_stack_quantizes_as_reference():
    """``quantize_tensor`` of ``[L, X, E, F]``: one scale per (layer,
    expert, output column), byte-equal to the reference's."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((2, X, E, F)) * 0.05).astype(np.float32)
    w[1, 2] *= 40.0     # one loud expert must not crush the others
    want = jquant.quantize_tensor(jnp.asarray(w))
    got = tquant.quantize_tensor(torch.from_numpy(w))
    assert got["scale"].shape == (2, X, 1, F)
    np.testing.assert_array_equal(got["weight"].numpy(),
                                  np.asarray(want["weight"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


def test_int8_init_equals_quantize_params_of_the_float_init():
    """The int8 random-init build, drawn and quantized layer by layer,
    equals ``quantize_params`` of the float build of the same seed."""
    cfg = ModelConfig.tiny(num_experts=X, dtype="bfloat16")
    want = tquant.quantize_params(tllama.init_params(cfg, 5, device="cpu"))
    got = tllama.init_params(cfg, 5, device="cpu", quantization="int8")
    a, b = dict(_flat(got)), dict(_flat(want))
    assert a.keys() == b.keys()
    assert ("layers", "experts", "w_down", "scale") in a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_hf_config_mapping_matches_reference():
    hf = {"vocab_size": 32000, "hidden_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "intermediate_size": 256, "model_type": "mixtral",
          "num_local_experts": 8, "num_experts_per_tok": 2,
          "rope_theta": 1e6, "sliding_window": None}
    got = ModelConfig.from_hf_config(hf, name="m")
    want = JModelConfig.from_hf_config(hf, name="m")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_experts, got.num_experts_per_tok,
            got.expert_capacity_factor) == (8, 2, 1.5)
    mix = CATALOG["mistralai/Mixtral-8x7B-Instruct-v0.1"]
    from helix_tpu.models.common import CATALOG as JCATALOG

    assert dataclasses.asdict(mix) == dataclasses.asdict(JCATALOG[mix.name])


# ---------------------------------------------------------------------------
# the model: forward
# ---------------------------------------------------------------------------


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def weights():
    """A tiny MoE model drawn by the reference (float32), both trees."""
    jcfg, cfg = _cfgs()
    jp = jinit(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    return jcfg, jp, cfg, tllama.params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_logits_match_reference(weights, quantized):
    jcfg, jp, cfg, tp = weights
    if quantized:
        jp = jquant.quantize_params(jp)
        tp = tllama.params_from_jax(jax.device_get(jp))
        assert tp["layers"]["router"]["weight"].dtype == torch.int8
    cfg = dataclasses.replace(cfg, expert_capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, expert_capacity_factor=0.5)
    rng = np.random.default_rng(2)
    tok = rng.integers(1, cfg.vocab_size, size=(2, 11))
    pos = np.broadcast_to(np.arange(11), (2, 11))
    mask = np.ones((2, 11), bool)
    mask[1, 8:] = False
    jl, _, jstats = jforward(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(pos),
        attn_fn=lambda q, k, v, c, p: jprefill_attn(q, k, v, c, p,
                                                    backend="reference"),
        moe_token_mask=jnp.asarray(mask), return_moe_stats=True)
    tl, _, tstats = tllama.forward(
        tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos.copy()),
        attn_fn=tllama.prefill_attn_fn,
        moe_token_mask=torch.from_numpy(mask), return_moe_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert int(tstats["dropped"]) == int(jstats["dropped"]) > 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture()
def router_gaps(monkeypatch):
    """The least (k-th - (k+1)-th) router logit of every call the port
    makes while the fixture is live."""
    gaps = []
    top_k = tmoe.top_k_lower_index

    def spy(logits, k):
        srt = torch.sort(logits, dim=-1, descending=True).values
        gaps.append(float((srt[..., k - 1] - srt[..., k]).min()))
        return top_k(logits, k)

    monkeypatch.setattr(tmoe, "top_k_lower_index", spy)
    return gaps


def _engines(weights, factor=2.0, **extra):
    jcfg, jp, cfg, tp = weights
    jcfg = dataclasses.replace(jcfg, expert_capacity_factor=factor)
    cfg = dataclasses.replace(cfg, expert_capacity_factor=factor)
    kw = {**GEOMETRY, **extra}
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    return je, te


def _greedy(n=N_TOK):
    return (jsampling.SamplingParams(temperature=0.0, max_tokens=n),
            tsampling.SamplingParams(temperature=0.0, max_tokens=n))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 250, size=n)] for n in lens]


def _gap_ok(gaps):
    assert gaps and min(gaps) > ROUTER_GAP_MIN, min(gaps or [0.0])


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_greedy_equal_with_prefix_cache(weights, router_gaps,
                                               prefix_cache):
    """A wave of short prompts (one request per prefill call), then the
    same prompts again: with the prefix cache on the second pass starts
    from cached pages and prefills only its tail, as the reference's."""
    je, te = _engines(weights, enable_prefix_cache=prefix_cache)
    js, ts = _greedy()
    prompts = _prompts(1, (9, 5, 12))
    for _ in range(2):
        want = je.generate(prompts, js)
        assert te.generate(prompts, ts) == want
    assert te.moe_dropped_tokens == je.moe_dropped_tokens
    assert (te.prefix_cache is not None) == prefix_cache
    if prefix_cache:
        assert te.prefix_cache.hits > 0
    _gap_ok(router_gaps)


def test_engine_chunked_long_prompt_with_decode(weights, router_gaps):
    """A prompt past ``max_prefill_len`` prefills in chunks (the mixed
    step beside a decoding row), each chunk's MoE over its own tokens:
    the same tokens and the same drop count (a low capacity factor) as
    the JAX engine."""
    je, te = _engines(weights, factor=0.5)
    js, ts = _greedy(8)
    prompts = _prompts(2, (5, 40))
    assert te.generate(prompts, ts) == je.generate(prompts, js)
    assert te.num_mixed_steps == je.num_mixed_steps > 0
    assert te.moe_dropped_tokens == je.moe_dropped_tokens > 0
    _gap_ok(router_gaps)


def test_engine_alone_equals_burst(weights, router_gaps):
    """The reference's determinism case: a prompt alone and in a burst
    of expert-hungry batch-mates gives the same tokens (one request per
    prefill call; decode is dropless), in both packages."""
    js, ts = _greedy(5)
    target = [9, 8, 7, 6, 5]
    burst = [[1] * 12, target, [2] * 12]
    je, te = _engines(weights, factor=1.0)
    alone = te.generate([target], ts)[0]
    assert alone == je.generate([target], js)[0]
    je, te = _engines(weights, factor=1.0)
    got = te.generate(burst, ts)
    assert got == je.generate(burst, js)
    assert got[1] == alone
    _gap_ok(router_gaps)


def test_engine_counts_prefill_drops_equal(weights, router_gaps):
    """A low capacity factor drops prefill assignments: the count after
    the prefill, unchanged by decode (dropless), equal to the JAX
    engine's, with the same tokens; the same for a burst of three."""
    je, te = _engines(weights, factor=0.5)
    js, ts = _greedy(5)
    counts = []
    for eng, mod, sp in ((je, jengine, js), (te, tengine, ts)):
        req = mod.Request(id="d", prompt_tokens=[3, 1, 4, 1, 5, 9, 2, 6],
                          sampling=sp)
        eng.add_request(req)
        eng.step()
        after = eng.moe_dropped_tokens
        while eng.has_work():
            eng.step()
        eng._drain_moe_drops()
        counts.append((after, eng.moe_dropped_tokens, req.output_tokens))
    assert counts[1] == counts[0]
    assert counts[1][0] > 0
    # a burst admitted together: one prefill call per request, each with
    # its own bucket's capacity (co-packing would change every count)
    je, te = _engines(weights, factor=0.5)
    prompts = _prompts(5, (7, 11, 5))
    assert te.generate(prompts, ts) == je.generate(prompts, js)
    assert te.moe_dropped_tokens == je.moe_dropped_tokens > 0
    _gap_ok(router_gaps)


def test_engine_attention_only_adapter_pool(weights, router_gaps):
    """An adapter pool on an MoE model serves its attention targets (FFN
    targets are dropped by ``target_dims``): an adapter row's tokens
    equal the JAX engine's and differ from the base model's."""
    _, _, cfg, _ = weights
    je, te = _engines(weights, adapter_pool_slots=3, adapter_rank=4,
                      adapter_targets=("wq", "wk", "wv", "wo", "w_gate"))
    assert te.adapter_pool.targets == ("wq", "wk", "wv", "wo")
    rng = np.random.default_rng(9)
    lora = {t: {"lora_a": (rng.standard_normal((cfg.num_layers, 64, 4))
                           / 8).astype(np.float32),
                "lora_b": (rng.standard_normal((cfg.num_layers, 4, w))
                           * 0.05).astype(np.float32)}
            for t, w in (("wq", 64), ("wk", 32), ("wv", 32), ("wo", 64))}
    for eng in (je, te):
        eng.publish_adapter("a1", lora, 2.0)
    js, ts = _greedy()
    prompt = [5, 6, 7, 8, 9]
    out = []
    for eng, mod, sp in ((je, jengine, js), (te, tengine, ts)):
        reqs = [mod.Request(id=f"r{i}", prompt_tokens=list(prompt),
                            sampling=sp, adapter=a)
                for i, a in enumerate(("a1", ""))]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        out.append([r.output_tokens for r in reqs])
    assert out[1] == out[0]
    assert out[1][0] != out[1][1]
    _gap_ok(router_gaps)


def test_engine_spec_decode_logged_off(weights, router_gaps, caplog):
    """``enable_spec_decode`` on an MoE model logs the reference's
    warning and runs plain decode, with the same tokens."""
    with caplog.at_level(logging.WARNING):
        je, te = _engines(weights, enable_spec_decode=True, spec_tokens=3)
    assert te.spec is None and je.spec is None
    assert any("not supported for MoE models" in r.getMessage()
               and r.name == tengine.__name__ for r in caplog.records)
    js, ts = _greedy()
    prompts = _prompts(4, (6, 6))
    assert te.generate(prompts, ts) == je.generate(prompts, js)
    assert te.num_spec_steps == 0
    _gap_ok(router_gaps)


# ---------------------------------------------------------------------------
# the loader and the residency estimate
# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_loader_reads_mixtral_names_as_reference(tmp_path, quantization):
    """A tiny HF Mixtral checkpoint (``block_sparse_moe.gate`` and
    ``experts.{e}.w1|w2|w3``) loads into the reference's tree: bf16 bit
    for bit, int8 byte for byte to the reference's ``quantize_params``
    of its load.

    The reference's loader reads each layer's dense ``mlp.gate_proj`` /
    ``up_proj`` / ``down_proj`` before its MoE branch replaces them, so
    on a Mixtral export, which has none, it raises ``KeyError`` (ROADMAP
    C).  It is compared here on the same checkpoint with a file of such
    dense tensors beside it, which the port's loader does not read."""
    cfg = ModelConfig.tiny(num_experts=X, dtype="bfloat16", name="mix")
    params = tllama.init_params(cfg, 6, device="cpu")
    d = str(tmp_path / "mixtral")
    write_checkpoint(d, cfg, params, model_type="mixtral")
    with pytest.raises(KeyError, match="mlp.gate_proj"):
        jloader.load_params(d)
    dense = {}
    for i in range(cfg.num_layers):
        for nm, shape in (("gate_proj", (F, E)), ("up_proj", (F, E)),
                          ("down_proj", (E, F))):
            dense[f"model.layers.{i}.mlp.{nm}.weight"] = np.zeros(
                shape, np.float32)
    st_np.save_file(dense, str(tmp_path / "mixtral" / "zz-dense.safetensors"))
    jcfg, jp = jloader.load_params(d)
    assert jcfg.num_experts == X
    if quantization:
        jp = jquant.quantize_params(jp)
    want = tllama.params_from_jax(jax.device_get(jp))
    got_cfg, got = tloader.load_params(d, device="cpu",
                                       quantization=quantization)
    assert got_cfg.num_experts == X
    a, b = dict(_flat(got)), dict(_flat(want))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k
    if not quantization:
        c, p = dict(_flat(params)), a
        assert all(torch.equal(_bits(c[k]), _bits(p[k])) for k in c)


def test_residency_estimate_is_the_reference_figure():
    """``estimate_model_bytes`` of Mixtral as the profile serves it
    equals the reference's: one FFN per layer, the active-per-token
    parameter count (7.24 B), so the int8 entry is estimated at ~17.4 GB
    where its weights alone take ~46.7 GB (ROADMAP C)."""
    mix = CATALOG["mistralai/Mixtral-8x7B-Instruct-v0.1"]
    from helix_tpu.models.common import CATALOG as JCATALOG

    engine = dict(max_decode_batch=16, num_pages=4096, page_size=16,
                  max_prefill_len=2048)
    for q in (None, "int8"):
        got = tresidency.estimate_model_bytes(mix, engine, q)
        assert got == jresidency.estimate_model_bytes(JCATALOG[mix.name],
                                                      engine, q)
    assert tresidency.model_param_count(mix) == 7_241_732_096
    est = tresidency.estimate_model_bytes(mix, engine, "int8")
    assert 17.3e9 < est < 17.5e9
    tiny = ModelConfig.tiny(num_experts=X)
    drawn = tresidency.tree_bytes(tllama.init_params(tiny, 0, device="cpu"))
    assert drawn > 2 * tresidency.model_param_count(tiny) * 2
