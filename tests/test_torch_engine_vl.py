"""The port's VL (Qwen2-VL, mrope) engine against the JAX ``Engine``.

Both engines serve the same tiny float32 text tower (JAX-initialised,
copied with ``params_from_jax``) at ``tests/test_engine_vl.py``'s
geometry; the JAX engine runs its reference attention backend, the port
runs on the CPU (its kernel wrappers take their plain versions).  The
same image embeddings (the reference's ``vision_forward``) and M-RoPE
streams go into both.  Greedy and seeded tokens must be IDENTICAL: one
image, two images, text only, several VL rows decoding together.

Also every reference VL gate, each against the reference: no packed
wave and no prefix cache for VL prompts, the ``vision prompt ...
exceeds max_prefill_len`` text, speculation and the adapter pool logged
off, tiered residency refused, the warmup skip, ``export_request`` None
for a request with image state, and the splice's out-of-range drop.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.models.qwen2_vl import VisionConfig as JVisionConfig
from helix_tpu.models.qwen2_vl import init_vision_params as jinit_vision
from helix_tpu.models.qwen2_vl import mrope_positions as jmrope_positions
from helix_tpu.models.qwen2_vl import vision_forward as jvision_forward
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax

IMG = 126
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=64,
                max_pages_per_seq=16, max_prefill_len=64)


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first (the JAX
    engine goes on writing host mirrors it uploaded asynchronously; see
    ``tests/test_torch_engine.py``)."""

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
def vl():
    over = dict(dtype="float32", attention_bias=True,
                mrope_sections=(2, 3, 3), vocab_size=128)
    jcfg = JModelConfig.tiny(**over)
    jp = jinit(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    vcfg = JVisionConfig.tiny(hidden_size=jcfg.hidden_size)
    vp = jinit_vision(vcfg, jax.random.PRNGKey(6))
    return jcfg, jp, ModelConfig.tiny(**over), tp, vcfg, vp


def _image(vl, grid, seed):
    *_, vcfg, vp = vl
    grid = np.asarray(grid)
    n = int(sum(int(np.prod(g)) for g in grid))
    patches = np.random.RandomState(seed).randn(
        n, vcfg.patch_dim).astype(np.float32)
    return np.asarray(jvision_forward(vp, vcfg, jnp.asarray(patches), grid))


def _vl_request(ids, grid, embeds):
    """The fields both packages' ``Request`` take for a VL prompt."""
    pos3, delta = jmrope_positions(ids, grid, IMG)
    return dict(prompt_tokens=list(ids), positions3=pos3, mrope_delta=delta,
                image_positions=[i for i, t in enumerate(ids) if t == IMG]
                if embeds is not None else None,
                image_embeds=embeds)


def _run_both(vl, specs, max_tokens=6, temperature=0.0, seed=None,
              **extra):
    """Submit each ``_vl_request`` spec to a JAX and a port engine (same
    order, same step), run both to completion; returns (ref, port)
    engines and token lists."""
    jcfg, jp, cfg, tp, *_ = vl
    kw = {**GEOMETRY, **extra}
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    outs = []
    for eng, mod, sp, arr in (
            (je, jengine, jsampling, jnp.asarray),
            (te, tengine, tsampling, torch.from_numpy)):
        reqs = []
        for i, spec in enumerate(specs):
            f = dict(spec)
            if f["image_embeds"] is not None:
                f["image_embeds"] = arr(np.array(f["image_embeds"]))
            reqs.append(mod.Request(
                id=f"r{i}", sampling=sp.SamplingParams(
                    temperature=temperature, max_tokens=max_tokens,
                    seed=seed), **f))
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        outs.append([r.output_tokens for r in reqs])
    return je, te, outs[0], outs[1]


def test_greedy_parity_with_image(vl):
    grid = np.array([[1, 4, 4]])
    ids = [1, 2] + [IMG] * 4 + [3]
    _, _, want, got = _run_both(vl, [_vl_request(ids, grid,
                                                 _image(vl, grid, 3))])
    assert got == want and len(got[0]) == 6


def test_greedy_parity_text_only(vl):
    ids = [5, 6, 7, 8]
    _, _, want, got = _run_both(vl, [_vl_request(ids, None, None)], 5)
    assert got == want


def test_greedy_parity_two_images_and_batched_rows(vl):
    """Two images in one prompt beside a one-image and a text-only
    prompt: three VL rows with different ``mrope_delta`` decode in one
    step; the fused window (``decode_steps_per_sync``) and a second
    bucket are exercised too."""
    g2 = np.array([[1, 4, 4], [1, 2, 4]])
    ids2 = [9, 125] + [IMG] * 4 + [124, 11, 125] + [IMG] * 2 + [124, 12]
    g1 = np.array([[1, 4, 8]])
    ids1 = [3] * 20 + [IMG] * 8 + [4]
    specs = [_vl_request(ids2, g2, _image(vl, g2, 4)),
             _vl_request(ids1, g1, _image(vl, g1, 5)),
             _vl_request([7, 8, 9], None, None)]
    _, _, want, got = _run_both(vl, specs, 8, decode_steps_per_sync=4,
                                adaptive_sync_max_streams=1)
    assert got == want


def test_seeded_sampling_parity_with_image(vl):
    grid = np.array([[1, 4, 4]])
    ids = [1, 2] + [IMG] * 4 + [3]
    spec = _vl_request(ids, grid, _image(vl, grid, 3))
    _, _, want, got = _run_both(vl, [spec, spec], 8, temperature=0.9,
                                seed=77)
    assert got == want and got[0] == got[1]


def test_vl_prompts_bypass_waves_and_prefix_cache(vl):
    """``_admit_wave`` never sees a VL prompt and nothing is shared: the
    same 20-token prompt twice hits no cached page on either engine."""
    ids = list(range(1, 21))
    specs = [_vl_request(ids, None, None)] * 2
    je, te, want, got = _run_both(vl, specs, 4)
    assert got == want
    assert te.prefix_cache_hits == je.prefix_cache_hits == 0
    assert te.prefix_cache.match_len(te._prompt_hashes(
        tengine.Request(id="x", prompt_tokens=ids))) == 0
    assert te.num_prefill_padding_tokens == 2 * (32 - 20)


def test_vision_prompt_over_max_prefill_len_refused_as_reference(vl):
    jcfg, jp, cfg, tp, *_ = vl
    kw = dict(GEOMETRY, max_prefill_len=16)
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    ids = list(range(1, 30))
    want = je.validate_request(jengine.Request(id="a", prompt_tokens=ids))
    got = te.validate_request(tengine.Request(id="a", prompt_tokens=ids))
    assert got == want == ("vision prompt (29 tokens) exceeds "
                           "max_prefill_len 16")
    # past the context limit the context text comes first, as there
    ids = list(range(1, 70))
    assert te.validate_request(tengine.Request(
        id="b", prompt_tokens=ids)) == je.validate_request(
            jengine.Request(id="b", prompt_tokens=ids))


def test_spec_and_adapter_pool_logged_off(vl, caplog):
    jcfg, jp, cfg, tp, *_ = vl
    kw = dict(GEOMETRY, enable_spec_decode=True, spec_tokens=3,
              adapter_pool_slots=4)
    with caplog.at_level(logging.WARNING):
        je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **kw, attn_backend="reference"))
        te = tengine.Engine(cfg, tp, tengine.EngineConfig(**kw),
                            device="cpu")
    assert je.spec is None and te.spec is None
    assert je.adapter_pool is None and te.adapter_pool is None
    texts = [r.getMessage() for r in caplog.records]
    for want in ("speculative decoding is not supported for mrope (VL) "
                 "models", "batched multi-LoRA serving is not supported "
                 "for mrope (VL) models"):
        assert sum(want in t for t in texts) == 2, (want, texts)


def test_tiered_residency_refused_for_mrope(vl):
    jcfg, jp, cfg, tp, *_ = vl
    kw = dict(GEOMETRY, host_pool_bytes=1 << 20, ctx_hot_pages=4)
    with pytest.raises(ValueError, match="mrope") as je:
        jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **kw, attn_backend="reference"))
    with pytest.raises(ValueError, match="mrope") as te:
        tengine.Engine(cfg, tp, tengine.EngineConfig(**kw), device="cpu")
    assert str(te.value) == str(je.value)


def test_warmup_skipped_for_vl(vl):
    *_, cfg, tp, _vc, _vp = vl
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**GEOMETRY),
                        device="cpu")
    te.warmup()
    assert te.num_device_calls == 0 and not te.has_work()


def test_export_request_none_for_image_state(vl):
    """A decoding VL request is not exported by either engine (its image
    state is bound to the engine); a text request on a text engine is."""
    grid = np.array([[1, 4, 4]])
    ids = [1, 2] + [IMG] * 4 + [3]
    spec = _vl_request(ids, grid, _image(vl, grid, 3))
    jcfg, jp, cfg, tp, *_ = vl
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**GEOMETRY),
                        device="cpu")
    for eng, mod, sp, arr in ((je, jengine, jsampling, jnp.asarray),
                              (te, tengine, tsampling, torch.from_numpy)):
        f = dict(spec, image_embeds=arr(np.array(spec["image_embeds"])))
        req = mod.Request(id="v", sampling=sp.SamplingParams(
            temperature=0.0, max_tokens=20), **f)
        eng.add_request(req)
        eng.step()
        eng.step()
        assert req.slot is not None and len(req.output_tokens) >= 2
        assert eng.export_request("v") is None
        eng.abort("v")


def test_splice_drops_out_of_range_rows_as_reference(vl):
    """An image row whose index lies past the bucket writes nothing (the
    reference's ``mode="drop"``), and the others land where named."""
    jcfg, jp, cfg, tp, *_ = vl
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference"))
    te = tengine.Engine(cfg, tp, tengine.EngineConfig(**GEOMETRY),
                        device="cpu")
    E = cfg.hidden_size
    emb = np.random.RandomState(9).randn(3, E).astype(np.float32)
    toks = np.arange(1, 9, dtype=np.int32)[None]
    fields = dict(prompt_tokens=list(toks[0]), image_positions=[2, 40, 5])
    want = je._splice_embeds(jengine.Request(
        id="s", image_embeds=jnp.asarray(emb), **fields), toks, 8)
    got = te._splice_embeds(tengine.Request(
        id="s", image_embeds=torch.from_numpy(emb), **fields),
        torch.from_numpy(toks.astype(np.int64)), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[0, 5], emb[2])


def test_text_engine_unchanged_by_vl_fields():
    """A text model's engine keeps refusing nothing new and its decode
    state carries a zero offset."""
    cfg = dataclasses.replace(ModelConfig.tiny(dtype="float32"))
    from helix_tpu_torch.models.llama import init_params

    te = tengine.Engine(cfg, init_params(cfg, 1, device="cpu"),
                        tengine.EngineConfig(**GEOMETRY), device="cpu")
    out = te.generate([[1, 2, 3]], tsampling.SamplingParams(
        temperature=0.0, max_tokens=3))
    assert len(out[0]) == 3
    assert int(te._dstate.mrope_delta.abs().sum()) == 0
