"""The port's checkpoint loader against the reference's, on the CPU.

- ``models/st_format.py`` (the port's safetensors reader) against the
  ``safetensors`` package on files that package writes: every dtype the
  reader takes, one file and shards with an index; planted faults (a
  truncated file, overlapping offsets, a gap, an unknown dtype) raise.
- ``models/loader.py`` ``load_params`` against
  ``helix_tpu.models.loader.load_params`` on tiny Llama, Qwen2 (bias,
  tied), Qwen3 (qk-norm) and Phi-3 (fused) checkpoints written by
  ``testing/hf_checkpoint.py``: float32 trees exactly equal, bfloat16
  trees equal bit for bit, int8 trees equal byte for byte to the
  reference's ``quantize_params`` of its load.  Logits of a loaded model
  equal ``helix_tpu.models.llama.forward`` on the reference's load
  (float32, ``atol 1e-4``: two libraries summing float32 matmuls in
  different orders, as ``tests/test_torch_model.py``); greedy tokens of
  the port's ``Engine`` equal the JAX ``Engine``'s.
- The refusals (MoE, an unknown activation, rope scalings other than
  ``llama3``), the mrope configs that load since A17b, and
  ``serve-node``'s checkpoint path.
"""

import dataclasses
import json
import logging
import os
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as st_np
import safetensors.torch as st_torch
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models import llama as jllama
from helix_tpu.models import loader as jloader
from helix_tpu.ops.quant import quantize_params as jquantize
from helix_tpu.ops.rope import rope_frequencies as jrope
from helix_tpu_torch import cli
from helix_tpu_torch.control.node_agent import NodeAgent
from helix_tpu_torch.control.profile import ServingProfile
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.models import loader as tloader
from helix_tpu_torch.models import st_format
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, HFTokenizer
from helix_tpu_torch.testing.hf_checkpoint import hf_config, write_checkpoint
from helix_tpu_torch.testing.tokenizer_fixtures import FIXTURES

FAMILIES = {
    "llama": ({}, "llama", False),
    "qwen2": ({"attention_bias": True, "tie_word_embeddings": True},
              "qwen2", False),
    "qwen3": ({"qk_norm": True}, "qwen3", False),
    "phi3": ({"num_kv_heads": 4}, "phi3", True),
}
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=16, max_prefill_len=16)


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


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(got, want):
    a, b = dict(_flat(got)), dict(_flat(want))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def _checkpoint(tmp_path, family, dtype="float32", seed=3, shard=None,
                **extra):
    """A tiny HF checkpoint of ``family`` in ``tmp_path``: (dir, port
    config, the tree written)."""
    over, model_type, fused = FAMILIES[family]
    cfg = ModelConfig.tiny(dtype=dtype, **over, **extra)
    params = tllama.init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for k in ("wq", "wk", "wv"):
        if "bias" in params["layers"][k]:   # zeros from init: give values
            b = params["layers"][k]["bias"]
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    for k in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
        if k in params["layers"]:
            w = params["layers"][k]["weight"]
            w.copy_(1 + torch.randn(w.shape, generator=gen) * 0.1)
    d = str(tmp_path / f"{family}-{dtype}")
    write_checkpoint(d, cfg, params, model_type=model_type, fused=fused,
                     max_shard_bytes=shard or 5_000_000_000)
    return d, cfg, params


def _jax_load(d, dtype, quantized=False):
    jcfg, jp = jloader.load_params(d, dtype=dtype)
    if quantized:
        jp = jquantize(jp)
    return jcfg, jp, tllama.params_from_jax(jax.device_get(jp))


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

ARRAYS = {
    "bf16": np.arange(12, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16) / 7,
    "f16": (np.arange(6, dtype=np.float16) - 2.5).reshape(2, 3),
    "f32": np.linspace(-1, 1, 10, dtype=np.float32),
    "i8": np.arange(-5, 5, dtype=np.int8).reshape(2, 5),
    "i32": np.arange(7, dtype=np.int32) * -3,
    "i64": np.arange(4, dtype=np.int64) << 40,
    "u8": np.arange(250, 256, dtype=np.uint8),
    "bool": np.array([True, False, True]),
    "empty": np.zeros((0, 3), dtype=np.float32),
    "scalar": np.array(2.5, dtype=np.float32),
}


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("sharded", [False, True])
def test_reader_equals_safetensors_package(tmp_path, sharded):
    """Every dtype the reader takes, as the package wrote it: values,
    shapes and dtypes equal what the package reads back."""
    if sharded:
        names = sorted(ARRAYS)
        parts = [names[:4], names[4:7], names[7:]]
        wmap = {}
        for k, part in enumerate(parts):
            fname = f"model-{k + 1:05d}-of-00003.safetensors"
            st_np.save_file({n: ARRAYS[n] for n in part},
                            str(tmp_path / fname))
            wmap.update({n: fname for n in part})
        (tmp_path / st_format.INDEX_NAME).write_text(json.dumps(
            {"metadata": {}, "weight_map": wmap}))
    else:
        st_np.save_file(ARRAYS, str(tmp_path / "model.safetensors"),
                        metadata={"format": "np"})
    with st_format.SafetensorsDir(str(tmp_path)) as st:
        assert sorted(st.names()) == sorted(ARRAYS)
        for name, want in ARRAYS.items():
            got = st.get(name)
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(_numpy_of(got), want)
            assert _numpy_of(got).dtype == want.dtype
            del got


def test_reader_reads_files_in_sorted_order_without_index(tmp_path):
    st_np.save_file({"b": ARRAYS["f32"]}, str(tmp_path / "b.safetensors"))
    st_np.save_file({"a": ARRAYS["i8"]}, str(tmp_path / "a.safetensors"))
    with st_format.SafetensorsDir(str(tmp_path)) as st:
        assert st.entry("a")[0] == "a.safetensors"
        np.testing.assert_array_equal(st.get("b").numpy(), ARRAYS["f32"])


def _rewrite_header(path, edit):
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    edit(header)
    new = json.dumps(header).encode()
    new += b" " * (-len(new) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(new)) + new + raw[8 + n:])


def _overlap(h):
    h["b"]["data_offsets"] = [0, h["b"]["data_offsets"][1]
                              - h["b"]["data_offsets"][0]]


def _gap(h):
    for k in ("a", "b"):
        h[k]["data_offsets"] = [x + 8 for x in h[k]["data_offsets"]]


@pytest.mark.parametrize("fault,match", [
    ("truncated", "truncated"),
    ("overlap", "overlaps"),
    ("gap", "gap"),
    ("dtype", "'F64'"),
    ("header", "header length"),
])
def test_reader_refuses_planted_faults(tmp_path, fault, match):
    path = str(tmp_path / "model.safetensors")
    arrays = {"a": np.ones((4, 4), np.float32), "b": np.ones(8, np.int32)}
    if fault == "dtype":
        arrays["c"] = np.ones(2, np.float64)
    st_np.save_file(arrays, path)
    if fault == "truncated":
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[:-4])
    elif fault == "overlap":
        _rewrite_header(path, _overlap)
    elif fault == "gap":
        _rewrite_header(path, _gap)
    elif fault == "header":
        raw = open(path, "rb").read()
        open(path, "wb").write(struct.pack("<Q", 1 << 40) + raw[8:])
    with pytest.raises(st_format.FormatError, match=match):
        st_format.SafetensorsDir(str(tmp_path))


def test_truncated_shard_fails_before_any_weights(tmp_path, monkeypatch):
    d, cfg, _ = _checkpoint(tmp_path, "llama", shard=20_000)
    shard = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))[-1]
    raw = open(os.path.join(d, shard), "rb").read()
    open(os.path.join(d, shard), "wb").write(raw[:-2])
    made = []
    monkeypatch.setattr(tloader, "_allocate",
                        lambda *a, **k: made.append(1))
    with pytest.raises(st_format.FormatError, match="truncated"):
        tloader.load_params(d, device="cpu")
    assert made == []


# ---------------------------------------------------------------------------
# the writer round-trips through the safetensors package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_writer_round_trips_through_safetensors(tmp_path, family):
    """The writer's files, read by the package: HF names and ``[out,
    in]`` layout (Phi-3 fused), shards of at most the limit, an index
    naming each tensor's shard, and a config that reads back to the
    same ModelConfig."""
    d, cfg, params = _checkpoint(tmp_path, family, dtype="bfloat16",
                                 shard=30_000)
    with open(os.path.join(d, st_format.INDEX_NAME)) as f:
        wmap = json.load(f)["weight_map"]
    shards = sorted(set(wmap.values()))
    assert len(shards) > 2
    tensors = {}
    for fname in shards:
        assert os.path.getsize(os.path.join(d, fname)) <= 30_000 + 8192
        part = st_torch.load_file(os.path.join(d, fname))
        assert all(wmap[k] == fname for k in part)
        tensors.update(part)
    lay = params["layers"]
    p = "model.layers.1."
    if FAMILIES[family][2]:
        qkv = torch.cat([lay[k]["weight"][1] for k in ("wq", "wk", "wv")],
                        dim=1).t()
        assert torch.equal(tensors[p + "self_attn.qkv_proj.weight"], qkv)
        gu = torch.cat([lay["w_gate"]["weight"][1],
                        lay["w_up"]["weight"][1]], dim=1).t()
        assert torch.equal(tensors[p + "mlp.gate_up_proj.weight"], gu)
    else:
        assert torch.equal(tensors[p + "self_attn.k_proj.weight"],
                           lay["wk"]["weight"][1].t())
    assert torch.equal(tensors["lm_head.weight"],
                       params["lm_head"]["weight"].t())
    assert tensors["model.embed_tokens.weight"].dtype == torch.bfloat16
    got = tloader.load_config(d, name=cfg.name)
    assert dataclasses.replace(got, dtype=cfg.dtype) == cfg


# ---------------------------------------------------------------------------
# load_params against the reference loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_params_equals_reference(tmp_path, family, dtype):
    """Same keys, shapes and dtypes as the reference's load, every value
    equal (bit for bit in bf16), and equal to the tree written."""
    d, cfg, params = _checkpoint(tmp_path, family, dtype, shard=40_000)
    tcfg, got = tloader.load_params(d, device="cpu", dtype=dtype)
    jcfg, _jp, want = _jax_load(d, dtype)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_int8_load_equals_quantize_params(tmp_path, family):
    """int8 as the weights land: bytes equal the reference's
    ``quantize_params`` of its bf16 load, and the port's
    ``quantize_params`` of the port's bf16 load."""
    d, cfg, _ = _checkpoint(tmp_path, family, "bfloat16")
    _, got = tloader.load_params(d, device="cpu", quantization="int8")
    _, _jp, want = _jax_load(d, "bfloat16", quantized=True)
    _assert_trees_equal(got, want)
    from helix_tpu_torch.ops.quant import quantize_params
    _, bf16 = tloader.load_params(d, device="cpu")
    _assert_trees_equal(got, quantize_params(bf16))


def test_f32_checkpoint_loaded_as_bf16_rounds_like_reference(tmp_path):
    d, _cfg, _ = _checkpoint(tmp_path, "qwen2", "float32")
    _, got = tloader.load_params(d, device="cpu")       # config's bf16
    _, _jp, want = _jax_load(d, None)
    _assert_trees_equal(got, want)
    assert got["embed"]["weight"].dtype == torch.bfloat16


def test_implicit_tie_takes_the_embedding(tmp_path):
    """An untied config whose checkpoint has no ``lm_head.weight``: the
    head is the embedding's transpose, as the reference's."""
    d, cfg, params = _checkpoint(tmp_path, "llama")
    with st_format.SafetensorsDir(d) as st:
        tensors = {n: st.get(n).clone() for n in st.names()}
    del tensors["lm_head.weight"]
    os.remove(os.path.join(d, "model.safetensors"))
    st_torch.save_file(tensors, os.path.join(d, "model.safetensors"))
    _, got = tloader.load_params(d, device="cpu", dtype="float32")
    _, _jp, want = _jax_load(d, "float32")
    _assert_trees_equal(got, want)
    assert torch.equal(got["lm_head"]["weight"],
                       params["embed"]["weight"].t())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loaded_logits_equal_reference_forward(tmp_path, family):
    d, _cfg, _ = _checkpoint(tmp_path, family)
    tcfg, tp = tloader.load_params(d, device="cpu", dtype="float32")
    jcfg, jp, _ = _jax_load(d, "float32")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, tcfg.vocab_size, size=(2, 7)).astype(np.int32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1)) + 3
    seg = np.ones_like(tok)
    want, _ = jllama.forward(
        jp, jcfg, tok, pos,
        attn_fn=lambda q, k, v, c, p: jllama.prefill_attn_fn(
            q, k, v, c, p, segment_ids=seg, backend="reference"))
    got, _ = tllama.forward(
        tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
        attn_fn=lambda q, k, v, c, p: tllama.prefill_attn_fn(
            q, k, v, c, p, segment_ids=torch.from_numpy(seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_loaded_engine_greedy_tokens_equal_jax_engine(tmp_path,
                                                      monkeypatch, family):
    monkeypatch.setattr(jengine, "jnp", _SnapshotJnp())
    d, _cfg, _ = _checkpoint(tmp_path, family)
    tcfg, tp = tloader.load_params(d, device="cpu", dtype="float32")
    jcfg, jp, _ = _jax_load(d, "float32")
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference"))
    te = tengine.Engine(tcfg, tp, tengine.EngineConfig(**GEOMETRY),
                        device="cpu")
    prompts = [[1, 2, 3, 4, 5], [10, 11, 12], [(3 * i) % 29 + 1
                                                for i in range(20)]]
    js = jsampling.SamplingParams(temperature=0.0, max_tokens=8)
    ts = tsampling.SamplingParams(temperature=0.0, max_tokens=8)
    assert te.generate(prompts, ts) == je.generate(prompts, js)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

ROPE_SCALINGS = {
    "longrope": {"type": "longrope", "short_factor": [1.0] * 8,
                 "long_factor": [4.0] * 8,
                 "original_max_position_embeddings": 256},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 256},
    "linear": {"type": "linear", "factor": 2.0},
}


def _config_dir(tmp_path, **fields):
    cfg = ModelConfig.tiny()
    hf = hf_config(cfg)
    hf.update(fields)
    d = tmp_path / "ckpt"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf))
    return str(d)


@pytest.mark.parametrize("fields,match", [
    ({"hidden_act": "relu2"}, "hidden_act 'relu2'"),
] + [({"rope_scaling": rs}, f"rope_scaling type '{k}'.*ROADMAP C")
     for k, rs in ROPE_SCALINGS.items()])
def test_unsupported_configs_refused_before_any_weights(tmp_path, fields,
                                                        match):
    d = _config_dir(tmp_path, **fields)
    with pytest.raises(NotImplementedError, match=match):
        tloader.load_config(d)
    with pytest.raises(NotImplementedError, match=match):
        tloader.load_params(d, device="cpu")
    prof = tmp_path / "p.json"
    prof.write_text(json.dumps({"models": [{"name": "m", "checkpoint": d}]}))
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["serve-node", "--profile", str(prof), "--device", "cpu",
                  "--port", "0"])


@pytest.mark.parametrize("fields,attention_bias", [
    ({"model_type": "qwen2_vl",
      "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]}}, True),
    ({"rope_scaling": {"type": "default", "mrope_section": [2, 3, 3]}},
     False),
])
def test_mrope_configs_load(tmp_path, fields, attention_bias):
    """The two mrope configs refused until A17b: a Qwen2-VL directory's
    config is its text tower (the reference's ``load_qwen2_vl``: qkv
    bias, the checkpoint's dtype), another family's keeps its own
    fields; both rotate by M-RoPE."""
    d = _config_dir(tmp_path, **fields)
    cfg = tloader.load_config(d)
    assert cfg.mrope_sections == (2, 3, 3) and cfg.rope_scaling is None
    assert cfg.attention_bias == attention_bias
    assert tloader.unsupported(json.load(open(f"{d}/config.json"))) == []


def test_reference_loads_longrope_and_serves_it_unscaled(tmp_path):
    """Reference behaviour 1 (ROADMAP C): the reference's loader keeps a
    ``longrope`` scaling and its rope ignores it, so it serves unscaled
    rope; the port refuses the config (above)."""
    d = _config_dir(tmp_path, rope_scaling=ROPE_SCALINGS["longrope"])
    jcfg = jloader.load_config(d)
    assert dict(jcfg.rope_scaling)["type"] == "longrope"
    np.testing.assert_array_equal(
        jrope(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling),
        jrope(jcfg.head_dim, jcfg.rope_theta, None))


def test_llama3_rope_scaling_is_loaded(tmp_path):
    rs = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 256}
    d = _config_dir(tmp_path, rope_scaling=rs)
    assert dict(tloader.load_config(d).rope_scaling) == rs
    assert dataclasses.asdict(tloader.load_config(d)) == \
        dataclasses.asdict(jloader.load_config(d))


def test_sliding_window_is_logged_once_and_dropped(tmp_path, caplog):
    """Reference behaviour 2 (ROADMAP C): the window is not applied (the
    reference's config has no field for it); the port says so once per
    load."""
    d, cfg, _ = _checkpoint(tmp_path, "phi3")
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    hf["sliding_window"] = 7
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    assert "sliding_window" not in {f.name for f in dataclasses.fields(
        jloader.load_config(d))}
    with caplog.at_level(logging.WARNING, logger=tloader.__name__):
        tloader.load_params(d, device="cpu")
    hits = [r for r in caplog.records if "sliding_window 7" in r.message]
    assert len(hits) == 1


# ---------------------------------------------------------------------------
# serve-node's checkpoint path
# ---------------------------------------------------------------------------


def _served_checkpoint(tmp_path, family="llama", tokenizer="llama3"):
    d, cfg, params = _checkpoint(tmp_path, family, "bfloat16",
                                 vocab_size=3072)
    if tokenizer:
        with open(os.path.join(FIXTURES[tokenizer], "tokenizer.json")) as f:
            text = f.read()
        with open(os.path.join(d, "tokenizer.json"), "w") as f:
            f.write(text)
    return d, cfg, params


def test_serve_node_profile_serves_a_checkpoint(tmp_path):
    """A profile entry's ``checkpoint:`` is served as written, without
    ``--random-weights``: its weights, its tokenizer and the tokenizer's
    end-of-turn ids; the residency estimate reads its ``config.json``."""
    d, cfg, params = _served_checkpoint(tmp_path)
    entry = {"name": "my-model", "checkpoint": d,
             "engine": GEOMETRY, "quantization": "int8"}
    prof = tmp_path / "p.json"
    prof.write_text(json.dumps({"residency": {"hbm_budget_bytes": 1 << 40},
                                "models": [entry]}))
    args = type("A", (), {"profile": str(prof), "engine": None,
                          "model": None, "random_weights": False, "seed": 0})
    (spec,) = cli._model_specs(args)
    assert spec["checkpoint"] == d
    agent = NodeAgent("t", device="cpu", warmup=False)
    state = agent.apply_profile(ServingProfile.from_dict(
        cli._load_profile(str(prof))))
    assert state.status == "running", state.error
    reg = agent.registry
    try:
        jcfg = jloader.load_config(d, name="my-model")
        from helix_tpu.engine.residency import estimate_model_bytes
        assert reg.inner._estimate("my-model") == estimate_model_bytes(
            jcfg, GEOMETRY, "int8")
        served = reg.get("my-model")
        eng = served.loop.engine
        assert isinstance(served.tokenizer, HFTokenizer)
        tok = served.tokenizer
        eot = tok._special("<|eot_id|>")
        assert eot in eng.cfg.eos_token_ids
        assert tuple(eng.cfg.eos_token_ids) == tok.eos_ids
        assert served.build_seconds.keys() == {"load", "engine", "warmup"}
        assert served.load_stats["bytes"] > 0
        from helix_tpu_torch.ops.quant import quantize_params
        _assert_trees_equal(eng.params, quantize_params(params))
        ids = tok.apply_chat_template([{"role": "user", "content": "hi"}])
        out = eng.generate([ids], tsampling.SamplingParams(
            temperature=0.0, max_tokens=4))[0]
        assert len(out) >= 1
    finally:
        reg.unregister("my-model")


def test_checkpoint_without_tokenizer_serves_byte_tokenizer(tmp_path):
    d, _cfg, _ = _served_checkpoint(tmp_path, tokenizer=None)
    served = cli.build_served_model("m", device="cpu", checkpoint=d,
                                    engine=GEOMETRY, warmup=False)
    try:
        assert isinstance(served.tokenizer, ByteTokenizer)
    finally:
        served.loop.stop()


def test_checkpoint_refusals_before_weights(tmp_path, monkeypatch):
    """A missing directory, and ``model_overrides`` that disagree with
    the checkpoint's config, fail before any weights are made; overrides
    that agree are served."""
    d, cfg, _ = _served_checkpoint(tmp_path)
    monkeypatch.setattr(cli, "load_params", lambda *a, **k: pytest.fail(
        "weights were made"))
    for entry, match in (
            ({"checkpoint": str(tmp_path / "nope")}, "does not exist"),
            ({"checkpoint": d, "model_overrides": {"num_layers": 4}},
             "num_layers 4 != 2")):
        prof = tmp_path / "p.json"
        prof.write_text(json.dumps({"models": [{"name": "m", **entry}]}))
        with pytest.raises(NotImplementedError, match=match):
            cli.main(["serve-node", "--profile", str(prof), "--device",
                      "cpu", "--port", "0"])
        with pytest.raises((OSError, ValueError), match=match):
            cli.build_served_model("m", device="cpu",
                                   checkpoint=entry["checkpoint"],
                                   model_overrides=entry.get(
                                       "model_overrides"))
    assert cli.checkpoint_config(d, "m", {"num_layers": 2}).num_layers == 2
