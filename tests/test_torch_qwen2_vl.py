"""The port's Qwen2-VL model code against the JAX package's, on the CPU.

Same inputs (seeded numpy) through ``helix_tpu.models.qwen2_vl`` and
``helix_tpu_torch.models.qwen2_vl``: the merge-block rotary ids and the
M-RoPE position streams exact; ``apply_mrope``, the vision tower (one and
two images, float32) and the M-RoPE text tower's logits within 1e-5;
``load_qwen2_vl`` byte-equal to the reference's on checkpoints the port's
writer makes in both HF namings and, where ``transformers`` imports, on
one ``Qwen2VLForConditionalGeneration.save_pretrained`` writes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.models import qwen2_vl as jvl
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.models.llama import prefill_attn_fn as jprefill_attn
from helix_tpu.ops.rope import rope_frequencies as jrope_frequencies
from helix_tpu_torch.models import qwen2_vl as tvl
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.testing.hf_checkpoint import write_qwen2_vl_checkpoint

IMG = 126
ATOL = 1e-5
TEXT = dict(dtype="float32", attention_bias=True, mrope_sections=(2, 3, 3),
            vocab_size=128)


@pytest.fixture(scope="module")
def towers():
    jcfg = JModelConfig.tiny(**TEXT)
    jp = jinit(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    vcfg = jvl.VisionConfig.tiny(hidden_size=jcfg.hidden_size)
    vp = jvl.init_vision_params(vcfg, jax.random.PRNGKey(6))
    return (jcfg, jp, vcfg, vp, ModelConfig.tiny(**TEXT),
            params_from_jax(jax.device_get(jp)),
            tvl.VisionConfig.tiny(hidden_size=jcfg.hidden_size),
            tvl.vision_params_from_jax(jax.device_get(vp)))


@pytest.mark.parametrize("grid", [[[1, 2, 2]], [[1, 4, 6]], [[1, 4, 4],
                                                            [2, 2, 4]]])
def test_vision_rotary_pos_exact(grid):
    np.testing.assert_array_equal(tvl.vision_rotary_pos(np.array(grid), 2),
                                  jvl.vision_rotary_pos(np.array(grid), 2))


@pytest.mark.parametrize("ids,grid,start", [
    ([1, 2] + [IMG] * 4 + [3], [[1, 4, 4]], (0, 0, 0)),
    ([5, 6, 7, 8], None, (0, 0, 0)),
    ([9] + [IMG] * 4 + [1, 2] + [IMG] * 6 + [4], [[1, 4, 4], [1, 4, 6]],
     (0, 0, 0)),
    ([IMG] * 12 + [3], [[1, 6, 8]], (7, 7, 7)),
])
def test_mrope_positions_exact(ids, grid, start):
    g = None if grid is None else np.array(grid)
    want = jvl.mrope_positions(ids, g, IMG, start=start)
    got = tvl.mrope_positions(ids, g, IMG, start=start)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_within_1e5(sections, D):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    pos3 = rng.integers(0, 4000, size=(3, 2, 9))
    inv = jrope_frequencies(D, 1e6)
    want = jvl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                           jnp.asarray(inv), sections)
    got = tvl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                          torch.from_numpy(inv), sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_apply_mrope_equal_streams_is_plain_rope():
    """Past the prompt the three streams are equal: M-RoPE is then the
    plain rotation of that position (the decode rows' identity)."""
    from helix_tpu_torch.ops.rope import apply_rope, rope_frequencies

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, size=(1, 5)))
    inv = torch.from_numpy(rope_frequencies(16, 1e4))
    got = tvl.apply_mrope(x, pos[None].expand(3, 1, 5), inv, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), apply_rope(x, pos, inv).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid", [[[1, 4, 4]], [[1, 4, 4], [1, 2, 6]]],
                         ids=["one_image", "two_images"])
def test_vision_forward_within_1e5(towers, grid):
    _jc, _jp, jvc, jvp, _c, _p, vc, vp = towers
    grid = np.array(grid)
    n = int(sum(np.prod(g) for g in grid))
    patches = np.random.default_rng(3).standard_normal(
        (n, jvc.patch_dim)).astype(np.float32)
    want = np.asarray(jvl.vision_forward(jvp, jvc, jnp.asarray(patches),
                                         grid))
    got = tvl.vision_forward(vp, vc, torch.from_numpy(patches), grid)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if len(grid) == 2:
        # the segment mask isolates the images: each alone gives its rows
        n0 = int(np.prod(grid[0]))
        alone = tvl.vision_forward(vp, vc, torch.from_numpy(patches[:n0]),
                                   grid[:1])
        np.testing.assert_allclose(alone.numpy(), got.numpy()[:n0 // 4],
                                   atol=ATOL, rtol=0)


def test_vision_forward_bf16_weights_promote_as_reference(towers):
    """bf16 weights with float32 patches: the tower runs in float32 on
    the promoted weights, as the reference's mixed dot_general."""
    _jc, _jp, jvc, jvp, _c, _p, vc, _vp = towers
    jvp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jvp)
    vp16 = tvl.vision_params_from_jax(jax.device_get(jvp16))
    grid = np.array([[1, 4, 4]])
    patches = np.random.default_rng(4).standard_normal(
        (16, jvc.patch_dim)).astype(np.float32)
    want = np.asarray(jvl.vision_forward(jvp16, jvc, jnp.asarray(patches),
                                         grid))
    got = tvl.vision_forward(vp16, vc, torch.from_numpy(patches), grid)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_text_forward_mrope_logits_within_1e5(towers):
    jcfg, jp, jvc, jvp, cfg, tp, _vc, _vp = towers
    grid = np.array([[1, 4, 4]])
    ids = [1, 2] + [IMG] * 4 + [3, 4]
    pos3, _ = jvl.mrope_positions(ids, grid, IMG)
    emb = np.random.default_rng(5).standard_normal(
        (1, len(ids), jcfg.hidden_size)).astype(np.float32)
    want, (jk, _jv) = jvl.text_forward_mrope(
        jp, jcfg, jnp.asarray([ids]), jnp.asarray(pos3)[:, None],
        attn_fn=lambda q, k, v, c, p: jprefill_attn(q, k, v, c, p,
                                                    backend="reference"),
        input_embeds=jnp.asarray(emb), mrope_sections=jcfg.mrope_sections)
    got, (tk, _tv) = tvl.text_forward_mrope(
        tp, cfg, torch.tensor([ids]), torch.from_numpy(pos3)[:, None],
        attn_fn=lambda q, k, v, c, p: tllama.prefill_attn_fn(
            q, k, v, c, p, backend="reference"),
        input_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)


def test_forward_refuses_an_mrope_config_without_streams(towers):
    *_, cfg, tp, _vc, _vp = towers
    tok = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="positions3"):
        tllama.forward(tp, cfg, tok, torch.arange(3)[None],
                       attn_fn=tllama.prefill_attn_fn)
    plain = dataclasses.replace(cfg, mrope_sections=None)
    with pytest.raises(ValueError, match="positions3"):
        tllama.forward(tp, plain, tok, torch.arange(3)[None],
                       attn_fn=tllama.prefill_attn_fn,
                       positions3=torch.zeros((3, 1, 3), dtype=torch.long))


def test_init_vision_params_layout_matches_reference(towers):
    _jc, _jp, jvc, jvp, _c, _p, vc, _vp = towers
    mine = tvl.init_vision_params(vc, 3, device="cpu")
    ref = jax.device_get(jvp)

    def walk(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k])
        else:
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32

    walk(mine, ref)
    gen = torch.Generator().manual_seed(3)
    again = tvl.init_vision_params(vc, device="cpu", generator=gen)
    assert torch.equal(again["blocks"]["qkv"]["weight"],
                       mine["blocks"]["qkv"]["weight"])


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
        return
    a = a if isinstance(a, torch.Tensor) else tllama._to_tensor(a)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert torch.equal(a, b), path


@pytest.mark.parametrize("naming", ["new", "old"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_qwen2_vl_byte_equal_to_reference(tmp_path, towers, naming,
                                               dtype):
    *_, cfg, _tp, vc, _vp = towers
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = tllama.init_params(cfg, 11, device="cpu")
    vparams = tvl.init_vision_params(vc, 12, device="cpu", dtype=dtype)
    write_qwen2_vl_checkpoint(str(tmp_path), cfg, params, vc, vparams,
                              naming=naming, max_shard_bytes=200_000)
    tcfg, vcfg, got = tvl.load_qwen2_vl(str(tmp_path), device="cpu")
    jcfg, jvcfg, want = jvl.load_qwen2_vl(str(tmp_path))
    want = jax.device_get(want)
    assert dataclasses.asdict(tcfg) == {
        **dataclasses.asdict(jcfg), "name": tcfg.name}
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    _equal_trees(want, got)
    _equal_trees(vparams, got["visual"])
    _equal_trees(params, {k: v for k, v in got.items() if k != "visual"})


def test_load_config_and_int8_text_tower(tmp_path, towers):
    """``load_config`` of a Qwen2-VL directory is its text tower; the
    int8 load quantizes the text tower only, as ``quantize_params``."""
    from helix_tpu_torch.models.loader import load_config
    from helix_tpu_torch.ops.quant import quantize_params

    *_, cfg, tp, vc, vp = towers
    write_qwen2_vl_checkpoint(str(tmp_path), cfg, tp, vc, vp)
    lc = load_config(str(tmp_path), name="vl")
    assert lc.mrope_sections == (2, 3, 3) and lc.attention_bias
    _c, _v, got = tvl.load_qwen2_vl(str(tmp_path), device="cpu",
                                    quantization="int8")
    vis = got.pop("visual")
    _equal_trees(vp, vis)
    _equal_trees(quantize_params(tp), got)


def test_load_qwen2_vl_transformers_export(tmp_path):
    """A checkpoint ``Qwen2VLForConditionalGeneration.save_pretrained``
    writes (the reference's ``hf_tiny``): both loaders, byte-equal."""
    transformers = pytest.importorskip("transformers")
    vc = dict(depth=2, embed_dim=32, hidden_size=64, num_heads=2,
              mlp_ratio=2, in_channels=3, patch_size=4, spatial_merge_size=2,
              temporal_patch_size=2)
    c = transformers.Qwen2VLConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0, vision_config=vc,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        image_token_id=IMG, video_token_id=127, vision_start_token_id=125,
        vision_end_token_id=124, tie_word_embeddings=False,
        torch_dtype="float32")
    torch.manual_seed(0)
    m = transformers.Qwen2VLForConditionalGeneration(c)
    m.save_pretrained(str(tmp_path), safe_serialization=True)
    _tcfg, _vcfg, got = tvl.load_qwen2_vl(str(tmp_path), device="cpu")
    _jcfg, _jvcfg, want = jvl.load_qwen2_vl(str(tmp_path))
    _equal_trees(jax.device_get(want), got)
