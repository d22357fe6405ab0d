"""The port's vision embedding worker against the JAX package's, on the CPU.

The same tiny text tower (float32, and int8 through the reference's
``quantize_params``) and vision tower (JAX-initialised, copied) behind
``helix_tpu.models.vision_embed.VisionEmbeddingRunner`` and the port's:
text, image and mixed vectors within 1e-5, the mixed list's order kept,
unit vectors; then ``/v1/embeddings`` over HTTP on the port's server
beside the reference's aiohttp server, status codes and texts equal; the
``kind: vision-embedding`` build through ``cli`` (random init and a
Qwen2-VL checkpoint) and its residency accounting.
"""

import asyncio
import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.models import qwen2_vl as jvl
from helix_tpu.models import vision_embed as jve
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.ops.quant import quantize_params as jquantize
from helix_tpu.serving import registry as jregistry
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu_torch import cli
from helix_tpu_torch.engine.residency import served_model_bytes, tree_bytes
from helix_tpu_torch.models import qwen2_vl as tvl
from helix_tpu_torch.models import vision_embed as tve
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
from helix_tpu_torch.serving.tokenizer import ByteTokenizer
from helix_tpu_torch.testing.png import random_png

TOL = 1e-5


def _runners(int8=False):
    jcfg = JModelConfig.tiny(name="ve", vocab_size=512, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if int8:
        jp = jquantize(jp)
    vcfg = jvl.VisionConfig.tiny(hidden_size=jcfg.hidden_size)
    vp = jvl.init_vision_params(vcfg, jax.random.PRNGKey(1))
    jr = jve.VisionEmbeddingRunner(jcfg, vcfg, jp, vp, JByteTokenizer())
    tr = tve.VisionEmbeddingRunner(
        ModelConfig.tiny(name="ve", vocab_size=512, dtype="float32"),
        tvl.VisionConfig.tiny(hidden_size=jcfg.hidden_size),
        params_from_jax(jax.device_get(jp)),
        tvl.vision_params_from_jax(jax.device_get(vp)), ByteTokenizer())
    return jr, tr


def _png_url(seed, h, w):
    png = random_png(np.random.default_rng(seed), h, w)
    return "data:image/png;base64," + base64.b64encode(png).decode()


TEXTS = ["a", "hello there", "", "ünïcödé ✓", "x" * 90]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_embed_texts_equal_reference(int8):
    jr, tr = _runners(int8)
    want, got = jr.embed_texts(TEXTS), tr.embed_texts(TEXTS)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert tr.embed_texts([]).shape == (0, 64)


def test_embed_images_equal_reference():
    pytest.importorskip("PIL")
    jr, tr = _runners()
    srcs = [_png_url(1, 60, 90), _png_url(2, 28, 28), _png_url(3, 100, 40)]
    want, got = jr.embed_images(srcs), tr.embed_images(srcs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_embed_mixed_keeps_order():
    pytest.importorskip("PIL")
    jr, tr = _runners()
    imgs = [{"image": _png_url(i, 30 + 7 * i, 50)} for i in range(3)]
    inputs = ["first", imgs[0], imgs[1], "fourth", imgs[2], "last"]
    want, got = jr.embed_mixed(inputs), tr.embed_mixed(inputs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    texts = tr.embed_texts(["first", "fourth", "last"])
    images = tr.embed_images([x["image"] for x in imgs])
    np.testing.assert_array_equal(got[[0, 3, 5]], texts)
    np.testing.assert_array_equal(got[[1, 2, 4]], images)


def _serve_app(app, holder):
    started = threading.Event()
    box = {}

    def run():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        from aiohttp import web

        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = site._server.sockets[0].getsockname()[1]
        holder.setdefault("loops", []).append(loop)
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return box["port"]


@pytest.fixture(scope="module")
def servers():
    """The port's server and the reference's, each with a vision
    embedder ``ve``, a text encoder ``enc`` and a chat model ``chat``
    (the reference's a stand-in loop: no request reaches it)."""
    pytest.importorskip("aiohttp")
    from helix_tpu.models import bge as jbge
    from helix_tpu.serving.openai_api import OpenAIServer as JServer
    from helix_tpu_torch.models import bge as tbge

    jr, tr = _runners()
    jenc_cfg = jbge.EncoderConfig.tiny()
    jenc = jbge.EmbeddingRunner(
        jenc_cfg, jbge.init_params(jenc_cfg, jax.random.PRNGKey(3)),
        JByteTokenizer())
    tenc = tbge.EmbeddingRunner(
        tbge.EncoderConfig.tiny(),
        params_from_jax(jax.device_get(jenc.params)), ByteTokenizer())
    chat = cli.build_served_model("chat", device="cpu", warmup=False,
                                  engine=dict(max_decode_batch=2,
                                              num_pages=32,
                                              max_prefill_len=64))
    treg = ModelRegistry()
    treg.register(ServedModel(name="ve", loop=None, tokenizer=tr.tokenizer,
                              kind="vision-embedding", embedder=tr))
    treg.register(ServedModel(name="enc", loop=None,
                              tokenizer=tenc.tokenizer, kind="embedding",
                              embedder=tenc))
    treg.register(chat)

    class _Loop:
        def submit(self, *a, **k):
            raise AssertionError("nothing reaches the engine")

    jreg = jregistry.ModelRegistry()
    jreg.register(jregistry.ServedModel(
        name="ve", loop=None, tokenizer=jr.tokenizer,
        kind="vision-embedding", embedder=jr))
    jreg.register(jregistry.ServedModel(
        name="enc", loop=None, tokenizer=jenc.tokenizer, kind="embedding",
        embedder=jenc))
    jreg.register(jregistry.ServedModel(name="chat", loop=_Loop(),
                                        tokenizer=JByteTokenizer()))
    httpd = OpenAIServer(treg).start("127.0.0.1", 0)
    holder: dict = {}
    jport = _serve_app(JServer(jreg).build_app(), holder)
    yield (f"http://127.0.0.1:{httpd.server_address[1]}",
           f"http://127.0.0.1:{jport}")
    httpd.shutdown()
    httpd.server_close()
    chat.loop.stop()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("inputs", [
    "one text", ["a", "bb ccc", ""],
    ["a", {"image": "IMG0"}, "b", {"image": "IMG1"}],
    {"image": "IMG1"},
], ids=["string", "texts", "mixed", "one_image"])
def test_vision_embeddings_route_equals_reference(servers, inputs):
    pytest.importorskip("PIL")
    url, jurl = servers
    imgs = {"IMG0": _png_url(5, 40, 60), "IMG1": _png_url(6, 90, 30)}

    def fill(x):
        if isinstance(x, dict):
            return {"image": imgs[x["image"]]}
        return [fill(y) for y in x] if isinstance(x, list) else x

    body = {"model": "ve", "input": fill(inputs)}
    ts, tdoc = _post(url + "/v1/embeddings", body)
    js, jdoc = _post(jurl + "/v1/embeddings", body)
    assert ts == js == 200
    assert list(tdoc) == list(jdoc)
    assert tdoc["usage"] == jdoc["usage"] and tdoc["model"] == jdoc["model"]
    assert [d["index"] for d in tdoc["data"]] == [d["index"] for d in
                                                  jdoc["data"]]
    got = np.array([d["embedding"] for d in tdoc["data"]])
    want = np.array([d["embedding"] for d in jdoc["data"]])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"model": "ve", "input": ["ok", {"foo": 1}]}),
    ("/v1/embeddings", {"model": "enc", "input": [{"image": "data:,"}]}),
    ("/v1/embeddings", {"model": "chat", "input": "x"}),
    ("/v1/embeddings", {"model": "nope", "input": "x"}),
    ("/v1/chat/completions", {"model": "ve", "messages": [
        {"role": "user", "content": "hi"}]}),
], ids=["dict_without_image", "text_encoder_image", "chat_model", "unknown",
        "chat_to_embedder"])
def test_errors_equal_reference(servers, path, body):
    url, jurl = servers
    ts, tdoc = _post(url + path, body)
    js, jdoc = _post(jurl + path, body)
    assert ts == js and ts in (400, 404)
    assert tdoc["error"]["message"] == jdoc["error"]["message"]
    assert tdoc["error"]["type"] == jdoc["error"]["type"]


def test_build_through_cli_and_residency(tmp_path):
    """``kind: vision-embedding`` through ``cli``: random init (the tiny
    towers) and a Qwen2-VL checkpoint (both towers, never quantized);
    the served bytes count both towers, the reference's estimate the
    text tower's config only."""
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.testing.hf_checkpoint import (
        write_qwen2_vl_checkpoint,
    )

    m = cli.build_served_model("ve", device="cpu", kind="vision-embedding")
    assert m.kind == "vision-embedding" and m.loop is None
    assert served_model_bytes(m) == int(
        (tree_bytes(m.embedder.params) + tree_bytes(m.embedder.vparams))
        * 1.1)
    cfg = ModelConfig.tiny(dtype="float32", attention_bias=True,
                           mrope_sections=(2, 3, 3), vocab_size=512)
    vcfg = tvl.VisionConfig.tiny(hidden_size=64)
    write_qwen2_vl_checkpoint(str(tmp_path), cfg,
                              init_params(cfg, 1, device="cpu"), vcfg,
                              tvl.init_vision_params(vcfg, 2, device="cpu"))
    spec = {"name": "ve", "kind": "vision-embedding",
            "checkpoint": str(tmp_path), "engine": {}}
    m2 = cli.build_served_model(device="cpu", **{k: v for k, v in
                                                 spec.items()
                                                 if k != "engine"})
    out = m2.embedder.embed_mixed(["a", {"image": _png_url(1, 30, 30)}]) \
        if _has_pil() else m2.embedder.embed_texts(["a"])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)
    assert cli.spec_bytes(spec) == cli.spec_bytes(
        {**spec, "kind": "vision"})


def _has_pil():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("kind", ["vision", "vision-embedding"])
@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_vision_estimate_is_the_reference_text_tower_figure(tmp_path, kind,
                                                            with_checkpoint):
    """The residency estimate of a vision entry is the reference node
    agent's (``node_agent.py:646-656``): ``estimate_model_bytes`` of its
    plain ``load_config`` (the text tower; bf16, no bias), else of the
    catalog or tiny config, with the entry's engine block.  It leaves the
    vision tower out (ROADMAP C)."""
    from helix_tpu.engine.residency import estimate_model_bytes as jestimate
    from helix_tpu.models.common import CATALOG as JCATALOG
    from helix_tpu.models.loader import load_config as jload_config
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.testing.hf_checkpoint import (
        write_qwen2_vl_checkpoint,
    )

    engine = {"max_decode_batch": 8, "num_pages": 64, "page_size": 16,
              "max_prefill_len": 256}
    spec = {"name": "Qwen/Qwen2-VL-7B-Instruct", "kind": kind,
            "engine": engine, "checkpoint": None}
    if with_checkpoint:
        cfg = ModelConfig.tiny(dtype="float32", attention_bias=True,
                               mrope_sections=(2, 3, 3), vocab_size=512)
        vcfg = tvl.VisionConfig.tiny(hidden_size=64)
        write_qwen2_vl_checkpoint(
            str(tmp_path), cfg, init_params(cfg, 1, device="cpu"), vcfg,
            tvl.init_vision_params(vcfg, 2, device="cpu"))
        spec["checkpoint"] = str(tmp_path)
        jcfg = jload_config(str(tmp_path), name=spec["name"])
    else:
        jcfg = JCATALOG.get(spec["name"]) or JModelConfig.tiny(
            name=spec["name"])
    assert cli.spec_bytes(spec) == jestimate(jcfg, engine, None)
