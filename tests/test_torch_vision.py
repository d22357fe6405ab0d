"""The port's image preprocessing and vision runner against the JAX
package's ``helix_tpu/serving/vision.py`` (which decodes and resizes
through PIL), on the CPU.

- ``decode_png`` byte-equal to ``np.asarray(Image.open(...).convert(
  "RGB"))`` for every colour type and bit depth it takes, every scanline
  filter, a grid of sizes; images PIL itself writes too;
- ``resize_bicubic`` byte-equal to ``Image.resize(..., Image.BICUBIC)``
  on upscales, downscales, odd sizes and the ``max_pixels`` clamp;
  ``patchify``, ``decode_image``, ``smart_resize``, ``build_vl_prompt``
  and ``VisionRunner.prepare`` equal to the reference's (the tower's
  embeddings within 1e-5 in float32);
- the A17c refusal: JPEG, GIF, WebP, BMP, an interlaced and a 16-bit PNG,
  and over HTTP the reference's ``400 image processing failed: ...``.
Tests that need PIL skip without it.
"""

import base64
import io
import json
import struct
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest

from helix_tpu.models import qwen2_vl as jvl
from helix_tpu.serving import vision as jvision
from helix_tpu_torch.models import qwen2_vl as tvl
from helix_tpu_torch.serving import vision as tvision
from helix_tpu_torch.serving.tokenizer import ByteTokenizer
from helix_tpu_torch.testing.png import encode_png, random_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
          (3, 8), (4, 8), (6, 8)]
SIZES = [(1, 1), (7, 13), (33, 5), (3, 100), (64, 64)]
FILTERS = [(0, 1, 2, 3, 4), (4,), (3, 1), (2, 0)]


def _pil():
    return pytest.importorskip("PIL.Image")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(_pil().open(io.BytesIO(data)).convert("RGB"))


def _sample(rng, h, w, ct, depth):
    px = rng.integers(0, 1 << depth, size=(h, w, CHANNELS[ct]))
    pal = rng.integers(0, 256, size=(1 << depth, 3)) if ct == 3 else None
    return px, pal


@pytest.mark.parametrize("ct,depth", DEPTHS,
                         ids=[f"type{c}_{d}bit" for c, d in DEPTHS])
def test_decode_png_byte_equal_to_pil(ct, depth):
    rng = np.random.default_rng(ct * 16 + depth)
    for h, w in SIZES:
        for filters in FILTERS:
            px, pal = _sample(rng, h, w, ct, depth)
            data = encode_png(px, ct, depth, pal, filters)
            got = tvision.decode_png(data)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_decode_png_of_pils_own_files(mode):
    Image = _pil()
    rng = np.random.default_rng(len(mode))
    img = Image.fromarray(rng.integers(0, 256, size=(37, 53, 3)).astype(
        np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    np.testing.assert_array_equal(tvision.decode_png(buf.getvalue()),
                                  _pil_rgb(buf.getvalue()))


def test_decode_image_forms_equal_reference():
    _pil()
    data = random_png(np.random.default_rng(0), 20, 30)
    b64 = base64.b64encode(data).decode()
    for src in (data, b64, "data:image/png;base64," + b64):
        np.testing.assert_array_equal(tvision.decode_image(src),
                                      jvision.decode_image(src))


RESIZE_IN = [(1, 1), (5, 7), (37, 91), (224, 224), (300, 20), (480, 640)]


@pytest.mark.parametrize("h,w", RESIZE_IN)
def test_resize_bicubic_byte_equal_to_pil(h, w):
    Image = _pil()
    img = np.random.default_rng(h * w).integers(
        0, 256, size=(h, w, 3)).astype(np.uint8)
    outs = [(h, w), (28, 28), (56, 84), (max(1, h // 3), w * 2),
            (h * 2 + 1, max(1, w // 5)), (476, 644), (13, 1)]
    for oh, ow in outs:
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BICUBIC))
        np.testing.assert_array_equal(tvision.resize_bicubic(img, ow, oh),
                                      want, err_msg=f"{(h, w)}->{(oh, ow)}")


@pytest.mark.parametrize("h,w,max_pixels", [
    (224, 224, tvision.MAX_PIXELS), (480, 640, tvision.MAX_PIXELS),
    (960, 1280, tvision.MAX_PIXELS), (50, 70, tvision.MAX_PIXELS),
    (300, 500, 56 * 56 * 4), (11, 900, tvision.MAX_PIXELS)])
def test_patchify_equal_to_reference(h, w, max_pixels):
    _pil()
    img = np.random.default_rng(h + w).integers(
        0, 256, size=(h, w, 3)).astype(np.uint8)
    want, wgrid = jvision.patchify(img, max_pixels=max_pixels)
    got, grid = tvision.patchify(img, max_pixels=max_pixels)
    assert grid == wgrid
    np.testing.assert_array_equal(got, want)


def test_smart_resize_equal_to_reference():
    rng = np.random.default_rng(7)
    cases = [(28 * k + 14, 28 * j + 14) for k in range(1, 6)
             for j in range(1, 6)]
    cases += [tuple(int(x) for x in rng.integers(1, 3000, size=2))
              for _ in range(300)]
    cases += [(960, 1280), (1, 150), (3000, 3000)]
    for h, w in cases:
        for kw in ({}, {"max_pixels": 56 * 56 * 4}, {"min_pixels": 448 * 448}):
            try:
                want = jvision.smart_resize(h, w, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tvision.smart_resize(h, w, **kw)
                continue
            assert tvision.smart_resize(h, w, **kw) == want, (h, w, kw)
    assert tvision.smart_resize(960, 1280) == (840, 1148)


def _messages(pngs):
    url = [{"type": "image_url", "image_url": {
        "url": "data:image/png;base64," + base64.b64encode(p).decode()}}
        for p in pngs]
    return [{"role": "system", "content": "be brief"},
            {"role": "user", "content": [{"type": "text", "text": "look"},
                                         url[0], {"type": "text",
                                                  "text": "and"},
                                         {"type": "image", "image":
                                          base64.b64encode(pngs[1]).decode()}]}]


def test_build_vl_prompt_equal_to_reference():
    _pil()
    rng = np.random.default_rng(9)
    pngs = [random_png(rng, 60, 90), random_png(rng, 33, 50)]
    kw = dict(image_pad_id=264, vision_start_id=265, vision_end_id=266,
              patch_size=4, max_pixels=10_000)
    want = jvision.build_vl_prompt(_messages(pngs), ByteTokenizer(), **kw)
    got = tvision.build_vl_prompt(_messages(pngs), ByteTokenizer(), **kw)
    assert got.input_ids == want.input_ids
    assert got.image_positions == want.image_positions
    np.testing.assert_array_equal(got.grid_thw, want.grid_thw)
    for a, b in zip(got.image_patches, want.image_patches):
        np.testing.assert_array_equal(a, b)


def test_vision_runner_prepare_equal_to_reference():
    _pil()
    vcfg = jvl.VisionConfig.tiny(hidden_size=64)
    vp = jvl.init_vision_params(vcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(10)
    msgs = _messages([random_png(rng, 60, 90), random_png(rng, 40, 40)])
    kw = dict(image_pad_id=264, vision_start_id=265, vision_end_id=266,
              max_pixels=10_000)
    want = jvision.VisionRunner(vcfg, vp, **kw).prepare(msgs,
                                                       ByteTokenizer())
    runner = tvision.VisionRunner(
        tvl.VisionConfig.tiny(hidden_size=64),
        tvl.vision_params_from_jax(jax.device_get(vp)), **kw)
    got = runner.prepare(msgs, ByteTokenizer())
    for k in ("prompt_tokens", "image_positions", "mrope_delta"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["positions3"], want["positions3"])
    np.testing.assert_allclose(got["image_embeds"].numpy(),
                               np.asarray(want["image_embeds"]), atol=1e-5,
                               rtol=0)
    # text only: no embeddings, positions as the reference's
    text = [{"role": "user", "content": "hello"}]
    got = runner.prepare(text, ByteTokenizer())
    want = jvision.VisionRunner(vcfg, vp, **kw).prepare(text,
                                                       ByteTokenizer())
    assert got["image_embeds"] is None and want["image_embeds"] is None
    np.testing.assert_array_equal(got["positions3"], want["positions3"])


def _rewrite_ihdr(data: bytes, depth=None, interlace=None) -> bytes:
    w, h, d, ct, comp, filt, il = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", w, h, depth or d, ct, comp, filt,
                       il if interlace is None else interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


@pytest.mark.parametrize("raw,name", [
    (b"\xff\xd8\xff\xe0\x00\x10JFIF\x00", "JPEG"),
    (b"GIF89a\x01\x00\x01\x00", "GIF"),
    (b"RIFF\x10\x00\x00\x00WEBPVP8 ", "WebP"),
    (b"BM\x00\x00\x00\x00", "BMP"),
    ("interlaced", "interlaced"),
    ("16-bit", "16-bit"),
])
def test_a17c_formats_refused(raw, name):
    png = encode_png(np.zeros((2, 2, 3), np.uint8))
    if raw == "interlaced":
        raw = _rewrite_ihdr(png, interlace=1)
    elif raw == "16-bit":
        raw = _rewrite_ihdr(png, depth=16)
    with pytest.raises(ValueError, match=f"{name}.*ROADMAP A17c"):
        tvision.decode_image(raw)
    with pytest.raises(ValueError, match="A17c"):
        tvision.decode_image(base64.b64encode(raw).decode())


def test_corrupt_png_raises():
    png = encode_png(np.zeros((4, 4, 3), np.uint8))
    idat = png.index(b"IDAT")
    with pytest.raises((ValueError, zlib.error)):
        tvision.decode_png(png[:idat + 10])


def _post(base, body):
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_image_errors_as_reference():
    """Over HTTP: a JPEG answers 400 ``image processing failed: JPEG ...
    A17c``; bytes no decoder takes answer the reference's status and
    prefix; a text model given an image answers the reference's 400."""
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry

    eng = dict(max_decode_batch=2, num_pages=64, max_prefill_len=256)
    vis = build_served_model("tiny-vl", device="cpu", kind="vision",
                             engine=eng, warmup=False)
    txt = build_served_model("tiny-chat", device="cpu", engine=eng,
                             warmup=False)
    reg = ModelRegistry()
    reg.register(vis)
    reg.register(txt)
    httpd = OpenAIServer(reg).start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def body(model, url):
        return {"model": model, "max_tokens": 2, "messages": [{
            "role": "user", "content": [{"type": "image_url",
                                         "image_url": {"url": url}}]}]}

    try:
        jpeg = "data:image/jpeg;base64," + base64.b64encode(
            b"\xff\xd8\xff\xe0\x00\x10JFIF").decode()
        st, err = _post(base, body("tiny-vl", jpeg))
        msg = err["error"]["message"]
        assert st == 400 and msg.startswith("image processing failed: JPEG")
        assert "ROADMAP A17c" in msg
        st, err = _post(base, body("tiny-vl", base64.b64encode(
            b"not an image").decode()))
        assert st == 400 and err["error"]["message"].startswith(
            "image processing failed: ")
        png = "data:image/png;base64," + base64.b64encode(
            random_png(np.random.default_rng(1), 30, 30)).decode()
        st, err = _post(base, body("tiny-chat", png))
        assert (st, err["error"]["message"]) == (
            400, "model 'tiny-chat' does not accept image input")
        st, out = _post(base, body("tiny-vl", png))
        assert st == 200 and out["usage"]["completion_tokens"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        vis.loop.stop()
        txt.loop.stop()


def test_reference_gives_the_same_statuses_and_prefixes():
    """The reference's aiohttp server on the same two failures (its own
    tiny VL model): a text model's image 400 with the same text, and
    bytes PIL cannot open 400 with the same ``image processing failed``
    prefix."""
    pytest.importorskip("aiohttp")
    _pil()
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from helix_tpu.serving.openai_api import OpenAIServer as JServer
    from helix_tpu.serving.registry import ModelRegistry as JRegistry
    from helix_tpu.serving.registry import ServedModel as JServed

    class _Loop:
        def submit(self, *a, **k):
            raise AssertionError("nothing reaches the engine")

    class _Tok:
        eos_ids = ()
        vocab_size = 260

        def apply_chat_template(self, *a, **k):
            return [1, 2]

        def encode(self, t):
            return [1]

    class _Vision:
        def prepare(self, messages, tok):
            raise ValueError("cannot identify image file")

    reg = JRegistry()
    reg.register(JServed(name="vl", loop=_Loop(), tokenizer=_Tok(),
                         kind="vision", vision=_Vision()))
    reg.register(JServed(name="txt", loop=_Loop(), tokenizer=_Tok()))
    app = JServer(reg).build_app()

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for model in ("vl", "txt"):
                r = await client.post("/v1/chat/completions", json={
                    "model": model, "messages": [{"role": "user", "content": [
                        {"type": "image_url", "image_url": {"url": "x"}}]}]})
                out.append((r.status, (await r.json())["error"]["message"]))
            return out
        finally:
            await client.close()

    (st1, m1), (st2, m2) = asyncio.run(run())
    assert st1 == 400 and m1.startswith("image processing failed: ")
    assert (st2, m2) == (400, "model 'txt' does not accept image input")
