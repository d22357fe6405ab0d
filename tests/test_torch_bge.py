"""The port's embedding encoder (``helix_tpu_torch/models/bge.py``) and
``/v1/embeddings`` against the JAX package's, on the CPU.

- ``forward`` on ``EncoderConfig.tiny`` in float32, with ``cls`` and
  ``mean`` pooling, with padded rows and ids past the vocab, on params
  from ``params_from_jax``: max abs <= 1e-5 against the reference's
  ``forward``.
- ``load_hf_encoder`` on tiny checkpoints the test writes, with and
  without the ``bert.`` prefix: the same config and every tensor equal
  (exact) to the reference loader's.
- ``EmbeddingRunner.embed_tokens`` on ragged batches longer than
  ``max_batch`` and on rows past ``max_position_embeddings`` (the
  reference cuts them without a word): max abs <= 1e-5.
- ``/v1/embeddings`` of the port's server and of the reference's aiohttp
  server over the same weights: the JSON key for key (vectors within
  1e-5) and the error texts.
- What the port matches on purpose (ROADMAP C): no special tokens when
  encoding (``cls`` pooling reads the first word's state, logged once
  per load), and the node agent's flat 256 MiB estimate for an
  embedding entry, below bge-base's own float32 weights.
"""

import asyncio
import json
import logging
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.control import node_agent as jagent
from helix_tpu.control import profile as jprofile
from helix_tpu.models import bge as jbge
from helix_tpu.serving import registry as jregistry
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu.serving.tokenizer import HFTokenizer as JHFTokenizer
from helix_tpu_torch import cli
from helix_tpu_torch.control.profile import ProfileModel
from helix_tpu_torch.engine.residency import served_model_bytes, tree_bytes
from helix_tpu_torch.models import bge as tbge
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer
from helix_tpu_torch.testing.hf_checkpoint import write_encoder_checkpoint
from helix_tpu_torch.testing.tokenizer_fixtures import FIXTURES

TOL = 1e-5


def _pair(**over):
    """The reference's tiny config and params, the port's of the same."""
    jcfg = jbge.EncoderConfig.tiny(**over)
    jp = jbge.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tbge.EncoderConfig.tiny(**over), \
        tbge.params_from_jax(jax.device_get(jp))


def _rows(rng, B, S, pad_to=None, vocab=256):
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b, n in enumerate(pad_to or ()):
        mask[b, n:] = 0
        toks[b, n:] = 0
    return toks, mask


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_equals_reference(pooling, padded):
    jcfg, jp, tcfg, tp = _pair(pooling=pooling)
    rng = np.random.default_rng(1)
    # ids past the vocab (256) read its last row in both
    toks, mask = _rows(rng, 4, 16, [16, 9, 3, 1] if padded else None,
                       vocab=300)
    want = np.asarray(jbge.forward(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(mask)))
    got = tbge.forward(tp, tcfg, torch.from_numpy(toks),
                       torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (4, 32)
    assert np.abs(got - want).max() <= TOL
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_init_params_layout_and_generator():
    cfg = tbge.EncoderConfig.tiny()
    jtree = jbge.init_params(jbge.EncoderConfig.tiny(), jax.random.PRNGKey(0))
    a = tbge.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tbge.init_params(cfg, seed=5, device="cpu")
    c = tbge.init_params(cfg, seed=6, device="cpu")

    def flat(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{pre}/{k}")
        else:
            yield pre, t

    shapes = {k: tuple(v.shape) for k, v in flat(jax.device_get(jtree))}
    assert {k: tuple(v.shape) for k, v in flat(a)} == shapes
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(flat(a), flat(b)))
    assert not torch.equal(a["embed"]["word"], c["embed"]["word"])
    assert all(v.dtype == torch.float32 for _, v in flat(a))


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_load_hf_encoder_equals_reference(tmp_path, prefix):
    cfg = tbge.EncoderConfig.tiny()
    params = tbge.init_params(cfg, seed=3, device="cpu")
    write_encoder_checkpoint(str(tmp_path), cfg, params, prefix=prefix)
    jcfg, jp = jbge.load_hf_encoder(str(tmp_path))
    tcfg, tp = tbge.load_hf_encoder(str(tmp_path), device="cpu")
    assert jcfg == jbge.EncoderConfig(**{
        f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__})
    assert tcfg.name == tmp_path.name

    def walk(t, j, path=""):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j), path
            for k in t:
                walk(t[k], j[k], f"{path}/{k}")
        else:
            assert np.array_equal(t.numpy(), np.asarray(j)), path

    walk(tp, jax.device_get(jp))
    walk(tp, params)   # the written tree comes back as written


def _runners(max_batch, tok=None):
    jcfg, jp, tcfg, tp = _pair()
    tok = tok or ByteTokenizer()
    jtok = JByteTokenizer()
    return (jbge.EmbeddingRunner(jcfg, jp, jtok, max_batch=max_batch),
            tbge.EmbeddingRunner(tcfg, tp, tok, max_batch=max_batch))


@pytest.mark.parametrize("case", ["ragged", "past_positions"])
def test_embed_tokens_equals_reference(case):
    jr, tr = _runners(max_batch=3)
    rng = np.random.default_rng(7)
    if case == "ragged":
        # 8 rows in chunks of 3: pads of 4, 16 and 32
        lens = [1, 3, 2, 9, 16, 5, 31, 17]
    else:
        # rows past max_position_embeddings (64) are cut at 64
        lens = [70, 64, 200, 3]
    rows = [list(rng.integers(0, 256, n)) for n in lens]
    want = jr.embed_tokens(rows)
    got = tr.embed_tokens(rows)
    assert got.shape == want.shape == (len(rows), 32)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL
    if case == "past_positions":
        # the reference's silent truncation: a cut row embeds as its
        # first 64 ids
        cut = tr.embed_tokens([rows[0][:64], rows[2][:64]])
        assert np.abs(cut - got[[0, 2]]).max() <= TOL
    assert tr.embed_tokens([]).shape == (0, 32)


def test_chunk_goes_to_the_device_once(monkeypatch):
    _jr, tr = _runners(max_batch=2)
    moves = []
    real = torch.Tensor.to

    def spy(self, *a, **kw):
        if "device" in kw or (a and isinstance(a[0], (torch.device, str))):
            moves.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    tr.embed_tokens([[5, 6, 7], [8], [9, 10]])
    # two chunks: ids and mask stacked, one move each
    assert moves == [(2, 2, 4), (2, 1, 2)]


def test_no_special_tokens_and_logged_once(caplog):
    """The reference encodes with ``add_special_tokens=False``: a BERT
    tokenizer's ``[CLS]`` is never prepended, so ``cls`` pooling takes
    the first word's state.  The port does the same and says so once per
    load."""
    path = FIXTURES["bert"] + "/tokenizer.json"
    port, ref = load_tokenizer(FIXTURES["bert"]), JHFTokenizer(path)
    text = "Embeddings for RAG ingest, via the bge encoder."
    ids = port.encode(text)
    assert ids == ref.encode(text)
    cls = port._tok.token_to_id("[CLS]")
    assert cls is not None and cls not in ids
    pm = ProfileModel(name="enc", kind="embedding",
                      engine={"max_batch": 4})
    with caplog.at_level(logging.INFO, logger="helix_tpu_torch.models.bge"):
        runner = tbge.EmbeddingRunner.build(pm, port, device="cpu")
    notes = [r for r in caplog.records if "special tokens" in r.message]
    assert len(notes) == 1 and runner.max_batch == 4


def test_embedding_estimate_is_the_reference_flat_reservation():
    """The reference agent reserves a flat 256 MiB for an embedding entry
    (``node_agent.py:648``), below bge-base's own float32 weights
    (108.9 M parameters without the pooler, 435.6 MB); the port keeps
    the reference's figure and phase 4k prints the measured bytes beside
    it."""
    spec = {"name": "BAAI/bge-base-en-v1.5", "kind": "embedding",
            "engine": {"max_batch": 64}, "checkpoint": None}
    assert cli.spec_bytes(spec) == cli.EMBEDDING_ESTIMATE_BYTES == 1 << 28
    ja = jagent.NodeAgent("r", build_model=lambda pm: None)
    prof = jprofile.ServingProfile.from_dict({
        "name": "p", "residency": {"hbm_budget_bytes": 1 << 30},
        "models": [{"name": "e", "kind": "embedding"}]})
    ja.apply_profile(prof)
    assert ja.registry.inner._estimate("e") == 1 << 28
    cfg = tbge.EncoderConfig()
    E, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    n = ((cfg.vocab_size + cfg.max_position_embeddings
          + cfg.type_vocab_size + 2) * E
         + L * (4 * (E * E + E) + 2 * E * F + F + E + 4 * E))
    assert n == 108_891_648 and 4 * n > 1 << 28


def test_served_bytes_count_the_embedder():
    _jr, tr = _runners(max_batch=2)
    served = ServedModel(name="e", loop=None, tokenizer=ByteTokenizer(),
                         kind="embedding", embedder=tr)
    assert served_model_bytes(served, headroom=0.0) == tree_bytes(tr.params)


# ---------------------------------------------------------------------------
# /v1/embeddings against the reference's aiohttp server
# ---------------------------------------------------------------------------


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
    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    jr, tr = _runners(max_batch=3)
    treg, jreg = ModelRegistry(), jregistry.ModelRegistry()
    treg.register(ServedModel(name="enc", loop=None, tokenizer=tr.tokenizer,
                              kind="embedding", embedder=tr))
    jreg.register(jregistry.ServedModel(name="enc", loop=None,
                                        tokenizer=jr.tokenizer,
                                        kind="embedding", embedder=jr))
    httpd = OpenAIServer(treg).start()
    holder: dict = {}
    jport = _serve_app(JServer(jreg).build_app(), holder)
    yield (f"http://127.0.0.1:{httpd.server_address[1]}",
           f"http://127.0.0.1:{jport}")
    httpd.shutdown()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_doc(got, want):
    """Equal key for key; embedding vectors within ``TOL``."""
    assert list(got) == list(want)
    for k in want:
        if k == "data":
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                assert list(g) == list(w)
                assert {**g, "embedding": 0} == {**w, "embedding": 0}
                assert np.abs(np.array(g["embedding"])
                              - np.array(w["embedding"])).max() <= TOL
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("inputs", [
    "one text", ["a", "bb ccc", "", "ünïcödé ✓", "x" * 90, "y" * 20, "z"],
])
def test_embeddings_route_equals_reference(servers, inputs):
    url, jurl = servers
    body = {"model": "enc", "input": inputs}
    ts, tdoc = _post(url + "/v1/embeddings", body)
    js, jdoc = _post(jurl + "/v1/embeddings", body)
    assert ts == js == 200
    _same_doc(tdoc, jdoc)


@pytest.mark.parametrize("body", [
    {"model": "nope", "input": "x"},
    {"model": "enc", "input": {"text": "x"}},
    {"model": "enc", "input": ["ok", {"foo": 1}]},
    {"model": "enc", "input": [{"image": "data:,"}]},
], ids=["unknown", "dict", "dict_in_list", "image"])
def test_embeddings_errors_equal_reference(servers, body):
    url, jurl = servers
    ts, tdoc = _post(url + "/v1/embeddings", body)
    js, jdoc = _post(jurl + "/v1/embeddings", body)
    assert ts == js and ts in (400, 404)
    assert tdoc["error"]["message"] == jdoc["error"]["message"]
    assert tdoc["error"]["type"] == jdoc["error"]["type"]


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/completions",
                                  "/v1/messages"])
def test_generation_routes_refuse_an_embedding_model(servers, path):
    url, jurl = servers
    body = {"model": "enc", "prompt": "x", "max_tokens": 4,
            "messages": [{"role": "user", "content": "x"}]}
    ts, tdoc = _post(url + path, body)
    js, jdoc = _post(jurl + path, body)
    assert ts == js == 404
    assert tdoc["error"]["message"] == jdoc["error"]["message"]
    assert tdoc["error"]["type"] == jdoc["error"]["type"]
    assert ("trace_id" in tdoc["error"]) == ("trace_id" in jdoc["error"])
