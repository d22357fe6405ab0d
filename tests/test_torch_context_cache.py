"""The context-caching API (ROADMAP A14): the port against the reference.

- ``serving/context_cache.py``: handles, the quota, the persisted index
  and blobs (one filestore root read and written by both packages, both
  ways), the typed load-error miss, ``stats_block``;
- the HTTP surface: ``POST`` / ``GET /v1/context`` and ``context_id`` on
  chat and completions, on the port's server beside the reference's
  aiohttp ``OpenAIServer`` serving the same weights (float32, the
  reference's plain attention): equal handles, ``cached``, listings and
  ``usage``, equal token ids, equal 404 / 429 bodies, equal
  ``helix_ctx_*`` series and heartbeat ``ctx`` blocks.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from helix_tpu.control import node_agent as jagent
from helix_tpu.engine import engine as jengine
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.serving import context_cache as jctx
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.serving import registry as jregistry
from helix_tpu.serving import tokenizer as jtokenizer
from helix_tpu_torch.control import node_agent as tagent
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving import context_cache as tctx
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.serving import registry as tregistry
from helix_tpu_torch.serving import tokenizer as ttokenizer
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.testing.metric_families import parse_exposition

TRACE = "0123456789abcdef0123456789abcdef"


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_handles_equal_the_reference(seed):
    ids = np.random.default_rng(seed).integers(0, 1 << 17, size=300).tolist()
    assert tctx.context_handle(ids) == jctx.context_handle(ids)
    assert tctx.context_handle(ids[:-1]) != tctx.context_handle(ids)


@pytest.mark.parametrize("writer,reader", [(tctx, jctx), (jctx, tctx)])
def test_one_filestore_root_both_ways(tmp_path, writer, reader):
    """A handle one package registers on a root resolves in the other,
    with its listing; a blob that no longer matches its content address
    is a typed miss in both."""
    root = str(tmp_path)
    w = writer.ContextCache(root, tenant_token_cap=0)
    ids = list(range(40, 140))
    h = w.put(ids, tenant="a")
    assert w.put(ids, tenant="a") == h and w.creates == 1
    r = reader.ContextCache(root, tenant_token_cap=0)
    assert r.contains(h)
    assert [(e["id"], e["tokens"]) for e in r.entries()] == [(h, 100)]
    assert r.get(h) == ids and r.hits == 1
    # a blob tampered with after its registration: a fresh cache of
    # either package drops it (and the index entry)
    blob = tmp_path / "ctx-cache" / h[4:6] / f"{h}.json"
    for mod in (tctx, jctx):
        writer.ContextCache(root, tenant_token_cap=0).put(ids, tenant="a")
        blob.write_text(json.dumps({"tokens": ids[:-1], "tenant": "a"}))
        fresh = mod.ContextCache(root, tenant_token_cap=0)
        assert fresh.get(h) is None
        assert (fresh.load_errors, fresh.misses) == (1, 1)


def test_registry_operations_match_the_reference(tmp_path):
    """One scripted series of creates, quota checks, reads, misses and a
    delete through both registries: the same answers and the same
    ``stats_block`` at every step."""
    caches = [mod.ContextCache(str(tmp_path / name), tenant_token_cap=250)
              for mod, name in ((tctx, "t"), (jctx, "j"))]
    rng = np.random.default_rng(7)
    spans = [rng.integers(0, 500, size=n).tolist() for n in (100, 120, 60)]
    script = [("admit", "a", 100), ("put", spans[0], "a"),
              ("admit", "a", 120), ("put", spans[1], "a"),
              ("admit", "a", 60), ("admit", "b", 60), ("put", spans[2], "b"),
              ("get", 0), ("get", 2), ("miss",), ("delete", 1),
              ("delete", 1), ("get", 1)]
    answers = []
    for c in caches:
        seen = []
        for op in script:
            if op[0] == "admit":
                got = c.admit(op[1], op[2])
            elif op[0] == "put":
                got = c.put(op[1], tenant=op[2])
            elif op[0] == "get":
                got = c.get(tctx.context_handle(spans[op[1]]))
            elif op[0] == "miss":
                got = c.get("ctx-" + "0" * 24)
            else:
                got = c.delete(tctx.context_handle(spans[op[1]]))
            seen.append((got, c.stats_block(), c.usage("a"), c.usage("b")))
        answers.append(seen)
    assert answers[0] == answers[1]


# ---------------------------------------------------------------------------
# the HTTP surface, beside the reference's server
# ---------------------------------------------------------------------------


class _IdTokenizer:
    """The byte tokenizer, except that ``decode`` writes every id as
    ``<id>``: the compared texts carry the tokens."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def decode(self, ids) -> str:
        return "".join(f"<{int(i)}>" for i in ids)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_server(registry):
    from aiohttp import web

    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    app = JServer(registry).build_app()
    port = _free_port()
    started = threading.Event()
    holder = {}

    def run():
        aloop = asyncio.new_event_loop()
        asyncio.set_event_loop(aloop)
        runner = web.AppRunner(app)
        aloop.run_until_complete(runner.setup())
        aloop.run_until_complete(
            web.TCPSite(runner, "127.0.0.1", port).start())
        holder["loop"] = aloop
        started.set()
        aloop.run_forever()
        aloop.run_until_complete(runner.cleanup())

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(30)
    return (f"http://127.0.0.1:{port}",
            lambda: holder["loop"].call_soon_threadsafe(holder["loop"].stop))


def _call(base, path, body=None, tenant=None):
    headers = {"Content-Type": "application/json", "X-Helix-Trace-Id": TRACE}
    if tenant:
        headers["X-Helix-Tenant"] = tenant
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


GEOM = dict(max_decode_batch=4, page_size=16, num_pages=256,
            max_pages_per_seq=64, max_prefill_len=64, eos_token_ids=(1,))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port base url, reference base url, port root, reference root)."""
    jcfg = JModelConfig.tiny(vocab_size=512, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.device_get(jp))
    cfg = ModelConfig.tiny(vocab_size=512, dtype="float32")
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("port", "ref")]
    stops = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HELIX_CTX_TENANT_TOKENS", "300")
        mp.setenv("HELIX_FILESTORE_KV_DIR", roots[0])
        tl = tloop.EngineLoop(tengine.Engine(
            cfg, tp, tengine.EngineConfig(**GEOM), device="cpu"),
            "tiny").start()
        treg = tregistry.ModelRegistry()
        treg.register(tregistry.ServedModel(
            name="tiny", loop=tl,
            tokenizer=_IdTokenizer(ttokenizer.ByteTokenizer())))
        httpd = OpenAIServer(treg, inter_token_timeout=60).start()
        stops.append(lambda: (httpd.shutdown(), httpd.server_close()))
        tbase = f"http://127.0.0.1:{httpd.server_address[1]}"
        mp.setenv("HELIX_FILESTORE_KV_DIR", roots[1])
        jl = jloop.EngineLoop(jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **GEOM, attn_backend="reference")), "tiny").start()
        jreg = jregistry.ModelRegistry()
        jreg.register(jregistry.ServedModel(
            name="tiny", loop=jl,
            tokenizer=_IdTokenizer(jtokenizer.ByteTokenizer())))
        jbase, jstop = _reference_server(jreg)
        stops.append(jstop)
    yield tbase, jbase, roots[0], roots[1]
    for stop in stops:
        stop()
    tl.stop()
    jl.stop()


def _both(servers, path, body=None, tenant=None):
    tbase, jbase, _rt, _rj = servers
    return _call(tbase, path, body, tenant), _call(jbase, path, body, tenant)


def _strip(body: dict) -> dict:
    """A response without its timestamps and generated ids."""
    return {k: v for k, v in body.items() if k not in ("created", "id")}


def test_context_api_matches_the_reference(servers):
    rng = np.random.default_rng(11)
    prefix = "".join(chr(c) for c in rng.integers(97, 123, size=200))
    create = {"model": "tiny", "prompt": prefix}
    (ts, tb), (js, jb) = _both(servers, "/v1/context", create)
    assert ts == js == 200
    assert tb == {**jb, "created": tb["created"]}
    assert tb["cached"] is False and tb["tokens"] == 200
    handle = tb["id"]
    (ts, tb2), (js, jb2) = _both(servers, "/v1/context", create)
    assert tb2["cached"] is True and _strip(tb2) == _strip(jb2)
    assert tb2["id"] == jb2["id"] == handle
    (_, tl), (_, jl) = _both(servers, "/v1/context")
    assert [(e["id"], e["tokens"]) for e in tl["data"]] == \
        [(e["id"], e["tokens"]) for e in jl["data"]] == [(handle, 200)]
    # a chat and a completion through the handle: the same token ids and
    # usage, the whole span charged
    chat = {"model": "tiny", "context_id": handle, "max_tokens": 6,
            "temperature": 0,
            "messages": [{"role": "user", "content": "and then?"}]}
    (ts, tc), (js, jc) = _both(servers, "/v1/chat/completions", chat)
    assert ts == js == 200
    assert tc["choices"][0]["message"]["content"] == \
        jc["choices"][0]["message"]["content"]
    assert tc["usage"] == jc["usage"]
    assert tc["usage"]["prompt_tokens"] > 200
    comp = {"model": "tiny", "context_id": handle, "max_tokens": 6,
            "temperature": 0, "prompt": " more"}
    (ts, tc), (js, jc) = _both(servers, "/v1/completions", comp)
    assert ts == js == 200
    assert tc["choices"][0]["text"] == jc["choices"][0]["text"]
    assert tc["usage"] == jc["usage"] and tc["usage"]["prompt_tokens"] == 205
    # an unknown handle: 404 context_not_found, bodies equal
    (ts, te), (js, je) = _both(servers, "/v1/chat/completions",
                               dict(chat, context_id="ctx-" + "0" * 24))
    assert (ts, te) == (js, je) and ts == 404
    assert te["error"]["code"] == "context_not_found"
    (ts, te), (js, je) = _both(servers, "/v1/chat/completions",
                               dict(chat, context_id=7))
    assert (ts, te) == (js, je) and ts == 400
    # past the tenant's HELIX_CTX_TENANT_TOKENS (300): 429, bodies equal
    (ts, te), (js, je) = _both(servers, "/v1/context",
                               {"model": "tiny", "prompt": "q" * 150})
    assert (ts, te) == (js, je) and ts == 429
    assert te["error"]["code"] == "context_quota_exceeded"
    # another tenant has its own quota; an empty prefix is refused
    (ts, tb3), (js, jb3) = _both(servers, "/v1/context",
                                 {"model": "tiny", "prompt": "q" * 150},
                                 tenant="other")
    assert ts == js == 200 and _strip(tb3) == _strip(jb3)
    (ts, te), (js, je) = _both(servers, "/v1/context", {"model": "tiny"})
    assert (ts, te) == (js, je) and ts == 400
    # the registry's series and the heartbeat block agree
    tbase, jbase, rt, rj = servers
    with urllib.request.urlopen(tbase + "/metrics", timeout=60) as r:
        text = r.read().decode()
    got = {n: f for n, f in parse_exposition(text).items()
           if n.startswith("helix_ctx_")}
    assert len(got) == 7
    lines = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
             if ln.startswith("helix_ctx_")}
    ref = jctx.context_cache_for(rj)
    want = {"helix_ctx_entries": 2, "helix_ctx_tokens": 350,
            "helix_ctx_creates_total": ref.creates,
            "helix_ctx_hits_total": ref.hits,
            "helix_ctx_misses_total": ref.misses,
            "helix_ctx_quota_rejects_total": ref.quota_rejects,
            "helix_ctx_load_errors_total": ref.load_errors}
    assert lines == want
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HELIX_FILESTORE_KV_DIR", rt)
        t_block = tagent.NodeAgent.ctx_summary(None)
        mp.setenv("HELIX_FILESTORE_KV_DIR", rj)
        j_block = jagent.NodeAgent.ctx_summary(None)
    assert t_block == j_block == jctx.validate_ctx_block(t_block)
    assert t_block["entries"] == 2 and t_block["hits"] == 2
