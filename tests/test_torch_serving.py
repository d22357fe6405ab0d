"""Serving surface of the PyTorch port: the standard-library OpenAI server
over a tiny model on the CPU with the ``ByteTokenizer``, the jax-free
import boundary, and the no-silent-CPU rule of every entry point."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

from helix_tpu_torch.cli import build_served_model, main as cli_main
from helix_tpu_torch.engine.engine import Engine, EngineConfig
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import init_params
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry

MODEL = "tiny-chat"
ENGINE = dict(max_decode_batch=2, page_size=4, num_pages=128,
              max_pages_per_seq=32, max_prefill_len=16)


@pytest.fixture(scope="module")
def server():
    served = build_served_model(
        MODEL, device="cpu", engine=ENGINE,
        model_overrides={"dtype": "float32"}, seed=3,
    )
    registry = ModelRegistry()
    registry.register(served)
    httpd = OpenAIServer(registry, inter_token_timeout=60).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield url, served
    httpd.shutdown()
    httpd.server_close()
    registry.unregister(MODEL)


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _sse_frames(text):
    frames = [f for f in text.split("\n\n") if f]
    assert all(f.startswith("data: ") for f in frames)
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[len("data: "):]) for f in frames[:-1]]


def _engine_text(served, prompt_ids, n):
    """Greedy tokens for the same prompt through a second engine built
    the same way (same seed), decoded like the server decodes them."""
    cfg = ModelConfig.tiny(name=MODEL, dtype="float32")
    eng = Engine(cfg, init_params(cfg, 3, device="cpu"),
                 EngineConfig(**ENGINE,
                              eos_token_ids=served.tokenizer.eos_ids),
                 rng_seed=3, device="cpu")
    out = eng.generate([prompt_ids],
                       SamplingParams(temperature=0.0, max_tokens=n))[0]
    eos = set(served.tokenizer.eos_ids)
    text = served.tokenizer.decode([t for t in out if t not in eos])
    # the streaming detokenizer holds back a trailing U+FFFD (a possibly
    # split UTF-8 rune) — random weights emit arbitrary bytes
    return text[:-1] if text.endswith("\ufffd") else text


def test_healthz_and_models(server):
    url, _ = server
    assert _get(url, "/healthz") == {"status": "ok", "models": [MODEL]}
    models = _get(url, "/v1/models")
    assert models["object"] == "list"
    assert [m["id"] for m in models["data"]] == [MODEL]


def test_chat_non_stream_matches_engine_generate(server):
    url, served = server
    messages = [{"role": "user", "content": "hello there"}]
    status, ctype, text = _post(url, "/v1/chat/completions", {
        "model": MODEL, "messages": messages, "max_tokens": 8,
        "temperature": 0,
    })
    assert status == 200 and ctype == "application/json"
    body = json.loads(text)
    assert body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant"
    prompt = served.tokenizer.apply_chat_template(messages)
    assert body["usage"]["prompt_tokens"] == len(prompt)
    assert msg["content"] == _engine_text(served, prompt, 8)


def test_chat_sse_stream(server):
    url, served = server
    messages = [{"role": "user", "content": "stream me"}]
    status, ctype, text = _post(url, "/v1/chat/completions", {
        "model": MODEL, "messages": messages, "max_tokens": 6,
        "temperature": 0, "stream": True,
    })
    assert status == 200 and ctype == "text/event-stream"
    chunks = _sse_frames(text)
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    streamed = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    prompt = served.tokenizer.apply_chat_template(messages)
    assert streamed == _engine_text(served, prompt, 6)


@pytest.mark.parametrize("stream", [False, True])
def test_completions(server, stream):
    url, served = server
    status, _, text = _post(url, "/v1/completions", {
        "model": MODEL, "prompt": "once upon", "max_tokens": 5,
        "temperature": 0, "stream": stream,
    })
    assert status == 200
    if stream:
        got = "".join(c["choices"][0]["text"] for c in _sse_frames(text))
    else:
        body = json.loads(text)
        assert body["object"] == "text_completion"
        got = body["choices"][0]["text"]
    want = _engine_text(served, served.tokenizer.encode("once upon"), 5)
    assert got == want


def test_errors_have_openai_shape(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/v1/chat/completions",
              {"model": "nope", "messages": [{"role": "user",
                                              "content": "x"}]})
    assert e.value.code == 404
    err = json.loads(e.value.read())["error"]
    assert err["type"] == "model_not_found" and "message" in err
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/v1/chat/completions", {"model": MODEL})
    assert e.value.code == 400


# packages the card's machine does not have: the port's modules and
# chip_smoke.py import none of them
BANNED = ("jax", "helix_tpu", "safetensors", "tokenizers", "regex",
          "ml_dtypes")


def test_port_imports_no_jax():
    """Every module of the port, in a fresh interpreter: neither jax, nor
    any helix_tpu module, nor ``safetensors``, ``tokenizers``, ``regex``
    or ``ml_dtypes`` may load; ``chip_smoke.py`` imports none of them
    either (its import statements, read from its source)."""
    import ast

    code = (
        "import pkgutil, sys, importlib, helix_tpu_torch\n"
        "for m in pkgutil.walk_packages(helix_tpu_torch.__path__, "
        "'helix_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [n for n in sys.modules if n.split('.')[0] in {BANNED!r}]\n"
        "assert not bad, bad\n"
        "print('clean', len([n for n in sys.modules "
        "if n.startswith('helix_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "helix_tpu_torch.cli" in names
    assert not {n for n in names if n.split(".")[0] in BANNED}


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = ModelConfig.tiny(dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, EngineConfig(**ENGINE))
    with pytest.raises(RuntimeError, match="cuda"):
        build_served_model(MODEL, engine=ENGINE)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["serve-node", "--model", MODEL, "--port", "0"])


def test_served_model_refuses_attention_backend_switch():
    with pytest.raises(ValueError, match="attn_backend"):
        build_served_model(MODEL, device="cpu",
                           engine={**ENGINE, "attn_backend": "reference"})
    with pytest.raises(ValueError, match="attn_backend"):
        cli_main(["serve-node", "--model", MODEL, "--port", "0",
                  "--device", "cpu", "--engine", "attn_backend=reference"])


def test_int8_profile_entry_serves_int8_weights_and_kv(tmp_path):
    """A profile entry with ``quantization: int8`` and ``engine:
    {kv_cache_dtype: int8}`` (the reference's int8 serving fields) builds
    int8 weights and an int8 pool, and answers a chat over HTTP."""
    from helix_tpu_torch.cli import _model_specs

    prof = tmp_path / "p.json"
    prof.write_text(json.dumps({"models": [{
        "name": MODEL, "quantization": "int8",
        "engine": {**ENGINE, "kv_cache_dtype": "int8"},
        "model_overrides": {"dtype": "float32"},
    }]}))
    args = type("A", (), {"profile": str(prof), "engine": None,
                          "model": None})
    (spec,) = _model_specs(args)
    assert spec["quantization"] == "int8"
    served = build_served_model(device="cpu", seed=3, **spec)
    registry = ModelRegistry()
    registry.register(served)
    httpd = OpenAIServer(registry, inter_token_timeout=60).start()
    try:
        eng = served.loop.engine
        assert eng.params["layers"]["wq"]["weight"].dtype == torch.int8
        assert eng.cache.quantized
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        # a seeded sampled request reproduces its text (a prompt under one
        # page: a prefix-cache hit would attend the quantized history, a
        # legitimately different input)
        body = {"model": MODEL, "prompt": "hi", "max_tokens": 6,
                "temperature": 0.8, "seed": 4}
        status, _, text = _post(url, "/v1/completions", body)
        again = _post(url, "/v1/completions", body)[2]
        assert status == 200
        assert (json.loads(text)["choices"][0]["text"]
                == json.loads(again)["choices"][0]["text"])
        assert eng.prefix_cache_hits == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        registry.unregister(MODEL)
    with pytest.raises(ValueError, match="quantization"):
        build_served_model(MODEL, device="cpu", engine=ENGINE,
                           quantization="int4")


def test_client_hang_up_frees_the_slot_without_a_traceback(caplog):
    """A client that reads one SSE frame and closes its socket: the
    server's next write fails, the stream's generator is closed (the
    request aborted, its slot freed) and one line is logged; the
    server's ``handle_error`` (socketserver's traceback) is never
    called."""
    import logging
    import socket
    import time

    served = build_served_model(MODEL, device="cpu", engine=ENGINE,
                                model_overrides={"dtype": "float32"}, seed=3)
    registry = ModelRegistry()
    registry.register(served)
    httpd = OpenAIServer(registry, inter_token_timeout=60).start()
    errors = []
    httpd.handle_error = lambda request, address: errors.append(address)
    body = json.dumps({"model": MODEL, "max_tokens": 200, "temperature": 0,
                       "stream": True, "messages": [
                           {"role": "user", "content": "a long answer"}]})
    try:
        with caplog.at_level(logging.INFO,
                             logger="helix_tpu_torch.serving.openai_api"):
            s = socket.create_connection(httpd.server_address, timeout=30)
            s.sendall((f"POST /v1/chat/completions HTTP/1.1\r\n"
                       f"Host: x\r\nContent-Type: application/json\r\n"
                       f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
            got = b""
            while b"data: " not in got:
                got += s.recv(4096)
            s.close()
            eng = served.loop.engine
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and (
                    any(r is not None for r in eng.slots) or eng.waiting
                    or not any("hung up" in r.message
                               for r in caplog.records)):
                time.sleep(0.02)
        assert all(r is None for r in eng.slots) and not eng.waiting
        hung = [r for r in caplog.records if "hung up" in r.message]
        assert len(hung) == 1 and "/v1/chat/completions" in \
            hung[0].getMessage()
        assert errors == []
        # the server goes on answering
        status, _, text = _post(
            f"http://127.0.0.1:{httpd.server_address[1]}",
            "/v1/chat/completions",
            {"model": MODEL, "max_tokens": 3, "temperature": 0,
             "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        registry.unregister(MODEL)


def test_profile_attn_backend_reference_is_dropped_not_refused(tmp_path):
    """A profile entry's ``attn_backend: reference`` (the reference's
    switch to its attention without Pallas, for the CPU, as
    ``profiles/dev-tiny.yaml`` writes it) is dropped: the served path
    always runs the kernels' wrappers.  Asked of ``build_served_model``
    or ``--engine`` it stays refused (above)."""
    from helix_tpu_torch.cli import _model_specs

    prof = tmp_path / "p.json"
    prof.write_text(json.dumps({"name": "p", "models": [{
        "name": MODEL, "engine": {**ENGINE, "attn_backend": "reference"}}]}))
    args = type("A", (), {"engine": None, "profile": str(prof), "model": None,
                          "random_weights": False, "seed": 0})()
    (spec,) = _model_specs(args)
    assert spec["engine"] == ENGINE
    args.engine = ["attn_backend=reference"]
    (spec,) = _model_specs(args)
    with pytest.raises(ValueError, match="attn_backend"):
        build_served_model(device="cpu", **spec)
