"""The port's reverse tunnel (``helix_tpu_torch/control/tunnel.py``, on
the standard library's websockets in ``control/websocket.py``) against the
JAX package's, on the CPU.

- **Codec**: ``pack_frame`` / ``unpack_frame`` byte-equal to the
  reference's over hypothesis-drawn ``(sid, op, payload)``.
- **The reference's tunnel suite with a port node** (the cases of
  ``tests/test_tunnel.py``): the port's ``TunnelAgent`` and unix-socket
  server, over a tiny float32 ``Engine`` and a tiny encoder on the CPU,
  behind the reference's ``ControlPlane`` and ``TunnelHub`` on aiohttp:
  chat plain and SSE (>= 2 frames), the SSE frames' content equal to a
  direct chat's (ids and timestamps masked), embeddings through the
  tunnel (the reference's structured-error case, and vectors equal to
  the reference encoder's within 1e-5), the unknown runner's 503, the
  reconnect grace, the runner token, and a mid-stream disconnect that
  ends in a structured error, frees the slot with no server traceback,
  and recovers.
- **The websocket client against aiohttp's server**: a 0.5 s server
  heartbeat and 3 s idle; a 1 MiB request and response through the
  reference hub (64-bit lengths both ways); continuation frames, pings
  and 16-bit lengths on a socket pair.
- **serve-node --tunnel** in a subprocess behind the reference control
  plane: a chat through the tunnel, then SIGTERM exits 0; without
  ``--control-plane`` it exits 2 with the reference's text.

Every comparison is exact except the embedding vectors (1e-5).
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from helix_tpu.control import tunnel as jtunnel
from helix_tpu.models import bge as jbge
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu_torch import cli
from helix_tpu_torch.control import tunnel as ttunnel
from helix_tpu_torch.control import websocket
from helix_tpu_torch.engine.engine import Engine, EngineConfig
from helix_tpu_torch.models import bge as tbge
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import init_params
from helix_tpu_torch.serving.engine_loop import EngineLoop
from helix_tpu_torch.serving.openai_api import OpenAIServer, UnixHTTPServer
from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
from helix_tpu_torch.serving.tokenizer import ByteTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(sid=st.integers(0, 2 ** 32 - 1), op=st.integers(0, 255),
       payload=st.binary(max_size=300))
def test_frame_codec_equals_reference(sid, op, payload):
    frame = ttunnel.pack_frame(sid, op, payload)
    assert frame == jtunnel.pack_frame(sid, op, payload)
    assert ttunnel.unpack_frame(frame) == jtunnel.unpack_frame(frame) \
        == (sid, op, payload)


def test_op_codes_equal_reference():
    for name in ("OP_OPEN", "OP_BODY", "OP_END", "OP_RESP", "OP_ERR",
                 "OP_CLOSE"):
        assert getattr(ttunnel, name) == getattr(jtunnel, name)


# ---------------------------------------------------------------------------
# helpers
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
        box["loop"] = loop
        holder.setdefault("loops", []).append(loop)
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return box["port"], box["loop"]


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _sse_docs(raw: bytes) -> list:
    out = []
    for line in raw.split(b"\n"):
        if line.startswith(b"data: ") and line[6:] != b"[DONE]":
            out.append(json.loads(line[6:]))
    return out


def _masked(docs) -> list:
    return [{k: v for k, v in d.items() if k not in ("id", "created")}
            for d in docs]


class _UnixPost:
    """A POST to a unix-socket server (the runner's local side)."""

    def __init__(self, path):
        self.path = path

    def __call__(self, route, body):
        conn = ttunnel.UnixHTTPConnection(self.path, timeout=120)
        try:
            conn.request("POST", route, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _drop(cp, loop, runner_id):
    """Close the runner's websocket from the control plane's side."""
    conn = cp.tunnels._conns.get(runner_id)
    assert conn is not None

    async def drop():
        await conn.ws.close()

    asyncio.run_coroutine_threadsafe(drop(), loop).result(timeout=10)


# ---------------------------------------------------------------------------
# the reference suite with a port node
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    """The reference control plane (TCP) and a tunnelled port runner
    (unix socket only) serving a tiny chat model and a tiny encoder."""
    from helix_tpu.control.server import ControlPlane

    cp = ControlPlane()
    holder: dict = {}
    port, cp_loop = _serve_app(cp.build_app(), holder)
    url = f"http://127.0.0.1:{port}"
    tok = ByteTokenizer()
    cfg = ModelConfig.tiny(vocab_size=512, dtype="float32")
    eng = Engine(cfg, init_params(cfg, 3, device="cpu"), EngineConfig(
        max_decode_batch=2, page_size=4, num_pages=256, max_pages_per_seq=64,
        max_prefill_len=128, eos_token_ids=tok.eos_ids), device="cpu")
    eloop = EngineLoop(eng, "tiny").start()
    jcfg = jbge.EncoderConfig.tiny()
    jp = jbge.init_params(jcfg, jax.random.PRNGKey(0))
    embedder = tbge.EmbeddingRunner(
        tbge.EncoderConfig.tiny(), tbge.params_from_jax(jax.device_get(jp)),
        tok, max_batch=4)
    registry = ModelRegistry()
    registry.register(ServedModel(name="tiny-tunnel", loop=eloop,
                                  tokenizer=tok, context_length=128))
    registry.register(ServedModel(name="tiny-embed", loop=None,
                                  tokenizer=tok, kind="embedding",
                                  embedder=embedder))
    sock = os.path.join(tempfile.mkdtemp(prefix="helix-tun-"), "node.sock")
    httpd = OpenAIServer(registry).make_unix_server(sock)
    errors: list = []
    httpd.handle_error = lambda request, address: errors.append(address)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    agent = ttunnel.TunnelAgent("nat-node", url, unix_socket=sock,
                                reconnect_delay=0.2).start()
    # heartbeat WITHOUT an address: the control plane must use the tunnel
    hb = {"address": "", "accelerators": [],
          "profile": {"name": "p", "status": "running",
                      "models": ["tiny-tunnel", "tiny-embed"]}}
    status, _, _ = _post(f"{url}/api/v1/runners/nat-node/heartbeat", hb)
    assert status == 200
    assert _wait(lambda: cp.tunnels.connected("nat-node"))
    yield {"cp": cp, "url": url, "loop": cp_loop, "agent": agent,
           "engine": eng, "errors": errors, "local": _UnixPost(sock),
           "sock": sock, "eloop": eloop,
           "jembed": jbge.EmbeddingRunner(jcfg, jp, JByteTokenizer(),
                                          max_batch=4)}
    agent.stop(join=True)
    httpd.shutdown()
    httpd.server_close()
    eloop.stop(join=False)
    cp.stop()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


def _chat(max_tokens=6, content="hello tunnel", stream=False):
    return {"model": "tiny-tunnel", "max_tokens": max_tokens,
            "temperature": 0, "stream": stream,
            "messages": [{"role": "user", "content": content}]}


def test_chat_streams_through_tunnel(stack):
    status, _, raw = _post(f"{stack['url']}/v1/chat/completions", _chat())
    assert status == 200, raw
    assert json.loads(raw)["choices"][0]["message"]["content"] is not None
    status, headers, raw = _post(f"{stack['url']}/v1/chat/completions",
                                 _chat(content="stream me", stream=True))
    assert status == 200
    assert "text/event-stream" in headers.get("Content-Type", "")
    assert len(_sse_docs(raw)) >= 2   # token by token, not one blob


def test_sse_frames_equal_a_direct_chat(stack):
    body = _chat(max_tokens=12, content="same frames", stream=True)
    status, _, raw = _post(f"{stack['url']}/v1/chat/completions", body)
    assert status == 200
    d_status, d_raw = stack["local"]("/v1/chat/completions", body)
    assert d_status == 200
    tun, direct = _sse_docs(raw), _sse_docs(d_raw)
    assert len(tun) >= 2 and _masked(tun) == _masked(direct)
    assert raw.endswith(b"data: [DONE]\n\n") and \
        d_raw.endswith(b"data: [DONE]\n\n")


def test_embeddings_through_tunnel(stack):
    # the reference case: a chat model answers a structured error that
    # rode the tunnel (status and JSON intact)
    status, _, raw = _post(f"{stack['url']}/v1/embeddings",
                           {"model": "tiny-tunnel", "input": "embed me"})
    assert status == 404
    assert json.loads(raw)["error"]["message"] == \
        "'tiny-tunnel' is not an embedding model"
    texts = ["embed me", "and me, a longer text to pad", "x"]
    status, _, raw = _post(f"{stack['url']}/v1/embeddings",
                           {"model": "tiny-embed", "input": texts})
    assert status == 200, raw
    doc = json.loads(raw)
    got = np.array([d["embedding"] for d in doc["data"]])
    want = stack["jembed"].embed_texts(texts)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    n = sum(len(t.encode()) for t in texts)
    assert doc["usage"] == {"prompt_tokens": n, "total_tokens": n}


def test_unknown_runner_is_clean_503(stack):
    cp = stack["cp"]
    cp.router.upsert_from_heartbeat(
        "ghost", models=["ghost-model"], profile_name="p",
        profile_status="running", accelerators=[], meta={"address": ""})
    cp.tunnels.grace = 0.5
    prev_base = cp.dispatch_backoff_base
    cp.dispatch_backoff_base = 0.001
    try:
        status, headers, raw = _post(f"{stack['url']}/v1/chat/completions", {
            "model": "ghost-model", "max_tokens": 2,
            "messages": [{"role": "user", "content": "x"}]})
        assert status == 503
        body = json.loads(raw)["error"]
        assert body["code"] == "runners_exhausted"
        assert headers.get("Retry-After") == "1"
        assert "unavailable" in body["message"]
    finally:
        cp.tunnels.grace = 30.0
        cp.dispatch_backoff_base = prev_base


def test_reconnect_grace_queues_dials(stack):
    before = stack["agent"].connects
    _drop(stack["cp"], stack["loop"], "nat-node")
    # dispatched at once: the agent re-dials after 0.2 s, inside the grace
    status, _, raw = _post(f"{stack['url']}/v1/chat/completions",
                           _chat(max_tokens=4, content="after drop"))
    assert status == 200, raw
    assert stack["agent"].connects >= before + 1


def test_midstream_disconnect_surfaces_clean_error(stack):
    """Kill the tunnel while an SSE stream is in flight: the client gets
    a terminal structured error frame; the runner's request is aborted
    (its slot frees) without a traceback on the server; the next request
    succeeds after the re-dial."""
    req = urllib.request.Request(
        f"{stack['url']}/v1/chat/completions",
        data=json.dumps(_chat(max_tokens=60, content="long stream",
                              stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    got_first = saw_error = False
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        for line in r:
            if not line.startswith(b"data: "):
                continue
            payload = line[6:].strip()
            if payload == b"[DONE]":
                break
            doc = json.loads(payload)
            if "error" in doc:
                saw_error = True
                assert "disconnected" in doc["error"]["message"]
                break
            if not got_first:
                got_first = True
                _drop(stack["cp"], stack["loop"], "nat-node")
    assert got_first and saw_error
    eng = stack["engine"]
    assert _wait(lambda: all(s is None for s in eng.slots)
                 and not eng.waiting)
    status, _, raw = _post(f"{stack['url']}/v1/chat/completions",
                           _chat(max_tokens=4, content="recovered"))
    assert status == 200, raw
    assert stack["errors"] == []


def test_op_close_aborts_the_local_request(stack):
    """The control plane's caller stops reading while the tunnel stays up
    (the stand-in hub sends ``OP_CLOSE`` when its chunk iterator is
    closed): the runner shuts its local socket, the server's next write
    hangs up and the engine aborts the request long before max_tokens,
    with no traceback and no new dial."""
    from helix_tpu_torch.testing.control_stub import ControlStub

    eloop, eng = stack["eloop"], stack["engine"]
    tokens: dict = {}
    submit = eloop.submit

    def counting(req, on_event, *a, **kw):
        tokens[req.id] = 0

        def ev(e):
            if e.token_id >= 0 and not e.error:
                tokens[req.id] += 1
            on_event(e)
        return submit(req, ev, *a, **kw)

    stub = ControlStub().start()
    agent = ttunnel.TunnelAgent("stub-node", stub.url,
                                unix_socket=stack["sock"],
                                reconnect_delay=0.2).start()
    eloop.submit = counting
    try:
        max_tokens = 200
        status, _h, chunks = stub.tunnel_request(
            "stub-node", "POST", "/v1/chat/completions",
            {"Content-Type": "application/json"},
            json.dumps(_chat(max_tokens=max_tokens, content="walk away",
                             stream=True)).encode())
        assert status == 200
        assert _sse_docs(next(chunks))
        chunks.close()
        assert _wait(lambda: all(s is None for s in eng.slots)
                     and not eng.waiting, 60)
        assert len(tokens) == 1
        (n,) = tokens.values()
        assert 0 < n < max_tokens // 4, n
        assert agent.connects == 1 and stub.dials["stub-node"] == 1
        assert not agent._active
        assert stack["errors"] == []
    finally:
        eloop.submit = submit
        agent.stop(join=True)
        stub.stop()


def test_runner_token_required_on_tunnel_when_auth_on():
    from helix_tpu.control.server import ControlPlane

    cp = ControlPlane(auth_required=True, runner_token="sekrit")
    holder: dict = {}
    port, _loop = _serve_app(cp.build_app(), holder)
    url = f"http://127.0.0.1:{port}/api/v1/runners/n/tunnel"
    try:
        for token in ("", "wrong"):
            with pytest.raises(websocket.HandshakeError) as e:
                websocket.connect(url, {"X-Runner-Token": token}
                                  if token else {})
            assert e.value.status == 401
        websocket.connect(url, {"X-Runner-Token": "sekrit"}).close()
        # the agent sends its token and connects
        agent = ttunnel.TunnelAgent("n", f"http://127.0.0.1:{port}",
                                    unix_socket="unused.sock",
                                    runner_token="sekrit",
                                    reconnect_delay=0.2).start()
        assert _wait(lambda: cp.tunnels.connected("n"))
        # the control plane registers the tunnel as it answers the
        # handshake, before the agent has read that answer and counted it
        assert _wait(lambda: agent.connects >= 1)
        assert agent.connects == 1
        agent.stop(join=True)
    finally:
        cp.stop()
        for lp in holder.get("loops", []):
            lp.call_soon_threadsafe(lp.stop)


# ---------------------------------------------------------------------------
# the websocket client against aiohttp's server
# ---------------------------------------------------------------------------


def test_client_survives_idle_under_a_short_server_heartbeat():
    """aiohttp's server pings every 0.5 s and drops a peer whose pong is
    late: the client answers, so 3 s idle leaves the socket open."""
    from aiohttp import WSMsgType, web

    async def echo(request):
        ws = web.WebSocketResponse(heartbeat=0.5, max_msg_size=0)
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == WSMsgType.BINARY:
                await ws.send_bytes(msg.data[::-1])
        return ws

    app = web.Application()
    app.router.add_get("/ws", echo)
    holder: dict = {}
    port, _loop = _serve_app(app, holder)
    try:
        ws = websocket.connect(f"http://127.0.0.1:{port}/ws",
                               heartbeat=None)
        got = []

        def read():
            try:
                while True:
                    got.append(ws.recv())
            except websocket.WebSocketClosed:
                got.append("closed")

        threading.Thread(target=read, daemon=True).start()
        time.sleep(3.0)
        assert not ws.closed.is_set() and got == []
        ws.send_bytes(b"abc")
        assert _wait(lambda: got, 5)
        assert got[0] == (websocket.OP_BINARY, b"cba")
        ws.close()
        assert _wait(lambda: got[-1] == "closed", 5)
    finally:
        for lp in holder.get("loops", []):
            lp.call_soon_threadsafe(lp.stop)


class _Echo(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        data = self.rfile.read(int(self.headers["Content-Length"]))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data[::-1])


def test_megabyte_request_and_response_cross_the_reference_hub():
    from helix_tpu.control.tunnel import TunnelHub

    hub = TunnelHub()
    from aiohttp import web

    async def dial(request):
        return await hub.handle_ws(request.match_info["id"], request)

    app = web.Application()
    app.router.add_get("/api/v1/runners/{id}/tunnel", dial)
    holder: dict = {}
    port, loop = _serve_app(app, holder)
    sock = os.path.join(tempfile.mkdtemp(prefix="helix-echo-"), "e.sock")
    httpd = UnixHTTPServer(sock, _Echo)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    agent = ttunnel.TunnelAgent("echo", f"http://127.0.0.1:{port}",
                                unix_socket=sock, reconnect_delay=0.2).start()
    try:
        assert _wait(lambda: hub.connected("echo"))
        body = np.random.default_rng(0).bytes(1 << 20)

        async def call():
            status, headers, chunks = await hub.request(
                "echo", "POST", "/echo",
                {"Content-Type": "application/octet-stream"}, body)
            parts = [c async for c in chunks]
            return status, headers, parts

        status, headers, parts = asyncio.run_coroutine_threadsafe(
            call(), loop).result(timeout=60)
        assert status == 200
        assert headers["Content-Type"] == "application/octet-stream"
        assert b"".join(parts) == body[::-1]
        # read1's 64 KiB chunks: every frame past the 16-bit length
        assert len(parts) >= 16 and max(map(len, parts)) >= 1 << 16
    finally:
        agent.stop(join=True)
        httpd.shutdown()
        httpd.server_close()
        for lp in holder.get("loops", []):
            lp.call_soon_threadsafe(lp.stop)


def test_frames_on_a_socket_pair():
    """Continuation frames join, pings are answered with the same
    payload, a 16-bit and a 64-bit length round-trip, and a close frame
    is echoed."""
    a, b = socket.socketpair()
    client = websocket.WebSocket(a, a.makefile("rb"), client=True)
    server = websocket.WebSocket(b, b.makefile("rb"), client=False)
    raw = websocket.encode_frame
    b.sendall(raw(websocket.OP_TEXT, b"hel", mask=False, fin=False)
              + raw(websocket.OP_PING, b"p1", mask=False)
              + raw(websocket.OP_CONT, b"lo", mask=False, fin=False)
              + raw(websocket.OP_CONT, b"!", mask=False))
    assert client.recv() == (websocket.OP_TEXT, b"hello!")
    got = server._frame()
    assert got[1:] == (websocket.OP_PONG, b"p1")     # masked, unmasked here
    for n in (300, 70_000):
        client.send_bytes(bytes(range(256)) * (n // 256))
        assert server.recv() == (websocket.OP_BINARY,
                                 bytes(range(256)) * (n // 256))
    server.send_bytes(b"x" * 70_000)
    assert client.recv() == (websocket.OP_BINARY, b"x" * 70_000)
    done = []
    t = threading.Thread(target=lambda: done.append(
        pytest.raises(websocket.WebSocketClosed, server.recv)))
    t.start()
    client.close(wait=0.2)
    t.join(5)
    assert done and server.close_code == websocket.CLOSE_NORMAL


# ---------------------------------------------------------------------------
# serve-node --tunnel
# ---------------------------------------------------------------------------


def _stream_through(url, body, out):
    """A streamed chat through the control plane: its data frames, the
    first one's arrival flagged in ``out`` as it comes."""
    req = urllib.request.Request(
        f"{url}/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    out["frames"] = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            if line.startswith(b"data: {"):
                out["frames"].append(json.loads(line[6:]))


def test_serve_node_tunnel_serves_and_exits_zero_on_sigterm():
    """``serve-node --tunnel`` in a process with no TCP listener: the
    reference control plane routes a chat to it through the tunnel (its
    heartbeat advertises no address); SIGTERM with two streams in flight
    drains them through the tunnel (each ends whole, one frame per
    token) before the tunnel closes, and the process exits 0."""
    from helix_tpu.control.server import ControlPlane

    cp = ControlPlane()
    holder: dict = {}
    port, _loop = _serve_app(cp.build_app(), holder)
    url = f"http://127.0.0.1:{port}"
    sock = os.path.join(tempfile.mkdtemp(prefix="helix-node-"), "s.sock")
    env = {**os.environ, "HELIX_DRAIN_SECONDS": "30"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch", "serve-node", "--tunnel",
         "--unix-socket", sock, "--control-plane", url, "--runner-id",
         "sub", "--device", "cpu", "--model", "tiny-chat", "--no-warmup",
         "--heartbeat-interval", "0.2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        assert _wait(lambda: cp.tunnels.connected("sub")
                     and "tiny-chat" in cp.router.available_models(), 90), \
            proc.stderr.read() if proc.poll() is not None else "no dial"
        beat = cp.router.get("sub")
        assert beat.meta.get("address") == ""
        status, _, raw = _post(f"{url}/v1/chat/completions", {
            "model": "tiny-chat", "max_tokens": 5, "temperature": 0,
            "messages": [{"role": "user", "content": "via the tunnel"}]})
        assert status == 200, raw
        assert json.loads(raw)["usage"]["completion_tokens"] >= 1
        streams = [{}, {}]
        threads = [threading.Thread(target=_stream_through, args=(url, {
            "model": "tiny-chat", "max_tokens": 40, "temperature": 0,
            "messages": [
                {"role": "user", "content": f"stream {i}"}]}, streams[i]))
            for i in range(2)]
        for t in threads:
            t.start()
        assert _wait(lambda: all(o.get("frames") for o in streams), 60)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        for o in streams:
            frames = o["frames"]
            assert "error" not in frames[-1], frames[-1]
            reason = frames[-1]["choices"][0]["finish_reason"]
            assert reason == "stop" or (reason == "length"
                                        and len(frames) == 40)
        assert proc.wait(60) == 0
        out, err = proc.stdout.read(), proc.stderr.read()
        assert "tunnelling to" in out and "Traceback" not in err
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
        cp.stop()
        for lp in holder.get("loops", []):
            lp.call_soon_threadsafe(lp.stop)


def test_tunnel_needs_a_control_plane(capsys):
    assert cli.main(["serve-node", "--tunnel", "--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip() == (
        "serve-node: --tunnel requires --control-plane (the tunnel dials "
        "out to it)")
