"""Tensor parallel on one host: the port's mesh against the reference's.

The reference runs here on its 8 virtual CPU devices (``tests/conftest.py``
forces them); the port's meshes are lists of CPU devices, one shard per
entry (its wrappers take their plain versions on CPU tensors).  The tiny
config has 8 query and 4 KV heads, so tp 2 and tp 4 divide it.

- ``MeshSpec`` / ``slice_devices`` / ``build_mesh`` / ``default_mesh_spec``
  against the reference's, error text included;
- ``shard_params`` byte-equal to the reference's ``addressable_shards``
  for float and int8 trees (``quantized_logical_axes``), the KV pool's
  sharding likewise, and the engine's pool shards shaped as the
  reference engine's;
- float32 logits of ``forward_sharded`` within 1e-5 of the reference's
  forward on sharded params and of the port's tp 1;
- the row-parallel sum rounded once (bf16): a case where rounding each
  partial first gives another number;
- greedy tokens (and one seeded sampled request) of the port's tp 2 and
  tp 4 engines equal to the reference's ``Engine(mesh=...)`` and to the
  port's tp 1, float and int8 KV, over packed prompts, chunked prefill,
  the mixed step and a prefix-cache hit;
- the engine loop with ``enable_async_loop`` on and off on a mesh;
- the node agent realising tp 2 chat entries at offsets 0 and 2 and an
  embedder at offset 4 over disjoint device slices;
- every refusal that remains, by name (an MoE model and the ``ep`` axis
  are served on a mesh, ``tests/test_torch_ep.py``; the MoE case asks for
  a ``pp`` axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.device import mesh as jmesh
from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models import llama as jllama
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.ops.quant import quantize_params as jquantize
from helix_tpu.ops.quant import quantized_logical_axes as jq_axes
from helix_tpu.parallel import sharding as jsharding
from helix_tpu_torch import cli
from helix_tpu_torch.control.node_agent import NodeAgent
from helix_tpu_torch.control.profile import ServingProfile
from helix_tpu_torch.device import mesh as tmesh
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.ops.quant import quantized_logical_axes as tq_axes
from helix_tpu_torch.parallel import collectives, sharding as tsharding
from helix_tpu_torch.serving.engine_loop import EngineLoop

CPU = torch.device("cpu")
HEADS = dict(num_heads=8, num_kv_heads=4)
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=16, max_prefill_len=16)
N_TOK = 8
LOGIT_ATOL = 1e-5


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first (the
    JAX engine uploads host mirrors it goes on writing; see
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
def weights():
    jcfg = JModelConfig.tiny(dtype="float32", **HEADS)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = tllama.params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(dtype="float32", **HEADS), tp


def _tmesh(tp, offset=0):
    return tmesh.build_mesh(tmesh.MeshSpec(tp=tp, device_offset=offset),
                            [CPU] * 8)


def _shard_of(arr, jm, i):
    """The reference array's shard on the mesh's i-th device."""
    dev = list(jm.devices.flat)[i]
    (sh,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(sh.data)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _join(shards: list, logical_axes, mesh) -> torch.Tensor:
    """The whole tensor back from its shards (replicated dimensions from
    the first shard covering them): the inverse of ``shard_tensor``."""
    full = None
    for i, part in enumerate(shards):
        if full is None:
            spec = tsharding._prune(mesh, tsharding.spec_for(logical_axes))
            full = torch.empty([n * (mesh.shape["tp"] if axes else 1)
                                for n, axes in zip(part.shape, spec)],
                               dtype=part.dtype)
        view = full
        for dim, (start, size) in enumerate(tsharding.shard_block(
                full.shape, logical_axes, mesh, i)):
            view = view.narrow(dim, start, size)
        view.copy_(part)
    return full


def _bytes(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    dict(tp=4), dict(tp=2, device_offset=2), dict(tp=1, device_offset=4),
    dict(dp=2, tp=2), dict(tp=2, device_offset=7), dict(tp=16)])
def test_mesh_matches_reference(spec):
    """Slices, axis sizes and device positions as the reference's, and
    its ``ValueError`` text where the slice runs past the devices."""
    jspec, tspec = jmesh.MeshSpec(**spec), tmesh.MeshSpec(**spec)
    assert tspec.to_dict() == jspec.to_dict()
    assert tspec.num_devices == jspec.num_devices
    assert tspec.axis_sizes() == jspec.axis_sizes()
    try:
        jm = jmesh.build_mesh(jspec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.build_mesh(tspec, [CPU] * len(jax.devices()))
        assert str(got.value) == str(e)
        with pytest.raises(ValueError, match="only 1 devices are visible"):
            tmesh.slice_devices(tspec, [CPU])
        return
    tm = tmesh.build_mesh(tspec, [CPU] * len(jax.devices()))
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert list(tm.device_ids) == [d.id for d in jm.devices.flat]
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for n in (1, 2, 4, 6, 8, 12):
        assert tmesh.default_mesh_spec(n).to_dict() == \
            jmesh.default_mesh_spec(n).to_dict()


# ---------------------------------------------------------------------------
# shards byte-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,int8,cfg_kw", [
    (2, False, {}), (4, False, {}), (4, True, {}),
    (2, False, dict(attention_bias=True, qk_norm=True,
                    tie_word_embeddings=True)),
    (2, True, dict(tie_word_embeddings=True))])
def test_shard_params_byte_equal_reference(tp, int8, cfg_kw):
    jcfg = JModelConfig.tiny(dtype="bfloat16", **HEADS, **cfg_kw)
    tcfg = ModelConfig.tiny(dtype="bfloat16", **HEADS, **cfg_kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    jm = jmesh.build_mesh(jmesh.MeshSpec(tp=tp))
    axes_j = jllama.param_logical_axes(jcfg)
    axes_t = tllama.param_logical_axes(tcfg)
    assert axes_t == axes_j
    full = tllama.params_from_jax(jax.device_get(jp))
    sharded = jsharding.shard_params(jp, jm, axes_j)
    if int8:
        out_sh = jsharding.sharding_tree(jm, jq_axes(axes_j))
        sharded = jax.jit(jquantize, out_shardings=out_sh)(sharded)
        # the same arrays: the reference's int8 tree, gathered whole
        full = tllama.params_from_jax(jax.device_get(sharded))
        axes_t = tq_axes(axes_t)
        assert axes_t == jq_axes(axes_j)
    shards = tsharding.shard_params(full, _tmesh(tp), axes_t)
    n = 0
    for path, arr in _leaves(sharded):
        for i in range(tp):
            got = _get(shards[i], path)
            want = _shard_of(arr, jm, i)
            assert got.is_contiguous() and tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(_bytes(got), want.view(
                _bytes(got).dtype), err_msg=str(path))
            n += 1
        # the shards joined give the whole tensor back
        joined = _join([_get(s, path) for s in shards],
                       _get(axes_t, path), _tmesh(tp))
        np.testing.assert_array_equal(_bytes(joined),
                                      _bytes(_get(full, path)))
    assert n == tp * len(list(_leaves(full)))


@pytest.mark.parametrize("tp", [2, 4])
def test_pool_sharding_byte_equal_reference(weights, tp):
    """The KV pool's layout over ``cache_heads``: a random int8 pool and
    its scales sharded as the reference shards them, and the engine's
    pool shards shaped as the reference engine's."""
    jcfg, jp, cfg, tp_params = weights
    rng = np.random.default_rng(tp)
    pool = rng.integers(-127, 128, (2, 16, 4, 4, 16), dtype=np.int8)
    scale = rng.random((2, 16, 4, 4), dtype=np.float32)
    jm = jmesh.build_mesh(jmesh.MeshSpec(tp=tp))
    for arr, axes in ((pool, tsharding.POOL_AXES),
                      (scale, tsharding.POOL_SCALE_AXES)):
        jarr = jax.device_put(arr, jsharding.logical_sharding(jm, axes))
        for i in range(tp):
            got = tsharding.shard_tensor(torch.from_numpy(arr), axes,
                                         _tmesh(tp), i)
            np.testing.assert_array_equal(got.numpy(), _shard_of(jarr, jm, i))
    ecfg = dict(GEOMETRY, kv_cache_dtype="int8")
    je = jengine.Engine(jcfg, jsharding.shard_params(
        jp, jm, jllama.param_logical_axes(jcfg)),
        jengine.EngineConfig(**ecfg, attn_backend="reference"), mesh=jm)
    mesh = _tmesh(tp)
    te = tengine.Engine(cfg, tsharding.shard_params(
        tp_params, mesh, tllama.param_logical_axes(cfg)),
        tengine.EngineConfig(**ecfg), mesh=mesh)
    for i in range(tp):
        for f in ("k_pages", "v_pages", "k_scale", "v_scale"):
            want = _shard_of(getattr(je.cache, f), jm, i)
            got = getattr(te.caches[i], f)
            assert tuple(got.shape) == want.shape, f
            assert str(got.dtype).split(".")[-1] == str(want.dtype)


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


def _tokens(cfg, B=2, S=7, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return tok, pos


def _t_attn(seg):
    def attn(q, k, v, carry, p):
        return tllama.prefill_attn_fn(q, k, v, None, p,
                                      segment_ids=seg), carry[0]
    return attn


@pytest.mark.parametrize("tp,int8", [(2, False), (4, False), (4, True)])
def test_sharded_logits_match_reference_and_tp1(weights, tp, int8):
    """float32 logits of ``forward_sharded`` against the reference's
    forward on params sharded over its mesh, and against the port's
    single-device forward, within 1e-5."""
    jcfg, jp, cfg, tparams = weights
    if int8:
        jp = jquantize(jp)
        tparams = tllama.params_from_jax(jax.device_get(jp))
    tok, pos = _tokens(cfg)
    seg = np.ones_like(tok)
    jm = jmesh.build_mesh(jmesh.MeshSpec(tp=tp))
    axes = jllama.param_logical_axes(jcfg)
    if int8:
        axes = jq_axes(axes)
    jlog, _ = jllama.forward(
        jsharding.shard_params(jp, jm, axes), jcfg, tok, pos,
        attn_fn=lambda q, k, v, c, p: jllama.prefill_attn_fn(
            q, k, v, c, p, segment_ids=seg, backend="reference"))
    mesh = _tmesh(tp)
    shards = tsharding.shard_params(tparams, mesh, tq_axes(
        tllama.param_logical_axes(cfg)) if int8 else
        tllama.param_logical_axes(cfg))
    tseg = torch.from_numpy(seg)
    tlog, caches = tllama.forward_sharded(
        shards, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
        attn_fns=[_t_attn(tseg)] * tp, carry_caches=[None] * tp, mesh=mesh)
    one, _ = tllama.forward(tparams, cfg, torch.from_numpy(tok),
                            torch.from_numpy(pos),
                            attn_fn=lambda q, k, v, c, p:
                            tllama.prefill_attn_fn(q, k, v, c, p,
                                                   segment_ids=tseg))
    assert tlog.dtype == torch.float32 and caches == [None] * tp
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tlog.numpy(), one.numpy(), atol=LOGIT_ATOL,
                               rtol=0)


def test_row_parallel_sum_rounds_once():
    """bf16 row-parallel projection over 2 shards, on values where
    rounding each shard's partial to bf16 before the sum gives another
    number than the float32 sum rounded once: the port gives the latter
    on every shard (the reference's float32 all-reduce, then its cast),
    the same bits on both."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 96)).astype(
        np.float32) * 0.05).bfloat16()
    parts = [tllama._row_partial(x[:, :128], {"weight": w[:128]}),
             tllama._row_partial(x[:, 128:], {"weight": w[128:]})]
    once = (parts[0] + parts[1]).bfloat16()
    twice = parts[0].bfloat16() + parts[1].bfloat16()
    assert (once != twice).sum() > 100
    got = collectives.all_reduce(parts, [CPU, CPU], torch.bfloat16)
    assert all(torch.equal(g, once) for g in got)
    # with the int8 form's scale: applied once, to the float32 sum
    scale = torch.rand((1, 96)) + 0.5
    got = collectives.all_reduce(parts, [CPU, CPU], torch.bfloat16,
                                 tllama._row_epilogue({"weight": w[:128],
                                                       "scale": scale}))
    assert torch.equal(got[1], ((parts[0] + parts[1]) * scale).bfloat16())


# ---------------------------------------------------------------------------
# engines: the port's tp 1 / 2 / 4 against the reference's mesh engine
# ---------------------------------------------------------------------------

SHORT = [[1, 2, 3, 4, 5], [10, 11, 12], [7, 3]]
LONG = [(5 * i) % 23 + 1 for i in range(40)]     # 3 chunks of <= 16


def _scenario(eng, mod, smod):
    """Packed prompts with a seeded sampled request, then a long prompt
    chunked while a short one decodes (mixed steps), then the long prompt
    again (a chunked prefix-cache hit).  Returns every request's tokens
    and the engine's counts of mixed steps and prefix hits."""
    def req(rid, prompt, **samp):
        return mod.Request(id=rid, prompt_tokens=list(prompt),
                           sampling=smod.SamplingParams(
                               max_tokens=N_TOK,
                               **{"temperature": 0.0, **samp}))

    def run(reqs, steps_between=()):
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        return [r.output_tokens for r in reqs]

    out = run([req(f"w{i}", p) for i, p in enumerate(SHORT)]
              + [req("seeded", [5, 6, 7, 8, 9], temperature=0.8,
                     seed=1234)])
    r1 = req("r1", [2, 4, 6, 8, 10])
    eng.add_request(r1)
    for _ in range(3):
        eng.step()
    r2 = req("r2", LONG)
    eng.add_request(r2)
    while eng.has_work():
        eng.step()
    out += [r1.output_tokens, r2.output_tokens]
    out += run([req("again", LONG)])
    return out, eng.num_mixed_steps, eng.prefix_cache_hits


def _port_engine(weights, tp, **extra):
    *_, cfg, tparams = weights
    ecfg = tengine.EngineConfig(**{**GEOMETRY, **extra})
    if tp == 1:
        return tengine.Engine(cfg, tparams, ecfg, device="cpu")
    mesh = _tmesh(tp)
    return tengine.Engine(cfg, tsharding.shard_params(
        tparams, mesh, tllama.param_logical_axes(cfg)), ecfg, mesh=mesh)


@pytest.fixture(scope="module")
def port_runs(weights):
    return {(tp, kv): _scenario(_port_engine(
        weights, tp, kv_cache_dtype=kv), tengine, tsampling)
        for tp in (1, 2, 4) for kv in ("auto", "int8")}


@pytest.mark.parametrize("tp,kv", [(2, "auto"), (4, "int8")])
def test_engine_tokens_equal_reference_mesh_engine(weights, port_runs, tp,
                                                   kv):
    """The reference's ``Engine(mesh=...)`` (float32, its reference
    attention) gives the port's tokens, at tp 2 with a float pool and
    tp 4 with an int8 pool; the scenario reaches chunking, the mixed
    step and the prefix cache on both."""
    jcfg, jp, _, _ = weights
    jm = jmesh.build_mesh(jmesh.MeshSpec(tp=tp))
    je = jengine.Engine(jcfg, jsharding.shard_params(
        jp, jm, jllama.param_logical_axes(jcfg)), jengine.EngineConfig(
        **GEOMETRY, kv_cache_dtype=kv, attn_backend="reference"), mesh=jm)
    want = _scenario(je, jengine, jsampling)
    assert port_runs[(tp, kv)] == want
    toks, mixed, hits = want
    assert mixed > 0 and hits >= 1


@pytest.mark.parametrize("tp,kv", [(tp, kv) for tp in (2, 4)
                                   for kv in ("auto", "int8")])
def test_engine_tokens_equal_tp1(port_runs, tp, kv):
    """The port's tp 2 and tp 4 engines give its single-device engine's
    tokens, greedy and seeded, float and int8 pools."""
    assert port_runs[(tp, kv)] == port_runs[(1, kv)]


@pytest.mark.parametrize("extra,int8_weights", [
    (dict(decode_steps_per_sync=4, adaptive_sync_max_streams=1), False),
    ({}, True)])
def test_fused_tail_and_int8_weights_on_a_mesh(weights, extra,
                                               int8_weights):
    """The fused decode tail (several decode steps a host fetch) and int8
    weights (the reference's ``test_tp2_int8_parity``: column-parallel
    scales sharded with their columns, row-parallel ones whole and
    applied after the sum) give tp 1's greedy tokens at tp 2."""
    from helix_tpu_torch.ops.quant import quantize_params

    jcfg, jp, cfg, tparams = weights
    if int8_weights:
        tparams = quantize_params(tparams)
        weights = (jcfg, jp, cfg, tparams)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], LONG[:21]]
    s = tsampling.SamplingParams(temperature=0.0, max_tokens=12)
    one = _port_engine(weights, 1, **extra).generate(prompts, s)
    mesh = _tmesh(2)
    axes = tllama.param_logical_axes(cfg)
    if int8_weights:
        axes = tq_axes(axes)
    two = tengine.Engine(cfg, tsharding.shard_params(tparams, mesh, axes),
                         tengine.EngineConfig(**{**GEOMETRY, **extra}),
                         mesh=mesh)
    assert two.generate(prompts, s) == one


def test_engine_launch_bookkeeping_on_a_mesh(weights):
    """Every forward runs every layer on every shard: the attention
    forwards count K1 and K2 kinds once per forward, and each shard's
    pool holds its own KV heads of the same pages (tp 2's shard 1 holds
    heads 2-3 of the tp 1 pool, float32 within 1e-5)."""
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    s = tsampling.SamplingParams(temperature=0.0, max_tokens=4)
    one = _port_engine(weights, 1, kv_cache_dtype="float32")
    two = _port_engine(weights, 2, kv_cache_dtype="float32")
    assert one.generate(prompts, s) == two.generate(prompts, s)
    assert one.attn_forwards == two.attn_forwards
    assert two.attn_forwards["k2"] >= 1 and two.attn_forwards["k1"] >= 1
    for i in range(2):
        for f in ("k_pages", "v_pages"):
            want = getattr(one.cache, f)[:, :, :, 2 * i:2 * i + 2]
            np.testing.assert_allclose(getattr(two.caches[i], f).numpy(),
                                       want.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the engine loop
# ---------------------------------------------------------------------------


def _loop_tokens(weights, async_on):
    eng = _port_engine(weights, 2, enable_async_loop=async_on,
                       kv_cache_dtype="int8")
    loop = EngineLoop(eng, name=f"tp-{async_on}").start()
    done, toks = {}, {}
    try:
        drain = loop._drain_inbox
        import threading

        gate = threading.Event()
        loop._drain_inbox = lambda: drain() if gate.is_set() else None
        for i in range(3):
            rid = f"a{i}"
            done[rid] = threading.Event()
            toks[rid] = []

            def on_event(ev, rid=rid):
                if ev.token_id >= 0:
                    toks[rid].append(ev.token_id)
                if ev.finished:
                    done[rid].set()
            loop.submit(tengine.Request(
                id=rid, prompt_tokens=[20 + 3 * i + j for j in range(6)],
                sampling=tsampling.SamplingParams(temperature=0.0,
                                                  max_tokens=16)), on_event)
        gate.set()
        loop._drain_inbox = drain
        for rid, ev in done.items():
            assert ev.wait(60), rid
        return toks, loop.stats()
    finally:
        loop.stop(join=True)


def test_async_loop_on_equals_off_on_a_mesh(weights):
    """The pipelined loop on a tp 2 engine gives the synchronous loop's
    tokens, and dispatches steps ahead."""
    off, _ = _loop_tokens(weights, False)
    on, stats = _loop_tokens(weights, True)
    assert on == off and all(len(t) == 16 for t in on.values())
    assert stats["async_loop"]["pipelined_steps"] > 0


# ---------------------------------------------------------------------------
# the node agent and the refusals
# ---------------------------------------------------------------------------

NODE_ECFG = dict(max_decode_batch=2, page_size=16, num_pages=64,
                 max_pages_per_seq=8, max_prefill_len=32)


def test_node_agent_realises_mesh_disjoint_slices():
    """Two chat entries on tp 2 slices at offsets 0 and 2 and an
    embedder at offset 4: the engines shard over devices {0, 1} and
    {2, 3}, the embedder is built on the slice's first device (4), as
    the reference's ``test_node_agent_realises_mesh_disjoint_slices``;
    a tp engine decodes."""
    seen = {}

    def build(**kw):
        seen[kw["name"]] = kw.get("mesh")
        return cli.build_served_model(**kw)

    agent = NodeAgent("n1", build_model=build, device="cpu",
                      devices=[CPU] * 8, random_weights=True)
    over = {"model_overrides": dict(HEADS)}
    profile = ServingProfile.from_dict({
        "name": "tp-slices", "requirement": {"chips": 8},
        "models": [
            {"name": "chat-a", "mesh": {"tp": 2, "device_offset": 0},
             "engine": dict(NODE_ECFG), **over},
            {"name": "chat-b", "mesh": {"tp": 2, "device_offset": 2},
             "engine": dict(NODE_ECFG), **over},
            {"name": "embed-c", "kind": "embedding",
             "mesh": {"tp": 1, "device_offset": 4}}]})
    try:
        state = agent.apply_profile(profile)
        assert state.status == "running", state.error
        devs = {}
        for name in ("chat-a", "chat-b"):
            eng = agent.registry.get(name).loop.engine
            assert eng.mesh is not None and eng.mesh.shape["tp"] == 2
            assert len(eng.params) == 2 and len(eng.caches) == 2
            devs[name] = set(eng.mesh.device_ids)
        assert devs == {"chat-a": {0, 1}, "chat-b": {2, 3}}
        assert seen["embed-c"].device_ids == (4,)
        assert agent.registry.get("embed-c").embedder is not None
        from helix_tpu_torch.engine.residency import served_model_bytes

        # the footprint counts every shard's weights and pool
        eng = agent.registry.get("chat-a").loop.engine
        want = sum(t.numel() * t.element_size()
                   for tree in eng.params for _p, t in _leaves(tree))
        want += sum(t.numel() * t.element_size()
                    for c in eng.caches for t in c.carry())
        assert served_model_bytes(agent.registry.get("chat-a"),
                                  headroom=0) == want
        loop = agent.registry.get("chat-a").loop
        loop.stop(join=True)
        toks = loop.engine.generate([[3, 5, 7, 9]], tsampling.SamplingParams(
            temperature=0.0, max_tokens=4))
        assert len(toks[0]) == 4
    finally:
        agent.stop()


def test_sharded_random_build_joins_to_tp1():
    """``cli.init_sharded`` (the served mesh's random weights): the
    shards joined equal ``init_params`` of the same seed byte for byte,
    bf16 and int8."""
    cfg = ModelConfig.tiny(dtype="bfloat16", **HEADS)
    mesh = _tmesh(4)
    for q in (None, "int8"):
        whole = tllama.init_params(cfg, 5, device="cpu", quantization=q)
        shards = cli.init_sharded(cfg, 5, mesh, q)
        axes = tllama.param_logical_axes(cfg)
        if q:
            axes = tq_axes(axes)
        for path, t in _leaves(whole):
            joined = _join([_get(s, path) for s in shards],
                           _get(axes, path), mesh)
            np.testing.assert_array_equal(_bytes(joined), _bytes(t))


@pytest.mark.parametrize("q,model_type,fused,cfg_kw", [
    (None, "llama", False, {}),
    ("int8", "llama", False, {}),
    (None, "phi3", True, dict(attention_bias=False)),
    ("int8", "qwen2", False, dict(attention_bias=True,
                                  tie_word_embeddings=True)),
])
def test_checkpoint_loads_shard_by_shard(tmp_path, q, model_type, fused,
                                         cfg_kw):
    """``load_params(..., mesh=)``: each shard's tree equals
    ``shard_params`` of the whole load byte for byte (bf16 and int8,
    fused HF projections, biases, a tied head), at tp 4."""
    from helix_tpu_torch.models import loader as tloader
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    cfg = ModelConfig.tiny(dtype="bfloat16", **HEADS, **cfg_kw)
    params = tllama.init_params(cfg, 9, device="cpu")
    write_checkpoint(str(tmp_path), cfg, params, model_type=model_type,
                     fused=fused, max_shard_bytes=40_000)
    lcfg, whole = tloader.load_params(str(tmp_path), device="cpu",
                                      quantization=q)
    mesh = _tmesh(4)
    _, shards = tloader.load_params(str(tmp_path), device="cpu",
                                    quantization=q, mesh=mesh)
    axes = tllama.param_logical_axes(lcfg)
    if q:
        axes = tq_axes(axes)
    want = tsharding.shard_params(whole, mesh, axes)
    for i in range(4):
        for path, t in _leaves(want[i]):
            got = _get(shards[i], path)
            assert got.dtype == t.dtype and got.shape == t.shape, path
            np.testing.assert_array_equal(_bytes(got), _bytes(t),
                                          err_msg=str(path))
        assert len(list(_leaves(shards[i]))) == len(list(_leaves(want[i])))


def _refusal_engine(weights, extra=None, cfg_kw=None, spec=None):
    *_, cfg, tparams = weights
    if cfg_kw:
        cfg = cfg.__class__(**{**cfg.__dict__, **cfg_kw})
    mesh = tmesh.build_mesh(spec or tmesh.MeshSpec(tp=2), [CPU] * 4)
    return tengine.Engine(cfg, [tparams] * mesh.size, tengine.EngineConfig(
        **{**GEOMETRY, **(extra or {})}), mesh=mesh)


@pytest.mark.parametrize("extra,cfg_kw,spec,item", [
    (dict(enable_spec_decode=True), None, None, "speculation on a mesh"),
    (dict(host_pool_bytes=1 << 20), None, None,
     "host tier and tiered context on a mesh"),
    (dict(host_pool_bytes=1 << 20, ctx_hot_pages=4), None, None,
     "host tier and tiered context on a mesh"),
    (dict(adapter_pool_slots=4), None, None, "adapters on a mesh"),
    (None, dict(num_experts=4), tmesh.MeshSpec(pp=2, tp=2),
     "dp / fsdp / pp / sp"),
    (None, dict(mrope_sections=(2, 3, 3)), None, "vision on a mesh"),
    (None, None, tmesh.MeshSpec(dp=2, tp=2), "dp / fsdp / pp / sp"),
    (None, None, tmesh.MeshSpec(sp=2), "dp / fsdp / pp / sp"),
])
def test_mesh_engine_refusals(weights, extra, cfg_kw, spec, item):
    with pytest.raises(NotImplementedError, match="ROADMAP A15b: " + item):
        _refusal_engine(weights, extra, cfg_kw, spec)


def test_export_import_refused_on_a_mesh(weights):
    eng = _port_engine(weights, 2)
    eng.generate([[1, 2, 3]], tsampling.SamplingParams(max_tokens=2))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A15b: export / import on a mesh"):
        eng.export_request("r")
    with pytest.raises(NotImplementedError, match="export / import"):
        eng.import_request(None)


@pytest.mark.parametrize("entry,text", [
    ({"name": "vl", "kind": "vision", "mesh": {"tp": 2}},
     "ROADMAP A15b: vision on a mesh"),
    ({"name": "m", "adapter": "/ckpt", "mesh": {"tp": 2}},
     "ROADMAP A15b: adapters on a mesh"),
    ({"name": "m", "mesh": {"tp": 2},
      "engine": {"enable_spec_decode": True}},
     "ROADMAP A15b: speculation on a mesh"),
    ({"name": "m", "mesh": {"tp": 2, "pp": 2}},
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    ({"name": "m", "mesh": {"tp": 3}}, "do not divide over tp 3"),
])
def test_profile_mesh_refusals_by_name(entry, text):
    """A profile entry the port cannot serve on a mesh is refused before
    anything is built, naming its ROADMAP item."""
    prof = ServingProfile.from_dict({"name": "p", "models": [entry]})
    with pytest.raises(NotImplementedError, match=text.replace(
            "/", "/")):
        cli.model_specs(prof)


def test_profile_asking_too_many_devices_fails_with_reference_text():
    """A tp 4 entry on a node with 2 devices: the apply fails with the
    reference's ``slice_devices`` text, nothing built."""
    agent = NodeAgent("n1", device="cpu", devices=[CPU] * 2,
                      random_weights=True, warmup=False)
    prof = ServingProfile.from_dict({
        "name": "p", "requirement": {"chips": 4}, "models": [
        {"name": "chat", "mesh": {"tp": 4}, "engine": dict(NODE_ECFG),
         "model_overrides": dict(HEADS)}]})
    try:
        state = agent.apply_profile(prof)
        assert state.status == "failed"
        assert ("MeshSpec wants devices [0, 4) but only 2 devices are "
                "visible") in state.error
        assert agent.registry.names() == []
    finally:
        agent.stop()
