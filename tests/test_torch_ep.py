"""Mixture-of-experts on a mesh and expert parallel: the port's ``{ep, tp}``
meshes against the reference's, on the CPU.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port's meshes are lists of CPU devices, one shard per entry.  The
tiny MoE config has 8 experts (top 2), 8 query and 4 KV heads and 2
layers, so ``{ep: 4, tp: 2}`` (``profiles/v5e8-mixtral.yaml``'s layout),
``{ep: 4}`` and ``{ep: 2, tp: 2}`` divide it.

- ``Mesh.coords`` / ``Mesh.groups`` against the reference mesh's device
  array, and the group sums: bit-equal within a group, one rounding;
- ``shard_params`` (and the random build drawn into its shards) byte-equal
  to the reference's ``addressable_shards`` at the three layouts, float
  and int8 (``quantized_logical_axes``), the KV pool over ``cache_heads``
  replicated over ``ep``;
- float32 logits of ``forward_sharded`` within 1e-5 of the reference's
  forward on its sharded params and of the port's single device, drop
  counts equal, with every routed token's k-th / (k+1)-th router gap
  above ``ROUTER_GAP_MIN`` (no top-k rides on a near tie);
- greedy tokens and drop counts of the port's ``Engine(mesh={ep: 4, tp:
  2})`` equal to the reference's ``Engine(mesh=...)`` and to the port's
  single device, over packed prompts, a chunked long prompt beside
  decode, and a prefix hit;
- a dense config on an ep mesh, served replicated over ``ep``;
- the node agent applying ``{ep: 4, tp: 2}`` with the expert axis split
  4 ways, and refusing a slice past its devices with the reference's
  text;
- a 2-layer Mixtral-named checkpoint loaded onto the mesh byte-equal to
  ``shard_params`` of the whole load;
- every refusal that remains on a mesh, by name.
"""

import dataclasses

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
from helix_tpu_torch.engine.residency import served_model_bytes
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.models import moe as tmoe
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.ops.quant import quantize_params as tquantize
from helix_tpu_torch.ops.quant import quantized_logical_axes as tq_axes
from helix_tpu_torch.parallel import collectives, sharding as tsharding

CPU = torch.device("cpu")
MOE = dict(num_heads=8, num_kv_heads=4, num_experts=8,
           num_experts_per_tok=2, num_layers=2)
LAYOUTS = [dict(ep=4, tp=2), dict(ep=4), dict(ep=2, tp=2)]
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=16, max_prefill_len=16)
LOGIT_ATOL = 1e-5
# the least k-th / (k+1)-th router logit gap allowed: the float32 sums
# of the two libraries (and of one device against the mesh) differ by
# ~1e-7 on these widths
ROUTER_GAP_MIN = 1e-4
# a capacity factor low enough that prefills drop assignments
FACTOR = 0.5
N_TOK = 6


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


def _cfgs(**over):
    kw = dict(MOE, dtype="float32", expert_capacity_factor=FACTOR, **over)
    return JModelConfig.tiny(**kw), ModelConfig.tiny(**kw)


@pytest.fixture(scope="module")
def weights():
    """A tiny MoE model (float32, seed 11), both trees."""
    jcfg, cfg = _cfgs()
    tp = tllama.init_params(cfg, 11, device="cpu")
    return jcfg, jax.tree.map(_to_jax, tp), cfg, tp


@pytest.fixture()
def router_gaps(monkeypatch):
    """The least (k-th - (k+1)-th) router logit of every call the port
    routes while the fixture is live."""
    gaps = []
    top_k = tmoe.top_k_lower_index

    def spy(logits, k):
        srt = torch.sort(logits, dim=-1, descending=True).values
        gaps.append(float((srt[..., k - 1] - srt[..., k]).min()))
        return top_k(logits, k)

    monkeypatch.setattr(tmoe, "top_k_lower_index", spy)
    return gaps


def _gap_ok(gaps):
    assert gaps and min(gaps) > ROUTER_GAP_MIN, min(gaps or [0.0])


def _tmesh(spec, n=8):
    return tmesh.build_mesh(tmesh.MeshSpec(**spec), [CPU] * n)


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


def _bytes(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _same_trees(got: list, want: list) -> None:
    for g, w in zip(got, want, strict=True):
        gl, wl = dict(_leaves(g)), dict(_leaves(w))
        assert gl.keys() == wl.keys()
        for path, t in wl.items():
            assert gl[path].dtype == t.dtype and gl[path].shape == t.shape
            np.testing.assert_array_equal(_bytes(gl[path]), _bytes(t),
                                          err_msg=str(path))


# ---------------------------------------------------------------------------
# the mesh and its sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", LAYOUTS)
def test_coords_and_groups_follow_the_reference_mesh(spec):
    """A shard's coordinates are its place in the reference mesh's device
    array; a tp group is a row of it (the other axes fixed), the whole
    mesh one group."""
    jm = jmesh.build_mesh(jmesh.MeshSpec(**spec))
    tm = _tmesh(spec)
    ids = [d.id for d in jm.devices.flat]
    assert list(tm.device_ids) == ids
    for i in range(tm.size):
        c = tm.coords(i)
        at = tuple(c[a] for a in jm.axis_names)
        assert jm.devices[at].id == ids[i]
    tp = tm.shape["tp"]
    assert tm.groups(("tp",)) == [list(range(g, g + tp))
                                  for g in range(0, tm.size, tp)]
    assert tm.groups(tmesh.AXIS_ORDER) == [list(range(tm.size))]
    assert tm.groups(("ep",)) == [list(range(t, tm.size, tp))
                                  for t in range(tp)]


def test_group_sums_round_once_and_agree_within_groups():
    """``all_reduce_groups`` over ``{ep: 4, tp: 2}``'s tp groups: each
    group's float32 partials summed in shard order and rounded once to
    bf16, the same bits on both of its shards; groups with equal partials
    give equal bits; the whole-mesh sum of eight shares is one rounding
    of their float32 sum."""
    mesh = _tmesh(dict(ep=4, tp=2))
    rng = np.random.default_rng(3)
    pair = [torch.from_numpy(rng.standard_normal((16, 64)).astype(
        np.float32)) for _ in range(2)]
    parts = pair * 4
    got = collectives.all_reduce_groups(parts, mesh.devices,
                                        mesh.groups(("tp",)),
                                        torch.bfloat16)
    once = (pair[0] + pair[1]).bfloat16()
    assert (once != pair[0].bfloat16() + pair[1].bfloat16()).any()
    assert all(torch.equal(g, once) for g in got)
    shares = [torch.from_numpy(rng.standard_normal((16, 64)).astype(
        np.float32)) for _ in range(8)]
    whole = collectives.all_reduce(shares, mesh.devices, torch.bfloat16)
    acc = shares[0].clone()
    for s in shares[1:]:
        acc += s
    assert all(torch.equal(w, acc.bfloat16()) for w in whole)
    with pytest.raises(ValueError, match="do not cover"):
        collectives.all_reduce_groups(parts, mesh.devices, [[0, 1]],
                                      torch.float32)


# ---------------------------------------------------------------------------
# shards byte-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", LAYOUTS)
@pytest.mark.parametrize("int8", [False, True])
def test_shard_params_byte_equal_reference(spec, int8):
    """Expert stacks cut over ``ep`` on X and ``tp`` on F (``w_down`` on
    its F input axis), their int8 scales whole over X and cut with their
    columns, the router whole: every leaf of every shard byte-equal to
    the reference's ``addressable_shards``; the random build drawn into
    its shards (``init_params(mesh=)``) equals ``shard_params`` of the
    whole build."""
    jcfg = JModelConfig.tiny(dtype="bfloat16", **MOE)
    tcfg = ModelConfig.tiny(dtype="bfloat16", **MOE)
    full = tllama.init_params(tcfg, 3, device="cpu")
    jp = jax.tree.map(_to_jax, full)
    jm = jmesh.build_mesh(jmesh.MeshSpec(**spec))
    axes_j = jllama.param_logical_axes(jcfg)
    axes_t = tllama.param_logical_axes(tcfg)
    assert axes_t == axes_j
    sharded = jsharding.shard_params(jp, jm, axes_j)
    if int8:
        out_sh = jsharding.sharding_tree(jm, jq_axes(axes_j))
        sharded = jax.jit(jquantize, out_shardings=out_sh)(sharded)
        full = tllama.params_from_jax(jax.device_get(sharded))
        axes_t = tq_axes(axes_t)
        assert axes_t == jq_axes(axes_j)
    mesh = _tmesh(spec)
    shards = tsharding.shard_params(full, mesh, axes_t)
    n = 0
    for path, arr in _leaves(sharded):
        for i in range(mesh.size):
            got = _get(shards[i], path)
            want = _shard_of(arr, jm, i)
            assert got.is_contiguous() and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(_bytes(got), want.view(
                _bytes(got).dtype), err_msg=str(path))
            n += 1
    assert n == mesh.size * len(list(_leaves(full)))
    w = shards[-1]["layers"]["experts"]["w_gate"]["weight"]
    assert w.shape[1] == 8 // spec["ep"]
    assert w.shape[3] == tcfg.intermediate_size // spec.get("tp", 1)
    q = "int8" if int8 else None
    drawn = tllama.init_params(tcfg, 5, mesh=mesh, quantization=q)
    whole = tllama.init_params(tcfg, 5, device="cpu", quantization=q)
    _same_trees(drawn, tsharding.shard_params(whole, mesh, axes_t))


def test_pool_over_cache_heads_replicated_over_ep():
    """The KV pool and its scales at ``{ep: 4, tp: 2}``: cut over
    ``cache_heads`` by ``tp``, the same block on every ep replica, as the
    reference places them; the engine holds one pool per shard."""
    rng = np.random.default_rng(1)
    pool = rng.integers(-127, 128, (2, 16, 4, 4, 16), dtype=np.int8)
    scale = rng.random((2, 16, 4, 4), dtype=np.float32)
    spec = dict(ep=4, tp=2)
    jm = jmesh.build_mesh(jmesh.MeshSpec(**spec))
    mesh = _tmesh(spec)
    for arr, axes in ((pool, tsharding.POOL_AXES),
                      (scale, tsharding.POOL_SCALE_AXES)):
        jarr = jax.device_put(arr, jsharding.logical_sharding(jm, axes))
        for i in range(8):
            got = tsharding.shard_tensor(torch.from_numpy(arr), axes, mesh, i)
            np.testing.assert_array_equal(got.numpy(), _shard_of(jarr, jm, i))
            assert torch.equal(got, tsharding.shard_tensor(
                torch.from_numpy(arr), axes, mesh, i % 2))


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


def _t_attn(seg):
    def attn(q, k, v, carry, p):
        return tllama.prefill_attn_fn(q, k, v, None, p,
                                      segment_ids=seg), carry[0]
    return attn


@pytest.mark.parametrize("spec,int8", [(dict(ep=4, tp=2), False),
                                       (dict(ep=4), False),
                                       (dict(ep=2, tp=2), True)])
def test_sharded_logits_match_reference_and_tp1(weights, router_gaps, spec,
                                                int8):
    """float32 logits of ``forward_sharded`` (a masked token, capacity
    drops) within 1e-5 of the reference's forward on params sharded over
    its mesh and of the port's single-device forward; the drop count,
    counted once, equal to both."""
    jcfg, jp, cfg, tparams = weights
    if int8:
        # the port's quantize_params, byte-equal to the reference's
        # (tests/test_torch_moe.py), handed to the reference
        tparams = tquantize(tparams)
        jp = jax.tree.map(_to_jax, tparams)
    rng = np.random.default_rng(2)
    tok = rng.integers(1, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    mask = np.ones((2, 11), bool)
    mask[1, 8:] = False
    jm = jmesh.build_mesh(jmesh.MeshSpec(**spec))
    axes = jllama.param_logical_axes(jcfg)
    if int8:
        axes = jq_axes(axes)
    jlog, _, jstats = jllama.forward(
        jsharding.shard_params(jp, jm, axes), jcfg, tok, pos,
        attn_fn=lambda q, k, v, c, p: jllama.prefill_attn_fn(
            q, k, v, c, p, backend="reference"),
        moe_token_mask=jnp.asarray(mask), return_moe_stats=True)
    mesh = _tmesh(spec)
    shards = tsharding.shard_params(tparams, mesh, tq_axes(
        tllama.param_logical_axes(cfg)) if int8 else
        tllama.param_logical_axes(cfg))
    seg = torch.ones((2, 11), dtype=torch.int32)
    tlog, caches, stats = tllama.forward_sharded(
        shards, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
        attn_fns=[_t_attn(seg)] * mesh.size,
        carry_caches=[None] * mesh.size, mesh=mesh,
        moe_token_mask=torch.from_numpy(mask), return_moe_stats=True)
    one, _, one_stats = tllama.forward(
        tparams, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
        attn_fn=tllama.prefill_attn_fn,
        moe_token_mask=torch.from_numpy(mask), return_moe_stats=True)
    assert tlog.dtype == torch.float32 and caches == [None] * mesh.size
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tlog.numpy(), one.numpy(), atol=LOGIT_ATOL,
                               rtol=0)
    assert int(stats["dropped"]) == int(jstats["dropped"]) \
        == int(one_stats["dropped"]) > 0
    _gap_ok(router_gaps)


def test_moe_shares_sum_to_moe_ffn_and_route_alike():
    """``moe_ffn_shard`` over ``{ep: 4, tp: 2}``: every shard's routing is
    the same (positions, kept slots, drops), a choice whose expert lives
    elsewhere adds an exact zero, and the eight float32 shares sum to
    ``moe_ffn``'s output within 1e-6 (bf16 input, float32 compute)."""
    _, cfg = _cfgs(hidden_size=64, intermediate_size=128)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 9, 64), generator=gen)
    router = torch.randn((64, 8), generator=gen)
    experts = {n: {"weight": torch.randn(s, generator=gen) * 0.05}
               for n, s in (("w_gate", (8, 64, 128)), ("w_up", (8, 64, 128)),
                            ("w_down", (8, 128, 64)))}
    act = torch.nn.functional.silu
    want, dropped = tmoe.moe_ffn(x, router, experts, cfg, act,
                                 return_dropped=True)
    mesh = _tmesh(dict(ep=4, tp=2))
    axes = {"w_gate": {"weight": ("expert", "embed", "mlp")},
            "w_up": {"weight": ("expert", "embed", "mlp")},
            "w_down": {"weight": ("expert", "mlp", "embed")}}
    shards = tsharding.shard_params(experts, mesh, axes)
    shares, routes = [], []
    for i, sh in enumerate(shards):
        share, d = tmoe.moe_ffn_shard(x, router, sh, cfg, act,
                                      mesh.coords(i)["ep"])
        assert int(d) == int(dropped) > 0
        shares.append(share)
        routes.append(tmoe.route(x.reshape(18, 64), router, cfg, 9))
    for r in routes[1:]:
        for a, b in zip(r[:4], routes[0][:4]):
            assert torch.equal(a, b)
    got = collectives.all_reduce(shares, mesh.devices, torch.float32)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # an ep replica's two shards hold no assignment of another replica
    held = torch.stack([s.abs().sum(-1) > 0 for s in shares[::2]])
    assert held.sum(0).max() <= 2 and held.any()


# ---------------------------------------------------------------------------
# engines: the port's {ep: 4, tp: 2} against the reference's mesh engine
# ---------------------------------------------------------------------------

SHORT = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 14], [7, 3, 9, 2]]
LONG = [(5 * i) % 23 + 1 for i in range(40)]     # 3 chunks of <= 16


def _scenario(eng, mod, smod):
    """Packed prompts with a seeded sampled request, then a long prompt
    chunked while a short one decodes (mixed steps), then the long prompt
    again (a chunked prefix-cache hit).  Returns every request's tokens,
    the engine's drop count and its counts of mixed steps and prefix
    hits."""
    def req(rid, prompt, **samp):
        return mod.Request(id=rid, prompt_tokens=list(prompt),
                           sampling=smod.SamplingParams(
                               max_tokens=N_TOK,
                               **{"temperature": 0.0, **samp}))

    def run(reqs):
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
    eng._drain_moe_drops()
    return (out, eng.moe_dropped_tokens, eng.num_mixed_steps,
            eng.prefix_cache_hits)


def _port_engine(weights, spec, cfg=None, params=None):
    *_, tcfg, tparams = weights
    cfg, params = cfg or tcfg, params or tparams
    ecfg = tengine.EngineConfig(**GEOMETRY)
    if spec is None:
        return tengine.Engine(cfg, params, ecfg, device="cpu")
    mesh = _tmesh(spec)
    return tengine.Engine(cfg, tsharding.shard_params(
        params, mesh, tllama.param_logical_axes(cfg)), ecfg, mesh=mesh)


@pytest.fixture(scope="module")
def port_runs(weights):
    return {spec: _scenario(_port_engine(
        weights, dict(spec) if spec else None), tengine, tsampling)
        for spec in (None, (("ep", 4), ("tp", 2)))}


def test_engine_tokens_and_drops_equal_reference_mesh_engine(weights,
                                                             port_runs):
    """The reference's ``Engine(mesh={ep: 4, tp: 2})`` (float32, its
    reference attention) gives the port's tokens and drop count; the
    scenario drops assignments and reaches chunking, the mixed step and
    the prefix cache."""
    jcfg, jp, _, _ = weights
    jm = jmesh.build_mesh(jmesh.MeshSpec(ep=4, tp=2))
    je = jengine.Engine(jcfg, jsharding.shard_params(
        jp, jm, jllama.param_logical_axes(jcfg)), jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference"), mesh=jm)
    want = _scenario(je, jengine, jsampling)
    assert port_runs[(("ep", 4), ("tp", 2))] == want
    toks, drops, mixed, hits = want
    assert drops > 0 and mixed > 0 and hits >= 1


def test_engine_on_ep_mesh_equals_single_device(port_runs):
    """The port's ``{ep: 4, tp: 2}`` engine gives its single-device
    engine's tokens (greedy and seeded) and drop count."""
    assert port_runs[(("ep", 4), ("tp", 2))] == port_runs[None]


def test_engine_mesh_bookkeeping(weights, router_gaps):
    """One pool per shard holding its tp group's KV heads (equal across
    ep replicas), K1 / K2 forwards counted once per forward as on one
    device, the drop queue counted once per call."""
    *_, cfg, tparams = weights
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    s = tsampling.SamplingParams(temperature=0.0, max_tokens=4)
    one = _port_engine(weights, None)
    ep = _port_engine(weights, dict(ep=4, tp=2))
    assert ep.generate(prompts, s) == one.generate(prompts, s)
    one._drain_moe_drops()
    ep._drain_moe_drops()
    assert ep.moe_dropped_tokens == one.moe_dropped_tokens > 0
    assert ep.attn_forwards == one.attn_forwards
    assert len(ep.caches) == 8
    for i, c in enumerate(ep.caches):
        assert c.k_pages.shape[3] == 2
        assert torch.equal(c.k_pages, ep.caches[i % 2].k_pages)
        np.testing.assert_allclose(
            c.v_pages.numpy(),
            one.caches[0].v_pages[:, :, :, 2 * (i % 2):2 * (i % 2) + 2]
            .numpy(), atol=1e-5, rtol=0)
    _gap_ok(router_gaps)


def test_dense_config_on_an_ep_mesh_is_replicated(weights):
    """A dense config on ``{ep: 2, tp: 2}``: its weights replicated over
    ``ep``, its tokens those of the single device."""
    cfg = ModelConfig.tiny(dtype="float32", num_heads=8, num_kv_heads=4)
    params = tllama.init_params(cfg, 4, device="cpu")
    prompts = [[1, 2, 3, 4, 5], LONG[:21]]
    s = tsampling.SamplingParams(temperature=0.0, max_tokens=6)
    want = _port_engine(weights, None, cfg, params).generate(prompts, s)
    eng = _port_engine(weights, dict(ep=2, tp=2), cfg, params)
    assert eng.generate(prompts, s) == want
    for path, t in _leaves(eng.params[0]):
        assert torch.equal(t, _get(eng.params[2], path)), path


# ---------------------------------------------------------------------------
# the node agent, the loader and the refusals
# ---------------------------------------------------------------------------

NODE_ECFG = dict(max_decode_batch=2, page_size=16, num_pages=64,
                 max_pages_per_seq=8, max_prefill_len=32)


def _moe_profile(chips=8, **mesh):
    return ServingProfile.from_dict({
        "name": "ep-moe", "requirement": {"chips": chips}, "models": [
            {"name": "tiny-moe", "mesh": mesh or {"ep": 4, "tp": 2},
             "quantization": "int8", "engine": dict(NODE_ECFG),
             "model_overrides": {k: MOE[k] for k in (
                 "num_heads", "num_kv_heads", "num_experts",
                 "num_experts_per_tok")}}]})


def test_node_agent_applies_ep_moe_profile():
    """The v5e8-mixtral layout ``{ep: 4, tp: 2}`` (the reference's
    ``test_node_agent_applies_ep_moe_profile``) through the port's agent
    over 8 devices: the expert stacks split 4 ways over ``ep`` and their
    columns 2 ways, the footprint counts every shard, the engine
    decodes; on 4 devices the apply fails with the reference's text."""
    agent = NodeAgent("n-moe", device="cpu", devices=[CPU] * 8,
                      random_weights=True, warmup=False)
    try:
        state = agent.apply_profile(_moe_profile())
        assert state.status == "running", state.error
        served = agent.registry.get("tiny-moe")
        eng = served.loop.engine
        assert eng.mesh.shape["ep"] == 4 and eng.mesh.shape["tp"] == 2
        X = eng.model_cfg.num_experts
        F = eng.model_cfg.intermediate_size
        for tree in eng.params:
            w = tree["layers"]["experts"]["w_gate"]["weight"]
            assert w.dtype == torch.int8
            assert w.shape[1] == X // 4 and w.shape[3] == F // 2
        want = sum(t.numel() * t.element_size()
                   for tree in eng.params for _p, t in _leaves(tree))
        want += sum(t.numel() * t.element_size()
                    for c in eng.caches for t in c.carry())
        assert served_model_bytes(served, headroom=0) == want
        loop = served.loop
        loop.stop(join=True)
        out = eng.generate([[7, 8, 9, 10]], tsampling.SamplingParams(
            temperature=0.0, max_tokens=3))
        assert len(out[0]) == 3
    finally:
        agent.stop()
    agent = NodeAgent("n-few", device="cpu", devices=[CPU] * 4,
                      random_weights=True, warmup=False)
    try:
        state = agent.apply_profile(_moe_profile())
        assert state.status == "failed"
        assert ("MeshSpec wants devices [0, 8) but only 4 devices are "
                "visible") in state.error
        assert agent.registry.names() == []
    finally:
        agent.stop()


@pytest.mark.parametrize("q", [None, "int8"])
def test_mixtral_checkpoint_loads_onto_the_mesh(tmp_path, q):
    """``load_params(..., mesh={ep: 4, tp: 2})`` of a 2-layer checkpoint in
    Mixtral's ``block_sparse_moe`` names: each shard's tree equals
    ``shard_params`` of the whole load byte for byte (an expert's rows
    reach only its ep replica's shards; int8 quantized over the whole
    input axis before the row-parallel cut)."""
    from helix_tpu_torch.models import loader as tloader
    from helix_tpu_torch.testing.hf_checkpoint import write_checkpoint

    cfg = ModelConfig.tiny(dtype="bfloat16", **MOE)
    params = tllama.init_params(cfg, 9, device="cpu")
    write_checkpoint(str(tmp_path), cfg, params, model_type="mixtral",
                     max_shard_bytes=60_000)
    lcfg, whole = tloader.load_params(str(tmp_path), device="cpu",
                                      quantization=q)
    assert lcfg.num_experts == 8
    mesh = _tmesh(dict(ep=4, tp=2))
    _, shards = tloader.load_params(str(tmp_path), device="cpu",
                                    quantization=q, mesh=mesh)
    axes = tllama.param_logical_axes(lcfg)
    if q:
        axes = tq_axes(axes)
    _same_trees(shards, tsharding.shard_params(whole, mesh, axes))


def _refusal_engine(weights, extra=None, cfg_kw=None, spec=None):
    *_, cfg, tparams = weights
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    mesh = tmesh.build_mesh(spec or tmesh.MeshSpec(ep=4, tp=2), [CPU] * 8)
    return tengine.Engine(cfg, [tparams] * mesh.size, tengine.EngineConfig(
        **{**GEOMETRY, **(extra or {})}), mesh=mesh)


@pytest.mark.parametrize("extra,cfg_kw,spec,item", [
    (dict(host_pool_bytes=1 << 20), None, None,
     "ROADMAP A15b: host tier and tiered context on a mesh"),
    (dict(host_pool_bytes=1 << 20, ctx_hot_pages=4), None, None,
     "tiered context on a mesh is not ported"),
    (dict(adapter_pool_slots=4), None, None,
     "ROADMAP A15b: adapters on a mesh"),
    (dict(enable_spec_decode=True), dict(num_experts=0), None,
     "ROADMAP A15b: speculation on a mesh"),
    (None, dict(mrope_sections=(2, 3, 3)), None,
     "ROADMAP A15b: vision on a mesh"),
    (None, None, tmesh.MeshSpec(dp=2, ep=2, tp=2),
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    (None, None, tmesh.MeshSpec(pp=2, ep=4),
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    (None, None, tmesh.MeshSpec(fsdp=2, ep=4),
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    (None, None, tmesh.MeshSpec(sp=2, ep=2, tp=2),
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    (None, dict(num_experts=6), tmesh.MeshSpec(ep=4, tp=2),
     "6 experts do not divide over ep 4"),
])
def test_mesh_engine_refusals_by_name(weights, extra, cfg_kw, spec, item):
    with pytest.raises(NotImplementedError, match=item):
        _refusal_engine(weights, extra, cfg_kw, spec)


def test_export_import_and_speculation_on_an_ep_mesh(weights, caplog):
    """Export / import stay refused on an ep mesh; speculation on an MoE
    model is logged off there as on one device (no verify step)."""
    import logging

    with caplog.at_level(logging.WARNING):
        eng = _refusal_engine(weights, dict(enable_spec_decode=True,
                                            spec_tokens=3))
    assert eng.spec is None
    assert any("not supported for MoE models" in r.getMessage()
               for r in caplog.records)
    eng.params = tsharding.shard_params(
        weights[3], eng.mesh, tllama.param_logical_axes(weights[2]))
    eng.generate([[1, 2, 3]], tsampling.SamplingParams(max_tokens=2))
    assert eng.num_spec_steps == 0
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A15b: export / import on a mesh"):
        eng.export_request("r")
    with pytest.raises(NotImplementedError, match="export / import"):
        eng.import_request(None)


@pytest.mark.parametrize("entry,text", [
    ({"name": "vl", "kind": "vision", "mesh": {"ep": 2, "tp": 2}},
     "ROADMAP A15b: vision on a mesh"),
    ({"name": "m", "adapter": "/ckpt", "mesh": {"ep": 2, "tp": 2}},
     "ROADMAP A15b: adapters on a mesh"),
    ({"name": "m", "mesh": {"ep": 2, "tp": 2},
      "engine": {"enable_spec_decode": True}},
     "ROADMAP A15b: speculation on a mesh"),
    ({"name": "m", "mesh": {"ep": 2, "dp": 2}},
     "ROADMAP A15b: dp / fsdp / pp / sp"),
    ({"name": "m", "mesh": {"ep": 3},
      "model_overrides": {"num_experts": 4}},
     "4 experts do not divide over ep 3"),
])
def test_profile_mesh_refusals_by_name(entry, text):
    """A profile entry the port cannot serve on an ep mesh is refused
    before anything is built, naming its ROADMAP item; the v5e8-mixtral
    entry's own layout is not."""
    prof = ServingProfile.from_dict({"name": "p", "models": [entry]})
    with pytest.raises(NotImplementedError, match=text):
        cli.model_specs(prof)
    (spec,) = cli.model_specs(_moe_profile(), random_weights=True)
    assert spec["mesh"]["ep"] == 4 and spec["mesh"]["tp"] == 2


def test_sharded_random_moe_build_never_holds_the_whole_model(monkeypatch):
    """``cli.init_sharded`` of an int8 MoE config: no tensor larger than
    one layer of an expert stack is made on the mesh's first device
    beside the shards (the build draws a layer at a time), and the shards
    are ``quantize_params`` of the float build, sharded."""
    cfg = ModelConfig.tiny(dtype="bfloat16", **MOE)
    mesh = _tmesh(dict(ep=4, tp=2))
    L, X, E, F = (cfg.num_layers, cfg.num_experts, cfg.hidden_size,
                  cfg.intermediate_size)
    largest = []
    real = torch.randn

    def randn(shape, *a, **kw):
        largest.append(int(np.prod(shape)))
        return real(shape, *a, **kw)

    monkeypatch.setattr(torch, "randn", randn)
    shards = cli.init_sharded(cfg, 6, mesh, "int8")
    monkeypatch.setattr(torch, "randn", real)
    assert max(largest) <= max(X * E * F, cfg.vocab_size * E)
    assert max(largest) < L * X * E * F
    whole = tquantize(tllama.init_params(cfg, 6, device="cpu"))
    _same_trees(shards, tsharding.shard_params(
        whole, mesh, tq_axes(tllama.param_logical_axes(cfg))))
