"""Multi-LoRA adapter serving in the port: ``helix_tpu_torch.engine.adapters``
and the pool form of ``ops.quant.maybe_dequant_dense`` against
``helix_tpu.engine.adapters`` and ``helix_tpu.ops.quant``, and the port's
engine against the JAX ``Engine`` (reference attention) on the CPU.

Inputs come from numpy seeds.  Tolerances: op outputs within 1e-6 in
float32 and one bf16 ulp in bfloat16; greedy tokens identical in float32.

- ops: the pool form, the single-LoRA form, int8 weights with the pool,
  bias, and the identity slot's exact zero;
- addressing: ``sanitize_adapter_id`` / ``split_model_adapter`` on hostile
  ids; ``_spec_checksum`` byte-equal; filestore blobs read across the two
  packages, a corrupt blob a miss;
- the pool: one scripted acquire / release / republish series through
  both pools gives the same slots, loads and evictions;
- the engine: the reference's ``TestBatchedAdapters`` cases (adapter-free
  bit-identity with the pool on, a mixed wave in one device call per
  step, a cold adapter's prefetch that never blocks, eviction churn,
  republish, the one-slot degrade), chunked prefill, verify rows and
  preempt / resume with adapter rows;
- the prefix-cache fault of the reference (ROADMAP C): its adapter rows
  reuse pages the base model prefilled; the port's do not;
- the wire: hostile adapter ids are refused with the reference's typed
  error, and a sanitised one survives export, import and resume.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import adapters as jad
from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.engine.kv_cache import PrefixCache as JPrefixCache
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.ops import quant as jquant
from helix_tpu.serving import migration as jmigration
from helix_tpu_torch.engine import adapters as tad
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.ops import quant as tquant
from helix_tpu_torch.serving import migration as tmigration

# identity + 2 usable slots: two adapters and adapter-free rows share a
# call, and a third adapter reaches eviction
POOL_ECFG = dict(max_decode_batch=3, page_size=16, num_pages=64,
                 max_pages_per_seq=8, max_prefill_len=64,
                 adapter_pool_slots=3, adapter_rank=4)
TARGETS = ("wq", "wk", "wv", "wo")
N_TOK = 6


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first (the JAX
    engine's asynchronous host-mirror upload, ROADMAP queue C)."""

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


@pytest.fixture(autouse=True)
def _no_filestore(monkeypatch):
    monkeypatch.delenv("HELIX_FILESTORE_KV_DIR", raising=False)
    monkeypatch.delenv("HELIX_ADAPTER_PREFETCH", raising=False)


@pytest.fixture(scope="module")
def base():
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(dtype="float32"), tp


def _lora(cfg, seed, rank=4, targets=TARGETS):
    """An adapter with nonzero ``b`` (a fresh LoRA is the identity), from
    a numpy seed: ``{target: {lora_a [L, in, r], lora_b [L, r, out]}}``."""
    rng = np.random.default_rng(seed)
    dims = tad.target_dims(cfg)
    out = {}
    for t in targets:
        fan_in, fan_out = dims[t]
        out[t] = {
            "lora_a": (rng.standard_normal((cfg.num_layers, fan_in, rank))
                       / np.sqrt(fan_in)).astype(np.float32),
            "lora_b": (rng.standard_normal((cfg.num_layers, rank, fan_out))
                       * 0.05).astype(np.float32),
        }
    return out


def _merged(tp, lora, scale):
    """The port's params with ``w + scale * a @ b`` folded into every
    targeted projection: a plain float32 merge, the numerical reference
    the pool is held to."""
    out = dict(tp)
    layers = dict(tp["layers"])
    for t, f in lora.items():
        w = layers[t]["weight"]
        delta = scale * np.einsum("lir,lro->lio", f["lora_a"], f["lora_b"])
        layers[t] = {**layers[t],
                     "weight": w + torch.from_numpy(delta).to(w.dtype)}
    out["layers"] = layers
    return out


def _jengine(base, **kw):
    jcfg, jp, _, _ = base
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, attn_backend="reference"))


def _tengine(base, params=None, **kw):
    _, _, cfg, tp = base
    return tengine.Engine(cfg, tp if params is None else params,
                          tengine.EngineConfig(**kw), device="cpu")


def _greedy_pair(n=N_TOK):
    return (jsampling.SamplingParams(temperature=0.0, max_tokens=n),
            tsampling.SamplingParams(temperature=0.0, max_tokens=n))


def _run(eng, mod, rid, prompt, sampling, adapter=""):
    req = mod.Request(id=rid, prompt_tokens=list(prompt), sampling=sampling,
                      adapter=adapter)
    eng.add_request(req)
    while eng.has_work():
        eng.step()
    return req


# ---------------------------------------------------------------------------
# the op: maybe_dequant_dense's LoRA forms
# ---------------------------------------------------------------------------


def _ulp_check(got, want, dtype):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        # one bf16 ulp of the reference value
        np.testing.assert_array_less(
            np.abs(got - want), 2.0 ** -7 * np.abs(want) + 1e-6)


def _jt(a, dtype):
    """A numpy array as (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _pool_case(dtype, seed, n_slots=4, rank=4, fan_in=48, fan_out=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, fan_in))
    w = rng.standard_normal((fan_in, fan_out)) * 0.1
    pa = rng.standard_normal((n_slots, fan_in, rank)) * 0.2
    pa[0] = 0.0
    pb = rng.standard_normal((n_slots, rank, fan_out)) * 0.2
    pb[0] = 0.0
    sc = np.array([0.0, 2.0, 0.5, 1.25][:n_slots], np.float32)
    ids = rng.integers(0, n_slots, size=(2, 7)).astype(np.int32)
    xj, xt = _jt(x, dtype)
    wj, wt = _jt(w, dtype)
    paj, pat = _jt(pa, dtype)
    pbj, pbt = _jt(pb, dtype)
    jp = {"weight": wj, "lora_pool_a": paj, "lora_pool_b": pbj,
          "lora_pool_scale": jnp.asarray(sc)}
    # the port stores a layer's a-stack [in, N, r]
    tp = {"weight": wt, "lora_pool_a": pat.permute(1, 0, 2).contiguous(),
          "lora_pool_b": pbt, "lora_pool_scale": torch.from_numpy(sc)}
    return xj, xt, jp, tp, jnp.asarray(ids), torch.from_numpy(ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_pool_form_matches_reference(dtype):
    xj, xt, jp, tp, idj, idt = _pool_case(dtype, 1)
    want = np.asarray(jquant.maybe_dequant_dense(xj, jp, adapter_ids=idj)
                      .astype(jnp.float32))
    got = tquant.maybe_dequant_dense(xt, tp, adapter_ids=idt)
    assert got.dtype == getattr(torch, dtype)
    _ulp_check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_single_lora_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32))
    xj, xt = _jt(x, dtype)
    wj, wt = _jt(rng.standard_normal((32, 24)) * 0.1, dtype)
    aj, at = _jt(rng.standard_normal((32, 4)) * 0.3, dtype)
    bj, bt = _jt(rng.standard_normal((4, 24)) * 0.3, dtype)
    bias_j, bias_t = _jt(rng.standard_normal((24,)) * 0.1, dtype)
    jp = {"weight": wj, "lora_a": aj, "lora_b": bj, "lora_scale": 1.5,
          "bias": bias_j}
    tp = {"weight": wt, "lora_a": at, "lora_b": bt, "lora_scale": 1.5,
          "bias": bias_t}
    want = np.asarray(jquant.maybe_dequant_dense(xj, jp)
                      .astype(jnp.float32))
    _ulp_check(tquant.maybe_dequant_dense(xt, tp), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_int8_with_pool_and_bias_matches_reference(dtype):
    """int8 weights (the reference's ``quantize_params`` codes and
    scales) under the pool, with a bias: scale, then the delta, then the
    bias, in float32, rounded once."""
    xj, xt, jp, tp, idj, idt = _pool_case(dtype, 3)
    rng = np.random.default_rng(4)
    q = jquant.quantize_params({"layers": {"wq": {"weight": jnp.asarray(
        rng.standard_normal((48, 40)) * 0.1, jnp.float32)}}})
    qw = q["layers"]["wq"]
    bias_j, bias_t = _jt(rng.standard_normal((40,)) * 0.1, dtype)
    jp = {**jp, "weight": qw["weight"], "scale": qw["scale"],
          "bias": bias_j}
    tp = {**tp, "weight": torch.from_numpy(np.array(qw["weight"])),
          "scale": torch.from_numpy(np.array(qw["scale"])),
          "bias": bias_t}
    want = np.asarray(jquant.maybe_dequant_dense(xj, jp, adapter_ids=idj)
                      .astype(jnp.float32))
    _ulp_check(tquant.maybe_dequant_dense(xt, tp, adapter_ids=idt), want,
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_slot_adds_exact_zero(dtype):
    """Rows of slot 0, and a pool-grafted projection called without
    adapter ids, equal the pool-less projection bit for bit."""
    _, xt, _, tp, _, _ = _pool_case(dtype, 5)
    plain = tquant.maybe_dequant_dense(xt, {"weight": tp["weight"]})
    zeros = torch.zeros(xt.shape[:-1], dtype=torch.int32)
    assert torch.equal(tquant.maybe_dequant_dense(xt, tp, adapter_ids=zeros),
                       plain)
    assert torch.equal(tquant.maybe_dequant_dense(xt, tp), plain)


# ---------------------------------------------------------------------------
# addressing, checksums, blobs
# ---------------------------------------------------------------------------

HOSTILE = [
    "", " ", "good", "also-good.v2", "a_b", "  padded  ", ".hidden", "..",
    "../../etc/passwd", "a/b", "a\\b", "x" * 64, "x" * 65, "__other__",
    "-lead", "ünï", "a b", "a@b", None, 7, ["a"], "a\nb", "0", "_x",
]


@pytest.mark.parametrize("value", HOSTILE, ids=range(len(HOSTILE)))
def test_sanitize_matches_reference(value):
    assert tad.sanitize_adapter_id(value) == jad.sanitize_adapter_id(value)


@pytest.mark.parametrize("name", [
    "m", "m@a1", "m@../x", "m@", "@a", "m@a@b", "org/model@tenant-1", None,
    "m@" + "x" * 65, "m@__other__"])
def test_split_model_adapter_matches_reference(name):
    assert tad.split_model_adapter(name) == jad.split_model_adapter(name)


def test_spec_checksum_byte_equal(base):
    _, _, cfg, _ = base
    lora = _lora(cfg, 11)
    t = tad.pack_lora_tree("a", lora, 2.0)
    j = jad.pack_lora_tree("a", lora, 2.0)
    assert tad._spec_checksum(t) == jad._spec_checksum(j)
    assert t.nbytes == j.nbytes and t.rank == j.rank == 4
    # torch factors pack to the same bytes
    tl = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in lora.items()}
    assert tad._spec_checksum(tad.pack_lora_tree("a", tl, 2.0)) == \
        jad._spec_checksum(j)


def _stores(cfg, root):
    dims = tad.target_dims(cfg)
    geo = ({t: dims[t] for t in TARGETS}, cfg.num_layers, 4)
    return (tad.AdapterStore("tiny", *geo, root_dir=root),
            jad.AdapterStore("tiny", *geo, root_dir=root))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_blobs_read_across_packages(base, tmp_path, writer):
    """A blob either package wrote is read by the other with the same
    factors and checksum; a corrupt blob is a miss, counted."""
    _, _, cfg, _ = base
    lora = _lora(cfg, 13)
    root = str(tmp_path / "adapters")
    t_w, j_w = _stores(cfg, root)
    w_mod, w_store = (tad, t_w) if writer == "port" else (jad, j_w)
    w_store.publish(w_mod.pack_lora_tree("blob1", lora, 1.5))
    t_r, j_r = _stores(cfg, root)
    r_store = j_r if writer == "port" else t_r
    spec = r_store.get("blob1")
    assert spec is not None and spec.scale == 1.5 and spec.rank == 4
    assert spec.checksum == tad._spec_checksum(spec)
    for t in TARGETS:
        np.testing.assert_array_equal(spec.targets[t]["a"], lora[t]["lora_a"])
        np.testing.assert_array_equal(spec.targets[t]["b"], lora[t]["lora_b"])
    assert r_store.ids() == ["blob1"] and r_store.load_errors == 0
    # flip one factor byte inside the archive: a miss, never weights
    path = os.path.join(root, "blob1.npz")
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["a__wq"][0, 0, 0] += 1.0
    np.savez(path, **arrays)
    t_c, j_c = _stores(cfg, root)
    for store in (t_c, j_c):
        assert store.get("blob1") is None and store.load_errors == 1


def test_publish_checkpoint_names_a18(base, tmp_path):
    """Publishing from a LoRA training checkpoint (ROADMAP A18): the
    port's ``publish_checkpoint`` of a checkpoint the port's trainer
    format holds gives the spec the reference packs from the same tree
    (checksum equal), at the checkpoint's scale (0 read as 1.0, an
    explicit scale first), and writes it through to a filestore blob the
    reference's store reads; a missing checkpoint is FileNotFoundError."""
    from helix_tpu_torch.training.checkpoint import save_checkpoint

    _, _, cfg, _ = base
    lora = _lora(cfg, 17)
    tree = {t: {n: torch.from_numpy(x) for n, x in f.items()}
            for t, f in lora.items()}
    root = str(tmp_path / "adapters")
    t_store, _ = _stores(cfg, root)
    for scaling, scale, want in ((1.5, None, 1.5), (0.0, None, 1.0),
                                 (1.5, 0.25, 0.25)):
        ckpt = str(tmp_path / f"ck{scaling}")
        save_checkpoint(ckpt, 4, tree, {"count": 4}, lora_scaling=scaling)
        spec = t_store.publish_checkpoint("sft", ckpt, scale)
        ref = jad.pack_lora_tree("sft", lora, want)
        assert spec.scale == want and spec.rank == ref.rank == 4
        assert spec.checksum == jad._spec_checksum(ref)
    _, j_read = _stores(cfg, root)
    got = j_read.get("sft")
    assert got is not None and got.checksum == spec.checksum
    with pytest.raises(FileNotFoundError):
        t_store.publish_checkpoint("a", str(tmp_path / "nope"))


def test_default_store_root_matches_reference(base, tmp_path, monkeypatch):
    jcfg, _, cfg, _ = base
    monkeypatch.setenv("HELIX_FILESTORE_KV_DIR", str(tmp_path))
    t = tad.default_adapter_store(cfg, tengine.EngineConfig(**POOL_ECFG))
    j = jad.default_adapter_store(jcfg, jengine.EngineConfig(**POOL_ECFG))
    assert (t.root, t.dims, t.num_layers, t.rank_cap, t.budget_bytes) == \
        (j.root, j.dims, j.num_layers, j.rank_cap, j.budget_bytes)
    assert t.root == os.path.join(str(tmp_path), "adapters", "tiny")


def test_target_dims_match_reference(base):
    from helix_tpu.training.lora import _target_dims

    jcfg, _, cfg, _ = base
    assert tad.target_dims(cfg) == _target_dims(jcfg)
    moe = dataclasses.replace(cfg, num_experts=4)
    assert tad.target_dims(moe) == _target_dims(
        dataclasses.replace(jcfg, num_experts=4))


# ---------------------------------------------------------------------------
# the pool: one scripted series through both
# ---------------------------------------------------------------------------


def _pool_series(mod, pool, store, cfg) -> list:
    """acquire / release / republish through one package's pool over its
    store; returns (call, result, resident ids, loads, evictions,
    version) per step."""
    specs = {f"a{i}": _lora(cfg, 40 + i) for i in range(1, 5)}
    for aid, lora in specs.items():
        store.publish(mod.pack_lora_tree(aid, lora, 2.0))

    def acq(aid):
        return pool.acquire(aid, store.get_resident,
                            generation=store.generation(aid))

    calls = [
        ("acquire", "a1"), ("acquire", "a2"), ("acquire", "a1"),
        ("acquire", "a3"), ("release", "a1"), ("acquire", "a3"),
        ("release", "a1"), ("acquire", "a3"), ("release", "a2"),
        ("acquire", "a4"), ("republish", "a3"), ("acquire", "a3"),
        ("release", "a3"), ("release", "a3"), ("acquire", "a3"),
        ("release", "a3"), ("release", "a4"), ("acquire", "a1"),
        ("acquire", "nope"),
    ]
    out = []
    for op, aid in calls:
        if op == "acquire":
            res = acq(aid)
        elif op == "release":
            res = pool.release(aid)
        else:
            res = store.publish(mod.pack_lora_tree(
                aid, _lora(cfg, 99), 0.5))
        st = pool.stats()
        out.append((op, aid, res, pool.resident_ids(), st["loads"],
                    st["evictions"], st["pinned"], pool.version))
    pool.note_rows({f"n{i}": i + 1 for i in range(12)})
    out.append(("rows", pool.rows_applied(), pool.stats()["rows_applied"]))
    return out


def test_pool_series_matches_reference(base):
    jcfg, _, cfg, _ = base
    dims = tad.target_dims(cfg)
    geo = ({t: dims[t] for t in TARGETS}, cfg.num_layers, 4)
    tpool = tad.AdapterPool(cfg, TARGETS, 4, 3, device="cpu")
    jpool = jad.AdapterPool(jcfg, TARGETS, 4, 3, dtype=jnp.float32)
    got = _pool_series(tad, tpool, tad.AdapterStore("t", *geo), cfg)
    want = _pool_series(jad, jpool, jad.AdapterStore("t", *geo), cfg)
    assert got == want
    assert any(r[0] == "acquire" and r[2] is None for r in got)
    assert got[-2][5] >= 2     # evictions happened
    assert tpool.hbm_bytes() == jpool.hbm_bytes()
    # the slots hold the same factors (the port's a-stack is [L, in, N, r])
    for t in TARGETS:
        np.testing.assert_array_equal(
            tpool._a[t].permute(0, 2, 1, 3).numpy(),
            np.asarray(jpool._a[t]))
        np.testing.assert_array_equal(tpool._b[t].numpy(),
                                      np.asarray(jpool._b[t]))
    np.testing.assert_array_equal(tpool._scale.numpy(),
                                  np.asarray(jpool._scale))


def test_pool_needs_two_slots(base):
    _, _, cfg, _ = base
    with pytest.raises(ValueError, match=">= 2"):
        tad.AdapterPool(cfg, TARGETS, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="no usable adapter targets"):
        tad.AdapterPool(cfg, ("router",), 4, 2, device="cpu")


# ---------------------------------------------------------------------------
# the engine against the JAX engine (the reference's TestBatchedAdapters)
# ---------------------------------------------------------------------------


def test_adapter_free_bit_identical_with_pool_on(base):
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    js, ts = _greedy_pair()
    plain = _tengine(base, **{**POOL_ECFG, "adapter_pool_slots": 0})
    pooled = _tengine(base, **POOL_ECFG)
    want = plain.generate(prompts, ts)
    assert pooled.generate(prompts, ts) == want
    assert _jengine(base, **POOL_ECFG).generate(prompts, js) == want


@pytest.fixture()
def rigs(base):
    """A pool engine of each package with adapters a1 and a2 published."""
    _, _, cfg, _ = base
    loras = {"a1": _lora(cfg, 9), "a2": _lora(cfg, 23)}
    je = _jengine(base, **POOL_ECFG)
    te = _tengine(base, **POOL_ECFG)
    for aid, lora in loras.items():
        je.publish_adapter(aid, lora, 2.0)
        te.publish_adapter(aid, lora, 2.0)
    return je, te, loras


def _mixed(eng, mod, prompts, sampling):
    reqs = []
    for aid, prompt in prompts.items():
        r = mod.Request(id=f"mix-{aid or 'base'}", prompt_tokens=list(prompt),
                        sampling=sampling, adapter=aid)
        eng.add_request(r)
        reqs.append(r)
    calls0 = eng.num_device_calls
    eng.step()
    # every row was admitted in the one wave
    assert all(len(r.output_tokens) >= 1 for r in reqs)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs], eng.num_device_calls - calls0


def test_mixed_wave_matches_reference_and_merged(base, rigs):
    """Two adapters and an adapter-free row in one wave, decoded in one
    device call per step: tokens equal the JAX engine's and each equals
    a pool-less engine on merged weights."""
    _, _, _, tp = base
    je, te, loras = rigs
    prompts = {"a1": [5, 6, 7, 8], "a2": [9, 10, 11, 12], "": [3, 4, 5]}
    js, ts = _greedy_pair()
    got, calls = _mixed(te, tengine, prompts, ts)
    want, jcalls = _mixed(je, jengine, prompts, js)
    assert got == want
    assert calls == N_TOK       # one wave + one call per decode step
    base_cfg = {**POOL_ECFG, "adapter_pool_slots": 0}
    for (aid, prompt), toks in zip(prompts.items(), got):
        params = _merged(tp, loras[aid], 2.0) if aid else None
        ref = _tengine(base, params, **base_cfg).generate([prompt], ts)[0]
        assert toks == ref, aid
    rows = te.adapter_pool.rows_applied()
    assert rows == je.adapter_pool.rows_applied()
    assert rows["a1"] >= N_TOK and rows["a2"] >= N_TOK
    assert got[0] != got[2] and got[1] != got[2]


def test_cold_adapter_prefetch_never_blocks(base, tmp_path):
    """A cold adapter (filestore rung only) at the queue head defers
    while the adapter-free request behind it admits and decodes; the
    prefetch lands and the request decodes through the blob's weights."""
    _, _, cfg, tp = base
    lora = _lora(cfg, 41)
    root = str(tmp_path / "adapters")
    warm, _ = _stores(cfg, root)
    warm.publish(tad.pack_lora_tree("cold1", lora, 2.0))
    eng = _tengine(base, **POOL_ECFG)
    eng.adapter_store, _ = _stores(cfg, root)
    _, ts = _greedy_pair()
    cold = tengine.Request(id="cold", prompt_tokens=[5, 6, 7, 8],
                           sampling=ts, adapter="cold1")
    free = tengine.Request(id="free", prompt_tokens=[3, 4, 5], sampling=ts)
    eng.add_request(cold)
    eng.add_request(free)
    eng.step()
    assert free.slot is not None and cold.slot is None
    deadline = time.monotonic() + 60
    while eng.has_work() and time.monotonic() < deadline:
        eng.step()
    assert free.finished and cold.finished
    assert eng.adapter_store.prefetches >= 1
    ref = _tengine(base, _merged(tp, lora, 2.0),
                   **{**POOL_ECFG, "adapter_pool_slots": 0}
                   ).generate([[5, 6, 7, 8]], ts)[0]
    assert cold.output_tokens == ref


def test_eviction_and_refcount_churn(base, rigs):
    """LRU eviction recycles refcount-0 slots; a slot pinned by a live
    request is never evicted; with both slots pinned nothing loads."""
    _, _, cfg, _ = base
    _, eng, _ = rigs
    pool, store = eng.adapter_pool, eng.adapter_store
    _, ts = _greedy_pair(n=40)
    # a live request pins a1
    live = tengine.Request(id="live", prompt_tokens=[5, 6, 7, 8],
                           sampling=ts, adapter="a1")
    eng.add_request(live)
    eng.step()
    assert pool.resident("a1") and pool.stats()["pinned"] == 1
    eng.publish_adapter("a3", _lora(cfg, 55), 2.0)
    assert pool.acquire("a3", store.get) is not None
    assert pool.resident("a1") and pool.resident("a3")
    assert pool.stats()["evictions"] == 0   # a2 was never loaded
    eng.publish_adapter("a4", _lora(cfg, 56), 2.0)
    assert pool.acquire("a4", store.get) is None   # a1, a3 pinned
    pool.release("a3")
    assert pool.acquire("a4", store.get) is not None
    assert not pool.resident("a3") and pool.stats()["evictions"] == 1
    assert pool.resident("a1")
    pool.release("a4")
    eng.abort("live")
    assert pool.stats()["pinned"] == 0


def test_republish_reloads_weights(base):
    _, _, cfg, tp = base
    _, ts = _greedy_pair()
    eng = _tengine(base, **POOL_ECFG)
    v1, v2 = _lora(cfg, 71), _lora(cfg, 72)
    prompt = [5, 6, 7, 8]
    eng.publish_adapter("t", v1, 2.0)
    out1 = _run(eng, tengine, "r1", prompt, ts, "t").output_tokens
    eng.publish_adapter("t", v2, 2.0)
    out2 = _run(eng, tengine, "r2", prompt, ts, "t").output_tokens
    ref2 = _tengine(base, _merged(tp, v2, 2.0),
                    **{**POOL_ECFG, "adapter_pool_slots": 0}
                    ).generate([prompt], ts)[0]
    assert out2 == ref2 and out1 != out2
    assert eng.adapter_pool.stats()["loads"] == 2


def test_one_slot_pool_degrades_to_off(base):
    _, ts = _greedy_pair()
    eng = _tengine(base, **{**POOL_ECFG, "adapter_pool_slots": 1})
    assert eng.adapter_pool is None and eng.adapter_store is None
    assert eng.generate([[5, 6, 7]], ts)[0]
    req = tengine.Request(id="x", prompt_tokens=[1, 2], adapter="a")
    jeng = _jengine(base, **{**POOL_ECFG, "adapter_pool_slots": 1})
    jreq = jengine.Request(id="x", prompt_tokens=[1, 2], adapter="a")
    assert eng.validate_request(req) == jeng.validate_request(jreq)


def test_unpublished_adapter_refused_as_reference(base, rigs):
    je, te, _ = rigs
    for aid in ("nope", "a1"):
        assert te.validate_request(tengine.Request(
            id="x", prompt_tokens=[1, 2], adapter=aid)) == \
            je.validate_request(jengine.Request(
                id="x", prompt_tokens=[1, 2], adapter=aid))
    with pytest.raises(ValueError, match="not published"):
        te.add_request(tengine.Request(id="x", prompt_tokens=[1, 2],
                                       adapter="nope"))


def test_chunked_prefill_and_mixed_step_carry_the_adapter(base, rigs):
    """A prompt longer than max_prefill_len prefills in chunks through
    the adapter, beside an adapter row decoding (the mixed step)."""
    je, te, _ = rigs
    js, ts = _greedy_pair(n=10)
    outs = []
    for eng, mod, sp in ((te, tengine, ts), (je, jengine, js)):
        long = mod.Request(id="long", prompt_tokens=list(range(3, 103)),
                           sampling=sp, adapter="a2")
        short = mod.Request(id="short", prompt_tokens=[7, 8, 9],
                            sampling=sp, adapter="a1")
        eng.add_request(short)
        eng.step()
        eng.add_request(long)
        while eng.has_work():
            eng.step()
        outs.append((long.output_tokens, short.output_tokens,
                     eng.num_mixed_steps))
    assert outs[0][:2] == outs[1][:2]
    assert outs[0][2] >= 1


def test_verify_rows_carry_the_adapter(base):
    """Speculative verify rows and the fused tail run each slot's
    adapter: tokens equal the JAX engine's with speculation on."""
    _, _, cfg, _ = base
    kw = {**POOL_ECFG, "enable_spec_decode": True, "spec_tokens": 3}
    je, te = _jengine(base, **kw), _tengine(base, **kw)
    lora = _lora(cfg, 9)
    je.publish_adapter("a1", lora, 2.0)
    te.publish_adapter("a1", lora, 2.0)
    js, ts = _greedy_pair(n=24)
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8]
    got = _run(te, tengine, "s", prompt, ts, "a1")
    want = _run(je, jengine, "s", prompt, js, "a1")
    assert got.output_tokens == want.output_tokens
    assert te.num_spec_steps == je.num_spec_steps > 0


def test_preempt_resume_keeps_the_adapter(base):
    """A preempted adapter row keeps its pool ref while parked and
    resumes through the same slot, token for token."""
    _, _, cfg, _ = base
    kw = {**POOL_ECFG, "host_pool_bytes": 1 << 24}
    lora = _lora(cfg, 9)
    _, ts = _greedy_pair(n=12)
    ref_eng = _tengine(base, **kw)
    ref_eng.publish_adapter("a1", lora, 2.0)
    want = _run(ref_eng, tengine, "u", [5, 6, 7, 8], ts, "a1").output_tokens
    eng = _tengine(base, **kw)
    eng.publish_adapter("a1", lora, 2.0)
    req = tengine.Request(id="p", prompt_tokens=[5, 6, 7, 8], sampling=ts,
                          adapter="a1")
    eng.add_request(req)
    while len(req.output_tokens) < 4:
        eng.step()
    slot = eng.adapter_pool.slot_for("a1")
    assert eng.preempt("p")
    assert eng.adapter_pool.stats()["pinned"] == 1
    while eng.has_work():
        eng.step()
    assert req.output_tokens == want
    assert eng.adapter_pool.slot_for("a1") == slot
    assert eng.adapter_pool.stats()["pinned"] == 0


# ---------------------------------------------------------------------------
# the reference's prefix-cache fault (ROADMAP C): pages keyed apart
# ---------------------------------------------------------------------------

PROMPT40 = [int(t) for t in np.random.default_rng(40).integers(4, 250, 40)]


def _base_then_adapter(eng, mod, sp):
    _run(eng, mod, "base", PROMPT40, sp)
    hits0 = eng.prefix_cache_hits
    r = _run(eng, mod, "ad", PROMPT40, sp, "a1")
    return r.output_tokens, r.cached_tokens, eng.prefix_cache_hits - hits0


def test_adapter_rows_never_reuse_other_pages(base):
    """40-token prompt, page 16, adapter a1 at scale 2.0: the reference's
    adapter request after a base request reuses the base model's two
    pages (cached_tokens 32) and emits other tokens than its cold run
    and than the merged weights; the port's reuses nothing and equals
    both.  A second a1 request does share a1's own pages."""
    _, _, cfg, tp = base
    lora = _lora(cfg, 9)
    js, ts = _greedy_pair()
    kw = dict(POOL_ECFG, max_decode_batch=2)

    def fresh(mk, **extra):
        eng = mk(base, **{**kw, **extra})
        eng.publish_adapter("a1", lora, 2.0)
        return eng

    merged = _tengine(base, _merged(tp, lora, 2.0),
                      **{**kw, "adapter_pool_slots": 0}
                      ).generate([PROMPT40], ts)[0]
    t_cold = _run(fresh(_tengine), tengine, "c", PROMPT40, ts,
                  "a1").output_tokens
    j_cold = _run(fresh(_jengine), jengine, "c", PROMPT40, js,
                  "a1").output_tokens
    assert t_cold == j_cold == merged
    teng = fresh(_tengine)
    t_toks, t_cached, t_hits = _base_then_adapter(teng, tengine, ts)
    assert (t_toks, t_cached, t_hits) == (merged, 0, 0)
    # the same adapter shares its own pages
    again = _run(teng, tengine, "again", PROMPT40, ts, "a1")
    assert again.cached_tokens == 32 and again.output_tokens == merged
    # the reference's fault, recorded so ROADMAP C stays true
    j_toks, j_cached, _ = _base_then_adapter(fresh(_jengine), jengine, js)
    assert j_cached == 32 and j_toks != merged


def test_republished_adapter_does_not_reuse_old_pages(base):
    _, _, cfg, tp = base
    _, ts = _greedy_pair()
    eng = _tengine(base, **POOL_ECFG)
    v2 = _lora(cfg, 72)
    eng.publish_adapter("t", _lora(cfg, 71), 2.0)
    _run(eng, tengine, "r1", PROMPT40, ts, "t")
    eng.publish_adapter("t", v2, 2.0)
    r2 = _run(eng, tengine, "r2", PROMPT40, ts, "t")
    assert r2.cached_tokens == 0
    assert r2.output_tokens == _tengine(
        base, _merged(tp, v2, 2.0), **{**POOL_ECFG, "adapter_pool_slots": 0}
    ).generate([PROMPT40], ts)[0]


@pytest.mark.parametrize("plen", [3, 16, 17, 40, 100])
def test_adapter_free_digests_equal_reference(base, plen):
    eng = _tengine(base, **POOL_ECFG)
    prompt = [int(t) for t in np.random.default_rng(plen).integers(
        0, 250, plen)]
    req = tengine.Request(id="d", prompt_tokens=prompt)
    cap = (plen - 1) // 16
    assert eng._prompt_hashes(req) == JPrefixCache.page_hashes(
        prompt, 16, cap)


# ---------------------------------------------------------------------------
# the wire: adapter ids sanitised at import, carried across engines
# ---------------------------------------------------------------------------


def _wire_doc(mig, adapter):
    doc = {"version": 1, "model": "tiny", "request_id": "w",
           "prompt_tokens": [1, 2, 3], "output_tokens": [], "sampling": {},
           "stop_token_ids": [], "tenant": "t", "trace_id": "",
           "sched_class": "", "max_len": None, "preempt_count": 0,
           "position": None, "last_token": None, "mrope_delta": 0,
           "key": None, "token_counts": {}, "page_size": 16,
           "num_layers": 2, "kv_heads": 2, "head_dim": 16,
           "kv_dtype": "float32", "pages": [], "page_checksums": [],
           "total_pages": 0, "adapter": adapter}
    doc["meta_checksum"] = mig._meta_checksum(doc)
    return doc


@pytest.mark.parametrize("adapter", [
    "../../etc/passwd", ".hidden", "a/b", "x" * 65, "__other__", "a b",
    "ünï", "-x"])
def test_wire_refuses_hostile_adapter_like_reference(adapter):
    errors = []
    for mig, err_cls in ((tmigration, tengine.SnapshotError),
                         (jmigration, jengine.SnapshotError)):
        with pytest.raises(err_cls) as e:
            mig.wire_to_snapshot(_wire_doc(mig, adapter))
        errors.append((str(e.value), e.value.code))
    assert errors[0] == errors[1]
    assert errors[0] == ("malformed snapshot field: snapshot adapter id "
                         "failed sanitisation", "snapshot_corrupt")


@pytest.mark.parametrize("adapter,want", [
    ("", ""), ("tenant-1.v2", "tenant-1.v2"), (" padded ", "padded"),
    (5, "5")])
def test_wire_keeps_clean_adapter_like_reference(adapter, want):
    t = tmigration.wire_to_snapshot(_wire_doc(tmigration, adapter))
    j = jmigration.wire_to_snapshot(_wire_doc(jmigration, adapter))
    assert t.adapter == j.adapter == want


def test_adapter_request_survives_export_import_resume(base):
    """Exported mid-decode, through the JSON wire, imported into a second
    engine with the adapter published, resumed: the tokens are the
    unmoved run's and the importer's pool served the rows."""
    _, _, cfg, _ = base
    lora = _lora(cfg, 9)
    _, ts = _greedy_pair(n=12)

    def engine():
        eng = _tengine(base, **POOL_ECFG)
        eng.publish_adapter("tenant-1", lora, 2.0)
        return eng

    want = _run(engine(), tengine, "u", PROMPT40, ts,
                "tenant-1").output_tokens
    src = engine()
    req = tengine.Request(id="x", prompt_tokens=list(PROMPT40), sampling=ts,
                          adapter="tenant-1")
    src.add_request(req)
    while len(req.output_tokens) < 5:
        src.step()
    wire = json.dumps(tmigration.snapshot_to_wire(src.export_request("x")))
    src.abort("x")
    assert src.adapter_pool.stats()["pinned"] == 0
    dst = engine()
    imp = dst.import_request(tmigration.wire_to_snapshot(json.loads(wire)))
    assert imp.adapter == "tenant-1"
    rows0 = dst.adapter_pool.rows_applied_total
    while not imp.finished:
        dst.step()
    assert imp.output_tokens == want
    assert dst.adapter_pool.rows_applied_total > rows0
    # an importer without the adapter refuses with the typed error
    bare = _tengine(base, **POOL_ECFG)
    with pytest.raises(tengine.SnapshotError, match="not published") as e:
        bare.import_request(tmigration.wire_to_snapshot(json.loads(wire)))
    assert e.value.code == "snapshot_invalid"
