"""LoRA SFT in the port (``helix_tpu_torch.training``) against the
reference's ``helix_tpu.training`` on the CPU, at ``ModelConfig.tiny`` in
float32 (the JAX side with ``attn_backend="reference"``).  Inputs come
from numpy seeds; each adapter the two trainers compare starts from the
JAX init, carried across with ``lora_from_jax``.

Tolerances, float32 on one CPU, summation order the only difference:

- attention gradients, logits, the loss and LoRA gradients: within
  ``1e-5 + 1e-5 |want|`` per element;
- the schedule: ``1e-6`` of the peak (optax evaluates it in float32, the
  port in double; ``1 + cos`` near the end of the decay cancels, so the
  error is one of the peak's size, not the value's);
- parameters after trainer steps: ``1e-3 lr`` per element plus ``1e-4``
  of the value.  AdamW's step ``lr m / (sqrt(v) + eps)`` normalises each
  gradient entry by its own running magnitude, so an entry whose gradient
  is a small difference of large terms (f32 cancellation: relative gaps
  up to ~1e-4 here) takes a step off by that relative gap, ~1e-4 lr
  measured; 1e-3 lr bounds it with margin and is still 2000 times below
  one step taken the wrong way (2 lr);
- tokens: identical (greedy).
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import forward as jforward
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.ops import attention as jatt
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu.serving.tokenizer import HFTokenizer as JHFTokenizer
from helix_tpu.training import data as jdata
from helix_tpu.training import lora as jlora
from helix_tpu.training import sft as jsft
from helix_tpu_torch import cli
from helix_tpu_torch.engine import adapters as tad
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import forward, lora_from_jax, \
    params_from_jax, prefill_attn_fn
from helix_tpu_torch.ops import attention as tatt
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry
from helix_tpu_torch.serving.tokenizer import ByteTokenizer, HFTokenizer
from helix_tpu_torch.testing.tokenizer_fixtures import FIXTURES
from helix_tpu_torch.training import checkpoint as tckpt
from helix_tpu_torch.training import data as tdata
from helix_tpu_torch.training import lora as tlora
from helix_tpu_torch.training import sft as tsft

ATOL = RTOL = 1e-5
TRAIN = dict(learning_rate=5e-3, warmup_steps=1, total_steps=4,
             batch_size=2, seq_len=64, grad_clip=0.05)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def base():
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, ModelConfig.tiny(dtype="float32"), \
        params_from_jax(jax.device_get(jp))


def _examples(seed=0, n=12):
    rng = np.random.default_rng(seed)
    return [jdata.SFTExample(
        input_ids=[int(x) for x in rng.integers(4, 250, m)],
        loss_mask=[int(x) for x in rng.random(m) < 0.7])
        for m in rng.integers(10, 40, n)]


@pytest.fixture(scope="module")
def batches():
    return list(jdata.pack_examples(_examples(), 2, 64, shuffle_seed=0))


def _nonzero_lora(cfg, seed, rank=16):
    rng = np.random.default_rng(seed)
    out = {}
    for t, (fan_in, fan_out) in tlora._target_dims(cfg).items():
        if t not in tlora.DEFAULT_TARGETS:
            continue
        out[t] = {"lora_a": (rng.standard_normal(
            (cfg.num_layers, fan_in, rank)) / np.sqrt(fan_in)).astype(
                np.float32),
            "lora_b": (rng.standard_normal((cfg.num_layers, rank, fan_out))
                       * 0.05).astype(np.float32)}
    return out


def _tbatch(b):
    return {"tokens": torch.from_numpy(b.tokens).long(),
            "targets": torch.from_numpy(b.targets).long(),
            "loss_mask": torch.from_numpy(b.loss_mask),
            "positions": torch.from_numpy(b.positions),
            "segment_ids": torch.from_numpy(b.segment_ids)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in vars(b).items()}


# ---------------------------------------------------------------------------
# attention gradients, the loss, the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 2.0])
def test_attention_gradients_match_jax(cap):
    """dq / dk / dv of the port's attention on the CPU (autograd through
    the plain version, what ``FlashAttentionFn`` replaces on the card)
    against ``jax.grad`` of the reference's ``mha_reference``, at group 4
    with packed segments."""
    rng = np.random.default_rng(3)
    B, S, H, KVH, D = 2, 45, 8, 2, 16
    pos = np.zeros((B, S), np.int32)
    seg = np.zeros((B, S), np.int32)
    for b, cuts in enumerate(((0, 20, 41), (0, 12, 30, 44))):
        for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            pos[b, lo:hi] = np.arange(hi - lo)
            seg[b, lo:hi] = i + 1
    q, dout = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg, logits_soft_cap=cap)

    def jloss(q, k, v):
        return jnp.sum(jatt.mha_reference(q, k, v, **kw) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, **tkw)
    out.backward(torch.from_numpy(dout))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)
    # the kernel wrapper's CPU path is that same autograd
    direct = tatt.flash_attention_backward(
        *(x.detach() for x in leaves), out.detach(), None,
        torch.from_numpy(dout), **tkw)
    for d, leaf in zip(direct, leaves):
        assert torch.equal(d, leaf.grad)


def test_matmul_f32_gradients_match_jax():
    """The gradients of the bf16 float32-output GEMM (``matmul_f32``: the
    LoRA projections and the logits head) for a float32 cotangent, the
    card's formula (``_matmul_f32_vjp``) and the CPU's autograd, against
    ``jax.vjp`` of the reference's ``dot_general(x, w,
    preferred_element_type=float32)``, which keeps the cotangent in
    float32.  The cotangent is 256 + N(0, 1), whose bf16 rounding keeps
    nothing of the noise, against x with paired rows and w with paired
    columns that cancel the 256 exactly.  Per element within one bf16
    ulp, 1e-5 + 2**-7 |want|, plus the float32 sum's order bound, n u
    sum |terms| <= 2**-16 sum |terms| for n <= 256 terms; the cotangent
    rounded to bf16 first lands outside."""
    from helix_tpu_torch.ops import quant as tquant

    rng = np.random.default_rng(4)
    xh = rng.standard_normal((30, 64)).astype(np.float32)
    wh = rng.standard_normal((64, 24)).astype(np.float32) * 0.05
    x = torch.from_numpy(np.concatenate([xh, -xh])).bfloat16()
    w = torch.from_numpy(np.concatenate([wh, -wh], 1)).bfloat16()
    g = torch.from_numpy(256.0 + rng.standard_normal((60, 48)).astype(
        np.float32))
    jx, jw = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w))
    _, vjp = jax.vjp(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32),
        jx, jw)
    want = [torch.from_numpy(np.asarray(t.astype(jnp.float32))).double()
            for t in vjp(g.numpy())]
    card = tquant._matmul_f32_vjp(x, w, g)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    tquant.matmul_f32(xl, wl).backward(g)
    x64, w64, g64 = x.double(), w.double(), g.double()
    g16 = g.bfloat16().double()
    mags = (g64.abs() @ w64.abs().T, x64.abs().T @ g64.abs())
    coarse = (g16 @ w64.T, x64.T @ g16)
    for name, c, a, mag, cz, wt in zip(("gx", "gw"), card,
                                       (xl.grad, wl.grad), mags, coarse,
                                       want):
        assert c.dtype == a.dtype == torch.bfloat16, name
        limit = 1e-5 + 2.0 ** -7 * wt.abs() + 2.0 ** -16 * mag
        for got in (c, a):
            assert ((got.double() - wt).abs() <= limit).all(), name
        assert ((cz - wt).abs() > limit).any(), name


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        want = jsft.masked_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets),
                                         jnp.asarray(m))
        got = tsft.masked_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(targets),
                                        torch.from_numpy(m))
        _close(got, want)
    assert float(got) == 0.0      # all masked: 0 / max(0, 1)


def test_pack_examples_and_load_jsonl_match_reference(tmp_path):
    """``load_jsonl`` (chat rows and prompt / completion rows) and
    ``pack_examples`` give the reference's arrays, with the byte tokenizer
    and with the Llama-3 fixture's ``tokenizer.json``."""
    rows = [{"messages": [{"role": "system", "content": "Be brief."},
                          {"role": "user", "content": f"Question {i}?"},
                          {"role": "assistant", "content": "Answer " * i}]}
            for i in range(1, 9)]
    rows += [{"prompt": "Translate: chat", "completion": "le chat"},
             {"completion": "only a completion"}]
    path = tmp_path / "data.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    tok_json = os.path.join(FIXTURES["llama3"], "tokenizer.json")
    name = "meta-llama/Meta-Llama-3-8B-Instruct"
    for ttok, jtok in ((ByteTokenizer(), JByteTokenizer()),
                       (HFTokenizer(tok_json, name),
                        JHFTokenizer(tok_json, name))):
        got = tdata.load_jsonl(str(path), ttok)
        want = jdata.load_jsonl(str(path), jtok)
        assert [(e.input_ids, e.loss_mask) for e in got] == \
            [(e.input_ids, e.loss_mask) for e in want]
        for seed in (0, 3, None):
            tb = list(tdata.pack_examples(got, 3, 48, shuffle_seed=seed))
            jb = list(jdata.pack_examples(want, 3, 48, shuffle_seed=seed))
            assert len(tb) == len(jb) > 1
            for t, j in zip(tb, jb):
                for f in ("tokens", "targets", "loss_mask", "positions",
                          "segment_ids"):
                    a, b = getattr(t, f), getattr(j, f)
                    assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# LoRA: the merged forward, gradients, the trainer, the schedule
# ---------------------------------------------------------------------------


def test_merged_adapter_forward_matches_jax(base, batches):
    """A nonzero adapter merged at scale 2: the port's logits (the LoRA
    form of ``maybe_dequant_dense``) against the reference's; the export
    bakes the same function into the weights; int8 refuses it."""
    jcfg, jp, cfg, tp = base
    lora = _nonzero_lora(cfg, 7)
    b = batches[0]
    want, _ = jforward(jlora.merge_lora_into_params(jp, lora, 2.0), jcfg,
                       jnp.asarray(b.tokens), jnp.asarray(b.positions),
                       attn_fn=lambda q, k, v, c, p: jatt.mha_reference(
                           q, k, v, q_positions=p, kv_positions=p))
    tl = lora_from_jax(lora)
    tb = _tbatch(b)
    got, _ = forward(tlora.merge_lora_into_params(tp, tl, 2.0), cfg,
                     tb["tokens"], tb["positions"], attn_fn=prefill_attn_fn)
    _close(got, want)
    baked, _ = forward(tlora.export_merged_weights(tp, tl, 2.0), cfg,
                       tb["tokens"], tb["positions"], attn_fn=prefill_attn_fn)
    _close(baked, got, atol=1e-4, rtol=1e-4)
    q8 = {**tp, "layers": {**tp["layers"], "wq": {
        "weight": tp["layers"]["wq"]["weight"].to(torch.int8)}}}
    with pytest.raises(ValueError, match="cannot bake LoRA into int8"):
        tlora.export_merged_weights(q8, {"wq": tl["wq"]}, 2.0)


def test_lora_config_and_targets_match_reference(base):
    _, _, cfg, _ = base
    assert tlora.LoraConfig().scaling == jlora.LoraConfig().scaling == 2.0
    assert tlora.DEFAULT_TARGETS == jlora.DEFAULT_TARGETS
    assert tlora.ALL_TARGETS == jlora.ALL_TARGETS
    moe_t = ModelConfig.tiny(num_experts=4)
    moe_j = JModelConfig.tiny(num_experts=4)
    assert tlora._target_dims(moe_t) == jlora._target_dims(moe_j)
    assert tlora._target_dims(cfg) == jlora._target_dims(
        JModelConfig.tiny())
    ffn = tlora.LoraConfig(targets=("w_up",))
    with pytest.raises(ValueError) as te:
        tlora.init_lora_params(moe_t, ffn, device="cpu")
    with pytest.raises(ValueError) as je:
        jlora.init_lora_params(moe_j, jlora.LoraConfig(targets=("w_up",)),
                               jax.random.PRNGKey(0))
    assert str(te.value) == str(je.value)
    init = tlora.init_lora_params(cfg, tlora.LoraConfig(), 3, device="cpu")
    for t, (fan_in, fan_out) in tlora._target_dims(cfg).items():
        if t in tlora.DEFAULT_TARGETS:
            a, b = init[t]["lora_a"], init[t]["lora_b"]
            assert a.shape == (cfg.num_layers, fan_in, 16)
            assert b.shape == (cfg.num_layers, 16, fan_out)
            assert a.dtype == b.dtype == torch.float32
            assert not b.any() and a.std() > 0


def test_lora_gradients_match_jax_and_base_takes_none(base, batches):
    """Gradients of the loss at a nonzero adapter against
    ``jax.grad(SFTTrainer.loss_fn)``; the frozen base tensors get none."""
    jcfg, jp, cfg, tp = base
    lora = _nonzero_lora(cfg, 11)
    jt = jsft.SFTTrainer(jcfg, jp, jsft.SFTConfig(attn_backend="reference",
                                                  **TRAIN))
    want = jax.grad(jt.loss_fn)(lora, jp, _jbatch(batches[1]))
    tt = tsft.SFTTrainer(cfg, tp, tsft.SFTConfig(**TRAIN))
    tl = lora_from_jax(lora)
    leaves = tsft._leaves(tl)
    for p in leaves:
        p.requires_grad_(True)
    loss = tt.loss_fn(tl, tp, _tbatch(batches[1]))
    loss.backward()
    for t in sorted(lora):
        for n in ("lora_a", "lora_b"):
            _close(tl[t][n].grad, want[t][n])

    def base_tensors(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in base_tensors(v)]
        return [tree]

    assert all(not x.requires_grad and x.grad is None
               for x in base_tensors(tp))


def test_trainer_steps_match_reference(base, batches):
    """Four steps of the port's trainer against the reference's from the
    same adapter: the losses, the adapters after every step (clipping
    triggered: grad_clip 0.05), the moments and the step count."""
    jcfg, jp, cfg, tp = base
    jt = jsft.SFTTrainer(jcfg, jp, jsft.SFTConfig(attn_backend="reference",
                                                  **TRAIN))
    tt = tsft.SFTTrainer(cfg, tp, tsft.SFTConfig(**TRAIN))
    tt.lora_params = lora_from_jax(jax.device_get(jt.lora_params))
    tt.opt_state = {"count": 0, "mu": tsft._zeros_like(tt.lora_params),
                    "nu": tsft._zeros_like(tt.lora_params)}
    lr = TRAIN["learning_rate"]
    clipped = 0
    for i in range(4):
        b = batches[i % len(batches)]
        jl, tl = jt.train_step(b), tt.train_step(b)
        assert abs(jl - tl) <= ATOL + RTOL * abs(jl), (i, jl, tl)
        clipped += float(tt.grad_norm) >= TRAIN["grad_clip"]
        jlp = jax.device_get(jt.lora_params)
        for t in jlp:
            for n in ("lora_a", "lora_b"):
                _close(tt.lora_params[t][n], jlp[t][n], atol=1e-3 * lr,
                       rtol=1e-4)
    assert clipped >= 1
    assert tt.step_num == jt.step_num == 4
    adam = jt.opt_state[1][0]
    assert tt.opt_state["count"] == int(adam.count) == 4
    for t in adam.mu:
        for n in ("lora_a", "lora_b"):
            _close(tt.opt_state["mu"][t][n], adam.mu[t][n], atol=1e-7,
                   rtol=1e-4)


@pytest.mark.parametrize("warmup,total", [(0, 5), (1, 4), (3, 10),
                                          (10, 100), (5, 5)])
def test_schedule_matches_optax(warmup, total):
    peak = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    got = tsft.warmup_cosine_decay_schedule(0.0, peak, warmup,
                                            max(total, warmup + 1))
    for step in range(total + 3):
        w = float(want(step))
        assert abs(got(step) - w) <= 1e-6 * peak, step
    if warmup:
        assert got(0) == 0.0     # the first update is zero


def test_mesh_and_moe_are_refused(base):
    _, _, cfg, tp = base
    with pytest.raises(NotImplementedError, match="A15b"):
        tsft.SFTTrainer(cfg, tp, tsft.SFTConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="A18b"):
        tsft.SFTTrainer(ModelConfig.tiny(num_experts=4), tp,
                        tsft.SFTConfig())


# ---------------------------------------------------------------------------
# checkpoints, resume, the command line
# ---------------------------------------------------------------------------


def test_resume_equals_straight_run_and_retention(base, batches, tmp_path,
                                                  monkeypatch):
    """2 steps, a save, a fresh trainer resumed, 2 more steps: the same
    adapters and moments as 4 straight; ``keep_last``; a save cut short
    is never listed."""
    _, _, cfg, tp = base
    conf = tsft.SFTConfig(**TRAIN)
    straight = tsft.SFTTrainer(cfg, tp, conf)
    for i in range(4):
        straight.train_step(batches[i % len(batches)])
    first = tsft.SFTTrainer(cfg, tp, conf)
    for i in range(2):
        first.train_step(batches[i % len(batches)])
    d = str(tmp_path / "ck")
    path = tckpt.save_checkpoint(d, first.step_num, first.lora_params,
                                 first.opt_state, lora_scaling=2.0)
    assert os.path.basename(path) == "step_00000002"
    second = tsft.SFTTrainer(cfg, tp, conf)
    assert tckpt.resume_trainer(second, d) and second.step_num == 2
    for i in range(2, 4):
        second.train_step(batches[i % len(batches)])
    for a, b in zip(tsft._leaves(second.lora_params) +
                    tsft._leaves(second.opt_state["mu"]),
                    tsft._leaves(straight.lora_params) +
                    tsft._leaves(straight.opt_state["mu"])):
        assert torch.equal(a, b)
    restored = tckpt.restore_checkpoint(d)
    assert restored["lora_scaling"] == 2.0 and restored["step"] == 2
    for step in (3, 4, 5, 6):
        tckpt.save_checkpoint(d, step, second.lora_params, second.opt_state,
                              keep_last=3)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005",
                                     "step_00000006"]

    def torn_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 half")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", torn_save)
    with pytest.raises(OSError):
        tckpt.save_checkpoint(d, 7, second.lora_params, second.opt_state)
    assert tckpt.latest_step(d) == 6
    assert sorted(os.listdir(d))[-1] == "step_00000006"
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def _write_chats(path, n=12):
    rows = [{"messages": [{"role": "user", "content": f"Say {i}."},
                          {"role": "assistant",
                           "content": f"I say {i} " * (1 + i % 3)}]}
            for i in range(n)]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def test_sft_command_on_cpu(tmp_path, capsys):
    """``python -m helix_tpu_torch sft --device cpu`` on ``tiny``: the
    reference's log lines, checkpoints at ``--save-every`` and the end;
    ``--resume`` continues; the multi-host flags are refused by name."""
    data = tmp_path / "chats.jsonl"
    _write_chats(data)
    out = str(tmp_path / "adapter")
    argv = ["sft", "--device", "cpu", "--model", "tiny", "--data",
            str(data), "--output", out, "--steps", "3", "--batch-size", "2",
            "--seq-len", "64", "--log-every", "1", "--save-every", "2",
            "--rank", "4", "--alpha", "8"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "loaded 12 examples"
    logs = [json.loads(x) for x in lines[1:4]]
    assert [m["step"] for m in logs] == [1, 2, 3]
    assert set(logs[0]) == {"step", "loss", "tokens_per_sec"}
    assert lines[-1] == f"saved adapters to {out}"
    assert sorted(os.listdir(out)) == ["step_00000002", "step_00000003"]
    state = tckpt.restore_checkpoint(out)
    assert state["lora_scaling"] == 2.0
    assert state["lora_params"]["wq"]["lora_a"].shape[-1] == 4
    assert cli.main(argv[:-8] + ["--steps", "4", "--resume", "--batch-size",
                                 "2", "--seq-len", "64", "--rank", "4"]) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    assert tckpt.latest_step(out) == 4
    with pytest.raises(SystemExit, match="--coordinator.*A15b"):
        cli.main(argv + ["--coordinator", "h:1"])


def test_sft_command_defaults_to_the_card():
    """Without ``--device`` the command trains on the card: here, with no
    CUDA, it fails before any weights are made."""
    with pytest.raises(Exception, match="(?i)cuda"):
        cli.main(["sft", "--data", "x.jsonl"])


# ---------------------------------------------------------------------------
# publishing: the store, HTTP, and the merge-at-apply build
# ---------------------------------------------------------------------------

ENGINE = dict(max_decode_batch=3, page_size=16, num_pages=64,
              max_pages_per_seq=8, max_prefill_len=64)


def _saved_adapter(cfg, tmp, seed, scaling=2.0):
    lora = {t: {n: torch.from_numpy(x) for n, x in f.items()}
            for t, f in _nonzero_lora(cfg, seed).items()}
    d = str(tmp / f"adapter{seed}")
    tckpt.save_checkpoint(d, 5, lora, {"count": 5}, lora_scaling=scaling)
    return d, lora


def _served(name, **kw):
    return cli.build_served_model(
        name, device="cpu", warmup=False,
        model_overrides={"dtype": "float32"}, **kw)


def _engine(**kw):
    """The engine of ``_served``, its loop stopped (driven here)."""
    served = _served("tiny-ad", **kw)
    served.loop.stop()
    return served.loop.engine


def _greedy(eng, prompt, adapter=""):
    req = tengine.Request(id=f"g{adapter}", prompt_tokens=list(prompt),
                          sampling=tsampling.SamplingParams(
                              temperature=0.0, max_tokens=8),
                          adapter=adapter)
    eng.add_request(req)
    while eng.has_work():
        eng.step()
    return req.output_tokens


def test_publish_checkpoint_through_the_store(tmp_path, monkeypatch):
    """``AdapterStore.publish_checkpoint``: the latest step restored and
    packed at the checkpoint's scale (an explicit scale beats it, 0
    becomes 1.0); a missing checkpoint is FileNotFoundError, a step that
    is not a LoRA checkpoint or does not fit the model ValueError."""
    monkeypatch.delenv("HELIX_FILESTORE_KV_DIR", raising=False)
    cfg = ModelConfig.tiny(dtype="float32")
    store = tad.AdapterStore("tiny", tad.target_dims(cfg), cfg.num_layers,
                             rank_cap=16)
    d, lora = _saved_adapter(cfg, tmp_path, 1)
    spec = store.publish_checkpoint("a1", d)
    assert (spec.rank, spec.scale) == (16, 2.0) and store.contains("a1")
    np.testing.assert_array_equal(spec.targets["wq"]["a"],
                                  lora["wq"]["lora_a"].numpy())
    assert store.publish_checkpoint("a2", d, scale=0.5).scale == 0.5
    d0, _ = _saved_adapter(cfg, tmp_path, 2, scaling=0.0)
    assert store.publish_checkpoint("a3", d0).scale == 1.0
    with pytest.raises(FileNotFoundError):
        store.publish_checkpoint("a4", str(tmp_path / "missing"))
    bad = tmp_path / "bad" / "step_00000001"
    bad.mkdir(parents=True)
    (bad / tckpt.STATE_FILE).write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a LoRA training checkpoint"):
        store.publish_checkpoint("a5", str(tmp_path / "bad"))
    big = ModelConfig.tiny(dtype="float32", num_layers=3)
    d3, _ = _saved_adapter(big, tmp_path, 3)
    with pytest.raises(ValueError, match="do not match model dims"):
        store.publish_checkpoint("a6", d3)


def _post(url, body, token=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **({"X-Runner-Token": token}
                                             if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_publish_over_http_and_serve(tmp_path, monkeypatch):
    """``POST /v1/adapters`` with the reference's answers: 200 and the
    ``model@name`` entry, which then serves (tokens unlike the base's,
    the base's unchanged); 404 for a missing checkpoint and an unknown
    model; 400 for a bad name, no checkpoint and a step that is not a
    LoRA checkpoint; 409 without a pool; 403 without the runner token."""
    monkeypatch.delenv("HELIX_FILESTORE_KV_DIR", raising=False)
    monkeypatch.delenv("HELIX_RUNNER_TOKEN", raising=False)
    pooled = _served("tiny-ad", engine=dict(ENGINE, adapter_pool_slots=2,
                                            adapter_rank=16))
    plain = _served("tiny-plain", engine=ENGINE)
    reg = ModelRegistry()
    for m in (pooled, plain):
        reg.register(m)
    httpd = OpenAIServer(reg).start(host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        d, _ = _saved_adapter(ModelConfig.tiny(dtype="float32"), tmp_path,
                              4)
        chat = {"model": "tiny-ad", "max_tokens": 8, "temperature": 0,
                "messages": [{"role": "user", "content": "hello there"}]}
        base_out = _post(url + "/v1/chat/completions", chat)
        status, out = _post(url + "/v1/adapters", {
            "model": "tiny-ad", "name": "sft-1", "checkpoint": d})
        assert status == 200, out
        assert (out["id"], out["object"], out["parent"], out["scale"]) == \
            ("tiny-ad@sft-1", "model", "tiny-ad", 2.0)
        adapted = _post(url + "/v1/chat/completions",
                        {**chat, "model": "tiny-ad@sft-1"})
        assert adapted[0] == 200
        assert adapted[1]["choices"][0]["message"]["content"] != \
            base_out[1]["choices"][0]["message"]["content"]
        again = _post(url + "/v1/chat/completions", chat)
        assert again[1]["choices"] == base_out[1]["choices"]
        bad = tmp_path / "bad" / "step_00000001"
        bad.mkdir(parents=True)
        (bad / tckpt.STATE_FILE).write_bytes(b"junk")
        for body, code in (
                ({"model": "tiny-ad", "name": "x",
                  "checkpoint": str(tmp_path / "nope")}, 404),
                ({"model": "nope", "name": "x", "checkpoint": d}, 404),
                ({"model": "tiny-ad", "name": "../evil",
                  "checkpoint": d}, 400),
                ({"model": "tiny-ad", "name": "x"}, 400),
                ({"model": "tiny-ad", "name": "x",
                  "checkpoint": str(tmp_path / "bad")}, 400),
                ({"model": "tiny-plain", "name": "x", "checkpoint": d},
                 409)):
            status, out = _post(url + "/v1/adapters", body)
            assert status == code, (body, out)
            assert "message" in out["error"]
        monkeypatch.setenv("HELIX_RUNNER_TOKEN", "s3cret")
        body = {"model": "tiny-ad", "name": "sft-2", "checkpoint": d}
        assert _post(url + "/v1/adapters", body)[0] == 403
        assert _post(url + "/v1/adapters", body, token="s3cret")[0] == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        for m in (pooled, plain):
            m.loop.stop()


def test_pool_tokens_equal_merge_at_apply(tmp_path, monkeypatch):
    """The f32 greedy tokens of a published adapter through the pool
    equal those of the build that merges it at apply (the profile's
    ``adapter:``), at the trained scale and at an explicit
    ``adapter_scale``; the merged build's tokens differ from the base's;
    a missing adapter checkpoint fails the build."""
    monkeypatch.delenv("HELIX_FILESTORE_KV_DIR", raising=False)
    cfg = ModelConfig.tiny(dtype="float32")
    d, _ = _saved_adapter(cfg, tmp_path, 6)
    prompts = ([5, 9, 33, 2, 80], [100, 7, 7, 61, 12, 3, 44])
    pooled = _engine(engine=dict(ENGINE, adapter_pool_slots=2,
                                 adapter_rank=16))
    pooled.adapter_store.publish_checkpoint("t", d)
    pooled.adapter_store.publish_checkpoint("h", d, scale=0.5)
    for scale, aid in ((None, "t"), (0.5, "h")):
        merged = _engine(engine=ENGINE, adapter=d, adapter_scale=scale)
        for p in prompts:
            want = _greedy(merged, p)
            assert _greedy(pooled, p, adapter=aid) == want
            assert _greedy(pooled, p) != want
    with pytest.raises(FileNotFoundError,
                       match="adapter checkpoint not found"):
        _served("tiny-ad", engine=ENGINE, adapter=str(tmp_path / "none"))
