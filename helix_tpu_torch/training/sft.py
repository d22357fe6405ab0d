"""LoRA supervised fine-tuning on one device (port of
``helix_tpu/training/sft.py``).

One step: the frozen base model runs ``models.llama.forward`` with the
adapters grafted in (``training.lora.merge_lora_into_params``) under
autograd -> masked float32 cross entropy -> gradients of the adapters
only -> optax's ``clip_by_global_norm`` then ``adamw`` over a
``warmup_cosine_decay_schedule``, written out here in plain torch to
optax's formulas -> new adapters.  Attention goes through
``ops.attention.attention``: on the card K2 forward and K2-backward
(``FlashAttentionFn``), on the CPU autograd through the plain version.

The base tensors take no gradient (they are never marked as requiring
it); the adapters are float32 leaves, updated in place with their AdamW
moments (the reference rebuilds its trees functionally).

Not ported: training over several devices (``mesh``, the multi-host
batch), which waits for ROADMAP A15b; MoE training (``moe_token_mask``),
ROADMAP A18b.  ``SFTConfig.remat`` and ``gradient_accumulation`` are kept
and, as in the reference, read nowhere (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, Optional

import numpy as np
import torch

from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import forward
from helix_tpu_torch.ops.attention import attention as _attention
from helix_tpu_torch.training.lora import (
    LoraConfig,
    init_lora_params,
    merge_lora_into_params,
)

# optax.adamw's defaults
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    lora: LoraConfig = LoraConfig()
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 100
    batch_size: int = 8
    seq_len: int = 1024
    grad_clip: float = 1.0
    gradient_accumulation: int = 1   # read nowhere, as in the reference
    seed: int = 0
    attn_backend: Optional[str] = None
    remat: bool = True               # read nowhere, as in the reference


def masked_cross_entropy(logits, targets, loss_mask):
    """Mean cross entropy over loss-masked positions, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    return (nll * loss_mask).sum() / denom


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (warmup included).  Evaluated in
    double precision (optax: float32)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = 1 - c / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _leaves(tree: dict) -> list:
    """The tree's tensors in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _zeros_like(tree: dict) -> dict:
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


class SFTTrainer:
    def __init__(self, model_cfg: ModelConfig, base_params, cfg: SFTConfig,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "training over several devices is not ported yet (ROADMAP "
                "A15b): train on one device")
        if model_cfg.num_experts > 0:
            raise NotImplementedError(
                f"{model_cfg.name}: MoE training (attention-only adapters, "
                "moe_token_mask) is not ported yet (ROADMAP A18b)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.base_params = base_params
        self.device = base_params["embed"]["weight"].device
        self.lora_params = init_lora_params(model_cfg, cfg.lora, cfg.seed,
                                            device=self.device)
        self.schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=cfg.learning_rate,
            warmup_steps=cfg.warmup_steps,
            decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1))
        self.opt_state = {"count": 0, "mu": _zeros_like(self.lora_params),
                          "nu": _zeros_like(self.lora_params)}
        self.step_num = 0
        self.grad_norm = None     # the last step's global norm, pre-clip

    # ------------------------------------------------------------------
    def loss_fn(self, lora_params, base_params, batch):
        cfg = self.model_cfg
        merged = merge_lora_into_params(base_params, lora_params,
                                        self.cfg.lora.scaling)
        backend = self.cfg.attn_backend
        seg = batch["segment_ids"]

        def attn_fn(q, k, v, cache, pos):
            out = _attention(
                q, k, v,
                causal=True,
                q_positions=pos, kv_positions=pos,
                q_segment_ids=seg, kv_segment_ids=seg,
                backend=backend,
            )
            return out, cache[0]

        # the carry protocol with an empty carry: no per-layer K/V is kept
        logits, _ = forward(merged, cfg, batch["tokens"], batch["positions"],
                            attn_fn=attn_fn, carry_caches=())
        return masked_cross_entropy(logits, batch["targets"],
                                    batch["loss_mask"])

    def _device_batch(self, batch) -> dict:
        def up(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

        return {
            "tokens": up(batch.tokens, torch.int64),
            "targets": up(batch.targets, torch.int64),
            "loss_mask": up(batch.loss_mask, torch.float32),
            "positions": up(batch.positions, torch.int32),
            "segment_ids": up(batch.segment_ids, torch.int32),
        }

    def _optimizer_update(self, grads: list) -> None:
        """optax ``chain(clip_by_global_norm, adamw(schedule,
        weight_decay))`` on the adapters, in place: the schedule at the
        count before the update; clip by ``grad_clip / g_norm`` only when
        ``g_norm >= grad_clip``; bias-corrected moments, ``m / (sqrt(v) +
        eps)``, ``+ weight_decay * p``, times ``-lr``."""
        params = _leaves(self.lora_params)
        mus = _leaves(self.opt_state["mu"])
        nus = _leaves(self.opt_state["nu"])
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        self.grad_norm = g_norm
        clip = float(self.cfg.grad_clip)
        grads = [torch.where(g_norm < clip, g, (g / g_norm) * clip)
                 for g in grads]
        count = self.opt_state["count"]
        lr = self.schedule(count)
        n = count + 1
        c1, c2 = 1 - ADAM_B1 ** n, 1 - ADAM_B2 ** n
        wd = float(self.cfg.weight_decay)
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            upd = upd + wd * p
            p.add_(-lr * upd)
        self.opt_state["count"] = n

    def train_step(self, batch) -> float:
        params = _leaves(self.lora_params)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = self.loss_fn(self.lora_params, self.base_params,
                                self._device_batch(batch))
            grads = torch.autograd.grad(loss, params)
        finally:
            for p in params:
                p.requires_grad_(False)
        with torch.no_grad():
            self._optimizer_update(list(grads))
        self.step_num += 1
        return float(loss.detach())

    def train(self, batches: Iterable, log_every: int = 10, on_log=None,
              on_step=None) -> list:
        """Run up to cfg.total_steps over ``batches``; returns the loss
        history.  ``on_step(step_num)`` fires after every optimizer step,
        ``on_log`` every ``log_every`` steps with a metrics dict."""
        history = []
        t0 = time.monotonic()
        for batch in batches:
            if self.step_num >= self.cfg.total_steps:
                break
            loss = self.train_step(batch)
            history.append(loss)
            if on_step is not None:
                on_step(self.step_num)
            if self.step_num % log_every == 0:
                msg = {
                    "step": self.step_num,
                    "loss": round(loss, 4),
                    "tokens_per_sec": round(
                        self.step_num * self.cfg.batch_size
                        * self.cfg.seq_len
                        / max(time.monotonic() - t0, 1e-9), 1),
                }
                (on_log or (lambda m: None))(msg)
        return history

    def eval_loss(self, batches: Iterable) -> float:
        with torch.no_grad():
            losses = [
                float(self.loss_fn(self.lora_params, self.base_params,
                                   self._device_batch(b)))
                for b in batches
            ]
        return sum(losses) / max(len(losses), 1)
