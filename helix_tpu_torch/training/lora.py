"""LoRA adapters as a separate parameter tree (port of
``helix_tpu/training/lora.py``).

Adapters live in their own dictionary ``{target: {"lora_a" [L, in, r],
"lora_b" [L, r, out]}}``: only it takes gradients and optimizer state,
the frozen base weights never do.  ``merge_lora_into_params`` grafts the
factors into the model's layers so ``ops.quant.maybe_dequant_dense`` adds
``scale * (x @ a) @ b`` wherever they appear, over float or int8 base
weights.  Serving a trained adapter: publish it to the multi-LoRA pool
(``engine.adapters.AdapterStore.publish_checkpoint``), or merge one at
profile-apply time (the profile's ``adapter:`` field).

``lora_logical_axes`` (the reference's sharding rule) waits for training
on a mesh (ROADMAP A15b).
"""

from __future__ import annotations

import dataclasses

import torch

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from helix_tpu_torch.models.common import ModelConfig

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.0
    targets: tuple = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _target_dims(cfg: ModelConfig) -> dict:
    E, H, KVH, D, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.intermediate_size)
    dims = {
        "wq": (E, H * D),
        "wk": (E, KVH * D),
        "wv": (E, KVH * D),
        "wo": (H * D, E),
        "w_gate": (E, F),
        "w_up": (E, F),
        "w_down": (F, E),
    }
    if cfg.num_experts > 0:
        # MoE replaces the dense FFN by expert stacks: attention only
        for t in ("w_gate", "w_up", "w_down"):
            del dims[t]
    return dims


def init_lora_params(model_cfg: ModelConfig, lora_cfg: LoraConfig,
                     seed: int = 0, *, device=DEFAULT_DEVICE,
                     dtype=torch.float32) -> dict:
    """A gaussian / sqrt(fan_in), B zero: the adapter starts as the
    identity.  Draws come from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (not ``jax.random``'s bits: tests carry a JAX init
    across with ``models.llama.lora_from_jax``).  Targets the
    architecture lacks (the FFN on an MoE config) are skipped."""
    dims = _target_dims(model_cfg)
    L, r = model_cfg.num_layers, lora_cfg.rank
    targets = [t for t in lora_cfg.targets if t in dims]
    if not targets:
        raise ValueError(
            f"no usable LoRA targets in {lora_cfg.targets} for "
            f"{model_cfg.name} (MoE configs adapt attention only)"
        )
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for t in targets:
        fan_in, fan_out = dims[t]
        a = torch.randn((L, fan_in, r), generator=gen, device=dev,
                        dtype=torch.float32) / fan_in ** 0.5
        out[t] = {"lora_a": a.to(dtype),
                  "lora_b": torch.zeros((L, r, fan_out), dtype=dtype,
                                        device=dev)}
    return out


def merge_lora_into_params(params: dict, lora_params: dict,
                           scaling: float) -> dict:
    """Graft adapters into the model's layers (shallow copies, no weight
    math: the low-rank product runs inside ``maybe_dequant_dense``).
    ``lora_scale`` is float32 ``[L]``, sliced per layer with the stacked
    weights."""
    merged = dict(params)
    layers = dict(params["layers"])
    for t, lp in lora_params.items():
        entry = dict(layers[t])
        entry["lora_a"] = lp["lora_a"]
        entry["lora_b"] = lp["lora_b"]
        entry["lora_scale"] = torch.full(
            (lp["lora_a"].shape[0],), float(scaling), dtype=torch.float32,
            device=lp["lora_a"].device)
        layers[t] = entry
    merged["layers"] = layers
    return merged


def export_merged_weights(params: dict, lora_params: dict,
                          scaling: float) -> dict:
    """Bake adapters into dense weights (serving without the LoRA path):
    ``w + scaling * a @ b`` in float32, rounded once to ``w``'s dtype.
    Only for float base weights."""
    merged = dict(params)
    layers = dict(merged["layers"])
    for t, lp in lora_params.items():
        w = layers[t]["weight"]
        if w.dtype == torch.int8:
            raise ValueError(
                "cannot bake LoRA into int8 base weights; serve with the "
                "adapter path instead"
            )
        delta = torch.einsum("lir,lro->lio", lp["lora_a"].float(),
                             lp["lora_b"].float()) * scaling
        entry = dict(layers[t])
        entry["weight"] = (w.float() + delta.to(w.device)).to(w.dtype)
        layers[t] = entry
    merged["layers"] = layers
    return merged
