"""Model configuration shared across families.

A copy of ``helix_tpu/models/common.py`` (the port imports nothing from the
JAX package; ``tests/test_torch_engine.py`` holds the two copies to the
same fields and defaults).

One config dataclass covers the decoder families the reference serves via
vLLM compose profiles (Llama-3, Phi-3, Qwen-2/3 — see
``design/sample-profiles/`` and BASELINE.md configs); family-specific
behaviour is expressed as data (activation, norm offsets, qk-norm, soft
caps), not subclasses, so one compiled forward function serves them all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 500000.0
    # stored as a sorted tuple of (key, value) pairs so the config stays
    # hashable (it keys compiled-function caches); None = no scaling
    rope_scaling: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"            # silu | gelu | gelu_tanh
    attention_bias: bool = False        # qkv bias (Qwen2)
    mlp_bias: bool = False
    qk_norm: bool = False               # per-head RMSNorm on q/k (Qwen3)
    logits_soft_cap: Optional[float] = None
    attn_logits_soft_cap: Optional[float] = None
    norm_offset: float = 0.0            # 1.0 for Gemma-style (1+w) RMSNorm
    max_position_embeddings: int = 8192
    dtype: str = "bfloat16"
    # multimodal rope sections (t, h, w) — set => Qwen2-VL-family text tower
    mrope_sections: Optional[tuple] = None
    # --- mixture of experts (Mixtral family); 0 = dense FFN ---
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # per-expert token capacity = factor * tokens * k / num_experts
    # (GShard-style dispatch; overflow tokens fall back to the residual)
    expert_capacity_factor: float = 1.5
    # --- non-architectural serving metadata ---
    name: str = "unnamed"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @classmethod
    def from_hf_config(cls, hf: dict, name: str = "unnamed") -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict (Llama/Qwen/Phi/
        Mistral-style decoder configs)."""
        hidden = hf["hidden_size"]
        heads = hf["num_attention_heads"]
        model_type = hf.get("model_type", "llama")
        rs = hf.get("rope_scaling") or {}
        mrope = (
            tuple(rs["mrope_section"]) if "mrope_section" in rs else None
        )
        # mrope is not a frequency scaling; store real scalings as a sorted
        # tuple so the config stays hashable
        rope_scaling = None
        if rs and mrope is None:
            rope_scaling = tuple(sorted(rs.items()))
        return cls(
            mrope_sections=mrope,
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            num_layers=hf["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hidden // heads,
            intermediate_size=hf["intermediate_size"],
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            hidden_act=hf.get("hidden_act", "silu"),
            attention_bias=hf.get("attention_bias", False)
            or model_type == "qwen2",
            mlp_bias=hf.get("mlp_bias", False),
            qk_norm=model_type == "qwen3",
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            num_experts=hf.get("num_local_experts", 0),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            name=name,
        )

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """A toy config for tests (fast to init/compile on one CPU core)."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            rope_theta=10000.0,
            max_position_embeddings=512,
            name="tiny",
        )
        base.update(overrides)
        return cls(**base)


# Canonical catalogue entries for the BASELINE.md configs — architecture
# hyperparameters only (weights come from HF checkpoints via
# ``models/loader.py``).
LLAMA3_8B = ModelConfig(
    vocab_size=128256,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=500000.0,
    rms_norm_eps=1e-5,
    max_position_embeddings=8192,
    name="meta-llama/Meta-Llama-3-8B-Instruct",
)

PHI3_MINI = ModelConfig(
    vocab_size=32064,
    hidden_size=3072,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    intermediate_size=8192,
    rope_theta=10000.0,
    max_position_embeddings=4096,
    name="microsoft/Phi-3-mini-4k-instruct",
)

QWEN2_7B = ModelConfig(
    vocab_size=152064,
    hidden_size=3584,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    intermediate_size=18944,
    rope_theta=1000000.0,
    attention_bias=True,
    max_position_embeddings=32768,
    name="Qwen/Qwen2-7B-Instruct",
)

MIXTRAL_8X7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    num_experts=8,
    num_experts_per_tok=2,
    name="mistralai/Mixtral-8x7B-Instruct-v0.1",
)

CATALOG = {
    m.name: m
    for m in (LLAMA3_8B, PHI3_MINI, QWEN2_7B, MIXTRAL_8X7B)
}
