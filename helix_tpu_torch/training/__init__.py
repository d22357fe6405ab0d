"""LoRA supervised fine-tuning on one device (port of
``helix_tpu/training``)."""

from helix_tpu_torch.training.lora import (
    LoraConfig,
    init_lora_params,
    merge_lora_into_params,
)
from helix_tpu_torch.training.sft import SFTConfig, SFTTrainer

__all__ = [
    "LoraConfig",
    "init_lora_params",
    "merge_lora_into_params",
    "SFTConfig",
    "SFTTrainer",
]
