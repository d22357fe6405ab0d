"""Vision embedding worker: images and text into one vector space.

Port of ``helix_tpu/models/vision_embed.py``.  The Qwen2-VL vision tower
already projects patches into the text tower's hidden space
(``models.qwen2_vl.vision_forward``), so the shared space comes from the
model itself:

- image -> vision tower -> mean over its merged-patch embeddings -> L2
  norm;
- text -> token-embedding lookup (``ops.quant.embed_lookup``: float or
  row-quantized int8 tables) -> masked mean -> L2 norm.

Both run on the weights' device (the card when served); ``embed_mixed``
keeps the order of an ``/v1/embeddings`` input list whose entries are
strings or ``{"image": <url / base64>}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from helix_tpu_torch.ops.quant import embed_lookup
from helix_tpu_torch.serving.vision import MAX_PIXELS


class VisionEmbeddingRunner:
    """Batched pooling worker behind /v1/embeddings for image + text."""

    def __init__(self, model_cfg, vcfg, params, vparams, tokenizer,
                 max_pixels: int = MAX_PIXELS):
        self.model_cfg = model_cfg
        self.vcfg = vcfg
        self.params = params          # text params (the embed table is used)
        self.vparams = vparams
        self.tokenizer = tokenizer
        self.max_pixels = max_pixels

    @classmethod
    def build(cls, pm, tokenizer, *, device=DEFAULT_DEVICE,
              seed: int = 0) -> "VisionEmbeddingRunner":
        """From ``pm.checkpoint`` (a Qwen2-VL checkpoint, both towers on
        ``device``) or, without one, the reference's tiny text tower and
        tiny vision tower with random weights from ``seed`` and ``seed +
        1``."""
        from helix_tpu_torch.models.common import ModelConfig
        from helix_tpu_torch.models.llama import init_params
        from helix_tpu_torch.models.qwen2_vl import (
            VisionConfig,
            init_vision_params,
            load_qwen2_vl,
        )

        dev = resolve_device(device)
        if pm.checkpoint:
            model_cfg, vcfg, params = load_qwen2_vl(pm.checkpoint, device=dev)
            model_cfg = dataclasses.replace(model_cfg, name=pm.name)
            vparams = params.pop("visual")
        else:
            model_cfg = ModelConfig.tiny(
                name=pm.name,
                vocab_size=max(getattr(tokenizer, "vocab_size", 512), 512),
            )
            params = init_params(model_cfg, seed, device=dev)
            vcfg = VisionConfig.tiny(hidden_size=model_cfg.hidden_size)
            vparams = init_vision_params(vcfg, seed + 1, device=dev)
        return cls(model_cfg, vcfg, params, vparams, tokenizer)

    @property
    def device(self):
        return self.params["embed"]["weight"].device

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.model_cfg.hidden_size), np.float32)

    # -- public API ----------------------------------------------------------
    def embed_texts(self, texts) -> np.ndarray:
        """Mean-pooled, L2-normalised token embeddings (the vision tower's
        projection space), each text padded to one power-of-two width."""
        if not texts:
            return self._empty()
        token_lists = [
            self.tokenizer.encode(t)[: self.model_cfg.max_position_embeddings]
            or [0]
            for t in texts
        ]
        S = 1
        maxlen = max(len(t) for t in token_lists)
        while S < maxlen:
            S *= 2
        toks = np.zeros((len(token_lists), S), np.int64)
        mask = np.zeros((len(token_lists), S), np.float32)
        for i, t in enumerate(token_lists):
            toks[i, : len(t)] = t
            mask[i, : len(t)] = 1
        with torch.no_grad():
            emb = embed_lookup(self.params["embed"],
                               torch.from_numpy(toks).to(self.device),
                               torch.float32)
            m = torch.from_numpy(mask).to(self.device)[..., None]
            v = (emb * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
            v = v / torch.clamp(torch.linalg.vector_norm(
                v, dim=-1, keepdim=True), min=1e-9)
        return v.cpu().numpy().astype(np.float32)

    def embed_images(self, sources) -> np.ndarray:
        """-> [N, E] pooled vision-tower embeddings; ``sources`` are data
        URLs / base64 / raw bytes (``serving.vision.decode_image``)."""
        from helix_tpu_torch.models.qwen2_vl import vision_forward
        from helix_tpu_torch.serving.vision import decode_image, patchify

        if not sources:
            return self._empty()
        out = []
        for src in sources:
            patches, grid = patchify(
                decode_image(src),
                patch_size=self.vcfg.patch_size,
                temporal_patch_size=self.vcfg.temporal_patch_size,
                merge_size=self.vcfg.spatial_merge_size,
                max_pixels=self.max_pixels,
            )
            with torch.no_grad():
                emb = vision_forward(
                    self.vparams, self.vcfg,
                    torch.from_numpy(patches).to(self.device), [grid])
            v = emb.float().cpu().numpy().mean(axis=0)
            v = v / max(float(np.linalg.norm(v)), 1e-9)
            out.append(v)
        return np.stack(out)

    def embed_mixed(self, inputs) -> np.ndarray:
        """An /v1/embeddings input list where each entry is a string OR
        ``{"image": <url/b64>}``, order preserved."""
        out: list = [None] * len(inputs)
        texts, t_idx, images, i_idx = [], [], [], []
        for i, item in enumerate(inputs):
            if isinstance(item, dict) and "image" in item:
                images.append(item["image"])
                i_idx.append(i)
            else:
                texts.append(str(item))
                t_idx.append(i)
        for i, v in zip(t_idx, self.embed_texts(texts)):
            out[i] = v
        for i, v in zip(i_idx, self.embed_images(images)):
            out[i] = v
        return np.stack(out) if out else self._empty()
