"""BERT-family embedding encoder (bge-base et al) in PyTorch.

Port of ``helix_tpu/models/bge.py``: tokens -> embeddings -> post-norm
BERT layers -> ``cls`` / ``mean`` pool -> L2 normalise, behind
``/v1/embeddings`` (BASELINE config 2, "bge-base embedding worker for
PGVector RAG ingest").

The parameter tree keeps the reference's layout (projections ``[in,
out]`` used as ``x @ W``, every layer tensor stacked on a leading
``num_layers`` dim), so ``params_from_jax`` is a plain copy.  The
attention is the reference's plain bidirectional softmax (a ``-1e9``
bias under the mask), not a Pallas kernel there, and plain torch ops
here, in float32: TF32 stays off (``torch.backends.cuda.matmul.
allow_tf32`` keeps its default, False), so the card computes what the
CPU computes, up to summation order.

``EmbeddingRunner`` batches as the reference does: chunks of
``max_batch`` rows, each padded to ``S``, the next power of two of the
chunk's longest row capped at ``max_position_embeddings``; a longer row
is cut at ``S`` without a word (the reference's silent truncation), and
padding is zeros under the mask.  A chunk's ids and mask go to the
model's device as one tensor.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from helix_tpu_torch.models.llama import params_from_jax, params_to
from helix_tpu_torch.models.st_format import SafetensorsDir
from helix_tpu_torch.ops.norms import layer_norm

log = logging.getLogger(__name__)

__all__ = ["EncoderConfig", "init_params", "params_from_jax", "forward",
           "load_hf_encoder", "EmbeddingRunner"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "cls"          # cls | mean  (bge uses CLS)
    normalize: bool = True
    dtype: str = "float32"
    name: str = "bge-base"

    @classmethod
    def from_hf_config(cls, hf: dict,
                       name: str = "encoder") -> "EncoderConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            name=name,
        )

    @classmethod
    def tiny(cls, **o) -> "EncoderConfig":
        base = dict(
            vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, name="tiny-enc",
        )
        base.update(o)
        return cls(**base)


_NORMS = ("attn_norm", "mlp_norm")


def init_params(cfg: EncoderConfig, generator: torch.Generator | None = None,
                *, seed: int = 0, device=DEFAULT_DEVICE) -> dict:
    """Random-init the reference's tree on ``device``: normal x 0.02 for
    projections and embeddings, ones / zeros for the norms, zero biases.
    Draws come from ``generator`` (a ``torch.Generator`` on ``device``;
    else one seeded with ``seed``) in a fixed order."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, E, F_, V = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                   cfg.vocab_size)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.02).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm(*lead):
        return {"weight": torch.ones((*lead, E), dtype=dt, device=dev),
                "bias": zeros(*lead, E)}

    shapes = {"wq": (E, E), "wk": (E, E), "wv": (E, E), "wo": (E, E),
              "w_in": (E, F_), "w_out": (F_, E)}
    embed = {"word": w(V, E), "position": w(cfg.max_position_embeddings, E),
             "token_type": w(cfg.type_vocab_size, E), "norm": norm()}
    layers = {k: {"weight": w(L, *s), "bias": zeros(L, s[1])}
              for k, s in shapes.items()}
    layers.update({k: norm(L) for k in _NORMS})
    return {"embed": embed, "layers": layers}


def _dense(x, p):
    """``x @ W + b`` accumulated in float32, cast back to ``x``'s dtype."""
    out = torch.matmul(x.float(), p["weight"].float())
    return (out + p["bias"].float()).to(x.dtype)


def forward(params: dict, cfg: EncoderConfig, tokens: torch.Tensor,
            attention_mask: torch.Tensor) -> torch.Tensor:
    """tokens / attention_mask ``[B, S]`` (on the params' device) ->
    pooled embeddings ``[B, E]``.  An id past the vocab reads the last
    row, as the reference's gather clamps."""
    B, S = tokens.shape
    H, E = cfg.num_heads, cfg.hidden_size
    D = E // H
    dt = torch_dtype(cfg.dtype)
    emb = params["embed"]
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)
    h = (emb["word"][ids] + emb["position"][:S][None]
         + emb["token_type"][0]).to(dt)
    h = layer_norm(h, emb["norm"]["weight"], emb["norm"]["bias"],
                   cfg.layer_norm_eps)
    # bidirectional mask: [B, 1, 1, S]
    bias = torch.where(attention_mask[:, None, None, :] > 0,
                       torch.zeros((), dtype=torch.float32, device=h.device),
                       torch.full((), -1e9, dtype=torch.float32,
                                  device=h.device))
    lay = params["layers"]
    scale = 1.0 / math.sqrt(D)
    for i in range(cfg.num_layers):
        lp = {k: {n: t[i] for n, t in v.items()} for k, v in lay.items()}
        q = _dense(h, lp["wq"]).view(B, S, H, D).float()
        k = _dense(h, lp["wk"]).view(B, S, H, D).float()
        v = _dense(h, lp["wv"]).view(B, S, H, D).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        p = torch.softmax(s + bias, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, E).to(dt)
        h = layer_norm(h + _dense(ctx, lp["wo"]), lp["attn_norm"]["weight"],
                       lp["attn_norm"]["bias"], cfg.layer_norm_eps)
        mid = F.gelu(_dense(h, lp["w_in"]), approximate="none")
        h = layer_norm(h + _dense(mid, lp["w_out"]), lp["mlp_norm"]["weight"],
                       lp["mlp_norm"]["bias"], cfg.layer_norm_eps)
    if cfg.pooling == "cls":
        pooled = h[:, 0]
    else:
        m = attention_mask[..., None].float()
        pooled = ((h.float() * m).sum(1) / m.sum(1).clamp_min(1.0)).to(dt)
    if cfg.normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled.float(), dim=-1, keepdim=True).to(pooled.dtype)
    return pooled


def load_hf_encoder(model_dir: str, device=DEFAULT_DEVICE) -> tuple:
    """``(EncoderConfig, params on device)`` of an HF BERT-style checkpoint
    (``config.json`` and safetensors): an optional ``bert.`` prefix on
    every name, linear weights transposed to ``[in, out]``, per-layer
    tensors stacked, as the reference's loader."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    cfg = EncoderConfig.from_hf_config(hf, name=os.path.basename(model_dir))
    dt = torch_dtype(cfg.dtype)
    with SafetensorsDir(model_dir) as st:
        pfx = "bert." if any(n.startswith("bert.") for n in st.names()) \
            else ""

        def g(name, transpose=False):
            # a copy: the mapped file closes with the reader
            t = st.get(pfx + name).to(device=dev, dtype=dt, copy=True)
            return t.t().contiguous() if transpose else t

        def stack(fmt, transpose=False):
            return torch.stack([g(fmt.format(i), transpose)
                                for i in range(cfg.num_layers)])

        layers = {}
        for ours, theirs in (("wq", "attention.self.query"),
                             ("wk", "attention.self.key"),
                             ("wv", "attention.self.value"),
                             ("wo", "attention.output.dense"),
                             ("w_in", "intermediate.dense"),
                             ("w_out", "output.dense")):
            base = "encoder.layer.{}." + theirs
            layers[ours] = {"weight": stack(base + ".weight", True),
                            "bias": stack(base + ".bias")}
        for ours, theirs in (("attn_norm", "attention.output.LayerNorm"),
                             ("mlp_norm", "output.LayerNorm")):
            base = "encoder.layer.{}." + theirs
            layers[ours] = {"weight": stack(base + ".weight"),
                            "bias": stack(base + ".bias")}
        params = {
            "embed": {
                "word": g("embeddings.word_embeddings.weight"),
                "position": g("embeddings.position_embeddings.weight"),
                "token_type": g("embeddings.token_type_embeddings.weight"),
                "norm": {"weight": g("embeddings.LayerNorm.weight"),
                         "bias": g("embeddings.LayerNorm.bias")},
            },
            "layers": layers,
        }
    return cfg, params


class EmbeddingRunner:
    """Batched embedding worker behind ``/v1/embeddings``.  Calls from
    several HTTP threads run side by side: the forward keeps no state."""

    def __init__(self, cfg: EncoderConfig, params: dict, tokenizer,
                 max_batch: int = 32):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_batch = max_batch

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["word"].device

    @classmethod
    def build(cls, pm, tokenizer, *, device=DEFAULT_DEVICE,
              seed: int = 0) -> "EmbeddingRunner":
        """The runner of profile entry ``pm`` (``name``, ``checkpoint``,
        ``engine``): the checkpoint's weights, else the reference's tiny
        encoder with random weights from ``seed``; ``engine.max_batch``
        (32 by default) rows per forward."""
        if pm.checkpoint:
            cfg, params = load_hf_encoder(pm.checkpoint, device=device)
        else:
            cfg = EncoderConfig.tiny(name=pm.name)
            params = init_params(cfg, seed=seed, device=device)
        if cfg.pooling == "cls":
            # the reference encodes with add_special_tokens=False: a real
            # checkpoint's [CLS] is never prepended
            log.info("%s: encoding without special tokens, as the "
                     "reference does: cls pooling reads the first token's "
                     "state, not a [CLS]", pm.name)
        return cls(cfg, params, tokenizer,
                   max_batch=(pm.engine or {}).get("max_batch", 32))

    def chunk_arrays(self, chunk) -> np.ndarray:
        """``[2, B, S]`` int64: the padded ids and the mask of one chunk
        of token lists, cut at ``S`` (the reference's bucketing)."""
        maxlen = min(max((len(t) for t in chunk), default=1),
                     self.cfg.max_position_embeddings)
        S = 1
        while S < maxlen:
            S *= 2
        S = min(S, self.cfg.max_position_embeddings)
        out = np.zeros((2, len(chunk), S), np.int64)
        for j, t in enumerate(chunk):
            t = list(t)[:S]
            out[0, j, :len(t)] = t
            out[1, j, :len(t)] = 1
        return out

    @torch.inference_mode()
    def embed_tokens(self, token_lists) -> np.ndarray:
        out = []
        for i in range(0, len(token_lists), self.max_batch):
            rows = torch.from_numpy(self.chunk_arrays(
                token_lists[i:i + self.max_batch])).to(self.device)
            out.append(forward(self.params, self.cfg, rows[0], rows[1])
                       .float().cpu().numpy())
        if not out:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        return np.concatenate(out, axis=0)

    def embed_texts(self, texts) -> np.ndarray:
        return self.embed_tokens([self.tokenizer.encode(t) for t in texts])

    def to(self, device) -> "EmbeddingRunner":
        """The same runner with its weights on ``device``."""
        return EmbeddingRunner(self.cfg, params_to(self.params, device),
                               self.tokenizer, self.max_batch)
