"""A writer of HF-layout safetensors checkpoints from a port parameter
tree (test scaffolding, not served code).

``write_checkpoint(model_dir, cfg, params)`` writes what a HuggingFace
export of the same model holds: ``config.json`` with HF field names,
projections back in HF's ``[out, in]`` layout under HF names
(``model.layers.{i}.self_attn.q_proj.weight``, ...), Phi-3's fused
``qkv_proj`` / ``gate_up_proj`` with ``fused=True``, a Mixtral tree's
router and experts as ``block_sparse_moe.gate`` and
``block_sparse_moe.experts.{e}.w1|w2|w3`` (``model_type="mixtral"``), and
shards of at most
``max_shard_bytes`` (HF's 5 GB) with a ``model.safetensors.index.json``
when there is more than one.  The files are what the ``safetensors``
package writes and reads; tensors go to disk one layer at a time, so a
parameter tree on the card is never copied to the host whole.

``write_qwen2_vl_checkpoint(model_dir, cfg, params, vcfg, vparams)`` writes
a Qwen2-VL export: ``model_type: qwen2_vl`` with its ``vision_config``,
mrope ``rope_scaling`` and image token ids, the text tower under
``model.language_model.`` and the vision tower under ``model.visual.``
(``naming="new"``, transformers >= 4.52) or under ``model.`` and
``visual.`` (``naming="old"``), ``lm_head.weight`` in both.

``write_encoder_checkpoint(model_dir, cfg, params)`` does the same for a
``models.bge`` encoder: a BERT ``config.json`` and one
``model.safetensors`` under HF BERT names (``bert.`` before each with
``prefix="bert."``), with a pooler as a BERT export has one (the loaders
do not read it).
"""

from __future__ import annotations

import json
import math
import os
import struct

import torch

from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.st_format import FORMAT_NAMES, INDEX_NAME

MAX_SHARD_BYTES = 5_000_000_000


def hf_config(cfg: ModelConfig, model_type: str = "llama",
              **extra) -> dict:
    """``config.json`` for ``cfg`` with HF field names (what
    ``ModelConfig.from_hf_config`` reads back to an equal config)."""
    out = {
        "architectures": [{"llama": "LlamaForCausalLM",
                           "phi3": "Phi3ForCausalLM",
                           "qwen2": "Qwen2ForCausalLM",
                           "qwen3": "Qwen3ForCausalLM",
                           "mixtral": "MixtralForCausalLM"}.get(
                               model_type, "LlamaForCausalLM")],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": dict(cfg.rope_scaling) if cfg.rope_scaling else None,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "hidden_act": cfg.hidden_act,
        "attention_bias": cfg.attention_bias,
        "mlp_bias": cfg.mlp_bias,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": cfg.dtype,
    }
    if cfg.num_experts > 0:
        out["num_local_experts"] = cfg.num_experts
        out["num_experts_per_tok"] = cfg.num_experts_per_tok
    out.update(extra)
    return out


def _hf_tensors(cfg: ModelConfig, params: dict, fused: bool) -> list:
    """``(HF name, shape, dtype, make)`` in the order HF writes them;
    ``make()`` gives the CPU tensor in HF layout, one layer's at a time
    (the views it reads are taken now, nothing is copied until then)."""
    lay = params["layers"]
    out = []

    def linear(name, views):
        """Views ``[in, out_k]`` concatenated on ``out``, as ``[out, in]``."""
        shape = (sum(v.shape[1] for v in views), views[0].shape[0])
        out.append((name, shape, views[0].dtype,
                    lambda: torch.cat(views, dim=1).t().contiguous().cpu()))

    def plain(name, view):
        out.append((name, tuple(view.shape), view.dtype,
                    lambda: view.contiguous().cpu()))

    plain("model.embed_tokens.weight", params["embed"]["weight"])
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        plain(p + "input_layernorm.weight", lay["attn_norm"]["weight"][i])
        plain(p + "post_attention_layernorm.weight",
              lay["mlp_norm"]["weight"][i])
        qkv = [lay[k]["weight"][i] for k in ("wq", "wk", "wv")]
        if fused:
            linear(p + "self_attn.qkv_proj.weight", qkv)
        else:
            for hf, w in zip(("q_proj", "k_proj", "v_proj"), qkv):
                linear(p + f"self_attn.{hf}.weight", [w])
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj")):
            if "bias" in lay[ours]:
                plain(p + f"self_attn.{hf}.bias", lay[ours]["bias"][i])
        linear(p + "self_attn.o_proj.weight", [lay["wo"]["weight"][i]])
        if "q_norm" in lay:
            plain(p + "self_attn.q_norm.weight", lay["q_norm"]["weight"][i])
            plain(p + "self_attn.k_norm.weight", lay["k_norm"]["weight"][i])
        if "experts" in lay:
            # Mixtral: the router, then each expert's w1 / w2 / w3
            moe = p + "block_sparse_moe."
            linear(moe + "gate.weight", [lay["router"]["weight"][i]])
            ex = lay["experts"]
            for e in range(cfg.num_experts):
                for hf, ours in (("w1", "w_gate"), ("w2", "w_down"),
                                 ("w3", "w_up")):
                    linear(moe + f"experts.{e}.{hf}.weight",
                           [ex[ours]["weight"][i, e]])
            continue
        gate, up = lay["w_gate"]["weight"][i], lay["w_up"]["weight"][i]
        if fused:
            linear(p + "mlp.gate_up_proj.weight", [gate, up])
        else:
            linear(p + "mlp.gate_proj.weight", [gate])
            linear(p + "mlp.up_proj.weight", [up])
        linear(p + "mlp.down_proj.weight", [lay["w_down"]["weight"][i]])
    plain("model.norm.weight", params["final_norm"]["weight"])
    if "lm_head" in params:
        linear("lm_head.weight", [params["lm_head"]["weight"]])
    return out


def write_checkpoint(model_dir: str, cfg: ModelConfig, params: dict, *,
                     model_type: str = "llama", fused: bool = False,
                     max_shard_bytes: int = MAX_SHARD_BYTES,
                     config_extra: dict | None = None) -> list:
    """Write ``params`` (an ``init_params`` tree, unquantized, on any
    device) as an HF checkpoint in ``model_dir``; returns the paths of
    the files written (``config.json`` first)."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "config.json")
    with open(path, "w") as f:
        json.dump(hf_config(cfg, model_type, **(config_extra or {})), f,
                  indent=2)
    return [path] + _write_safetensors(
        model_dir, _hf_tensors(cfg, params, fused), max_shard_bytes)


def _write_safetensors(model_dir: str, tensors: list,
                       max_shard_bytes: int = MAX_SHARD_BYTES) -> list:
    """``(name, shape, dtype, make)`` tensors (``make()`` gives a CPU
    tensor) as safetensors shards of at most ``max_shard_bytes`` in
    ``model_dir``, with the index when there is more than one; returns
    the paths written."""
    metas = [(name, shape, dtype, math.prod(shape) * dtype.itemsize)
             for name, shape, dtype, _make in tensors]
    shards, cur, cur_bytes = [], [], 0
    for i, m in enumerate(metas):
        if cur and cur_bytes + m[3] > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += m[3]
    shards.append(cur)
    names = (["model.safetensors"] if len(shards) == 1 else
             [f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
              for k in range(len(shards))])
    paths = []
    weight_map = {}
    for fname, idx in zip(names, shards):
        header, at = {}, 0
        for i in idx:
            name, shape, dtype, n = metas[i]
            header[name] = {"dtype": FORMAT_NAMES[dtype],
                            "shape": list(shape),
                            "data_offsets": [at, at + n]}
            at += n
            weight_map[name] = fname
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)    # safetensors pads to 8 bytes
        path = os.path.join(model_dir, fname)
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for i in idx:
                name, shape, dtype, _n = metas[i]
                x = tensors[i][3]()
                if tuple(x.shape) != shape or x.dtype != dtype:
                    raise AssertionError(f"{name}: made {tuple(x.shape)} "
                                         f"{x.dtype}, header {shape} {dtype}")
                if x.numel():
                    f.write(memoryview(x.contiguous().view(torch.uint8)
                                       .numpy()))
        paths.append(path)
    if len(shards) > 1:
        total = sum(m[3] for m in metas)
        path = os.path.join(model_dir, INDEX_NAME)
        with open(path, "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
        paths.append(path)
    return paths


# Qwen/Qwen2-VL-7B-Instruct's image token ids (its config.json)
QWEN2_VL_TOKEN_IDS = {"image_token_id": 151655, "video_token_id": 151656,
                      "vision_start_token_id": 151652,
                      "vision_end_token_id": 151653}


def qwen2_vl_hf_config(cfg: ModelConfig, vcfg, token_ids=None) -> dict:
    """``config.json`` of a Qwen2-VL export (text fields at the top, as
    both packages' loaders read them)."""
    out = hf_config(cfg, "qwen2_vl")
    out["architectures"] = ["Qwen2VLForConditionalGeneration"]
    out["rope_scaling"] = {"type": "mrope",
                           "mrope_section": list(cfg.mrope_sections)}
    out["vision_config"] = {
        "depth": vcfg.depth, "embed_dim": vcfg.embed_dim,
        "hidden_size": vcfg.hidden_size, "num_heads": vcfg.num_heads,
        "mlp_ratio": vcfg.mlp_ratio, "in_chans": vcfg.in_channels,
        "in_channels": vcfg.in_channels, "patch_size": vcfg.patch_size,
        "spatial_merge_size": vcfg.spatial_merge_size,
        "temporal_patch_size": vcfg.temporal_patch_size,
    }
    out.update(token_ids or QWEN2_VL_TOKEN_IDS)
    return out


def _vision_tensors(vcfg, vparams: dict, prefix: str) -> list:
    """The vision tower's HF tensors under ``prefix`` (``visual.`` or
    ``model.visual.``), HF layouts, one block's at a time."""
    out = []
    E = vcfg.embed_dim

    def plain(name, view):
        out.append((prefix + name, tuple(view.shape), view.dtype,
                    lambda: view.contiguous().cpu()))

    def linear(name, w, shape=None):
        hf = tuple(w.shape)[::-1] if shape is None else shape
        out.append((prefix + name, hf, w.dtype,
                    lambda: w.t().contiguous().reshape(hf).cpu()))

    linear("patch_embed.proj.weight", vparams["patch_embed"]["weight"],
           (E, vcfg.in_channels, vcfg.temporal_patch_size, vcfg.patch_size,
            vcfg.patch_size))
    blk = vparams["blocks"]
    for i in range(vcfg.depth):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            plain(p + norm + ".weight", blk[norm]["weight"][i])
            plain(p + norm + ".bias", blk[norm]["bias"][i])
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            linear(p + theirs + ".weight", blk[ours]["weight"][i])
            plain(p + theirs + ".bias", blk[ours]["bias"][i])
    m = vparams["merger"]
    plain("merger.ln_q.weight", m["ln_q"]["weight"])
    plain("merger.ln_q.bias", m["ln_q"]["bias"])
    for ours, k in (("mlp0", 0), ("mlp2", 2)):
        linear(f"merger.mlp.{k}.weight", m[ours]["weight"])
        plain(f"merger.mlp.{k}.bias", m[ours]["bias"])
    return out


def write_qwen2_vl_checkpoint(model_dir: str, cfg: ModelConfig, params: dict,
                              vcfg, vparams: dict, *, naming: str = "new",
                              max_shard_bytes: int = MAX_SHARD_BYTES,
                              token_ids: dict | None = None) -> list:
    """Write a Qwen2-VL text tower (``params``, an ``init_params`` tree of
    an mrope config with qkv bias) and vision tower (``vparams``, an
    ``init_vision_params`` tree) as an HF checkpoint; returns the paths
    written (``config.json`` first)."""
    if naming not in ("new", "old"):
        raise ValueError(f"naming {naming!r}: expected 'new' or 'old'")
    text_pfx, vis_pfx = (("model.language_model.", "model.visual.")
                         if naming == "new" else ("model.", "visual."))
    text = [(n if n == "lm_head.weight" else text_pfx + n[len("model."):],
             *rest) for n, *rest in _hf_tensors(cfg, params, False)]
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "config.json")
    with open(path, "w") as f:
        json.dump(qwen2_vl_hf_config(cfg, vcfg, token_ids), f, indent=2)
    return [path] + _write_safetensors(
        model_dir, text + _vision_tensors(vcfg, vparams, vis_pfx),
        max_shard_bytes)


def encoder_hf_config(cfg) -> dict:
    """A BERT ``config.json`` for a ``models.bge.EncoderConfig``."""
    return {"architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
            "torch_dtype": cfg.dtype}


def write_encoder_checkpoint(model_dir: str, cfg, params: dict, *,
                             prefix: str = "") -> list:
    """Write a ``models.bge`` parameter tree as an HF BERT checkpoint;
    returns the paths written (``config.json`` first)."""
    os.makedirs(model_dir, exist_ok=True)
    emb, lay = params["embed"], params["layers"]
    out = []

    def plain(name, view):
        out.append((prefix + name, tuple(view.shape), view.dtype,
                    lambda: view.detach().cpu()))

    def linear(name, w, b):
        # [in, out] -> HF's [out, in]
        out.append((prefix + name + ".weight", tuple(w.shape)[::-1],
                    w.dtype, lambda: w.detach().t().contiguous().cpu()))
        plain(name + ".bias", b)

    plain("embeddings.word_embeddings.weight", emb["word"])
    plain("embeddings.position_embeddings.weight", emb["position"])
    plain("embeddings.token_type_embeddings.weight", emb["token_type"])
    plain("embeddings.LayerNorm.weight", emb["norm"]["weight"])
    plain("embeddings.LayerNorm.bias", emb["norm"]["bias"])
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for ours, theirs in (("wq", "attention.self.query"),
                             ("wk", "attention.self.key"),
                             ("wv", "attention.self.value"),
                             ("wo", "attention.output.dense"),
                             ("w_in", "intermediate.dense"),
                             ("w_out", "output.dense")):
            linear(p + theirs, lay[ours]["weight"][i], lay[ours]["bias"][i])
        for ours, theirs in (("attn_norm", "attention.output.LayerNorm"),
                             ("mlp_norm", "output.LayerNorm")):
            plain(p + theirs + ".weight", lay[ours]["weight"][i])
            plain(p + theirs + ".bias", lay[ours]["bias"][i])
    E = cfg.hidden_size
    pooler = torch.zeros((E, E), dtype=emb["word"].dtype)
    plain("pooler.dense.weight", pooler)
    plain("pooler.dense.bias", pooler[0])
    path = os.path.join(model_dir, "config.json")
    with open(path, "w") as f:
        json.dump(encoder_hf_config(cfg), f, indent=2)
    return [path] + _write_safetensors(model_dir, out)
