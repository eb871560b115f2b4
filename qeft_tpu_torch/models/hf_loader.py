"""Hugging Face checkpoint directories (``config.json`` and safetensors
shards) read into the port's dense trees.  Counterpart of
``qeft_tpu/models/hf_loader.py``: the same config translation per family,
the same transposes to the ``[K, N]`` (in-features-first) layout, Bloom's
head-interleaved fused qkv and the Falcon new-architecture per-group qkv
de-interleaved into the contiguous ``[q | k | v]`` layout, and the
``model_type`` dispatch of `load_hf_model`.  The tree has the JAX loader's
leaf names (a llama tree keeps ``q``, ``k``, ``v``, ``up``, ``gate``, as
the quantization pipeline reads it).

The safetensors format is read by `read_safetensors`, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte range, then the raw
little-endian data.  A directory holds ``model.safetensors`` or a
``model.safetensors.index.json`` that maps each tensor to its shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _header(f) -> Tuple[Dict, int]:
    """-> (the JSON header, the file offset where the data starts)."""
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def read_safetensors(path: str, names=None) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file (those in ``names``, or all)
    as CPU tensors, each read from its byte range into its own buffer."""
    out = {}
    with open(path, "rb") as f:
        header, start = _header(f)
        for name, info in header.items():
            if name == "__metadata__" or (names is not None and name not in names):
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which "
                                 "the reader does not know")
            begin, end = info["data_offsets"]
            f.seek(start + begin)
            buf = bytearray(f.read(end - begin))
            dtype = _ST_DTYPES[info["dtype"]]
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(info["shape"])
    return out


def _reader(path: str) -> Tuple[Callable[[str], torch.Tensor], Callable[[str], bool]]:
    """(get(name) -> CPU tensor, has(name) -> bool) over the directory's
    shards."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            key_to_file = json.load(f)["weight_map"]
    else:
        with open(os.path.join(path, "model.safetensors"), "rb") as f:
            key_to_file = {k: "model.safetensors" for k in _header(f)[0] if k != "__metadata__"}

    def get(name: str) -> torch.Tensor:
        return read_safetensors(os.path.join(path, key_to_file[name]), {name})[name]

    return get, (lambda name: name in key_to_file)


def _hf_config(path: str) -> Dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _stack(blocks):
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def _loaders(path: str, dtype):
    """(get(name): the tensor as stored, arr(name): in ``dtype``, lin(name):
    an HF ``[out, in]`` weight as our ``[K, N]``, has(name))."""
    get, has = _reader(path)

    def arr(name):
        return get(name).to(dtype)

    def lin(name):
        return get(name).t().to(dtype).contiguous()

    return get, arr, lin, has


def _head(params, lin, has) -> torch.Tensor:
    if has("lm_head.weight"):
        return lin("lm_head.weight")
    return params["embed"].t().contiguous()  # tied embeddings


def config_from_hf(path: str):
    """The ``LlamaConfig`` of a llama-family Hugging Face directory's
    ``config.json`` (gemma's numerics where ``model_type`` says so)."""
    from qeft_tpu_torch.models.llama import LlamaConfig

    hc = _hf_config(path)
    gemma = hc.get("model_type", "llama").lower() == "gemma"
    return LlamaConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        head_dim=hc.get("head_dim", hc["hidden_size"] // hc["num_attention_heads"]),
        max_position_embeddings=hc.get("max_position_embeddings", 4096),
        rms_norm_eps=hc.get("rms_norm_eps", 1e-5), rope_theta=hc.get("rope_theta", 10000.0),
        act="gelu_tanh" if gemma else "silu", rms_one_offset=gemma, embed_scale=gemma)


def load_hf_llama(path: str, dtype=torch.bfloat16):
    cfg = config_from_hf(path)
    _, arr, lin, has = _loaders(path, dtype)
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "up": "mlp.up_proj", "gate": "mlp.gate_proj",
             "down": "mlp.down_proj"}
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        blk = {"input_ln": arr(pre + "input_layernorm.weight"),
               "post_ln": arr(pre + "post_attention_layernorm.weight")}
        blk.update({ours: lin(pre + theirs + ".weight") for ours, theirs in names.items()})
        blocks.append(blk)
    params = {"embed": arr("model.embed_tokens.weight"), "layers": _stack(blocks),
              "final_ln": arr("model.norm.weight")}
    params["lm_head"] = _head(params, lin, has)
    return params, cfg


def load_hf_opt(path: str, dtype=torch.bfloat16):
    from qeft_tpu_torch.models.opt import OPTConfig

    hc = _hf_config(path)
    wepd = hc.get("word_embed_proj_dim", hc["hidden_size"])
    cfg = OPTConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"], ffn_dim=hc["ffn_dim"],
        num_layers=hc["num_hidden_layers"], num_heads=hc["num_attention_heads"],
        max_position_embeddings=hc.get("max_position_embeddings", 2048),
        do_layer_norm_before=hc.get("do_layer_norm_before", True),
        word_embed_proj_dim=None if wepd == hc["hidden_size"] else wepd)
    _, arr, lin, has = _loaders(path, dtype)
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.out_proj", "fc1": "fc1", "fc2": "fc2"}
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"model.decoder.layers.{i}."
        blk = {"attn_ln": arr(pre + "self_attn_layer_norm.weight"),
               "attn_ln_b": arr(pre + "self_attn_layer_norm.bias"),
               "final_ln": arr(pre + "final_layer_norm.weight"),
               "final_ln_b": arr(pre + "final_layer_norm.bias")}
        for ours, theirs in names.items():
            blk[ours] = lin(pre + theirs + ".weight")
            blk[ours + "_b"] = arr(pre + theirs + ".bias")
        blocks.append(blk)
    params = {"embed": arr("model.decoder.embed_tokens.weight"),
              "embed_pos": arr("model.decoder.embed_positions.weight"),
              "layers": _stack(blocks)}
    if has("model.decoder.final_layer_norm.weight"):
        params["final_ln"] = arr("model.decoder.final_layer_norm.weight")
        params["final_ln_b"] = arr("model.decoder.final_layer_norm.bias")
    if has("model.decoder.project_in.weight"):  # opt-350m's narrow embedding space
        params["project_in"] = lin("model.decoder.project_in.weight")
        params["project_out"] = lin("model.decoder.project_out.weight")
    params["lm_head"] = _head(params, lin, has)
    return params, cfg


def load_hf_phi(path: str, dtype=torch.bfloat16):
    from qeft_tpu_torch.models.phi import PhiConfig

    hc = _hf_config(path)
    cfg = PhiConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads") or hc["num_attention_heads"],
        max_position_embeddings=hc.get("max_position_embeddings", 2048),
        layer_norm_eps=hc.get("layer_norm_eps", 1e-5),
        partial_rotary_factor=hc.get("partial_rotary_factor", 0.5),
        rope_theta=hc.get("rope_theta", 10000.0))
    _, arr, lin, has = _loaders(path, dtype)
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.dense", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        blk = {"input_ln": arr(pre + "input_layernorm.weight"),
               "input_ln_b": arr(pre + "input_layernorm.bias")}
        for ours, theirs in names.items():
            blk[ours] = lin(pre + theirs + ".weight")
            blk[ours + "_b"] = arr(pre + theirs + ".bias")
        blocks.append(blk)
    params = {"embed": arr("model.embed_tokens.weight"), "layers": _stack(blocks),
              "final_ln": arr("model.final_layernorm.weight"),
              "final_ln_b": arr("model.final_layernorm.bias"),
              "lm_head": lin("lm_head.weight"),
              "lm_head_b": (arr("lm_head.bias") if has("lm_head.bias")
                            else torch.zeros(cfg.vocab_size, dtype=dtype))}
    return params, cfg


def load_hf_bloom(path: str, dtype=torch.bfloat16):
    """HF's fused query_key_value is head-interleaved ([H, 3, Dh] output
    rows); ours is the contiguous [q | k | v], de-interleaved once here."""
    from qeft_tpu_torch.models.bloom import BloomConfig

    hc = _hf_config(path)
    d = hc.get("hidden_size") or hc["n_embed"]
    h = hc.get("num_attention_heads") or hc["n_head"]
    cfg = BloomConfig(vocab_size=hc["vocab_size"], hidden_size=d,
                      num_layers=hc.get("num_hidden_layers") or hc["n_layer"], num_heads=h,
                      layer_norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    get, arr, lin, has = _loaders(path, dtype)
    dh = d // h

    def qkv_rows(t):  # [3D, ...] rows [H, 3, Dh] -> [3D, ...] rows [3, H, Dh]
        return t.reshape(h, 3, dh, *t.shape[1:]).transpose(0, 1).reshape(t.shape)

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        qkv = pre + "self_attention.query_key_value."
        blocks.append({
            "attn_ln": arr(pre + "input_layernorm.weight"),
            "attn_ln_b": arr(pre + "input_layernorm.bias"),
            "post_ln": arr(pre + "post_attention_layernorm.weight"),
            "post_ln_b": arr(pre + "post_attention_layernorm.bias"),
            "qkv": qkv_rows(get(qkv + "weight")).t().to(dtype).contiguous(),
            "qkv_b": qkv_rows(get(qkv + "bias")).to(dtype),
            "dense": lin(pre + "self_attention.dense.weight"),
            "dense_b": arr(pre + "self_attention.dense.bias"),
            "fc1": lin(pre + "mlp.dense_h_to_4h.weight"),
            "fc1_b": arr(pre + "mlp.dense_h_to_4h.bias"),
            "fc2": lin(pre + "mlp.dense_4h_to_h.weight"),
            "fc2_b": arr(pre + "mlp.dense_4h_to_h.bias"),
        })
    params = {"embed": arr("transformer.word_embeddings.weight"),
              "embed_ln": arr("transformer.word_embeddings_layernorm.weight"),
              "embed_ln_b": arr("transformer.word_embeddings_layernorm.bias"),
              "layers": _stack(blocks),
              "final_ln": arr("transformer.ln_f.weight"),
              "final_ln_b": arr("transformer.ln_f.bias")}
    params["lm_head"] = _head(params, lin, has)  # bloom ties it to the embedding
    return params, cfg


def falcon_qkv_deinterleave_ids(hq: int, hkv: int, dh: int) -> np.ndarray:
    """Column ids turning the new architecture's per-group fused qkv --
    [q_g0.., k_g0, v_g0, q_g1.., k_g1, v_g1, ...], hq / hkv query heads a
    kv group -- into the contiguous [all q | all k | all v]."""
    q_per = hq // hkv
    stride = (q_per + 2) * dh
    ids = []
    for h in range(hq):
        g, j = divmod(h, q_per)
        ids.append(np.arange(g * stride + j * dh, g * stride + (j + 1) * dh))
    for first in (q_per, q_per + 1):  # the k heads, then the v heads
        ids.extend(np.arange(g * stride + first * dh, g * stride + (first + 1) * dh)
                   for g in range(hkv))
    return np.concatenate(ids)


def load_hf_falcon(path: str, dtype=torch.bfloat16):
    """Both lineages: falcon-7b (multi-query, one LayerNorm a block, the
    fused qkv already [q | k | v]) and the new decoder architecture
    (falcon-40B/180B: GQA, ``ln_attn`` and ``ln_mlp``, a per-group fused
    qkv de-interleaved once here)."""
    from qeft_tpu_torch.models.falcon import FalconConfig

    hc = _hf_config(path)
    new_arch = bool(hc.get("new_decoder_architecture"))
    if not new_arch and not hc.get("multi_query", True):
        raise NotImplementedError("the falcon loader reads the falcon-7b (multi_query) and "
                                  "new_decoder_architecture lineages")
    hq = hc["num_attention_heads"]
    hkv = hc.get("num_kv_heads", hq) if new_arch else 1
    cfg = FalconConfig(vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
                       num_layers=hc["num_hidden_layers"], num_heads=hq, num_kv_heads=hkv,
                       layer_norm_eps=hc.get("layer_norm_epsilon", 1e-5),
                       rope_theta=hc.get("rope_theta", 10000.0), dual_ln=new_arch)
    get, arr, lin, has = _loaders(path, dtype)
    ids = (torch.from_numpy(falcon_qkv_deinterleave_ids(hq, hkv, cfg.head_dim))
           if new_arch else None)
    ln = "ln_attn" if new_arch else "input_layernorm"
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        qkv = get(pre + "self_attention.query_key_value.weight").t()
        if ids is not None:
            qkv = qkv[:, ids]
        blk = {"attn_ln": arr(pre + ln + ".weight"), "attn_ln_b": arr(pre + ln + ".bias"),
               "qkv": qkv.to(dtype).contiguous(),
               "dense": lin(pre + "self_attention.dense.weight"),
               "fc1": lin(pre + "mlp.dense_h_to_4h.weight"),
               "fc2": lin(pre + "mlp.dense_4h_to_h.weight")}
        if new_arch:
            blk["mlp_ln"] = arr(pre + "ln_mlp.weight")
            blk["mlp_ln_b"] = arr(pre + "ln_mlp.bias")
        blocks.append(blk)
    params = {"embed": arr("transformer.word_embeddings.weight"), "layers": _stack(blocks),
              "final_ln": arr("transformer.ln_f.weight"),
              "final_ln_b": arr("transformer.ln_f.bias")}
    params["lm_head"] = _head(params, lin, has)
    return params, cfg


def load_hf_model(path: str, dtype=torch.bfloat16, device=None):
    """``config.json``'s ``model_type`` picks the family loader -> (dense
    tree on ``device``, config, family); ``device`` as `resolve_device`
    takes it (the card unless ``"cpu"`` is named).  Mistral runs as llama,
    its position budget capped at its sliding window."""
    from qeft_tpu_torch.device import resolve_device

    device = resolve_device(device)
    hc = _hf_config(path)
    mt = hc.get("model_type", "llama").lower()
    if mt in ("llama", "gemma", "mistral"):
        params, cfg = load_hf_llama(path, dtype)
        sw = (hc.get("sliding_window") or 0) if mt == "mistral" else 0
        if sw and sw < cfg.max_position_embeddings:
            cfg = dataclasses.replace(cfg, max_position_embeddings=sw)
        family = "gemma" if mt == "gemma" else "llama"
    elif mt in ("opt", "phi", "bloom", "falcon"):
        params, cfg = globals()[f"load_hf_{mt}"](path, dtype)
        family = mt
    else:
        raise NotImplementedError(f"HF model_type {mt!r} not supported")
    from qeft_tpu_torch.checkpoint import tree_map

    return tree_map(lambda t: t.to(device), params), cfg, family
