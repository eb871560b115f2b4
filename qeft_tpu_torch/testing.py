"""Shape-faithful random packed models, built on the device from a seed, the
dense model a packed one stands for, and a dense OPT tree written as a
Hugging Face directory.  Test tooling: the machine with the card holds no
checkpoint.

Counterpart of ``qeft_tpu/testing.py``.  A llama model has its value
distributions (random full-range words, scales in [0.01, 0.03), zero points
in (-0.16, 0], oweight ~ N(0, 0.02)) and is built directly in fused-stage
form (``qkv``, ``upgate``) without the TPU-only padding or banded operands.
An OPT, Phi, Bloom or Falcon model keeps its family's linear names, with its
norms, embeddings and heads shaped as the family's ``init_params`` makes
them, every linear bias drawn ~ N(0, 0.02), and weights of the size
``init_params`` gives (`random_packed_linear` with ``fan_in``): with the
llama distribution every column's weights have a positive mean, ReLU or
gelu outputs then give the residual stream a common mode hundreds of times
the signal, and bf16 rounds the signal away before LayerNorm removes the
common mode, so no two summation orders agree after 32 layers.

With ``reorder=True`` ``o_reorder`` is a random OGR-style compaction -- the
non-outlier head channels in order, ``r`` outliers moved to the tail -- so
the o-projection gather really runs; with ``reorder=False`` every linear
carries such a compaction as its own ``reorder_ids``, as a model packed
without the global reorder does.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import struct
from typing import Dict

import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.ops.packing import QLinearParams, dequantize_weight, resolve_group


def random_packed_linear(gen: torch.Generator, n_layers: int, k: int, n: int, g: int = 128,
                         r: int = 128, dtype=torch.bfloat16, fan_in: bool = False) -> QLinearParams:
    """A stacked [L, ...] packed linear with random codes and parameters:
    the JAX package's test distribution, or with ``fan_in`` weights of std
    about 1/sqrt(k), as ``init_params`` draws dense ones -- scales
    (0.75..1.25) / (4.61 sqrt(k)) (4.61 is the std of a uniform 4-bit code),
    zero points at codes 7.25..7.75 (where an asymmetric quantizer puts them
    for zero-mean weights) and oweight ~ N(0, 1/k)."""
    dev = gen.device
    resolve_group(k, g)
    words = torch.randint(-2**31, 2**31, (n_layers, k // 8, n), generator=gen,
                          dtype=torch.int64, device=dev).to(torch.int32)
    groups = (n_layers, k // g, n)
    if fan_in:
        s = (torch.rand(groups, generator=gen, device=dev) * 0.5 + 0.75) / (4.61 * k ** 0.5)
        zero = torch.rand(groups, generator=gen, device=dev) * 0.5 + 7.25
        return QLinearParams(
            qweight=words, scales=s.to(dtype), scaled_zeros=(-s * zero).to(dtype),
            oweight=(torch.randn((n_layers, r, n), generator=gen, device=dev)
                     * k ** -0.5).to(dtype),
            group_size=g)
    scales = (torch.rand(groups, generator=gen, device=dev) * 0.02 + 0.01).to(dtype)
    szeros = (-torch.rand(groups, generator=gen, device=dev) * 0.16).to(dtype)
    ow = (torch.randn((n_layers, r, n), generator=gen, device=dev) * 0.02).to(dtype)
    return QLinearParams(qweight=words, scales=scales, scaled_zeros=szeros, oweight=ow,
                         group_size=g)


def random_compaction(gen: torch.Generator, n_layers: int, k: int, r: int) -> torch.Tensor:
    """[L, k] int32 gather ids: non-outliers in order, then r random outliers."""
    dev = gen.device
    rows = []
    for _ in range(n_layers):
        outliers = torch.randperm(k, generator=gen, device=dev)[:r].sort().values
        keep = torch.ones(k, dtype=torch.bool, device=dev)
        keep[outliers] = False
        rows.append(torch.cat([torch.arange(k, device=dev)[keep], outliers]))
    return torch.stack(rows).to(torch.int32)


def build_packed_model(cfg, seed: int = 0, g: int = 128, r: int = 128,
                       dtype=torch.bfloat16, device=None, family: str = "llama",
                       reorder: bool = True) -> Dict:
    """Random packed model of ``family`` on ``device`` (default: the GPU,
    which must exist).  ``dtype`` is the float dtype of every non-integer
    leaf."""
    device = resolve_device(device)
    meta = get_model_meta(family)
    if meta.family not in ("llama", "gemma"):
        return _build_family(cfg, meta, seed, g, r, dtype, device, reorder)
    if not reorder:
        raise ValueError("the fused llama stages need the global reorder")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hd = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    layers = {
        "input_ln": torch.ones(n_layers, d, dtype=dtype, device=device),
        "post_ln": torch.ones(n_layers, d, dtype=dtype, device=device),
        "qkv": random_packed_linear(gen, n_layers, d, hd + 2 * hkv, g, r, dtype),
        "o": random_packed_linear(gen, n_layers, hd, d, g, r, dtype),
        "upgate": random_packed_linear(gen, n_layers, d, 2 * f, g, r, dtype),
        "down": random_packed_linear(gen, n_layers, f, d, g, r, dtype),
        "o_reorder": random_compaction(gen, n_layers, hd, r),
    }
    return {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02).to(dtype),
        "layers": layers,
        "final_ln": torch.ones(d, dtype=dtype, device=device),
        "lm_head": (torch.randn((d, cfg.vocab_size), generator=gen, device=device) * 0.02).to(dtype),
    }


def _build_family(cfg, meta, seed, g, r, dtype, device, reorder) -> Dict:
    """The family's ``init_params`` at one layer gives every leaf's shape;
    norms repeat over the layers, linears become packed, biases random."""
    module = importlib.import_module(f"qeft_tpu_torch.models.{meta.family}")
    one = module.init_params(dataclasses.replace(cfg, num_layers=1), seed, dtype, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    n_layers = cfg.num_layers
    layers = {}
    for name, leaf in one["layers"].items():
        if name in meta.all_linears:
            k, n = leaf.shape[-2:]
            lin = random_packed_linear(gen, n_layers, k, n, g, r, dtype, fan_in=True)
            if not reorder:
                lin.reorder_ids = random_compaction(gen, n_layers, k, r)
            layers[name] = lin
        elif name[:-2] in meta.all_linears:  # a linear's bias
            layers[name] = (torch.randn((n_layers, *leaf.shape[1:]), generator=gen,
                                        device=device) * 0.02).to(dtype)
        else:
            layers[name] = leaf.expand(n_layers, *leaf.shape[1:]).clone()
    if reorder:
        layers["o_reorder"] = random_compaction(gen, n_layers, layers[meta.out[0]].in_features, r)
    return {**one, "layers": layers}


def dense_linear(p: QLinearParams, dtype=torch.bfloat16) -> torch.Tensor:
    """Stacked dense [L, K, N] weight equal to a stacked packed linear:
    ``code*scale + zero`` with the oweight slab added on the last r rows,
    summed in f32 and cast once; a linear with ``reorder_ids`` has its rows
    put back in input order (``x[..., ids] @ W == x @ dense``)."""
    n_layers, k = p.qweight.shape[0], p.in_features
    out = torch.empty(n_layers, k, p.out_features, dtype=dtype, device=p.qweight.device)
    for l in range(n_layers):
        lin = p.layer(l)
        w = dequantize_weight(lin, torch.float32)
        if lin.oweight is not None:
            w[k - lin.n_outlier:] += lin.oweight.to(torch.float32)
        if lin.reorder_ids is not None:
            w = torch.zeros_like(w).index_copy_(0, lin.reorder_ids.long(), w)
        out[l] = w.to(dtype)
    return out


def dense_model(params: Dict, dtype=torch.bfloat16) -> Dict:
    """The dense model a packed model stands for (the analogue of the
    fake-quantized checkpoint), of any family: each packed linear becomes its
    dense weight and its own bias, if it has one, joins the ``<name>_b`` leaf.
    Dense trees run plain PyTorch only."""
    layers = {name: leaf for name, leaf in params["layers"].items()
              if not isinstance(leaf, QLinearParams)}
    for name, leaf in params["layers"].items():
        if isinstance(leaf, QLinearParams):
            layers[name] = dense_linear(leaf, dtype)
            if leaf.bias is not None:
                b = layers.get(name + "_b")
                layers[name + "_b"] = leaf.bias if b is None else b + leaf.bias
    return {**params, "layers": layers}


_ST_CODES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``tensors`` in the safetensors format (what
    ``models.hf_loader.read_safetensors`` reads): the header padded to 8
    bytes, then each tensor's little-endian bytes in turn."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


def write_hf_opt(path: str, params: Dict, cfg, shards: int = 1) -> None:
    """A dense OPT tree written as a Hugging Face directory (``config.json``
    and safetensors, in ``shards`` files with a ``model.safetensors.index
    .json`` when more than one): the inverse of ``models.hf_loader.
    load_hf_opt``, each ``[K, N]`` linear stored as HF's ``[out, in]``."""
    os.makedirs(path, exist_ok=True)
    hf = {"model.decoder.embed_tokens.weight": params["embed"],
          "model.decoder.embed_positions.weight": params["embed_pos"]}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.out_proj", "fc1": "fc1", "fc2": "fc2"}
    layers = params["layers"]
    for i in range(cfg.num_layers):
        pre = f"model.decoder.layers.{i}."
        for ours, theirs in (("attn_ln", "self_attn_layer_norm"),
                             ("final_ln", "final_layer_norm")):
            hf[pre + theirs + ".weight"] = layers[ours][i]
            hf[pre + theirs + ".bias"] = layers[ours + "_b"][i]
        for ours, theirs in names.items():
            hf[pre + theirs + ".weight"] = layers[ours][i].t()
            hf[pre + theirs + ".bias"] = layers[ours + "_b"][i]
    if "final_ln" in params:
        hf["model.decoder.final_layer_norm.weight"] = params["final_ln"]
        hf["model.decoder.final_layer_norm.bias"] = params["final_ln_b"]
    if "project_in" in params:
        hf["model.decoder.project_in.weight"] = params["project_in"].t()
        hf["model.decoder.project_out.weight"] = params["project_out"].t()
    hf["lm_head.weight"] = params["lm_head"].t()
    keys = list(hf)
    files = [f"model-{j + 1:05d}-of-{shards:05d}.safetensors" for j in range(shards)]
    if shards == 1:
        files = ["model.safetensors"]
    per = -(-len(keys) // shards)
    weight_map = {}
    for j, fname in enumerate(files):
        part = keys[j * per: (j + 1) * per]
        write_safetensors(os.path.join(path, fname), {k: hf[k] for k in part})
        weight_map.update(dict.fromkeys(part, fname))
    if shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    config = {"model_type": "opt", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "ffn_dim": cfg.ffn_dim, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "do_layer_norm_before": cfg.do_layer_norm_before,
              "word_embed_proj_dim": cfg.embed_dim}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)


def _awq_pack(codes_nk: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """int codes [N, K] -> int16 [N//4, K] in the AWQ interleave: nibble i
    of word (row, col) is the code at flat index ``src[row, col, i]``."""
    nib = codes_nk.reshape(-1).to(torch.int32)[src]  # [N//4, K, 4]
    word = nib[..., 0] | nib[..., 1] << 4 | nib[..., 2] << 8 | nib[..., 3] << 12
    return torch.where(word >= 1 << 15, word - (1 << 16), word).to(torch.int16)


def write_reference_packed(params: Dict, cfg) -> Dict:
    """A packed llama tree (fused stages or member names, the global
    reorder) as the reference's packed checkpoint dict, the input of
    ``import_reference.import_reference_packed`` (``torch.save`` it):
    int16 ``qweight`` [OC/4, IC] pushed through the AWQ interleave's forward
    source map, fp16 ``scales`` / ``scaled_zeros`` [G, OC], the slab
    ``oweight`` [OC, r] fp16 and ``outlieridx`` (the o-projection's from
    ``o_reorder``), and ``quantinfos`` with ``reorder=True``.  Test
    tooling: the port writes no reference checkpoints otherwise."""
    from argparse import Namespace

    from qeft_tpu_torch.import_reference import _HF_LLAMA_LINEARS, _awq_nibble_source_map
    from qeft_tpu_torch.ops.packing import unpack_codes
    from qeft_tpu_torch.pipeline import member_widths, split_fused

    meta = get_model_meta("llama")
    layers = params["layers"]
    widths = member_widths(cfg, meta)
    lins = {n: l for n, l in layers.items() if isinstance(l, QLinearParams)}
    per_field = {f: split_fused({n: getattr(l, f) for n, l in lins.items()}, meta, widths)
                 for f in ("qweight", "scales", "scaled_zeros", "oweight")}
    g = next(iter(lins.values())).group_size
    fp16 = torch.float16
    sd, quantinfos, maps = {}, {}, {}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = layers["input_ln"][i].to(fp16).cpu()
        sd[pre + "post_attention_layernorm.weight"] = layers["post_ln"][i].to(fp16).cpu()
        for ours, theirs in _HF_LLAMA_LINEARS.items():
            theirs = pre + theirs  # the module path and its dot
            qw = per_field["qweight"][ours][i]
            codes_nk = unpack_codes(qw.contiguous(), g).t()  # [N, K]
            n, k = codes_nk.shape
            if (n, k) not in maps:
                maps[(n, k)] = torch.from_numpy(_awq_nibble_source_map(n, k)).to(qw.device)
            ow = per_field["oweight"][ours][i]
            r = ow.shape[0]
            sd[theirs + "qweight"] = _awq_pack(codes_nk, maps[(n, k)]).cpu()
            sd[theirs + "scales"] = per_field["scales"][ours][i].to(fp16).cpu()
            sd[theirs + "scaled_zeros"] = per_field["scaled_zeros"][ours][i].to(fp16).cpu()
            sd[theirs + "oweight"] = ow.t().to(fp16).contiguous().cpu()
            if ours == "o" and "o_reorder" in layers:
                sd[theirs + "outlieridx"] = layers["o_reorder"][i][k - r:].to(
                    torch.int64).cpu()
            else:
                sd[theirs + "outlieridx"] = torch.arange(k - r, k)
            quantinfos[theirs[:-1]] = Namespace(bits=4, sym=False, group_size=g, n_out=r,
                                                 reorder=True)
    sd["model.embed_tokens.weight"] = params["embed"].to(fp16).cpu()
    sd["model.norm.weight"] = params["final_ln"].to(fp16).cpu()
    sd["lm_head.weight"] = params["lm_head"].t().to(fp16).contiguous().cpu()
    return {"model_state_dict": sd, "quantinfos": quantinfos, "packing": True,
            "dtype": fp16, "bits": 4, "group_size": g}


def write_reference_wct(slabs: Dict, base_path: str) -> Dict:
    """A reference WCT checkpoint dict (the tuned slabs only) over the
    reference packed checkpoint at ``base_path``: ``slabs`` {(layer, name):
    [r, N] slab} as ``oweight_state_dict`` entries [N, r] fp16 under the
    reference's module paths."""
    from qeft_tpu_torch.import_reference import _HF_LLAMA_LINEARS

    return {"oweight_state_dict": {
        f"model.layers.{i}.{_HF_LLAMA_LINEARS[name][:-1]}": w.t().to(torch.float16)
        .contiguous().cpu() for (i, name), w in slabs.items()}, "base_path": base_path}
