"""OPT-family decoder (fc1/fc2 MLP, LayerNorm, learned positional
embeddings): its embedding, block and head, which `models.common`'s layer
loop drives as `DECODER` (plain forward, prefill, windowed forward and
single-token decode over the head-major static KV cache).

Counterpart of ``qeft_tpu/models/opt.py``: pre-LN (OPT-125m ... 6.7B) and
post-LN with the narrow embedding space (OPT-350m: ``project_in`` /
``project_out``, no final LayerNorm).  Conventions and the linear dispatch
are those of `models.common`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.models.common import (
    init_generator,
    Decoder,
    attention,
    cache_write,
    dense,
    layer_norm,
    linear,
)
from qeft_tpu_torch.ops.permute import apply_o_reorder


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    do_layer_norm_before: bool = True
    # opt-350m: token embeddings in a narrower space, projected in and out
    word_embed_proj_dim: Optional[int] = None  # None -> hidden_size
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads  # OPT is MHA

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size


OPT_PRESETS: Dict[str, OPTConfig] = {
    "opt-125m": OPTConfig(),
    "opt-1.3b": OPTConfig(hidden_size=2048, ffn_dim=8192, num_layers=24, num_heads=32),
    "opt-6.7b": OPTConfig(hidden_size=4096, ffn_dim=16384, num_layers=32, num_heads=32),
    "opt-350m": OPTConfig(
        hidden_size=1024, ffn_dim=4096, num_layers=24, num_heads=16,
        word_embed_proj_dim=512, do_layer_norm_before=False,
    ),
    "opt-tiny": OPTConfig(
        vocab_size=256, hidden_size=128, ffn_dim=256, num_layers=2, num_heads=4,
        max_position_embeddings=128,
    ),
    "opt-tiny-350m": OPTConfig(
        vocab_size=256, hidden_size=128, ffn_dim=256, num_layers=2, num_heads=4,
        max_position_embeddings=128, word_embed_proj_dim=64,
        do_layer_norm_before=False,
    ),
}

POS_OFFSET = 2  # OPT's learned positional embedding is read at position + 2


def init_params(cfg: OPTConfig, seed: int = 0, dtype=None, device=None) -> Dict:
    """Random dense model shaped as ``qeft_tpu/models/opt.py::init_params``
    makes it (weights ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02^2), unit
    norms, zero biases), on ``device`` (default: the GPU, which must exist).
    The values come from a ``torch.Generator`` and differ from JAX's."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = init_generator(device, seed)
    d, f, n, e = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers, cfg.embed_dim

    def lin(kin, kout, lead=()):
        w = torch.randn((*lead, kin, kout), generator=gen, device=device) * kin ** -0.5
        return w.to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    layers = {"attn_ln": full((n, d), 1.0), "attn_ln_b": full((n, d), 0.0),
              "final_ln": full((n, d), 1.0), "final_ln_b": full((n, d), 0.0)}
    for name, kin, kout in (("q", d, d), ("k", d, d), ("v", d, d), ("o", d, d),
                            ("fc1", d, f), ("fc2", f, d)):
        layers[name] = lin(kin, kout, (n,))
        layers[name + "_b"] = full((n, kout), 0.0)
    out = {
        "embed": (torch.randn((cfg.vocab_size, e), generator=gen, device=device) * 0.02).to(dtype),
        "embed_pos": (torch.randn((cfg.max_position_embeddings + POS_OFFSET, d), generator=gen,
                                  device=device) * 0.02).to(dtype),
        "layers": layers,
        "lm_head": lin(e, cfg.vocab_size),
    }
    if cfg.do_layer_norm_before:  # post-LN OPT (350m) has no final layer norm
        out["final_ln"] = full((d,), 1.0)
        out["final_ln_b"] = full((d,), 0.0)
    if e != d:
        out["project_in"] = lin(e, d)
        out["project_out"] = lin(d, e)
    return out


def _embed_opt(params: Dict, tokens: torch.Tensor, positions: torch.Tensor,
               cfg: OPTConfig) -> torch.Tensor:
    """tokens [B, W]; positions [W] absolute positions."""
    x = params["embed"][tokens]
    if "project_in" in params:  # opt-350m's narrow embedding space
        x = dense(params["project_in"], x)
    return x + params["embed_pos"][positions + POS_OFFSET]


def opt_block(layers: Dict, l: int, x: torch.Tensor, cfg: OPTConfig, mask: torch.Tensor,
              rope=None, cache: Optional[Dict] = None, pos: int = 0,
              capture: Optional[Dict] = None) -> torch.Tensor:
    """Decoder block ``l``; with ``cache`` its K/V are written at ``pos`` and
    attention reads the layer's whole cache under ``mask``.  OPT has no
    rotary embedding (``rope`` is None).  ``capture`` receives the inputs of
    the four quantization stages (``qkv_in``, ``o_in`` before the o gather,
    ``ffn1_in``, ``ffn2_in``), as JAX's ``opt_block(capture=True)`` returns
    them."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    eps, pre = cfg.layer_norm_eps, cfg.do_layer_norm_before

    res = x
    if pre:
        x = layer_norm(x, layers["attn_ln"][l], layers["attn_ln_b"][l], eps)
    if capture is not None:
        capture["qkv_in"] = x
    q = linear(layers, "q", l, x).reshape(b, s, h, dh)
    kh = linear(layers, "k", l, x).reshape(b, s, h, dh).transpose(1, 2)
    vh = linear(layers, "v", l, x).reshape(b, s, h, dh).transpose(1, 2)
    if cache is not None:
        kh, vh = cache_write(cache, l, kh, vh, pos)
    ctx = attention(q, kh, vh, mask)
    o_reorder = layers.get("o_reorder")
    if capture is not None:
        capture["o_in"] = ctx
    x = res + linear(layers, "o", l, apply_o_reorder(ctx, None if o_reorder is None
                                                      else o_reorder[l]))
    if not pre:
        x = layer_norm(x, layers["attn_ln"][l], layers["attn_ln_b"][l], eps)

    res = x
    if pre:
        x = layer_norm(x, layers["final_ln"][l], layers["final_ln_b"][l], eps)
    h1 = torch.relu(linear(layers, "fc1", l, x))
    if capture is not None:
        capture["ffn1_in"], capture["ffn2_in"] = x, h1
    x = res + linear(layers, "fc2", l, h1)
    if not pre:
        x = layer_norm(x, layers["final_ln"][l], layers["final_ln_b"][l], eps)
    return x


def _final(params: Dict, x: torch.Tensor, cfg: OPTConfig) -> torch.Tensor:
    if "final_ln" in params:  # absent for post-LN opt-350m
        x = layer_norm(x, params["final_ln"], params["final_ln_b"], cfg.layer_norm_eps)
    if "project_out" in params:
        x = dense(params["project_out"], x)
    return dense(params["lm_head"], x)


DECODER = Decoder(norm="attn_ln", embed=_embed_opt, block=opt_block, final=_final)
