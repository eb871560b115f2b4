"""Falcon-family decoder (parallel attention + MLP, rotary, multi-query
attention, fused qkv linear, gelu MLP, no linear biases): its block and
head, which `models.common`'s layer loop drives as `DECODER` (plain forward,
prefill, windowed forward and single-token decode over the head-major
static KV cache).

Counterpart of ``qeft_tpu/models/falcon.py``: the falcon-7b lineage shares
ONE LayerNorm (``attn_ln``) between attention and the MLP; the
falcon-40B lineage (``dual_ln``) carries a separate ``mlp_ln`` and GQA heads.
``num_kv_heads`` K/V heads (1 at 7b) serve all query heads; the fused qkv
linear has the contiguous [q | k | v] column layout.  Conventions and the
linear dispatch are those of `models.common`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.models.common import (
    init_generator,
    Decoder,
    attention,
    cache_write,
    dense,
    gelu,
    layer_norm,
    linear,
    model_api,
)
from qeft_tpu_torch.models.llama import apply_rope, rope_tables
from qeft_tpu_torch.ops.permute import apply_o_reorder


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_layers: int = 32
    num_heads: int = 71
    num_kv_heads: int = 1
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # new_decoder_architecture (falcon-40B/180B): separate ln_attn / ln_mlp
    dual_ln: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_size


FALCON_PRESETS: Dict[str, FalconConfig] = {
    "falcon-7b": FalconConfig(),
    "falcon-40b": FalconConfig(
        vocab_size=65024, hidden_size=8192, num_layers=60, num_heads=128,
        num_kv_heads=8, dual_ln=True,
    ),
    "falcon-tiny": FalconConfig(
        vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
        num_kv_heads=1, max_position_embeddings=128,
    ),
    "falcon-tiny-40b": FalconConfig(
        vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2, max_position_embeddings=128, dual_ln=True,
    ),
}


def init_params(cfg: FalconConfig, seed: int = 0, dtype=None, device=None) -> Dict:
    """Random dense model shaped as ``qeft_tpu/models/falcon.py::
    init_params`` makes it, on ``device`` (default: the GPU, which must
    exist); values from a ``torch.Generator``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = init_generator(device, seed)
    d, f, n = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(kin, kout, lead=()):
        w = torch.randn((*lead, kin, kout), generator=gen, device=device) * kin ** -0.5
        return w.to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    layers = {"attn_ln": full((n, d), 1.0), "attn_ln_b": full((n, d), 0.0)}
    for name, kin, kout in (("qkv", d, (hq + 2 * hkv) * dh), ("dense", hq * dh, d),
                            ("fc1", d, f), ("fc2", f, d)):
        layers[name] = lin(kin, kout, (n,))
    if cfg.dual_ln:
        layers["mlp_ln"] = full((n, d), 1.0)
        layers["mlp_ln_b"] = full((n, d), 0.0)
    return {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02).to(dtype),
        "layers": layers,
        "final_ln": full((d,), 1.0),
        "final_ln_b": full((d,), 0.0),
        "lm_head": lin(d, cfg.vocab_size),
    }


def falcon_block(layers: Dict, l: int, x: torch.Tensor, cfg: FalconConfig, mask: torch.Tensor,
                 rope: Tuple[torch.Tensor, torch.Tensor], cache: Optional[Dict] = None,
                 pos: int = 0, capture: Optional[Dict] = None) -> torch.Tensor:
    """Parallel block ``l``: x + attn(ln_attn(x)) + mlp(ln_mlp(x)); ``rope``
    the (cos, sin) tables of ``llama.rope_tables``.  ``capture`` receives the
    four stage inputs, as JAX's ``falcon_block(capture=True)`` returns them
    (without ``mlp_ln`` qkv and fc1 share ln(x))."""
    b, s, _ = x.shape
    cos, sin = rope
    hq, hkv, dh, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.layer_norm_eps
    h = layer_norm(x, layers["attn_ln"][l], layers["attn_ln_b"][l], eps)
    h_mlp = (layer_norm(x, layers["mlp_ln"][l], layers["mlp_ln_b"][l], eps)
             if "mlp_ln" in layers else h)
    qkv = linear(layers, "qkv", l, h)
    q = apply_rope(qkv[..., : hq * dh].reshape(b, s, hq, dh), cos, sin)
    k = apply_rope(qkv[..., hq * dh: (hq + hkv) * dh].reshape(b, s, hkv, dh), cos, sin)
    kh = k.transpose(1, 2)
    vh = qkv[..., (hq + hkv) * dh:].reshape(b, s, hkv, dh).transpose(1, 2)
    if cache is not None:
        kh, vh = cache_write(cache, l, kh, vh, pos)
    ctx = attention(q, kh, vh, mask, pos)
    o_reorder = layers.get("o_reorder")
    attn_out = linear(layers, "dense", l, apply_o_reorder(ctx, None if o_reorder is None
                                                          else o_reorder[l]))
    h1 = gelu(linear(layers, "fc1", l, h_mlp))
    if capture is not None:
        capture.update(qkv_in=h, o_in=ctx, ffn1_in=h_mlp, ffn2_in=h1)
    return x + attn_out + linear(layers, "fc2", l, h1)


def _final(params: Dict, x: torch.Tensor, cfg: FalconConfig) -> torch.Tensor:
    x = layer_norm(x, params["final_ln"], params["final_ln_b"], cfg.layer_norm_eps)
    return dense(params["lm_head"], x)


def _embed(params: Dict, tokens: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    return params["embed"][tokens]


DECODER = Decoder(norm="attn_ln", embed=_embed, block=falcon_block, final=_final,
                  rope=rope_tables)
MODEL_API = model_api("falcon", DECODER, FalconConfig)
