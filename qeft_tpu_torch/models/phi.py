"""Phi-family decoder (parallel attention + MLP residual, partial rotary
embedding, fc1/fc2 MLP, LayerNorm, biases on every linear and the lm_head):
its block and head, which `models.common`'s layer loop drives as `DECODER`
(plain forward, prefill, windowed forward and single-token decode over the
head-major static KV cache).

Counterpart of ``qeft_tpu/models/phi.py``: ONE LayerNorm per block
(``input_ln``) feeds attention and the MLP, which both add into the
residual; RoPE turns the first ``rotary_dim`` dims of each head (32 of 80 on
phi-2) and passes the rest through.  Conventions and the linear dispatch are
those of `models.common`.
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
from qeft_tpu_torch.models.llama import apply_rope
from qeft_tpu_torch.ops.permute import apply_o_reorder


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 24
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)


PHI_PRESETS: Dict[str, PhiConfig] = {
    "phi-1.5": PhiConfig(),
    "phi-2": PhiConfig(hidden_size=2560, intermediate_size=10240, num_layers=32,
                       partial_rotary_factor=0.4),
    "phi-tiny": PhiConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=4, max_position_embeddings=128,
    ),
}


def init_params(cfg: PhiConfig, seed: int = 0, dtype=None, device=None) -> Dict:
    """Random dense model shaped as ``qeft_tpu/models/phi.py::init_params``
    makes it, on ``device`` (default: the GPU, which must exist); values from
    a ``torch.Generator``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = init_generator(device, seed)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def lin(kin, kout, lead=()):
        w = torch.randn((*lead, kin, kout), generator=gen, device=device) * kin ** -0.5
        return w.to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    layers = {"input_ln": full((n, d), 1.0), "input_ln_b": full((n, d), 0.0)}
    for name, kin, kout in (("q", d, hq), ("k", d, hkv), ("v", d, hkv), ("o", hq, d),
                            ("fc1", d, f), ("fc2", f, d)):
        layers[name] = lin(kin, kout, (n,))
        layers[name + "_b"] = full((n, kout), 0.0)
    return {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02).to(dtype),
        "layers": layers,
        "final_ln": full((d,), 1.0),
        "final_ln_b": full((d,), 0.0),
        "lm_head": lin(d, cfg.vocab_size),
        "lm_head_b": full((cfg.vocab_size,), 0.0),
    }


def phi_rope_tables(cfg: PhiConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables [..., rotary_dim] for integer ``positions``."""
    rd = cfg.rotary_dim
    exponent = torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device) / rd
    freqs = positions.to(torch.float32)[..., None] * (1.0 / (cfg.rope_theta ** exponent))
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rope_partial(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rotary_dim: int) -> torch.Tensor:
    """RoPE on the first ``rotary_dim`` dims of each head; the rest as is."""
    return torch.cat([apply_rope(x[..., :rotary_dim], cos, sin), x[..., rotary_dim:]], dim=-1)


def phi_block(layers: Dict, l: int, x: torch.Tensor, cfg: PhiConfig, mask: torch.Tensor,
              rope: Tuple[torch.Tensor, torch.Tensor], cache: Optional[Dict] = None,
              pos: int = 0, capture: Optional[Dict] = None) -> torch.Tensor:
    """Parallel block ``l``: x + attn(ln(x)) + mlp(ln(x)); ``rope`` the
    (cos, sin) tables of `phi_rope_tables`.  ``capture`` receives the four
    stage inputs, as JAX's ``phi_block(capture=True)`` returns them: qkv and
    fc1 share ln(x)."""
    b, s, _ = x.shape
    cos, sin = rope
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = layer_norm(x, layers["input_ln"][l], layers["input_ln_b"][l], cfg.layer_norm_eps)
    q = _rope_partial(linear(layers, "q", l, h).reshape(b, s, hq, dh), cos, sin, cfg.rotary_dim)
    k = _rope_partial(linear(layers, "k", l, h).reshape(b, s, hkv, dh), cos, sin, cfg.rotary_dim)
    kh = k.transpose(1, 2)
    vh = linear(layers, "v", l, h).reshape(b, s, hkv, dh).transpose(1, 2)
    if cache is not None:
        kh, vh = cache_write(cache, l, kh, vh, pos)
    ctx = attention(q, kh, vh, mask, pos)
    o_reorder = layers.get("o_reorder")
    attn_out = linear(layers, "o", l, apply_o_reorder(ctx, None if o_reorder is None
                                                      else o_reorder[l]))
    h1 = gelu(linear(layers, "fc1", l, h))
    if capture is not None:
        capture.update(qkv_in=h, o_in=ctx, ffn1_in=h, ffn2_in=h1)
    return x + attn_out + linear(layers, "fc2", l, h1)


def _final(params: Dict, x: torch.Tensor, cfg: PhiConfig) -> torch.Tensor:
    x = layer_norm(x, params["final_ln"], params["final_ln_b"], cfg.layer_norm_eps)
    y = dense(params["lm_head"], x)
    return y + params["lm_head_b"].to(y.dtype)


def _embed(params: Dict, tokens: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    return params["embed"][tokens]


DECODER = Decoder(norm="input_ln", embed=_embed, block=phi_block, final=_final,
                  rope=phi_rope_tables)
MODEL_API = model_api("phi", DECODER, PhiConfig)
