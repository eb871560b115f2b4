"""BLOOM-family decoder (ALiBi attention, fused qkv linear, LayerNorm, gelu
MLP): its embedding, score bias, block and head, which `models.common`'s
layer loop drives as `DECODER` (plain forward, prefill, windowed forward and
single-token decode over the head-major static KV cache).

Counterpart of ``qeft_tpu/models/bloom.py``: ALiBi adds ``slopes[h] *
key_pos`` to the scores in place of positional embeddings; the fused qkv
linear has the contiguous [q | k | v] column layout; the embedding is
followed by a LayerNorm (``embed_ln``).  Conventions and the linear dispatch
are those of `models.common`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

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
from qeft_tpu_torch.ops.permute import apply_o_reorder


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 2048  # cache-sizing bound (ALiBi itself is unbounded)
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads  # bloom is MHA

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_size


BLOOM_PRESETS: Dict[str, BloomConfig] = {
    "bloom-560m": BloomConfig(),
    "bloom-7b1": BloomConfig(hidden_size=4096, num_layers=30, num_heads=32),
    "bloom-tiny": BloomConfig(
        vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
        max_position_embeddings=128,
    ),
}


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (f32 [H]); a head count that is not a power of
    two takes every other slope of the next power's series for the rest."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2(closest) + pow2(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32)


def init_params(cfg: BloomConfig, seed: int = 0, dtype=None, device=None) -> Dict:
    """Random dense model shaped as ``qeft_tpu/models/bloom.py::init_params``
    makes it, on ``device`` (default: the GPU, which must exist); values from
    a ``torch.Generator``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = init_generator(device, seed)
    d, f, n = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers

    def lin(kin, kout, lead=()):
        w = torch.randn((*lead, kin, kout), generator=gen, device=device) * kin ** -0.5
        return w.to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    layers = {"attn_ln": full((n, d), 1.0), "attn_ln_b": full((n, d), 0.0),
              "post_ln": full((n, d), 1.0), "post_ln_b": full((n, d), 0.0)}
    for name, kin, kout in (("qkv", d, 3 * d), ("dense", d, d), ("fc1", d, f), ("fc2", f, d)):
        layers[name] = lin(kin, kout, (n,))
        layers[name + "_b"] = full((n, kout), 0.0)
    return {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02).to(dtype),
        "embed_ln": full((d,), 1.0),
        "embed_ln_b": full((d,), 0.0),
        "layers": layers,
        "final_ln": full((d,), 1.0),
        "final_ln_b": full((d,), 0.0),
        "lm_head": lin(d, cfg.vocab_size),
    }


@functools.lru_cache(maxsize=None)
def _slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """`alibi_slopes` copied to ``device`` once: a copy from host memory
    inside the decode step would wait for the device (and cannot be
    captured in a CUDA graph)."""
    return alibi_slopes(n_heads).to(device)


def _alibi_bias(cfg: BloomConfig, n_keys: int, device) -> torch.Tensor:
    """[1, H, 1, Sk] additive score bias: slopes[h] * key_pos."""
    key_pos = torch.arange(n_keys, dtype=torch.float32, device=device)
    slopes = _slopes_on(cfg.num_heads, torch.device(device))
    return (slopes[:, None] * key_pos[None, :])[None, :, None, :]


def bloom_block(layers: Dict, l: int, x: torch.Tensor, cfg: BloomConfig, mask: torch.Tensor,
                rope=None, cache: Optional[Dict] = None, pos: int = 0,
                capture: Optional[Dict] = None) -> torch.Tensor:
    """Decoder block ``l``; ``mask`` is the causal mask plus ALiBi (no
    rotary embedding: ``rope`` is None).  ``capture`` receives the four
    stage inputs, as JAX's ``bloom_block(capture=True)`` returns them."""
    b, s, d = x.shape
    h, dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    hn = layer_norm(x, layers["attn_ln"][l], layers["attn_ln_b"][l], eps)
    qkv = linear(layers, "qkv", l, hn)
    q = qkv[..., :d].reshape(b, s, h, dh)
    kh = qkv[..., d: 2 * d].reshape(b, s, h, dh).transpose(1, 2)
    vh = qkv[..., 2 * d:].reshape(b, s, h, dh).transpose(1, 2)
    if cache is not None:
        kh, vh = cache_write(cache, l, kh, vh, pos)
    ctx = attention(q, kh, vh, mask, pos)
    o_reorder = layers.get("o_reorder")
    x = x + linear(layers, "dense", l, apply_o_reorder(ctx, None if o_reorder is None
                                                       else o_reorder[l]))
    h2 = layer_norm(x, layers["post_ln"][l], layers["post_ln_b"][l], eps)
    h1 = gelu(linear(layers, "fc1", l, h2))
    if capture is not None:
        capture.update(qkv_in=hn, o_in=ctx, ffn1_in=h2, ffn2_in=h1)
    return x + linear(layers, "fc2", l, h1)


def _final(params: Dict, x: torch.Tensor, cfg: BloomConfig) -> torch.Tensor:
    x = layer_norm(x, params["final_ln"], params["final_ln_b"], cfg.layer_norm_eps)
    return dense(params["lm_head"], x)


def _embed_bloom(params: Dict, tokens: torch.Tensor, positions: torch.Tensor,
                 cfg: BloomConfig) -> torch.Tensor:
    return layer_norm(params["embed"][tokens], params["embed_ln"], params["embed_ln_b"],
                      cfg.layer_norm_eps)


DECODER = Decoder(norm="attn_ln", embed=_embed_bloom, block=bloom_block, final=_final,
                  score_bias=_alibi_bias)
MODEL_API = model_api("bloom", DECODER, BloomConfig)
