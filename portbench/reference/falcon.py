"""Falcon-7b, from the published modelling code: parallel attention and MLP
under one shared LayerNorm, ``x + dense(attn(ln(x))) + fc2(gelu(fc1(ln(x))))``;
the fused query_key_value linear laid out [q heads | k | v] with one K/V
head (multi-query); rotary embedding (rotate-half, theta from the
configuration) on q and k; exact (erf) GELU; no biases; a final LayerNorm
and the head tied to the token embedding.  The dense projection's input is
gathered by the stored ``o_reorder``."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.common import Arith, apply, attention, f32, layer_norm


def embed(raw: Dict, dims, tokens: torch.Tensor) -> torch.Tensor:
    return f32(raw["embed"][tokens])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, Dh] rotated at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    freqs = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]  # [S, 1, Dh]
    half = dh // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(emb) + rotated * torch.sin(emb)


def block(p: Dict, x: torch.Tensor, dims, ar: Arith) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, dh = dims.heads, dims.kv_heads, dims.head_dim
    y = layer_norm(x, p["attn_ln"], p["attn_ln_b"], dims.eps)
    qkv = apply(p, "qkv", y, ar)
    q = rope(qkv[..., : h * dh].reshape(b, s, h, dh), dims.rope_theta)
    k = rope(qkv[..., h * dh: (h + hkv) * dh].reshape(b, s, hkv, dh), dims.rope_theta)
    v = qkv[..., (h + hkv) * dh:].reshape(b, s, hkv, dh)
    ctx = attention(q, k, v, ar).index_select(-1, p["o_reorder"])
    mlp = apply(p, "fc2", torch.nn.functional.gelu(apply(p, "fc1", y, ar)), ar)
    return x + apply(p, "dense", ctx, ar) + mlp


def logits(raw: Dict, dims, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    x = layer_norm(x, f32(raw["final_ln"]), f32(raw["final_ln_b"]), dims.eps)
    return ar.mm(x, f32(raw["embed"]).t())
