"""DeepSeek-V2, from the published modelling code (``modeling_deepseek.py``
of deepseek-ai/DeepSeek-V2-Lite), in f32: pre-RMSNorm blocks ``x +
o(attn(norm1(x)))`` then ``x + mlp(norm2(x))``; multi-head latent attention
without a query LoRA -- ``q`` gives each head ``qk_nope + qk_rope`` dims,
``kv_a`` a latent ``c`` and a key ``k_pe`` shared by the heads, ``kv_b``
maps ``kv_a_ln(c)`` to each head's ``k_nope`` and value; RoPE on ``q_pe``
and ``k_pe`` in the published interleaved-pair layout with YaRN's
frequencies and cos/sin scale; softmax scale ``q_head_dim ** -0.5 *
mscale(factor, mscale_all_dim) ** 2``; causal softmax attention.  The MLP of
the first ``first_k_dense_replace`` layers is a dense SwiGLU, of the rest the
MoE: router logits in f32, softmax, greedy top-k, weights times
``routed_scaling_factor`` without renormalisation (``norm_topk_prob``
false), each chosen expert's SwiGLU weighted and summed, plus the shared
experts as one SwiGLU.  A final RMSNorm and the untied head.

Departures from the published code, each where the benchmark's model
differs from a checkpoint, not from the equations: gate and up are one
packed linear of each MLP (its columns [gate | up]), every linear but the
router and the head adds its weak-column slab, and o's input is gathered by
the stored ``o_reorder``, as the QEFT model stores it.  The routing is the
reference's own, computed layer by layer on its f32 activations; the
attention runs a few sequences at a time so that its scores fit."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import Arith, dequant, f32, linear

ATTENTION_ROWS = 8  # sequences a pass of the attention, so that the scores fit


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(dims) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies, f32 on the CPU."""
    rs = dict(dims.rope_scaling)
    dim, base = dims.rope, dims.rope_theta
    ctx, factor = rs["original_max_position_embeddings"], rs["factor"]

    def correction_dim(rotations):
        return dim * math.log(ctx / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(dims) -> float:
    rs = dict(dims.rope_scaling)
    m = mscale(rs["factor"], rs["mscale_all_dim"])
    return (dims.nope + dims.rope) ** -0.5 * m * m


def rotate(x: torch.Tensor, dims) -> torch.Tensor:
    """``apply_rotary_pos_emb`` of x [B, S, (H,) d] at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    rs = dict(dims.rope_scaling)
    freqs = torch.arange(s, dtype=torch.float32)[:, None] * yarn_inv_freq(dims)
    emb = torch.cat([freqs, freqs], dim=-1).to(x.device)
    m = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = emb.cos() * m, emb.sin() * m
    if x.dim() == 4:
        cos, sin = cos[:, None], sin[:, None]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rotated * sin


def embed(raw: Dict, dims, tokens: torch.Tensor) -> torch.Tensor:
    return f32(raw["embed"][tokens])


def _linear(lin: Dict, i: int, group: int) -> Dict:
    """Entry ``i`` of a packed linear's leading axis in f32: weight and slab."""
    return {"w": dequant(lin, i, group), "slab": f32(lin["oweight"][i])}


def layer_params(raw: Dict, dims, l: int, slabs: Optional[Dict] = None) -> Dict:
    """Layer ``l`` in f32: the attention's linears, the norms, o's gather,
    and the dense MLP or the router, the shared experts and every routed
    expert (its gate/up and down)."""
    lay = raw["layers"]
    p = {"o_reorder": lay["o_reorder"][l].to(torch.int64)}
    for name in ("input_ln", "post_ln", "kv_a_ln"):
        p[name] = f32(lay[name][l])
    for name in ("q", "kv_a", "kv_b", "o"):
        p[name] = _linear(lay[name], l, dims.group_of(name))
    if l < dims.dense_layers:
        for name in ("gate_up", "down"):
            p[name] = _linear(lay[name], l, dims.group_of(name))
        return p
    m = l - dims.dense_layers
    p["router"] = f32(lay["router"][m])
    for name in ("shared_gate_up", "shared_down"):
        p[name] = _linear(lay[name], m, dims.group_of(name))
    experts = {name: {k: v[m] for k, v in lay[name].items()}
               for name in ("experts_gate_up", "experts_down")}
    p["experts"] = [{name: _linear(lin, e, dims.group_of(name)) for name, lin in experts.items()}
                    for e in range(dims.experts)]
    return p


def apply(p: Dict, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    return linear(x, p["w"], p["slab"], None, ar)


def swiglu(x: torch.Tensor, gate_up: Dict, down: Dict, ar: Arith) -> torch.Tensor:
    gate, up = apply(gate_up, x, ar).chunk(2, dim=-1)
    return apply(down, F.silu(gate) * up, ar)


def attention(p: Dict, x: torch.Tensor, dims, ar: Arith) -> torch.Tensor:
    b, s, _ = x.shape
    h, dn, dr, dv, rank = dims.heads, dims.nope, dims.rope, dims.v, dims.rank
    q = apply(p["q"], x, ar).reshape(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], rotate(q[..., dn:], dims)], dim=-1)
    ckv = apply(p["kv_a"], x, ar)
    c = rms_norm(ckv[..., :rank], p["kv_a_ln"], dims.eps)
    k_pe = rotate(ckv[..., rank:], dims)  # [B, S, dr], one key for every head
    kv = apply(p["kv_b"], c, ar).reshape(b, s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(b, s, h, dr)], dim=-1)
    v = kv[..., dn:]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    out = []
    for i in range(0, b, ATTENTION_ROWS):
        qi, ki, vi = (t[i:i + ATTENTION_ROWS].transpose(1, 2) for t in (q, k, v))
        scores = ar.mm(qi, ki.transpose(-1, -2)) * softmax_scale(dims)
        scores = scores.masked_fill(~causal, float("-inf"))
        out.append(ar.mm(torch.softmax(scores, dim=-1), vi).transpose(1, 2))
    ctx = torch.cat(out).reshape(b, s, h * dv).index_select(-1, p["o_reorder"])
    return apply(p["o"], ctx, ar)


def moe(p: Dict, x: torch.Tensor, dims, ar: Arith) -> torch.Tensor:
    """The routed experts (the reference's own routing) plus the shared ones."""
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    scores = torch.softmax(ar.mm(h, p["router"]), dim=-1)
    weights, chosen = torch.topk(scores, dims.top_k, dim=-1)
    weights = weights * dims.routed_scale
    y = torch.zeros_like(h)
    for e, ex in enumerate(p["experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            out = swiglu(h[tok], ex["experts_gate_up"], ex["experts_down"], ar)
            y.index_add_(0, tok, out * weights[tok, slot][:, None])
    y = y + swiglu(h, p["shared_gate_up"], p["shared_down"], ar)
    return y.reshape(*lead, -1)


def block(p: Dict, x: torch.Tensor, dims, ar: Arith) -> torch.Tensor:
    x = x + attention(p, rms_norm(x, p["input_ln"], dims.eps), dims, ar)
    y = rms_norm(x, p["post_ln"], dims.eps)
    if "router" in p:
        return x + moe(p, y, dims, ar)
    return x + swiglu(y, p["gate_up"], p["down"], ar)


def logits(raw: Dict, dims, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    x = rms_norm(x, f32(raw["final_ln"]), dims.eps)
    return ar.mm(x, f32(raw["lm_head"]))
