"""OPT (pre-LN, as OPT-125m ... 6.7B), from the published modelling code:
token embedding plus a learned position embedding read at position + 2;
each block ``x + o(attn(ln1(x)))`` then ``x + fc2(relu(fc1(ln2(x))))``, with
biases; a final LayerNorm and the head tied to the token embedding.  Every
product is `common.Arith`'s; the packed linears add their weak-column slab,
and the o projection's input is gathered by the stored ``o_reorder``, as the
QEFT model stores it."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.common import Arith, apply, attention, f32, layer_norm

POS_OFFSET = 2


def embed(raw: Dict, dims, tokens: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(tokens.shape[1], device=tokens.device) + POS_OFFSET
    return f32(raw["embed"][tokens]) + f32(raw["embed_pos"][pos])


def block(p: Dict, x: torch.Tensor, dims, ar: Arith) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh = dims.heads, dims.head_dim
    y = layer_norm(x, p["attn_ln"], p["attn_ln_b"], dims.eps)
    q = apply(p, "q", y, ar).reshape(b, s, h, dh)
    k = apply(p, "k", y, ar).reshape(b, s, h, dh)
    v = apply(p, "v", y, ar).reshape(b, s, h, dh)
    ctx = attention(q, k, v, ar).index_select(-1, p["o_reorder"])
    x = x + apply(p, "o", ctx, ar)
    y = layer_norm(x, p["final_ln"], p["final_ln_b"], dims.eps)
    return x + apply(p, "fc2", torch.relu(apply(p, "fc1", y, ar)), ar)


def logits(raw: Dict, dims, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    x = layer_norm(x, f32(raw["final_ln"]), f32(raw["final_ln_b"]), dims.eps)
    return ar.mm(x, f32(raw["embed"]).t())
