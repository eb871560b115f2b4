"""The reference of weak-column tuning: the family's forward in f32 with
trainable f32 slabs (each layer recomputed in the backward, so one layer's
f32 weights live at a time), the shifted cross entropy over the labelled
positions, clipping by the global norm (divided by max(norm, clip)), and
AdamW with the warm-up and cosine schedule, written from their published
definitions.  ``half_batch`` takes the loss over the first half of each
batch's rows only: the planted fault of a step that drops half its batch."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common, family, layer_params

IGNORE_INDEX = -100


def lr_factor(o: Dict, count: int) -> float:
    """The schedule's factor after ``count`` applied updates: linear warm-up
    over int(total * ratio) + 1 updates from 0, then cosine to 0 (or
    constant)."""
    warmup = int(o["total_steps"] * o["warmup_ratio"]) + 1
    if count < warmup:
        return count / warmup
    if o["lr_schedule"] != "cosine":
        return 1.0
    decay = o["total_steps"] - warmup
    t = min(count - warmup, decay)
    return 0.5 * (1.0 + math.cos(math.pi * t / decay))


def loss_fn(dims, raw, slabs, ids, labels, ar) -> torch.Tensor:
    fam = family(dims.family)
    params = layer_params(fam)

    def block(x, l):
        return fam.block(params(raw, dims, l, slabs), x, dims, ar)

    x = fam.embed(raw, dims, ids)
    for l in range(dims.layers):
        x = checkpoint(block, x, l, use_reentrant=False)
    logits = fam.logits(raw, dims, x, ar)[:, :-1]
    targets = labels[:, 1:]
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                            ignore_index=IGNORE_INDEX, reduction="sum")
    return total / (targets != IGNORE_INDEX).sum().clamp(min=1)


def run(dims, raw: Dict, mix: Dict, ids: torch.Tensor, labels: torch.Tensor,
        ar: common.Arith = common.F32, half_batch: bool = False) -> Dict:
    """Steps over ``ids`` / ``labels`` [n, B, S] from the packed model's
    slabs -> {"losses", "grad1": {slab: norm of the first clipped gradient},
    "change": {slab: norm of its change after the n steps}}."""
    common.no_tf32()
    o = mix["optimizer"]
    b1, b2 = o["betas"]
    slabs = {name: [common.f32(t).clone().requires_grad_() for t in raw["layers"][name]["oweight"]]
             for name, _, _ in dims.linears}
    keys = [(name, l) for name in slabs for l in range(dims.layers)]
    leaves = [slabs[n][l] for n, l in keys]
    first = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    out: Dict = {"losses": []}
    rows = ids.shape[1] // 2 if half_batch else ids.shape[1]
    for step in range(ids.shape[0]):
        loss = loss_fn(dims, raw, slabs, ids[step, :rows], labels[step, :rows], ar)
        grads = torch.autograd.grad(loss, leaves)
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = o["max_grad_norm"] / max(float(norm), o["max_grad_norm"])
            grads = [g * scale for g in grads]
            if step == 0:
                out["grad1"] = {f"{n}.{l}": float(torch.linalg.vector_norm(g))
                                for (n, l), g in zip(keys, grads)}
            lr = o["learning_rate"] * lr_factor(o, step)
            t = step + 1
            for p, g, mm, vv in zip(leaves, grads, m, v):
                p.mul_(1 - lr * o["weight_decay"])
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vv.sqrt() / math.sqrt(1 - b2 ** t)).add_(o["eps"])
                p.addcdiv_(mm, denom, value=-lr / (1 - b1 ** t))
    out["change"] = {f"{n}.{l}": float(torch.linalg.vector_norm(p.detach() - p0))
                     for (n, l), p, p0 in zip(keys, leaves, first)}
    return out
