"""The mixture-of-experts layer: a router over every expert, top-k choices,
the chosen experts' SwiGLU MLPs on their tokens, and shared experts every
token passes through (DeepSeek-V2's ``DeepseekV2MoE``).  ``qeft_tpu`` has
no expert layer; this one exists only in the port.

Everything that depends on the routing is computed on the device into
buffers whose shapes depend on the token count alone, so a decode step that
holds the layer is captured once as a CUDA graph and replays correctly when
the routing changes between replays:

- `route`: the router's scores in f32 (a bf16 linear, scored as the
  published code scores it), the softmax, the top-k experts and their
  weights (greedy, no renormalisation, times ``scale``);
- `dispatch`: each expert's row count, its first row, and each (token,
  choice)'s row among the rows sorted by expert -- a stable sort of the
  choices and a count, no host read;
- `experts`: the tokens gathered into their rows, gate/up, SwiGLU, down.
  A decode step runs `qmm.qgemv_moe`, the grouped matvec over all experts
  at once; a prefill (eager) reads the counts once and runs each touched
  expert's rows through `qlinear_apply` (K2, or K5 at up to 8 rows); on
  the CPU the plain versions;
- `combine`: the experts' rows back in token order, weighted in f32 and
  summed over the choices, plus the shared experts.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.qlinear import qlinear_apply
from qeft_tpu_torch.ops.qmm import qgemv_moe
from qeft_tpu_torch.utils.profiling import span


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D], router [D, E] -> (weights f32 [T, k], experts int64 [T, k])."""
    scores = torch.softmax(torch.matmul(x.to(torch.float32), router.to(torch.float32)), dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    return weights * scale, experts


def dispatch(experts: torch.Tensor, n_experts: int):
    """experts int64 [T, k] -> (counts int32 [E], offsets int32 [E], rows
    int64 [T * k]): the rows of the (token, choice) pairs sorted by expert,
    in token order within an expert (a stable sort of the choices)."""
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    rows = torch.empty_like(order)
    rows[order] = torch.arange(flat.numel(), device=flat.device)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return counts, offsets, rows


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of a fused [..., 2F] gate/up output, in f32, rounded once."""
    gate, up = gate_up.chunk(2, dim=-1)
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(gate_up.dtype)


def mlp(x: torch.Tensor, gate_up: QLinearParams, down: QLinearParams) -> torch.Tensor:
    """A SwiGLU MLP on one layer's packed gate/up and down."""
    return qlinear_apply(swiglu(qlinear_apply(x, gate_up)), down)


def experts(xs: torch.Tensor, gate_up: QLinearParams, down: QLinearParams,
            counts: torch.Tensor, offsets: torch.Tensor, tokens: int,
            grouped: bool) -> torch.Tensor:
    """xs [R, D] sorted by expert through each row's expert: ``gate_up``
    and ``down`` stacked over the experts ([E, K/8, N]).  ``grouped``: the
    grouped matvec (a decode step; no host read), else one expert at a time
    over counts read once (eager)."""
    if grouped or not xs.is_cuda:
        h = swiglu(qgemv_moe(xs, gate_up, counts, offsets, tokens))
        return qgemv_moe(h, down, counts, offsets, tokens)
    out = torch.empty(xs.shape[0], down.out_features, dtype=xs.dtype, device=xs.device)
    for e, (off, n) in enumerate(zip(offsets.tolist(), counts.tolist())):
        if n:
            out[off:off + n] = mlp(xs[off:off + n], gate_up.layer(e), down.layer(e))
    return out


def moe_layer(x: torch.Tensor, router: torch.Tensor, gate_up: QLinearParams,
              down: QLinearParams, shared_gate_up: QLinearParams, shared_down: QLinearParams,
              top_k: int, scale: float = 1.0, grouped: bool = False) -> torch.Tensor:
    """x [..., D] -> the routed experts' weighted sum plus the shared
    experts' output, [..., D].  ``router`` [D, E]; ``gate_up`` / ``down``
    the experts' packed linears of this layer ([E, ...]); the shared
    experts one SwiGLU."""
    with span("qeft.model.moe"):
        lead, d = x.shape[:-1], x.shape[-1]
        h = x.reshape(-1, d)
        t = h.shape[0]
        with span("qeft.model.moe.route"):
            weights, chosen = route(h, router, top_k, scale)
            counts, offsets, rows = dispatch(chosen, router.shape[-1])
        with span("qeft.model.moe.experts"):
            xs = torch.empty(t * top_k, d, dtype=h.dtype, device=h.device)
            xs.index_copy_(0, rows, h.repeat_interleave(top_k, dim=0))
            ys = experts(xs, gate_up, down, counts, offsets, t, grouped)
            shared = mlp(h, shared_gate_up, shared_down)
        with span("qeft.model.moe.combine"):
            y = (ys.index_select(0, rows).reshape(t, top_k, d).to(torch.float32)
                 * weights[..., None]).sum(1)
            return (y.to(h.dtype) + shared).reshape(*lead, d)
