"""Tensor-parallel weak-column tuning on a (dp, tp) mesh, Megatron style.
Counterpart of ``qeft_tpu/parallel/tp_train.py``.

Every rank holds its shard of the packed model (`tp_forward.
tp_shard_packed_params`) and runs the single-device autograd linear
(``ops.qlinear.QLinearFunction``: K2 forward, K7 for ``dx``) on local data:

- qkv / upgate are column-parallel: their slabs are N-sharded and train
  with purely local gradients;
- o / down are row-parallel: each rank contracts its K rows without a
  slab, and the last rank also applies the replicated slab (the tail of K)
  and the bias, so the psum after the stage counts them once; the slab's
  gradient is therefore nonzero on the last rank only;
- the lm_head is vocab-sharded and dense; the loss is a vocab-parallel
  cross entropy whose mean is global over ``dp``.

JAX differentiates the whole ``shard_map`` from outside, and the transpose
of its collectives puts the reductions in.  Per-rank autograd has no such
step, so each collective is an ``autograd.Function`` over the `Mesh` with
its transpose written out:

- `_Reduce`: psum forward, identity backward (the psum after a row-parallel
  stage, and the sums of the cross entropy: every rank computes the same
  replicated loss, so the cotangent of a replicated sum is the cotangent of
  each part);
- `_Enter`: identity forward, psum backward (the replicated input of each
  column-parallel linear and of the head: each rank's partial ``dx`` comes
  from its own columns);
- `_Gather`: all-gather forward, psum-then-own-slice backward (``ctx`` and
  ``act``).  The OGR ``o_reorder`` gather sends some of rank t's context
  channels into other ranks' K rows, so the shortcut of taking one's own
  slice of the cotangent is wrong here.

After the backward the column-parallel slab gradients are summed over
``dp``, the row-stage ones over ``tp`` and ``dp`` (every rank issues that
psum, with zeros where it applied no slab, so the collectives run in the
same order everywhere).  Global-norm clipping runs over the global slabs:
the squares of N-sharded gradients psummed over ``tp``, each replicated one
counted once, so every rank clips by the same factor and the replicas
cannot drift.  Each block is rematerialised (``torch.utils.checkpoint``)
when ``remat`` is on; the recomputation re-issues the block's forward
collectives in the same order on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from qeft_tpu_torch.finetune import (
    IGNORE_INDEX, Oweights, leaves, local_grad_norm, merge_wct, split_wct,
)
from qeft_tpu_torch.models.llama import (
    LlamaConfig,
    _act,
    _embed,
    _split_qkv,
    causal_mask,
    rms_norm,
    rope_tables,
)
from qeft_tpu_torch.ops.flash import masked_attention
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.ops.qlinear import qlinear_apply
from qeft_tpu_torch.parallel.mesh import Mesh
from qeft_tpu_torch.parallel.tp_forward import _local_cfg, tp_shard_packed_params

# stages whose slab is replicated under row-parallel sharding (applied by
# the last shard only; their gradients are psummed over tp)
_ROW_STAGES = ("o", "down")
_COL_STAGES = ("qkv", "upgate")


# ---------------------------------------------------------------------------
# collectives under autograd


class _Reduce(torch.autograd.Function):
    """psum over ``axis`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        return mesh.psum(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, psum of the cotangent over ``tp`` backward."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), "tp"), None


def _gather_grad(g: torch.Tensor, mesh: Mesh, width: int) -> torch.Tensor:
    """Cotangent of this rank's part of a tiled all-gather over ``tp``: the
    cotangents of every rank's copy summed, then this rank's slice."""
    full = mesh.psum(g.contiguous(), "tp")
    return full.narrow(-1, mesh.index("tp") * width, width).contiguous()


class _Gather(torch.autograd.Function):
    """Tiled all-gather over ``tp`` on the last dimension forward;
    `_gather_grad` backward."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.all_gather(x.contiguous(), "tp", dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _gather_grad(g, ctx.mesh, ctx.width), None


# ---------------------------------------------------------------------------
# the sharded training forward and loss


def _row_parallel_train(lin: QLinearParams, l: int, x_full: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """This rank's part of row-parallel stage ``l`` through the autograd
    linear: its K rows without a slab, and on the last shard, whose rows
    end with the weak columns, the slab and the bias as well."""
    tp, my = mesh.shape["tp"], mesh.index("tp")
    one = lin.layer(l)
    ks = one.in_features
    if one.n_outlier > ks:
        raise ValueError(f"{one.n_outlier} weak columns exceed a row shard of {ks}")
    last = my == tp - 1
    local = QLinearParams(one.qweight, one.scales, one.scaled_zeros,
                          oweight=one.oweight if last else None,
                          bias=one.bias if last else None, group_size=one.group_size)
    return qlinear_apply(x_full[..., my * ks: (my + 1) * ks], local)


def _tp_block_train(layers: Dict, l: int, x: torch.Tensor, lcfg: LlamaConfig, cos, sin,
                    mask, mesh: Mesh) -> torch.Tensor:
    """Differentiable decoder block ``l`` on the local shards (the twin of
    ``models.llama.llama_block_train`` with the tp collectives)."""
    eps, one = lcfg.rms_norm_eps, lcfg.rms_one_offset
    h = _Enter.apply(rms_norm(x, layers["input_ln"][l], eps, one), mesh)
    qkv = qlinear_apply(h, layers["qkv"].layer(l))  # local [q_t | k_t | v_t]
    q, k, v = _split_qkv(qkv, lcfg, cos, sin)
    ctx = masked_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask)
    o_reorder = layers.get("o_reorder")
    o_in = apply_o_reorder(_Gather.apply(ctx, mesh), None if o_reorder is None else o_reorder[l])
    x = x + _Reduce.apply(_row_parallel_train(layers["o"], l, o_in, mesh), mesh, "tp")
    h2 = _Enter.apply(rms_norm(x, layers["post_ln"][l], eps, one), mesh)
    ug = qlinear_apply(h2, layers["upgate"].layer(l))  # local [up_t | gate_t]
    f_l = ug.shape[-1] // 2
    act = _Gather.apply(_act(ug[..., f_l:], lcfg.act) * ug[..., :f_l], mesh)
    return x + _Reduce.apply(_row_parallel_train(layers["down"], l, act, mesh), mesh, "tp")


def _tp_forward_train(params: Dict, ids: torch.Tensor, cfg: LlamaConfig, mesh: Mesh,
                      remat: bool) -> torch.Tensor:
    """Full-sequence sharded forward of this rank's rows -> its vocab shard
    of the logits [B, S, V/tp]."""
    lcfg = _local_cfg(cfg, mesh.shape["tp"])
    layers = params["layers"]
    for name in _COL_STAGES + _ROW_STAGES:
        if not isinstance(layers.get(name), QLinearParams):
            raise ValueError("tensor-parallel training takes a packed, stage-fused model "
                             f"(no packed {name!r})")
    s = ids.shape[1]
    x = _embed(params, ids, cfg)
    cos, sin = rope_tables(cfg, torch.arange(s, device=ids.device)[None, :])
    mask = causal_mask(s, ids.device)
    for l in range(layers["input_ln"].shape[0]):
        if remat:
            x = checkpoint(_tp_block_train, layers, l, x, lcfg, cos, sin, mask, mesh,
                           use_reentrant=False)
        else:
            x = _tp_block_train(layers, l, x, lcfg, cos, sin, mask, mesh)
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps, cfg.rms_one_offset)
    head = params["lm_head"]
    if not isinstance(head, torch.Tensor):
        raise ValueError("tensor-parallel training takes a dense (vocab-sharded) lm_head")
    return torch.matmul(_Enter.apply(x, mesh), head.to(x.dtype))


def _vocab_parallel_ce(logits_local: torch.Tensor, labels: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """Shifted cross entropy over vocab-sharded logits [B, S, V/tp] in f32;
    the mean over the valid targets of the whole (dp) batch.  The max is
    detached (it cancels in the softmax's derivative); the sum of
    exponentials and the target's logit are psummed over ``tp``."""
    logits = logits_local[:, :-1].to(torch.float32)
    targets = labels[:, 1:]
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    v_l = logits.shape[-1]
    lo = mesh.index("tp") * v_l
    lmax = mesh.pmax(logits.detach().amax(dim=-1), "tp")
    sumexp = _Reduce.apply(torch.exp(logits - lmax[..., None]).sum(dim=-1), mesh, "tp")
    lse = torch.log(sumexp) + lmax
    local = (safe - lo).clamp(0, v_l - 1)
    tl = logits.gather(-1, local[..., None])[..., 0]
    in_shard = (safe >= lo) & (safe < lo + v_l)
    tlogit = _Reduce.apply(torch.where(in_shard, tl, torch.zeros_like(tl)), mesh, "tp")
    token_loss = torch.where(valid, lse - tlogit, torch.zeros_like(tl))
    num = _Reduce.apply(token_loss.sum().reshape(1), mesh, "dp")[0]
    den = mesh.psum(valid.sum().reshape(1), "dp")[0]
    return num / den.clamp(min=1)


# ---------------------------------------------------------------------------
# public API


def _leaf_spec(name: str) -> Tuple:
    return (None, "tp") if name not in _ROW_STAGES else (None, None)


def tp_train_specs(oweights: Oweights, frozen: Dict) -> Tuple[Dict, Dict]:
    """(slab specs, frozen-param specs) of the layout, as JAX's table names
    them for the stacked ``[L, ...]`` leaves: column-parallel slabs N-sharded,
    row-stage slabs replicated; column-parallel linears shard N, row-parallel
    ones their K rows with their group parameters; the head its vocabulary.
    A slab spec is given per ``[r, N]`` leaf of a layer."""
    ow_specs = {name: _leaf_spec(name) for name in oweights}
    layer_specs = {}
    for name, leaf in frozen["layers"].items():
        if isinstance(leaf, QLinearParams):
            col = name in _COL_STAGES
            qw = (None, None, "tp") if col else (None, "tp", None)
            layer_specs[name] = QLinearParams(
                qweight=qw, scales=qw, scaled_zeros=qw,
                oweight=None if leaf.oweight is None else
                ((None, None, "tp") if col else (None, None, None)),
                bias=None if leaf.bias is None else ((None, "tp") if col else (None, None)),
                group_size=leaf.group_size)
        else:
            layer_specs[name] = (None,) * leaf.dim()
    return ow_specs, {"embed": (None, None), "layers": layer_specs, "final_ln": (None,),
                      "lm_head": (None, "tp")}


def tp_shard_wct(params: Dict, mesh: Mesh, cfg: LlamaConfig, meta=None) -> Tuple[Oweights, Dict]:
    """This rank's shards of a stage-fused packed model, split into its
    trainable slabs (per-layer f32 leaves) and the frozen rest.  Splitting
    after the sharding keeps each slab on its shard."""
    return split_wct(tp_shard_packed_params(params, mesh, cfg), meta)


def _reduce_grads(oweights: Oweights, mesh: Mesh) -> None:
    """Sum the slab gradients of this rank's backward into the global ones,
    in place: column-parallel over ``dp``, row stages over ``tp`` and
    ``dp`` (zeros where this rank applied no slab)."""
    for names, axes in ((sorted(n for n in oweights if n not in _ROW_STAGES), ("dp",)),
                        (sorted(n for n in oweights if n in _ROW_STAGES), ("tp", "dp"))):
        ts = [t for n in names for t in oweights[n]]
        if not ts:
            continue
        flat = torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
                          for t in ts])
        for axis in axes:
            flat = mesh.psum(flat, axis)
        for t, g in zip(ts, flat.split([t.numel() for t in ts])):
            t.grad = g.view_as(t).clone()


def make_tp_loss_and_grad(cfg: LlamaConfig, mesh: Mesh, oweights: Oweights, frozen: Dict,
                          remat: bool = True):
    """-> ``loss_and_grad(oweights, frozen, ids, labels) -> (loss, grads)``.

    ``ids`` / ``labels`` are this rank's rows of the global batch (its
    ``dp`` coordinate's, `multihost.process_slice`), the same on every rank
    of a tp group.  The loss is the global mean, replicated; ``grads``
    {stage: [per-layer gradients]} are this rank's shards of the global
    slab gradients, also left in each leaf's ``.grad``."""
    mesh.check(frozen["embed"])

    def loss_and_grad(oweights: Oweights, frozen: Dict, ids: torch.Tensor,
                      labels: torch.Tensor):
        for t in leaves(oweights):
            t.grad = None
        logits = _tp_forward_train(merge_wct(oweights, frozen), ids, cfg, mesh, remat)
        loss = _vocab_parallel_ce(logits, labels, mesh)
        loss.backward()
        _reduce_grads(oweights, mesh)
        return loss.detach(), {n: [t.grad for t in ts] for n, ts in oweights.items()}

    return loss_and_grad


def tp_grad_norm(mesh: Mesh, oweights: Oweights):
    """-> the clipping norm of tensor-parallel training, for
    ``finetune.make_optimizer(tc, oweights, grad_norm=...)``: the global L2
    norm of this rank's slab gradients in `leaves` order, the N-sharded
    ones' squares psummed over ``tp``, the replicated ones counted once.
    Every rank then clips by the same factor, as JAX's update on the global
    arrays does."""
    sharded = [n not in _ROW_STAGES for n in sorted(oweights) for _ in oweights[n]]

    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        def sq(gs):
            return sum((g.to(torch.float32).square().sum() for g in gs),
                       torch.zeros((), dtype=torch.float32, device=grads[0].device))

        col = sq([g for g, s in zip(grads, sharded) if s])
        row = sq([g for g, s in zip(grads, sharded) if not s])
        return torch.sqrt(mesh.psum(col.reshape(1), "tp")[0] + row)

    return norm


def make_tp_train_step(cfg: LlamaConfig, opt, mesh: Mesh, oweights: Oweights, frozen: Dict,
                       remat: bool = True):
    """-> ``train_step(oweights, frozen, ids, labels) -> loss``: the sharded
    loss and global gradients (`make_tp_loss_and_grad`), then ``opt.step()``
    (``finetune.WCTOptimizer`` over this rank's leaves: AdamW, the schedule,
    accumulation), which updates the leaves in place.  An ``opt`` that clips
    must clip by `tp_grad_norm` when tp > 1 (else each rank would clip by
    its own norm and the replicated slabs drift apart); every rank then
    applies the same update to its replicated slabs."""
    if opt.max_grad_norm is not None and mesh.shape["tp"] > 1 and \
            opt.grad_norm is local_grad_norm:
        raise ValueError("clipping at tp > 1 needs the global norm: build the optimizer with "
                         "make_optimizer(tc, oweights, grad_norm=tp_grad_norm(mesh, oweights))")
    loss_and_grad = make_tp_loss_and_grad(cfg, mesh, oweights, frozen, remat)

    def train_step(oweights: Oweights, frozen: Dict, ids: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        loss, _ = loss_and_grad(oweights, frozen, ids, labels)
        opt.step()
        return loss

    return train_step
