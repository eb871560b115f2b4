"""Weak-column tuning (WCT): train only the fp weak-column slabs (``oweight``)
of a packed model.  Counterpart of ``qeft_tpu/finetune.py``.

The packed tree is split into trainable slabs and the frozen rest.  The
slabs are per-layer f32 leaves, ``{stage: [L tensors of [r, N]]}``: a stacked
``[L, r, N]`` leaf sliced per layer would make autograd build a full
``[L, r, N]`` zero gradient for every slice.  The training forward
differentiates through the packed GEMM (K2) and takes the transposed INT4
GEMM (K7) for ``dx`` (``ops/qlinear.py``); each decoder block is
rematerialised with ``torch.utils.checkpoint`` when ``remat`` is on.  Each
family's `ModelApi` carries its training forward (`train_forward`): llama
and gemma run their training block, OPT, Phi, Bloom and Falcon their blocks
under autograd; DeepSeek-V2's raises (ROADMAP F1).
Only the slabs train; biases, norms and the embeddings stay frozen.

The optimizer is ``torch.optim.AdamW`` behind `WCTOptimizer`, which adds
what the JAX chain ``MultiSteps(chain(clip_by_global_norm, adamw(schedule)))``
does around it: the running-mean gradient accumulation of
``optax.MultiSteps``, optax's global-norm clipping (divide by
``max(norm, max_norm)``, unlike ``clip_grad_norm_``'s ``norm + 1e-6``) and a
``LambdaLR`` that gives optax's warmup-cosine or warmup-constant schedule,
value for value, counted in applied updates (step 0 has lr 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.utils.profiling import span

IGNORE_INDEX = -100

Oweights = Dict[str, List[torch.Tensor]]


@dataclasses.dataclass
class TrainConfig:
    """Defaults of the reference's Platypus-style setup: AdamW, cosine
    schedule, 3 % warmup."""

    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    grad_accum: int = 1
    max_grad_norm: float = 0.3
    lr_schedule: str = "cosine"  # or "constant"
    remat: bool = True


# ---------------------------------------------------------------------------
# parameter partition


def split_wct(params: Dict, meta=None) -> Tuple[Oweights, Dict]:
    """(trainable per-layer f32 oweight leaves, frozen rest without them).
    The leaves are copies: training never writes the packed model's slabs."""
    oweights: Oweights = {}
    frozen_layers = dict(params["layers"])
    for name, lin in params["layers"].items():
        if isinstance(lin, QLinearParams) and lin.oweight is not None:
            oweights[name] = [w.detach().to(torch.float32, copy=True).requires_grad_()
                              for w in lin.oweight.unbind(0)]
            frozen_layers[name] = dataclasses.replace(lin, oweight=None)
    return oweights, {**params, "layers": frozen_layers}


def merge_wct(oweights: Oweights, frozen: Dict, stack: bool = False) -> Dict:
    """The model with the trainable slabs back in place.  ``stack=False``
    keeps the per-layer leaves (the training forward differentiates through
    them); ``stack=True`` gives detached ``[L, r, N]`` slabs in the frozen
    scales' dtype, which the serving kernels read."""
    layers = dict(frozen["layers"])
    for name, leaves in oweights.items():
        lin = layers[name]
        ow = leaves
        if stack:
            ow = torch.stack([t.detach() for t in leaves]).to(lin.scales.dtype)
        layers[name] = dataclasses.replace(lin, oweight=ow)
    return {**frozen, "layers": layers}


# ---------------------------------------------------------------------------
# training forward / loss


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross-entropy in f32, mean over the targets that are not
    IGNORE_INDEX (0 when there are none)."""
    logits = logits[:, :-1].to(torch.float32)
    targets = labels[:, 1:]
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                            ignore_index=IGNORE_INDEX, reduction="sum")
    return total / (targets != IGNORE_INDEX).sum().clamp(min=1)


def train_forward(params: Dict, tokens: torch.Tensor, cfg, remat: bool = True,
                  family: str = "llama") -> torch.Tensor:
    """The training forward of ``family`` (``qeft_tpu/finetune.py::
    _train_forward``): its `ModelApi`'s ``forward_train``."""
    return get_model_api(family).forward_train(params, tokens, cfg, remat)


def wct_loss(oweights: Oweights, frozen: Dict, input_ids: torch.Tensor, labels: torch.Tensor,
             cfg, remat: bool = True, family: str = "llama") -> torch.Tensor:
    logits = train_forward(merge_wct(oweights, frozen), input_ids, cfg, remat, family)
    return causal_lm_loss(logits, labels)


# ---------------------------------------------------------------------------
# optimizer


def lr_factor(tc: TrainConfig) -> Callable[[int], float]:
    """Multiplier of the peak lr after ``count`` applied updates: optax's
    ``warmup_cosine_decay_schedule(0, lr, W, total_steps)`` or the linear
    warmup joined to a constant, with ``W = int(total_steps * warmup_ratio)
    + 1`` as ``qeft_tpu.finetune.make_optimizer`` sets them."""
    warmup = int(tc.total_steps * tc.warmup_ratio) + 1
    decay = tc.total_steps - warmup
    if tc.lr_schedule == "cosine" and decay <= 0:
        raise ValueError(f"the cosine schedule needs total_steps > {warmup} (warmup), "
                         f"got {tc.total_steps}")

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        if tc.lr_schedule != "cosine":
            return 1.0
        t = min(count - warmup, decay)
        return 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return factor


def local_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``grads`` together, summed in f32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))


class WCTOptimizer:
    """A ``torch.optim`` optimizer over the trainable leaves, with optional
    gradient accumulation (``optax.MultiSteps``: every ``grad_accum``-th call
    of `step` applies the running mean of the accumulated gradients, the
    others apply nothing), optional global-norm clipping of the applied
    gradient (``optax.clip_by_global_norm``) and an optional ``LambdaLR``
    stepped once per applied update.  ``grad_norm`` is the norm clipping
    divides by: of these leaves' gradients alone by default; tensor-parallel
    training passes the global one (``parallel.tp_train.tp_grad_norm``)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr_lambda: Optional[Callable[[int], float]] = None,
                 max_grad_norm: Optional[float] = None, grad_accum: int = 1,
                 grad_norm: Callable[[List[torch.Tensor]], torch.Tensor] = local_grad_norm):
        self.optimizer = optimizer
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda)
                          if lr_lambda is not None else None)
        self.max_grad_norm = max_grad_norm
        self.grad_accum = grad_accum
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        self.grad_norm = grad_norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> bool:
        """Consume the leaves' ``.grad``; returns whether an update was applied."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.grad_accum > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                self.zero_grad()
                return False
            grads, self.mini_step = [a.clone() for a in self.acc], 0
            for a in self.acc:
                a.zero_()
        if self.max_grad_norm is not None:
            norm = self.grad_norm(grads)
            scale = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
            for g in grads:  # in place: these gradients belong to this step
                g.mul_(scale)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.zero_grad()
        return True

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = state["mini_step"]
        self.acc = state["acc"]


def leaves(oweights: Oweights) -> List[torch.Tensor]:
    return [t for name in sorted(oweights) for t in oweights[name]]


def make_optimizer(tc: TrainConfig, oweights: Oweights,
                   grad_norm: Callable[[List[torch.Tensor]], torch.Tensor] = local_grad_norm
                   ) -> WCTOptimizer:
    """AdamW (optax's defaults: betas 0.9/0.999, eps 1e-8) under global-norm
    clipping (by ``grad_norm``), the lr schedule and ``tc.grad_accum``-step
    accumulation."""
    adamw = torch.optim.AdamW(leaves(oweights), lr=tc.learning_rate, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=tc.weight_decay)
    return WCTOptimizer(adamw, lr_factor(tc), tc.max_grad_norm, tc.grad_accum, grad_norm)


def make_train_step(cfg, opt: WCTOptimizer, remat: bool = True,
                    family: str = "llama"):
    """-> ``train_step(oweights, frozen, input_ids, labels) -> loss``: one
    forward and backward, then ``opt.step()``, which updates the leaves in
    place.  The loss stays on the device (no synchronisation)."""

    def train_step(oweights: Oweights, frozen: Dict, input_ids: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        with span("qeft.finetune.loss"):
            loss = wct_loss(oweights, frozen, input_ids, labels, cfg, remat, family)
        with span("qeft.finetune.backward"):
            loss.backward()
        with span("qeft.finetune.optimizer"):
            opt.step()
        return loss.detach()

    return train_step
