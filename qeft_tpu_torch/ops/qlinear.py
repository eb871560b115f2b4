"""The packed linear: the serving dispatch between the decode matvec and the
GEMM, and the autograd linear that training differentiates through.

Counterpart of ``qeft_tpu/ops/qlinear.py``: `qlinear_fused_stage` of its
``qlinear_fused_stage`` (inference), `qlinear_apply_stacked` of its
``qlinear_apply_stacked`` (inference), `qlinear_apply` / `QLinearFunction` of
its ``qlinear_apply`` and custom-vjp core ``_qlinear_core`` / ``_core_fwd`` /
``_core_bwd``.  The JAX package switches kernels at ``< 8`` tokens in one
place and ``<= 8`` in another; here one threshold, `qmm.DECODE_MAX_TOKENS`,
decides for every call.

`qlinear_apply` is the linear of every OPT, Phi, Bloom and Falcon layer in
serving and of every training layer: a per-linear ``reorder_ids`` gather
first (outside the autograd function, as the JAX package keeps it outside
its custom vjp), then `QLinearFunction`, whose forward runs K5 for at most
`qmm.DECODE_MAX_TOKENS` rows (bias inside the kernel) and K2 above (bias
added after it).  The stacked paths keep K1 and K6 (`env` says when a
decode stage runs unfused or unstacked).

The backward of `QLinearFunction` (the reference's ``QuantMatMulQEFT``, with
the true transpose)::

    dx    = g @ W_deq^T  +  pad_last_r(g @ oweight^T)   K7, the weak-column
                                                        product as its f32 addend
    dow   = x[..., -r:]^T @ g                           f32, the only trainable
    dbias = sum of g over the rows

The two weak-column products are `matmul_f32`: bf16 operands, f32 sums and an
f32 result, as JAX's ``preferred_element_type=f32``.

Under ``QEFT_PALLAS=0`` (`env.PALLAS` off: JAX's ``qlinear_xla``, its
ablation without the kernels) every entry here dequantizes the weight and
multiplies with ``torch.matmul`` (`qmm.qgemm_plain`, the norm and the
residual around it), on the card too, and training differentiates through
that path by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from qeft_tpu_torch import env
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.qmm import (
    DECODE_MAX_TOKENS,
    qgemm,
    qgemm_plain,
    qgemm_t,
    qgemv,
    qgemv_stacked,
    qgemv_stacked_fused,
    rms_norm,
)
from qeft_tpu_torch.utils.profiling import span


def _without_kernels() -> bool:
    """``QEFT_PALLAS=0``: the dequantize-then-matmul path (announced once)."""
    if env.PALLAS:
        return False
    env.announce("QEFT_PALLAS")
    return True


def qlinear_fused_stage(x: torch.Tensor, p: QLinearParams, layer: int,
                        lnw: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        eps: float = 1e-5, one_offset: bool = False) -> torch.Tensor:
    """One decoder stage on layer ``layer`` of the stacked linear ``p``:
    ``[residual +] (rms_norm(x) if lnw else x) @ W``.

    Few rows run the fused decode matvec (norm and residual inside the
    kernel; under ``QEFT_FUSED_DECODE=0`` or ``QEFT_STACKED_GEMV=0`` the norm,
    `qlinear_apply_stacked` and the residual add one after another); more
    rows run the norm in PyTorch and the GEMM with the residual in its
    epilogue."""
    with span("qeft.linear.forward"):
        tokens = x.numel() // x.shape[-1]
        if _without_kernels():
            if lnw is not None:
                x = rms_norm(x, lnw, eps, one_offset)
            return qgemm_plain(x, p.layer(layer), residual)
        if tokens <= DECODE_MAX_TOKENS and env.FUSED_DECODE:
            return qgemv_stacked_fused(x, p, layer, lnw=lnw, residual=residual,
                                       eps=eps, one_offset=one_offset)
        if lnw is not None:
            x = rms_norm(x, lnw, eps, one_offset)
        if tokens <= DECODE_MAX_TOKENS:
            y = qlinear_apply_stacked(x, p, layer)
            return y if residual is None else residual + y
        return qgemm(x, p.layer(layer), residual=residual)


def qlinear_apply_stacked(x: torch.Tensor, p: QLinearParams, layer: int) -> torch.Tensor:
    """``x @ W`` of layer ``layer`` of the stacked linear ``p``, no norm and
    no residual: the plain decode matvec (K6; K5 on the layer's view under
    ``QEFT_STACKED_GEMV=0``) for few rows, the GEMM (K2) on the layer's view
    for more."""
    with span("qeft.linear.forward"):
        if _without_kernels():
            return qgemm_plain(x, p.layer(layer))
        if x.numel() // x.shape[-1] <= DECODE_MAX_TOKENS:
            if env.STACKED_GEMV:
                return qgemv_stacked(x, p, layer)
            return qgemv(x, p.layer(layer))
        return qgemm(x, p.layer(layer))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) summed and returned in f32.  On the GPU half-precision
    operands stay as they are (``torch.mm(..., out_dtype=float32)``); f32
    operands, and every CPU call, multiply in f32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _forward(x, qweight, scales, scaled_zeros, oweight, bias, group_size):
    """K5 for at most `DECODE_MAX_TOKENS` rows (bias in its epilogue), K2
    with the bias added after it for more; oweight and bias in x's dtype."""
    ow = None if oweight is None else oweight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if x.numel() // x.shape[-1] <= DECODE_MAX_TOKENS:
        return qgemv(x, QLinearParams(qweight, scales, scaled_zeros, oweight=ow, bias=b,
                                      group_size=group_size))
    y = qgemm(x, QLinearParams(qweight, scales, scaled_zeros, oweight=ow, group_size=group_size))
    return y if b is None else y + b


class QLinearFunction(torch.autograd.Function):
    """``x @ W_deq + x[..., K-r:] @ oweight (+ bias)`` of one layer's packed
    linear, differentiable in ``x``, ``oweight`` and ``bias``.  The forward
    is `_forward`; the backward runs K7 for ``dx`` only when it is wanted,
    and returns ``dow`` in oweight's dtype (f32 when training) and ``dbias``
    in the bias's."""

    @staticmethod
    def forward(ctx, x, qweight, scales, scaled_zeros, oweight, bias, group_size):
        ctx.group_size = group_size
        ctx.save_for_backward(x, qweight, scales, scaled_zeros, oweight, bias)
        return _forward(x, qweight, scales, scaled_zeros, oweight, bias, group_size)

    @staticmethod
    def backward(ctx, g):
        with span("qeft.linear.backward"):
            x, qweight, scales, scaled_zeros, oweight, bias = ctx.saved_tensors
            n, k = g.shape[-1], x.shape[-1]
            g2 = g.reshape(-1, n)
            ow = None if oweight is None else oweight.to(g.dtype)
            dx = dow = dbias = None
            if ctx.needs_input_grad[0]:
                p = QLinearParams(qweight, scales, scaled_zeros, group_size=ctx.group_size)
                tail = None if ow is None else matmul_f32(g2, ow.t())
                dx = qgemm_t(g2, p, tail).reshape(x.shape)
            if oweight is not None and ctx.needs_input_grad[4]:
                r = oweight.shape[-2]
                xr = x.reshape(-1, k)[:, k - r:].to(g.dtype)
                dow = matmul_f32(xr.t(), g2).to(oweight.dtype)
            if bias is not None and ctx.needs_input_grad[5]:
                dbias = g2.to(torch.float32).sum(0).to(bias.dtype)
            return dx, None, None, None, dow, dbias, None


def qlinear_apply(x: torch.Tensor, p: QLinearParams) -> torch.Tensor:
    """The linear of one layer's (unstacked) packed linear, whose ``oweight``
    and ``bias`` may be trainable leaves: ``x`` gathered by ``reorder_ids``
    (a linear packed without the global reorder keeps its weak columns last
    by its own permutation), then `QLinearFunction` -- or its forward alone
    where nothing needs a gradient (serving), which spares the autograd
    bookkeeping on the host.  ``x`` [..., K] -> [..., N]."""
    with span("qeft.linear.forward"):
        if p.reorder_ids is not None:
            x = x.index_select(-1, p.reorder_ids)
        if _without_kernels():  # differentiable as it stands; the gather is done
            return qgemm_plain(x, p)
        args = (x, p.qweight, p.scales, p.scaled_zeros, p.oweight, p.bias, p.group_size)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, p.oweight, p.bias)):
            return QLinearFunction.apply(*args)
        return _forward(*args)
