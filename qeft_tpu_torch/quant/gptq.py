"""GPTQ-OWQ reconstruction: Hessian-weighted, error-compensated
quantization, with the full-precision weak ("outlier") columns last.

Counterpart of ``qeft_tpu/quant/gptq.py``: the same math, the JAX
``scan`` over column blocks and its inner ``fori_loop`` over a block's
columns written as a PyTorch loop (each column launches about ten kernels
on the GPU).  Group parameters are found again at each group boundary over
the error-compensated weights, and trailing all-outlier groups repeat the
last group's parameters.  The damped upper factor ``U`` with ``U^T U =
H^-1`` comes from the reversal identity the JAX docstring gives, with
``torch.linalg`` (the JAX package's blocked triangular inverse is a TPU
memory workaround and is not carried over).

f32 products (the Hessian, the block error propagation, the triangular
inverse) run at full f32 precision whatever the process's TF32 setting:
`full_f32` sets it for the call and restores it.
``QEFT_HESSIAN_PRECISION=high`` takes XLA's ``Precision.HIGH`` for the
Hessian sums: bf16 x 3 (hi.hi + hi.lo + lo.hi, summed in f32).

``w`` is ``[OC, IC]`` (row = output channel).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch

from qeft_tpu_torch.quant.quantizer import QuantSpec, find_params, quantize


@dataclasses.dataclass
class LayerQuantResult:
    """``w_fake`` [OC, IC] in the original column order (outlier columns
    keep their error-compensated values); ``scale_group`` / ``zero_group``
    [OC, G] in the outliers-last layout; ``out_ids`` [n_out], ascending."""

    w_fake: torch.Tensor
    scale_group: torch.Tensor
    zero_group: torch.Tensor
    out_ids: torch.Tensor


@contextlib.contextmanager
def full_f32():
    """CUDA f32 matmuls in IEEE f32 (no TF32) inside the block, the
    process's setting restored after it."""
    matmul = torch.backends.cuda.matmul
    if hasattr(matmul, "fp32_precision"):
        old = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = old
    else:
        old = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = old


def hessian_precision() -> str:
    """``highest`` (f32, the default) or ``high`` (bf16 x 3), from
    ``QEFT_HESSIAN_PRECISION`` as the JAX package reads it."""
    v = os.environ.get("QEFT_HESSIAN_PRECISION", "highest").lower()
    return "high" if v == "high" else "highest"


def gram(flat: torch.Tensor, precision: Optional[str] = None) -> torch.Tensor:
    """``flat^T flat`` [IC, IC] in f32 of ``flat`` [T, IC] at the Hessian
    precision."""
    flat = flat.to(torch.float32)
    if (precision or hessian_precision()) == "highest":
        with full_f32():
            return flat.t() @ flat
    from qeft_tpu_torch.ops.qlinear import matmul_f32

    hi = flat.to(torch.bfloat16)
    lo = (flat - hi.to(torch.float32)).to(torch.bfloat16)
    return (matmul_f32(hi.t(), hi) + matmul_f32(hi.t(), lo)) + matmul_f32(lo.t(), hi)


def hessian_from_inputs(x: torch.Tensor, nsamples: Optional[int] = None) -> torch.Tensor:
    """``H = (2 / nsamples) sum_b X_b^T X_b`` of ``x`` [n, tokens, IC] (or
    [tokens, IC])."""
    if x.dim() == 2:
        x = x[None]
    n = nsamples if nsamples is not None else x.shape[0]
    return (2.0 / n) * gram(x.reshape(-1, x.shape[-1]))


def hessian_accumulate(h: torch.Tensor, x: torch.Tensor, nsamples_seen: int,
                       nsamples_new: int):
    """Streaming form keeping ``h = (2 / n_seen) sum x x^T``."""
    total = nsamples_seen + nsamples_new
    h = h * (nsamples_seen / total)
    return h + (2.0 / total) * gram(x.reshape(-1, x.shape[-1])), total


def _cholesky_inv_upper(h: torch.Tensor, percdamp: float) -> torch.Tensor:
    """Damped upper-triangular ``U`` with ``H^-1 = U^T U``: with J the
    index reversal and ``Lb = chol(J H J)``, ``U = J inv(Lb) J``.  Dead
    columns (zero diagonal) get a unit diagonal first."""
    ic = h.shape[0]
    h = h.clone()
    diag = h.diagonal()
    diag[diag == 0] = 1.0
    diag += percdamp * diag.mean()
    with full_f32():
        lb = torch.linalg.cholesky(torch.flip(h, (0, 1)))
        eye = torch.eye(ic, dtype=h.dtype, device=h.device)
        linv = torch.linalg.solve_triangular(lb, eye, upper=False)
    return torch.flip(linv, (0, 1))


def _quantize_block(w_blk: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    u_blk: torch.Tensor, active: int, spec: QuantSpec):
    """The column loop of one block of ``g`` columns, in place on
    ``w_blk``; its first ``active`` columns quantize, the rest (the weak
    slab) keep their value and emit no error.  -> (q_blk, err_blk)."""
    q_blk = torch.empty_like(w_blk)
    err_blk = torch.zeros_like(w_blk)
    for i in range(active):
        w_i = w_blk[:, i]
        q_i = quantize(w_i, scale, zero, spec)
        err = (w_i - q_i) / u_blk[i, i]
        w_blk[:, i + 1:] -= err[:, None] * u_blk[i, i + 1:][None, :]
        q_blk[:, i] = q_i
        err_blk[:, i] = err
    q_blk[:, active:] = w_blk[:, active:]
    return q_blk, err_blk


def gptq_quantize_permuted(w_perm: torch.Tensor, h_perm: torch.Tensor, spec: QuantSpec,
                           n_nonout: int, percdamp: float = 0.01, num: int = 40,
                           rtn: bool = False):
    """GPTQ over a weight already permuted to the outliers-last order.

    ``w_perm`` [OC, IC], ``h_perm`` [IC, IC] (same permutation).  Returns
    (q_perm [OC, IC], scale_group [OC, G], zero_group [OC, G]) in the
    permuted layout.  ``rtn`` skips the error compensation."""
    oc, ic = w_perm.shape
    g = spec.group_size if spec.group_size > 0 else ic
    if ic % g:
        raise ValueError(f"in-features {ic} are not a multiple of the group size {g}")
    n_groups = ic // g
    n_blocks = -(-n_nonout // g)  # blocks holding any dense column
    w = w_perm.to(torch.float32).clone()
    w[:, h_perm.diagonal() == 0] = 0.0
    u = None if rtn else _cholesky_inv_upper(h_perm.to(torch.float32), percdamp)
    scales, zeros = [], []
    with full_f32():
        for b in range(n_blocks):
            i1, i2 = b * g, (b + 1) * g
            active = min(g, n_nonout - i1)
            w_blk = w[:, i1:i2].clone()
            w_params = w_blk.clone()
            w_params[:, active:] = 0.0  # exact: the range keeps 0, the loss scales per row
            p = find_params(w_params, spec, num)
            if rtn:
                q_blk = w_blk.clone()
                q_blk[:, :active] = quantize(w_blk[:, :active], p.scale[:, None],
                                             p.zero[:, None], spec)
            else:
                q_blk, err_blk = _quantize_block(w_blk, p.scale, p.zero, u[i1:i2, i1:i2],
                                                 active, spec)
                w[:, i2:] -= err_blk @ u[i1:i2, i2:]
            w[:, i1:i2] = q_blk
            scales.append(p.scale)
            zeros.append(p.zero)
    scale_group = torch.stack(scales, dim=1)
    zero_group = torch.stack(zeros, dim=1)
    if n_groups > n_blocks:  # trailing all-outlier groups repeat the last params
        pad = n_groups - n_blocks
        scale_group = torch.cat([scale_group, scale_group[:, -1:].expand(-1, pad)], dim=1)
        zero_group = torch.cat([zero_group, zero_group[:, -1:].expand(-1, pad)], dim=1)
    return w, scale_group, zero_group


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, spec: QuantSpec, ids: torch.Tensor,
                  out_ids: torch.Tensor, percdamp: float = 0.01, num: int = 40,
                  rtn: bool = False) -> LayerQuantResult:
    """OWQ-GPTQ of one layer: permute by ``ids`` (outliers last), run the
    blocked GPTQ, scatter the columns back."""
    ids = ids.to(device=w.device, dtype=torch.int64)
    n_nonout = w.shape[1] - int(out_ids.shape[0])
    w_perm = w.to(torch.float32)[:, ids]
    h_perm = h[ids][:, ids]
    q_perm, scale_group, zero_group = gptq_quantize_permuted(
        w_perm, h_perm, spec, n_nonout, percdamp, num, rtn)
    q = q_perm[:, torch.argsort(ids)]
    return LayerQuantResult(w_fake=q, scale_group=scale_group, zero_group=zero_group,
                            out_ids=out_ids)
