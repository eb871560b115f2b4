"""GPTQ-OWQ reconstruction: Hessian-weighted, error-compensated
quantization, with the full-precision weak ("outlier") columns last.

Counterpart of ``qeft_tpu/quant/gptq.py``: the same math and the same
structure.  JAX runs a linear as one jitted program, a ``scan`` over column
blocks with a ``fori_loop`` over a block's columns; here one column block
is a static program (`ColumnLoop`: the group re-fit, the column loop, the
trailing update over the whole width), captured once per linear shape as a
CUDA graph on the card and replayed for every block, and run eagerly on the
CPU or with ``graph=False``.  Group parameters are found again at each
group boundary over the error-compensated weights, and trailing
all-outlier groups repeat the last group's parameters.  The damped upper
factor ``U`` with ``U^T U = H^-1`` comes from the reversal identity the JAX
docstring gives, with ``torch.linalg`` (the JAX package's blocked
triangular inverse is a TPU memory workaround and is not carried over).

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
from typing import Dict, Optional

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


class ColumnLoop:
    """The static tensors of the GPTQ of one linear shape and the program
    of one column block over them, run eagerly or as a captured CUDA graph.

    ``w`` [OC, IC] is the working weight and ``u`` [IC, IC] the upper
    factor (None under ``rtn``); ``i1`` is the current block's first column,
    an int64 scalar on the device that the program advances itself, as
    ``generate.DecodeLoop`` advances its position.  A block reads its
    columns, its ``u`` rows and its diagonal block with ``index_select`` at
    ``i1``, re-fits the group's parameters, runs the column loop and applies
    the trailing update ``w[:, i2:] -= err_blk @ u[i1:i2, i2:]`` as one GEMM
    over the whole width with the rows of ``u`` zeroed left of ``i2`` (as
    JAX masks it), so that every block has the same shapes: one capture per
    (``active``, spec, grid) serves every block and every linear of the
    shape, each linear copying its weight and factor into ``w`` and ``u``.
    The eager and the captured run launch the same kernels in the same
    order, so their codes, scales and zeros are bit-identical; the eager
    run goes on the caller's stream, the capture and its replays on
    ``stream``."""

    def __init__(self, oc: int, ic: int, g: int, rtn: bool, device: torch.device,
                 stream: Optional[torch.cuda.Stream]):
        self.g = g
        self.w = torch.empty(oc, ic, dtype=torch.float32, device=device)
        self.u = None if rtn else torch.empty(ic, ic, dtype=torch.float32, device=device)
        self.scales = torch.empty(oc, ic // g, dtype=torch.float32, device=device)
        self.zeros = torch.empty_like(self.scales)
        self.i1 = torch.zeros((), dtype=torch.int64, device=device)
        self.offsets = torch.arange(g, device=device)
        self.col_ids = torch.arange(ic, device=device)
        self.graphs: Dict[tuple, object] = {}
        self.stream = stream  # where the captures run and replay (None on the CPU)
        self.replays = 0

    def step(self, active: int, spec: QuantSpec, num: int) -> None:
        """One block at column ``i1``: its first ``active`` columns quantize."""
        g = self.g
        cols = self.i1 + self.offsets
        w_blk = self.w.index_select(1, cols)
        w_params = w_blk.clone()
        w_params[:, active:] = 0.0  # exact: the range keeps 0, the loss scales per row
        p = find_params(w_params, spec, num)
        if self.u is None:  # rtn: no error compensation
            q_blk = w_blk
            q_blk[:, :active] = quantize(w_blk[:, :active], p.scale[:, None], p.zero[:, None],
                                         spec)
        else:
            u_rows = self.u.index_select(0, cols)  # [g, IC]
            q_blk, err_blk = _quantize_block(w_blk, p.scale, p.zero,
                                             u_rows.index_select(1, cols), active, spec)
            u_rows.masked_fill_((self.col_ids < self.i1 + g)[None, :], 0.0)
            self.w.addmm_(err_blk, u_rows, alpha=-1.0)
        self.w.index_copy_(1, cols, q_blk)
        b = torch.div(self.i1, g, rounding_mode="floor").reshape(1)
        self.scales.index_copy_(1, b, p.scale[:, None])
        self.zeros.index_copy_(1, b, p.zero[:, None])
        self.i1 += g

    def run(self, active: int, spec: QuantSpec, num: int, graph: bool) -> None:
        """One block; with ``graph`` (on the card) a replay of the block's
        program, captured after its first eager run."""
        key = (active, spec, num)
        if not graph or self.stream is None:
            self.step(active, spec, num)
        elif key in self.graphs:
            self.graphs[key].replay()
            self.replays += 1
        else:
            from qeft_tpu_torch.ops.cuda_lib import Graph

            self.step(active, spec, num)  # the block's work, and the capture's warm-up
            # the warm-up's temporaries (an MSE grid chunk of up to 4 GiB) go
            # back to the card before the capture takes its own pool
            torch.cuda.empty_cache()
            self.graphs[key] = Graph(lambda: self.step(active, spec, num), self.stream)


class ColumnLoops(dict):
    """The `ColumnLoop` s of one run by linear shape (``quantize_model`` keeps
    one for a whole model), all on one CUDA stream, so that what one shape's
    eager run leaves cached on the stream serves the next."""

    stream: Optional[torch.cuda.Stream] = None

    def loop(self, oc: int, ic: int, g: int, rtn: bool, device: torch.device) -> ColumnLoop:
        key = (oc, ic, g, rtn, device)
        if key not in self:
            if self.stream is None and device.type == "cuda":
                self.stream = torch.cuda.Stream(device)
            self[key] = ColumnLoop(oc, ic, g, rtn, device, self.stream)
        return self[key]


def gptq_quantize_permuted(w_perm: torch.Tensor, h_perm: torch.Tensor, spec: QuantSpec,
                           n_nonout: int, percdamp: float = 0.01, num: int = 40,
                           rtn: bool = False, graph: bool = True,
                           loops: Optional[ColumnLoops] = None):
    """GPTQ over a weight already permuted to the outliers-last order.

    ``w_perm`` [OC, IC], ``h_perm`` [IC, IC] (same permutation).  Returns
    (q_perm [OC, IC], scale_group [OC, G], zero_group [OC, G]) in the
    permuted layout.  ``rtn`` skips the error compensation.  On the card the
    column blocks run as replays of captured programs (`ColumnLoop`) unless
    ``graph=False``; ``loops`` (`ColumnLoops`, kept by the caller) holds them
    across calls, one per linear shape."""
    oc, ic = w_perm.shape
    g = spec.group_size if spec.group_size > 0 else ic
    if ic % g:
        raise ValueError(f"in-features {ic} are not a multiple of the group size {g}")
    n_groups = ic // g
    n_blocks = -(-n_nonout // g)  # blocks holding any dense column
    loop = (loops if loops is not None else ColumnLoops()).loop(oc, ic, g, rtn, w_perm.device)
    # captures and replays run on the programs' own stream; an eager run on
    # the caller's
    side = loop.stream if graph else None
    caller = torch.cuda.current_stream(w_perm.device) if side is not None else None
    with full_f32():
        loop.w.copy_(w_perm)
        loop.w.masked_fill_((h_perm.diagonal() == 0)[None, :], 0.0)
        if not rtn:
            loop.u.copy_(_cholesky_inv_upper(h_perm.to(torch.float32), percdamp))
        loop.i1.zero_()
        if side is not None:
            side.wait_stream(caller)
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            for b in range(n_blocks):
                loop.run(min(g, n_nonout - b * g), spec, num, graph)
        if side is not None:
            caller.wait_stream(side)
        w = loop.w.clone()
        scale_group = loop.scales[:, :n_blocks].clone()
        zero_group = loop.zeros[:, :n_blocks].clone()
    if n_groups > n_blocks:  # trailing all-outlier groups repeat the last params
        pad = n_groups - n_blocks
        scale_group = torch.cat([scale_group, scale_group[:, -1:].expand(-1, pad)], dim=1)
        zero_group = torch.cat([zero_group, zero_group[:, -1:].expand(-1, pad)], dim=1)
    return w, scale_group, zero_group


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, spec: QuantSpec, ids: torch.Tensor,
                  out_ids: torch.Tensor, percdamp: float = 0.01, num: int = 40,
                  rtn: bool = False, graph: bool = True,
                  loops: Optional[ColumnLoops] = None) -> LayerQuantResult:
    """OWQ-GPTQ of one layer: permute by ``ids`` (outliers last), run the
    blocked GPTQ (``graph``, ``loops`` as `gptq_quantize_permuted`), scatter
    the columns back."""
    ids = ids.to(device=w.device, dtype=torch.int64)
    n_nonout = w.shape[1] - int(out_ids.shape[0])
    w_perm = w.to(torch.float32)[:, ids]
    h_perm = h[ids][:, ids]
    q_perm, scale_group, zero_group = gptq_quantize_permuted(
        w_perm, h_perm, spec, n_nonout, percdamp, num, rtn, graph, loops)
    q = q_perm[:, torch.argsort(ids)]
    return LayerQuantResult(w_fake=q, scale_group=scale_group, zero_group=zero_group,
                            out_ids=out_ids)
