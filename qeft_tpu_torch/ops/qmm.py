"""Packed INT4 matrix products: the fused decode matvec (K1), the plain decode
matvec of a stacked (K6) and of an unstacked linear (K5), the prefill GEMM
(K2) and the training backward's transposed GEMM (K7).

Kernels (``csrc/qmm.cu``), each beside its plain PyTorch version:

- `qgemv_stacked_fused` replaces ``qeft_tpu/ops/pallas_qmm.py::
  qgemv_stacked_fused``: one decoder stage for at most `DECODE_MAX_TOKENS`
  rows -- optional RMS norm of the raw residual, the INT4 matvec over all K
  rows, the weak-column slab, optional residual add -- reading layer
  ``layer`` straight out of the stacked ``[L, ...]`` buffers: K6's kernel
  with the norm as its prologue and the residual in its epilogue.
- `qgemv_stacked` replaces ``pallas_qmm.py::qgemv_stacked``: the same
  matvec of layer ``layer`` with its weak-column slab, without the norm and
  the residual, on the tensor cores (``mma.sync``, the packed codes as A
  operands as they stand, in the contraction order `mma_k_row`).
  K1, K5 and K6 take group sizes 64 and 128 and N a multiple of 4.
- `qgemv` replaces ``pallas_qmm.py::qgemv``: the decode matvec of one
  unstacked linear, its weak-column slab and an optional bias, rounded once
  (K6's kernel at layer 0 with the bias in its epilogue) -- every linear of
  the OPT, Phi, Bloom and Falcon blocks at decode.
- `qgemm` replaces ``pallas_qmm.py::qgemm``: the W4A16 GEMM for more rows,
  with the weak-column slab and an optional residual in its epilogue.
- `qgemv_moe` has no counterpart in ``qeft_tpu`` (which has no expert
  layer): the decode matvec of a mixture of experts' stacked linear
  ``[E, K/8, N]`` over rows sorted by expert, expert e's ``counts[e]``
  rows from row ``offsets[e]`` on, both read on the device -- K5's main
  loop a block per (column tile, expert, tile of 8 rows), an expert's
  buffers read once a row tile, untouched experts and row tiles past an
  expert's rows leaving at once, so a decode step captured as a graph
  replays correctly whatever the routing.
- `qgemm_t` replaces ``pallas_qmm.py::qgemm_t``: ``dx = g @ W_deq^T`` from
  the packed codes over all K rows, written in original K order, with an
  optional f32 addend on the last r columns (the weak-column product) summed
  before the one rounding.

K1, K5 and K6 keep the codes exact and apply the scale in f32 after the
product, which is the JAX kernels' default (``QEFT_GEMV_F32W=1``).  Under
``QEFT_GEMV_F32W=0`` (`env.GEMV_F32W` off) they run their ``bf16w``
variant, the kernel's template flag that rounds each dequantized weight,
code x scale, to bf16 before the product as ``pallas_qmm._plane_dot``
does, the zero points folded in f32 as ever; its plain version,
`qgemm_bf16w_plain`, rounds the same products to the activation dtype.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from qeft_tpu_torch import env
from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.ops.packing import QLinearParams, dequantize_weight, unpack_codes

# calls with at most this many token rows take a decode matvec (K1, K5, K6);
# more rows take the GEMM (K2).  The choice changes which kernel runs, not the
# math.
DECODE_MAX_TOKENS = 8
GEMM_BN = 128  # output columns of a GEMM block (csrc/qmm.cu kM_BN), K2 and K7
# the decode matvecs' blocks (csrc/qmm.cu kD_*): output columns of a block,
# the most splits of a cluster (the portable cluster size)
GEMV_BN = 256
GEMV_MAX_SPLITS = 8


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             one_offset: bool = False) -> torch.Tensor:
    """f32 statistics; the normalised value is cast to the activation dtype
    BEFORE the weight multiply (gemma scales by ``1 + w``)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1.0 + w) if one_offset else normed * w


# ---------------------------------------------------------------------------
# plain versions


def qgemm_plain(x: torch.Tensor, p: QLinearParams,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize to ``[K, N]`` in the activation dtype, matmul, add the
    weak-column GEMM, bias and residual (twin of ``qlinear_xla``)."""
    dtype = x.dtype
    y = torch.matmul(x, dequantize_weight(p, dtype))
    if p.oweight is not None:
        r = p.oweight.shape[-2]
        y = y + torch.matmul(x[..., -r:], p.oweight.to(dtype))
    if p.bias is not None:
        y = y + p.bias.to(dtype)
    return y if residual is None else residual + y


def qgemm_bf16w_plain(x: torch.Tensor, p: QLinearParams,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``bf16w`` decode matvec's arithmetic: each weight's code x scale
    rounded to x's dtype, multiplied in f32, the zero points as
    ``sum_group(x) * zero``, the weak-column slab, bias and residual added
    in f32 and rounded once to x's dtype."""
    k = p.in_features
    g = k if p.group_size <= 0 else p.group_size
    xf = x.to(torch.float32)
    codes = unpack_codes(p.qweight, p.group_size).to(torch.float32)
    w = (codes * p.scales.to(torch.float32).repeat_interleave(g, dim=0)).to(x.dtype)
    y = xf @ w.to(torch.float32)
    y = y + xf.reshape(*x.shape[:-1], k // g, g).sum(-1) @ p.scaled_zeros.to(torch.float32)
    if p.oweight is not None:
        r = p.oweight.shape[-2]
        y = y + xf[..., k - r:] @ p.oweight.to(torch.float32)
    if p.bias is not None:
        y = y + p.bias.to(torch.float32)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(x.dtype)


def _matvec_plain(x, p: QLinearParams, residual=None) -> torch.Tensor:
    """The decode matvecs' plain arithmetic under the current `env.GEMV_F32W`."""
    if env.GEMV_F32W:
        return qgemm_plain(x, p, residual)
    return qgemm_bf16w_plain(x, p, residual)


def qgemv_stacked_fused_plain(x, p: QLinearParams, layer: int, lnw=None,
                              residual=None, eps: float = 1e-5,
                              one_offset: bool = False) -> torch.Tensor:
    if lnw is not None:
        x = rms_norm(x, lnw, eps, one_offset)
    return _matvec_plain(x, p.layer(layer), residual)


def qgemv_plain(x, p: QLinearParams) -> torch.Tensor:
    """``x @ W_deq + x[..., -r:] @ oweight + bias`` of one unstacked linear
    (twin of ``qgemv`` with its outside slab product and bias)."""
    return _matvec_plain(x, p)


def qgemv_stacked_plain(x, p: QLinearParams, layer: int) -> torch.Tensor:
    """``x @ W_deq[l] + x[..., -r:] @ oweight[l]`` (twin of ``qgemv_stacked``
    with its outside weak-column product)."""
    return _matvec_plain(x, p.layer(layer))


def qgemv_moe_plain(x: torch.Tensor, p: QLinearParams, counts: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Each expert's rows through its linear (`qgemm_plain` of ``p.layer(e)``):
    x [R, K] sorted by expert -> [R, N]; reads the counts on the host."""
    out = torch.zeros(x.shape[0], p.out_features, dtype=x.dtype, device=x.device)
    for e, (off, n) in enumerate(zip(offsets.tolist(), counts.tolist())):
        if n:
            out[off:off + n] = qgemm_plain(x[off:off + n], p.layer(e))
    return out


def qgemm_t_plain(g: torch.Tensor, p: QLinearParams,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``g @ W_deq^T`` with the weight dequantized in g's dtype, the products
    summed in f32, the f32 ``tail`` [..., r] added to the last r columns, and
    one rounding to g's dtype.  ``g`` [..., N] -> [..., K]."""
    w = dequantize_weight(p, g.dtype).to(torch.float32)
    y = torch.matmul(g.to(torch.float32), w.t())
    if tail is not None:
        y[..., y.shape[-1] - tail.shape[-1]:] += tail
    return y.to(g.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_packed(p: QLinearParams, stacked: bool, bias: bool = False) -> None:
    """Raise unless ``p`` is what the kernels read; ``bias``: the kernel adds
    a bias (K5), which must then be a bf16 CUDA vector of the N outputs."""
    nd = 3 if stacked else 2
    if p.qweight.dim() != nd or p.qweight.dtype != torch.int32:
        raise ValueError(f"qweight must be int32 with {nd} dims, got "
                         f"{p.qweight.dtype} {tuple(p.qweight.shape)}")
    if p.reorder_ids is not None:
        raise ValueError("the packed kernels take no reorder_ids: gather the input first")
    if p.bias is not None:
        if not bias:
            raise ValueError("this packed kernel takes no bias")
        b = p.bias
        if (b.dtype != torch.bfloat16 or not b.is_cuda or not b.is_contiguous()
                or tuple(b.shape) != (p.out_features,)):
            raise ValueError(f"bias must be a contiguous bfloat16 CUDA tensor of shape "
                             f"({p.out_features},)")
    for name in ("qweight", "scales", "scaled_zeros", "oweight"):
        t = getattr(p, name)
        if t is None:
            continue
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned CUDA tensor")
        if name != "qweight" and t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")


def _check_act(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    if t.dtype != torch.bfloat16 or not t.is_cuda:
        raise ValueError(f"{name} must be a bfloat16 CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return cuda_lib.aligned(t)


def mma_k_row(hh: int, jj0: int, t: int, j: int) -> int:
    """K row, within its quantization group, of element ``j`` (0..7) of lane
    ``t``'s activation chunk of the unit at word row ``jj0`` in the
    contraction order of K5/K6's tensor-core kernel: word row ``jj0 + t``,
    nibble ``j // 2 + 4 * (j % 2)`` (``hh`` = g / 8 word rows a group).
    Chunk words 2s and 2s + 1 are the B registers of k16 step s, the
    word's mask-or pairs 2s and 2s + 1 its A registers.  Twin of
    ``csrc/qmm.cu::mma_k_row`` for the CPU tests; the kernel does not call
    it."""
    return ((j >> 1) + 4 * (j & 1)) * hh + jj0 + t


def gemm_rows(m: int) -> int:
    """Rows of a `qgemm` / `qgemm_t` block: one warpgroup's 64-row wgmma tile
    for at most 64 rows (prefill windows), else two (128 rows, so each
    dequantized weight tile is reused 128 times)."""
    return 64 if m <= 64 else 128


def gemm_plan(m: int, n: int, n_groups: int, sms: int):
    """(rows of a block, split-K factor) of `qgemm`: at least about two
    (split, tile) blocks per SM, each split at least one quantization group,
    no split empty."""
    bm = gemm_rows(m)
    tiles = -(-m // bm) * -(-n // GEMM_BN)
    want = max(1, min(n_groups, -(-2 * sms // tiles)))
    per = n_groups // want  # groups of a split: at least `want` splits, none empty
    return bm, -(-n_groups // per)


def gemv_splits(tiles: int, units: int, sms: int) -> int:
    """Splits of a decode matvec's ``units`` groups over ``tiles`` column
    tiles of `GEMV_BN` (K1, K5, K6; the grouped expert matvec with ``tiles``
    x experts) on a card of ``sms`` SMs: the largest power of two, at most
    `GEMV_MAX_SPLITS` and ``units``, that keeps the grid within one block an
    SM where that grid fills 7/8 of the SMs, else within two blocks an SM.
    Twin of ``csrc/qmm.cu:gemv_splits`` (and ``common.cuh:k_splits``) for
    the CPU tests; the kernels do not call it."""
    def most(per_sm):
        s = 1
        while 2 * s <= GEMV_MAX_SPLITS and 2 * s <= units and tiles * 2 * s <= per_sm * sms:
            s *= 2
        return s

    one = most(1)
    return one if 8 * tiles * one >= 7 * sms else most(2)


def _decode_rows(x: torch.Tensor, p: QLinearParams, layer: Optional[int]):
    """The checks K1, K5 and K6 share (``layer`` None: unstacked, K5)
    -> (x as [M, K], M, K, N)."""
    _check_packed(p, stacked=layer is not None, bias=layer is None)
    k8, n = p.qweight.shape[-2:]
    k = k8 * 8
    m = x.numel() // k if x.shape[-1] == k else 0
    if not 1 <= m <= DECODE_MAX_TOKENS:
        raise ValueError(f"decode matvec takes 1..{DECODE_MAX_TOKENS} rows of {k}, got "
                         f"{tuple(x.shape)}")
    if layer is not None and not 0 <= layer < p.qweight.shape[0]:
        raise IndexError(f"layer {layer} out of range for {p.qweight.shape[0]} layers")
    return _check_act(x.reshape(m, k), "x", (m, k)), m, k, n


def _variant(name: str) -> str:
    """The entry point of decode matvec ``name`` under `env.GEMV_F32W`."""
    if env.GEMV_F32W:
        return name
    env.announce("QEFT_GEMV_F32W")
    return name + "_bf16w"


def qgemv_stacked_fused(x: torch.Tensor, p: QLinearParams, layer: int,
                        lnw: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        eps: float = 1e-5, one_offset: bool = False) -> torch.Tensor:
    """One decode stage of layer ``layer`` of the stacked linear ``p``.

    ``x`` [..., K] is the raw residual when ``lnw`` is given, else the stage
    input; ``residual`` [..., N] is added to the output.  Returns [..., N]."""
    if not x.is_cuda:
        return qgemv_stacked_fused_plain(x, p, layer, lnw, residual, eps, one_offset)
    x2, m, k, n = _decode_rows(x, p, layer)
    lnw_c = None if lnw is None else _check_act(lnw, "lnw", (k,))
    res = None if residual is None else _check_act(residual.reshape(m, n), "residual", (m, n))
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    cuda_lib.launch(
        _variant("qgemv_stacked_fused"),
        cuda_lib.ptr(x2), cuda_lib.ptr(lnw_c), cuda_lib.ptr(p.qweight),
        cuda_lib.ptr(p.scales), cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(p.oweight),
        cuda_lib.ptr(res), cuda_lib.ptr(out),
        int(layer), m, k, n, p.group_size, p.n_outlier, float(eps), int(one_offset),
    )
    return out.reshape(*x.shape[:-1], n)


def qgemv_stacked(x: torch.Tensor, p: QLinearParams, layer: int) -> torch.Tensor:
    """The decode matvec of layer ``layer`` of the stacked linear ``p``, no
    norm, no residual.  ``x`` [..., K] with at most `DECODE_MAX_TOKENS`
    rows -> [..., N]."""
    if not x.is_cuda:
        return qgemv_stacked_plain(x, p, layer)
    x2, m, k, n = _decode_rows(x, p, layer)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    cuda_lib.launch(
        _variant("qgemv_stacked"),
        cuda_lib.ptr(x2), cuda_lib.ptr(p.qweight), cuda_lib.ptr(p.scales),
        cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(p.oweight), cuda_lib.ptr(out),
        int(layer), m, k, n, p.group_size, p.n_outlier,
    )
    return out.reshape(*x.shape[:-1], n)


def qgemv(x: torch.Tensor, p: QLinearParams) -> torch.Tensor:
    """``x @ W_deq + x[..., K-r:] @ oweight (+ bias)`` of one layer's
    (unstacked) packed linear, rounded once.  ``x`` [..., K] with at most
    `DECODE_MAX_TOKENS` rows -> [..., N]."""
    if not x.is_cuda:
        return qgemv_plain(x, p)
    x2, m, k, n = _decode_rows(x, p, None)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    cuda_lib.launch(
        _variant("qgemv"),
        cuda_lib.ptr(x2), cuda_lib.ptr(p.qweight), cuda_lib.ptr(p.scales),
        cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(p.oweight), cuda_lib.ptr(p.bias),
        cuda_lib.ptr(out), m, k, n, p.group_size, p.n_outlier,
    )
    return out.reshape(*x.shape[:-1], n)


def qgemm(x: torch.Tensor, p: QLinearParams,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W_deq + x[..., K-r:] @ oweight (+ residual)`` for one layer's
    (unstacked) packed linear.  ``x`` [..., K] -> [..., N]."""
    if not x.is_cuda:
        return qgemm_plain(x, p, residual)
    _check_packed(p, stacked=False)
    k8, n = p.qweight.shape
    k = k8 * 8
    lead = x.shape[:-1]
    m = x.numel() // k
    x2 = _check_act(x.reshape(m, k), "x", (m, k))
    res = None if residual is None else _check_act(residual.reshape(m, n), "residual", (m, n))
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    bm, splits = gemm_plan(m, n, k // p.group_size, cuda_lib.sm_count(x.device))
    ws = (torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    cuda_lib.launch(
        "qgemm",
        cuda_lib.ptr(x2), cuda_lib.ptr(p.qweight), cuda_lib.ptr(p.scales),
        cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(p.oweight), cuda_lib.ptr(res),
        cuda_lib.ptr(out), cuda_lib.ptr(ws), m, k, n, p.group_size, p.n_outlier, bm, splits,
    )
    return out.reshape(*lead, n)


def qgemm_t(g: torch.Tensor, p: QLinearParams,
            tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``g @ W_deq^T`` of one layer's packed linear (its ``oweight`` is not
    read), plus the f32 ``tail`` [..., r] on the last r columns before the
    rounding.  ``g`` [..., N] -> [..., K]."""
    if not g.is_cuda:
        return qgemm_t_plain(g, p, tail)
    _check_packed(p, stacked=False)
    k8, n = p.qweight.shape
    k = k8 * 8
    lead = g.shape[:-1]
    m = g.numel() // n
    g2 = _check_act(g.reshape(m, n), "g", (m, n))
    r = 0
    if tail is not None:
        r = tail.shape[-1]
        if tail.dtype != torch.float32 or not tail.is_cuda or tuple(tail.shape[:-1]) != tuple(lead):
            raise ValueError(f"tail must be a float32 CUDA tensor of shape {(*lead, r)}")
        tail = cuda_lib.aligned(tail.reshape(m, r))
    out = torch.empty(m, k, dtype=torch.bfloat16, device=g.device)
    cuda_lib.launch(
        "qgemm_t",
        cuda_lib.ptr(g2), cuda_lib.ptr(p.qweight), cuda_lib.ptr(p.scales),
        cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(tail), cuda_lib.ptr(out),
        m, k, n, p.group_size, r, gemm_rows(m),
    )
    return out.reshape(*lead, k)


def qgemv_moe(x: torch.Tensor, p: QLinearParams, counts: torch.Tensor, offsets: torch.Tensor,
              max_rows: int) -> torch.Tensor:
    """The grouped decode matvec of the experts' stacked linear ``p``
    (qweight [E, K/8, N]): x [R, K] holds expert e's ``counts[e]`` rows from
    row ``offsets[e]`` on (int32 [E], on the device with x); the launch is
    sized for ``max_rows`` an expert (the token count: top-k picks an
    expert once a token), and an expert with more takes further turns of
    its blocks.  Returns [R, N], each row through its expert's linear and
    weak-column slab, rounded once.  Nothing is read on the host."""
    if not x.is_cuda:
        return qgemv_moe_plain(x, p, counts, offsets)
    _check_packed(p, stacked=True)
    e, k8, n = p.qweight.shape
    k = k8 * 8
    rows = x.shape[0]
    x2 = _check_act(x, "x", (rows, k))
    for name, t in (("counts", counts), ("offsets", offsets)):
        if t.dtype != torch.int32 or not t.is_cuda or tuple(t.shape) != (e,):
            raise ValueError(f"{name} must be an int32 CUDA tensor of shape ({e},)")
    out = torch.empty(rows, n, dtype=torch.bfloat16, device=x.device)
    cuda_lib.launch(
        "qgemv_moe",
        cuda_lib.ptr(x2), cuda_lib.ptr(p.qweight), cuda_lib.ptr(p.scales),
        cuda_lib.ptr(p.scaled_zeros), cuda_lib.ptr(p.oweight), cuda_lib.ptr(counts.contiguous()),
        cuda_lib.ptr(offsets.contiguous()), cuda_lib.ptr(out), e, int(max_rows), k, n,
        p.group_size, p.n_outlier,
    )
    return out
