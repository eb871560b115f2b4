"""Uniform affine weight quantizer: per-row min-max, or an MSE grid search
over range shrinkage (and, asymmetric, the zero point) scored with an Lp
(p = 2.4) loss.

Counterpart of ``qeft_tpu/quant/quantizer.py``.  The JAX grid search is a
``fori_loop`` with one step per grid point; here each grid is one batched
pass: every grid point of a chunk is evaluated at once as a ``[points, OC,
C]`` tensor, and the first best point of each row is kept (the loop's
strict ``<``).  A chunk holds at most `GRID_ELEMENTS` values, so a
quantization group of a Llama-2-7B linear (``[11008, 128]``, 640 points)
takes one pass and a whole-row search (the Frobenius weighting) a few.

Division by a constant is multiplication by its f32 reciprocal, and a grid
point's range is ``xrange * (i / num)``, as XLA compiles the JAX
functions, so that the parameters agree bit for bit.

``w`` is ``[OC, C]``: one quantization channel per row.
"""

from __future__ import annotations

import dataclasses

import torch

EPS = 1e-8
GRID_ELEMENTS = 1 << 30  # f32 values of one grid chunk (4 GiB)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 4
    sym: bool = False
    mse: bool = True
    norm: float = 2.4
    group_size: int = -1  # -1: one group spanning the whole row

    @property
    def n_levels(self) -> int:
        return 2 ** self.bits

    @property
    def minq(self) -> int:
        return -((self.n_levels - 1) // 2 + 1) if self.sym else 0

    @property
    def maxq(self) -> int:
        return (self.n_levels - 1) // 2 if self.sym else self.n_levels - 1


@dataclasses.dataclass
class QuantParams:
    """Per-row affine parameters, ``[OC]`` each."""

    scale: torch.Tensor
    zero: torch.Tensor


def quantize(w: torch.Tensor, scale, zero, spec: QuantSpec) -> torch.Tensor:
    """Fake-quantize ``w`` with the given affine parameters."""
    q = torch.clamp(torch.round(w / scale) + zero, spec.minq, spec.maxq)
    return scale * (q - zero)


def quantize_int(w: torch.Tensor, scale, zero, spec: QuantSpec) -> torch.Tensor:
    """Integer codes of ``w`` (what gets packed)."""
    return torch.clamp(torch.round(w / scale) + zero, spec.minq, spec.maxq).to(torch.int32)


def _range(w: torch.Tensor):
    zeros = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    return torch.minimum(w.amin(dim=-1), zeros), torch.maximum(w.amax(dim=-1), zeros)


def _minmax_params(w: torch.Tensor, spec: QuantSpec):
    xmin, xmax = _range(w)
    if spec.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    if spec.sym:
        scale = xmax * (1.0 / -spec.minq)
        return scale, torch.zeros_like(scale)
    scale = (xmax - xmin) * (1.0 / spec.maxq)
    return scale, torch.round(-xmin / scale)


def _grid_scores(w: torch.Tensor, delta: torch.Tensor, zero: torch.Tensor,
                 spec: QuantSpec) -> torch.Tensor:
    """Lp loss ``[P, OC]`` of fake-quantizing ``w`` [OC, C] at the ``P``
    grid points ``delta``, ``zero`` [P, OC] (the operations of the JAX
    loop's body, in its order, in place on one ``[P, OC, C]`` tensor)."""
    d, z = delta[..., None], zero[..., None]
    t = w / d
    t.round_().add_(z).clamp_(spec.minq, spec.maxq).sub_(z).mul_(d)
    t.sub_(w).abs_().pow_(spec.norm)
    return t.mean(dim=-1)


def _grid_search(w: torch.Tensor, points: int, point_params, spec: QuantSpec):
    """Index ``[OC]`` of each row's first best grid point among ``points``;
    ``point_params(idx)`` gives (delta, zero) [len(idx), OC] of grid
    points ``idx``."""
    per_chunk = max(1, GRID_ELEMENTS // w.numel())
    best_score = torch.full((w.shape[0],), 1e10, dtype=w.dtype, device=w.device)
    best = torch.full((w.shape[0],), -1, dtype=torch.int64, device=w.device)
    for start in range(0, points, per_chunk):
        idx = torch.arange(start, min(points, start + per_chunk), device=w.device)
        score, arg = _grid_scores(w, *point_params(idx), spec).min(dim=0)
        better = score < best_score
        best_score = torch.where(better, score, best_score)
        best = torch.where(better, idx[arg], best)
    return best


def _mse_params_sym(w: torch.Tensor, spec: QuantSpec, num: int):
    xmin, xmax = _range(w)
    xrange = torch.maximum(xmin.abs(), xmax)

    def tmp_max(i):  # i: grid index as w's dtype, [P, 1] or [OC]
        return xrange * ((i + 1.0) * (1.0 / num))

    def params(idx):
        scale = torch.clamp_min(tmp_max(idx.to(w.dtype)[:, None]) * (1.0 / -spec.minq), EPS)
        return scale, torch.zeros_like(scale)

    best = _grid_search(w, num, params, spec)
    best_max = torch.where(best >= 0, tmp_max(best.to(w.dtype)), xmax)
    scale = torch.clamp_min(torch.clamp_min(best_max, 0.0) * (1.0 / -spec.minq), EPS)
    return scale, torch.zeros_like(scale)


def _mse_params_asym(w: torch.Tensor, spec: QuantSpec, num: int):
    minq, maxq, levels = spec.minq, spec.maxq, spec.n_levels
    xmin, xmax = _range(w)
    xrange = xmax - xmin

    def point(idx):
        """(tmp_max, delta, zp) of grid index ``idx``: i = idx // levels + 1
        shrinks the range, zp = idx % levels shifts the zero point."""
        i = (idx // levels + 1).to(w.dtype)
        zp = (idx % levels).to(w.dtype)
        tmax = xrange * (i * (1.0 / num))
        return tmax, torch.clamp_min(tmax * (1.0 / (maxq - minq)), EPS), zp

    def params(idx):
        _, delta, zp = point(idx[:, None])
        new_min = -zp * delta
        return delta, torch.clamp(minq - torch.round(new_min / delta), minq, maxq)

    best = _grid_search(w, num * levels, params, spec)
    tmax, delta, zp = point(best.clamp_min(0))
    new_min = torch.where(best >= 0, -zp * delta, xmin)
    new_max = torch.where(best >= 0, tmax - zp * delta, xmax)
    min_neg = torch.clamp_max(new_min, 0.0)
    max_pos = torch.clamp_min(new_max, 0.0)
    scale = torch.clamp_min((max_pos - min_neg) * (1.0 / (maxq - minq)), EPS)
    zero = torch.clamp(minq - torch.round(min_neg / scale), minq, maxq)
    return scale, zero


def find_params(w: torch.Tensor, spec: QuantSpec, num: int = 100) -> QuantParams:
    """Per-row affine parameters of ``w`` [OC, C] (f32)."""
    w = w.to(torch.float32)
    if not spec.mse:
        scale, zero = _minmax_params(w, spec)
    elif spec.sym:
        scale, zero = _mse_params_sym(w, spec, num)
    else:
        scale, zero = _mse_params_asym(w, spec, num)
    return QuantParams(scale=scale, zero=zero)


def fake_quantize(w: torch.Tensor, spec: QuantSpec, num: int = 100) -> torch.Tensor:
    """find_params + quantize in one call (per row, whole-row group)."""
    p = find_params(w, spec, num)
    return quantize(w, p.scale[:, None], p.zero[:, None], spec)
