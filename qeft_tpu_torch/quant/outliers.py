"""Weak ("outlier") column selection from the Hessian diagonal, and the
global (OGR) sensitivity accumulation.  Counterpart of
``qeft_tpu/quant/outliers.py``.

Ties in a top-k resolve to the lower index, as ``jax.lax.top_k`` resolves
them (a stable descending sort); argsorts are stable, as ``jnp.argsort``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qeft_tpu_torch.quant.quantizer import QuantSpec, find_params, quantize
from qeft_tpu_torch.quant.reorder import sparse_to_dense_ids


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.argsort(x, descending=True, stable=True)[:k]


def hessian_sort_ids(h_diag: torch.Tensor, n_out: int,
                     frob_norm: Optional[torch.Tensor] = None,
                     outidx: Optional[torch.Tensor] = None,
                     actorder: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The outliers-last column permutation of one layer.

    Sensitivity is ``diag(H)``, times the per-column Frobenius error when
    given.  The top ``n_out`` columns (or the fixed global ``outidx``) go to
    the end in ascending order; the rest keep their order (or descending
    sensitivity with ``actorder``).  -> (ids [IC], out_ids [n_out] int32)."""
    ic = h_diag.shape[0]
    dev = h_diag.device
    sens = h_diag if frob_norm is None else h_diag * frob_norm
    if n_out == 0 and outidx is None:
        ids = _top_k(sens, ic) if actorder else torch.arange(ic, device=dev)
        return ids, torch.zeros(0, dtype=torch.int32, device=dev)
    top = _top_k(sens, n_out) if outidx is None else outidx.to(dev)
    out_ids = torch.sort(top).values.to(torch.int32)
    if actorder:
        masked = sens.clone()
        masked[out_ids.long()] = float("-inf")
        keep = _top_k(masked, ic - out_ids.shape[0])
        return torch.cat([keep, out_ids.to(keep.dtype)]), out_ids
    return sparse_to_dense_ids(out_ids, ic), out_ids


def frob_norm_error(w: torch.Tensor, spec: QuantSpec, num: int = 40) -> torch.Tensor:
    """Per-column squared quantization error of ``w`` [OC, IC] summed over
    the rows (one whole-row group per row)."""
    w = w.to(torch.float32)
    p = find_params(w, spec, num)
    wq = quantize(w, p.scale[:, None], p.zero[:, None], spec)
    return ((w - wq) ** 2).sum(dim=0)


def normalized_sensitivity(h_diag: torch.Tensor) -> torch.Tensor:
    """One layer's share of the global sensitivity: ``diag(H) / mean``."""
    return h_diag / h_diag.mean()


def select_global_outliers(sensitivity_sum: torch.Tensor, target_rank: int) -> torch.Tensor:
    """The top ``target_rank`` channels, ascending, int32."""
    return torch.sort(_top_k(sensitivity_sum, target_rank)).values.to(torch.int32)
