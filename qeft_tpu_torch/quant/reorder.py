"""Offline global reordering (OGR): the index math.  Counterpart of
``qeft_tpu/quant/reorder.py``; the model-level pass is
``pipeline.reorder_model``."""

from __future__ import annotations

import torch


def sparse_to_dense_ids(sparse_ids: torch.Tensor, length: int) -> torch.Tensor:
    """int32 permutation [length]: the columns not in ``sparse_ids`` in
    order, then ``sparse_ids`` in their given order."""
    sparse_ids = sparse_ids.to(torch.int64)
    key = torch.arange(length, device=sparse_ids.device)
    key[sparse_ids] = length + torch.arange(sparse_ids.shape[0], device=sparse_ids.device)
    return torch.argsort(key).to(torch.int32)


def inverse_permutation(ids: torch.Tensor) -> torch.Tensor:
    return torch.argsort(ids)
