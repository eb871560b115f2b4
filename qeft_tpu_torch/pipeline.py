"""Load-time stage fusion of a packed model, and its inverse for one field.

Counterpart of ``qeft_tpu/pipeline.py::fuse_packed_stages`` without the
TPU-only steps: no zero-padding of the upgate halves and no banded
o-permutation operands.  `split_fused` cuts a fused stage's tensor (the
trained weak-column slabs) back into its members, so that WCT checkpoints
carry the linear names of the base checkpoint.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from qeft_tpu_torch.models.registry import ModelMeta
from qeft_tpu_torch.ops.packing import QLinearParams


def _fuse_stage(layers: Dict, names: Sequence[str], fused_name: str) -> None:
    """Concatenate same-stage packed linears along N (every field carries N
    on its last axis); valid because they share one input permutation."""
    lins = [layers.pop(n) for n in names]
    if any(l.reorder_ids is not None for l in lins):
        raise ValueError("stage fusion needs a statically reordered model")

    def cat(field):
        parts = [getattr(l, field) for l in lins]
        return None if parts[0] is None else torch.cat(parts, dim=-1)

    layers[fused_name] = QLinearParams(
        qweight=cat("qweight"), scales=cat("scales"), scaled_zeros=cat("scaled_zeros"),
        oweight=cat("oweight"), bias=cat("bias"), group_size=lins[0].group_size,
    )


def fused_stages(meta: ModelMeta) -> Dict[str, Tuple[str, ...]]:
    """Fused stage name -> its members, in concatenation order, as
    ``qeft_tpu/pipeline.py::fuse_packed_stages`` fuses them: q/k/v only for
    the llama topology (llama, gemma), up/gate only where ffn1 has two
    members.  The OPT, Phi, Bloom and Falcon blocks read their linears by
    their own names and get nothing fused."""
    out = {}
    if meta.family in ("llama", "gemma") and len(meta.qkv) == 3:
        out["qkv"] = meta.qkv
    if len(meta.ffn1) == 2:
        out["upgate"] = meta.ffn1
    return out


def fuse_packed_stages(params: Dict, meta: ModelMeta) -> Dict:
    """q/k/v -> ``qkv`` and up/gate -> ``upgate`` on a stacked packed model
    (see `fused_stages`); a model already fused, or of a family with nothing
    to fuse, passes through unchanged."""
    layers = dict(params["layers"])
    for fused, names in fused_stages(meta).items():
        if all(n in layers for n in names):
            _fuse_stage(layers, names, fused)
    return {**params, "layers": layers}


def member_widths(cfg, meta: ModelMeta) -> Dict[str, int]:
    """Output width N of each member of a fused stage (empty for a family
    with nothing to fuse)."""
    stages = fused_stages(meta)
    out = {}
    if "qkv" in stages:
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        out.update(zip(stages["qkv"], (q, kv, kv)))
    if "upgate" in stages:
        out.update(dict.fromkeys(stages["upgate"], cfg.intermediate_size))
    return out


def split_fused(tensors: Dict[str, torch.Tensor], meta: ModelMeta, widths: Dict[str, int],
                keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Inverse of the N-concatenation of `_fuse_stage` for one field: every
    fused stage of ``tensors`` not named in ``keep`` is cut along its last
    axis into its members (``widths`` from `member_widths`)."""
    out = {}
    for name, t in tensors.items():
        names = fused_stages(meta).get(name)
        if names is None or name in keep:
            out[name] = t
            continue
        if t.shape[-1] != sum(widths[n] for n in names):
            raise ValueError(f"{name} is {t.shape[-1]} wide, its members "
                             f"{names} sum to {sum(widths[n] for n in names)}")
        out.update(zip(names, torch.split(t, [widths[n] for n in names], dim=-1)))
    return out


def fuse_tensors(tensors: Dict[str, torch.Tensor], meta: ModelMeta) -> Dict[str, torch.Tensor]:
    """Per-member tensors of one field concatenated into their fused stages
    along N, as `_fuse_stage` concatenates each field."""
    out = dict(tensors)
    for fused, names in fused_stages(meta).items():
        if all(n in out for n in names):
            out[fused] = torch.cat([out.pop(n) for n in names], dim=-1)
    return out
