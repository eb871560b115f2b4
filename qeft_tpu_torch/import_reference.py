"""Import a reference (xvyaward/qeft) packed checkpoint, or a WCT overlay
on one, into the port's packed format: the migration path for users who
hold the reference's ``torch.save`` files.

Counterpart of ``qeft_tpu/import_reference.py``, with its own copy of the
layout math.  The reference stores, per linear of a llama-family model
(``model_state_dict`` of ``{'model_state_dict', 'quantinfos', 'packing',
'group_size', ...}``):

- ``qweight`` int16 [OC/4, IC]: INT4 codes in the AWQ tensor-core
  interleave (a 32-column [4, 4, 2] shuffle, the in-octet [0, 2, 4, 6, 1,
  3, 5, 7] order, a 4-row interleave at kstride 64, four nibbles an int16);
- ``scales`` and ``scaled_zeros`` fp16 [IC/g, OC], the port's [G, N] as
  they are;
- ``oweight`` fp16 [OC, r], the weak-column slab (the last r input rows;
  their codes hold the zero point) and ``outlieridx``.

So the import is layout math and no requantization: the codes are
unshuffled (`unpack_awq`, the forward shuffle's reshapes and transposes
undone in reverse order, on the device) and repacked by
``ops.packing.pack_codes``; scales, zero points and slabs are cast to bf16.
Only OGR (``--reorder``) checkpoints are read, as in the JAX package::

    python -m qeft_tpu_torch.import_reference ref_ckpt.pth out_ckpt --model llama2-7b
    python -m qeft_tpu_torch.main --load out_ckpt --eval

The file is read with ``torch.load(..., weights_only=False)``: the
reference pickles ``argparse.Namespace`` quantizer records, so read only
files you trust.  Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.ops.packing import QLinearParams, pack_codes


@functools.lru_cache(maxsize=8)
def _awq_nibble_source_map(n: int, k: int) -> np.ndarray:
    """[N//4, K, 4]: the flat index (row-major [N, K]) of the code that
    nibble ``i`` of packed int16 (row, col) holds, made by pushing an index
    array through the reference's forward shuffle (``pack_intweight``)."""
    a = np.arange(n * k, dtype=np.int64).reshape(n, k)
    # 32-column [4, 4, 2] shuffle
    a = a.reshape(n, k // 32, 4, 4, 2).transpose(0, 1, 3, 2, 4).reshape(n, k // 32, 32)
    # in-octet [0, 2, 4, 6, 1, 3, 5, 7] order
    a = a.reshape(n, k // 32, 4, 4, 2).transpose(0, 1, 2, 4, 3).reshape(n, k)
    # 4-row interleave at kstride 64
    a = a.reshape(n // 4, 4, k // 64, 64).transpose(0, 2, 1, 3)
    a = a.reshape(n // 4, k // 64, 64, 4)
    return a.reshape(n // 4, k, 4)


def unpack_awq(qweight: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int16 [N//4, K] AWQ-packed -> int32 codes [N, K] where ``qweight``
    lives: the exact inverse of the reference's ``pack_intweight``, each
    step of `_awq_nibble_source_map`'s shuffle undone in reverse order."""
    q = torch.as_tensor(qweight).to(torch.int32).reshape(n // 4, k) & 0xFFFF
    a = torch.stack([(q >> (4 * i)) & 0xF for i in range(4)], dim=-1)  # [N//4, K, 4]
    a = a.reshape(n // 4, k // 64, 4, 64).transpose(1, 2).reshape(n, k)
    a = a.reshape(n, k // 32, 4, 2, 4).transpose(3, 4).reshape(n, k)
    a = a.reshape(n, k // 32, 4, 4, 2).transpose(2, 3).reshape(n, k)
    return a.contiguous()


def _bf16(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=torch.float32).to(torch.bfloat16)


def _import_linear(sd: Dict, prefix: str, group_size: int, device) -> QLinearParams:
    """One reference QuantLinear -> a packed linear on ``device``."""
    scales = torch.as_tensor(sd[prefix + "scales"])  # [G, OC]
    oc = scales.shape[1]
    qweight = torch.as_tensor(sd[prefix + "qweight"]).to(device)  # [OC/4, IC]
    codes_kn = unpack_awq(qweight, oc, qweight.shape[1]).t()  # [K, N]
    ow = sd.get(prefix + "oweight")
    bias = sd.get(prefix + "bias")
    return QLinearParams(
        qweight=pack_codes(codes_kn, group_size),
        scales=_bf16(scales, device),
        scaled_zeros=_bf16(sd[prefix + "scaled_zeros"], device),
        oweight=None if ow is None else _bf16(torch.as_tensor(ow).t().contiguous(), device),
        bias=None if bias is None else _bf16(bias, device),
        group_size=group_size)


# the port's linear name -> the reference's (Hugging Face) module path
_HF_LLAMA_LINEARS = {
    "q": "self_attn.q_proj.",
    "k": "self_attn.k_proj.",
    "v": "self_attn.v_proj.",
    "o": "self_attn.o_proj.",
    "up": "mlp.up_proj.",
    "gate": "mlp.gate_proj.",
    "down": "mlp.down_proj.",
}


def _stack(blocks):
    out = {}
    for k in blocks[0]:
        parts = [b[k] for b in blocks]
        if isinstance(parts[0], QLinearParams):
            def cat(field):
                vals = [getattr(p, field) for p in parts]
                return None if vals[0] is None else torch.stack(vals)

            out[k] = QLinearParams(
                qweight=cat("qweight"), scales=cat("scales"), scaled_zeros=cat("scaled_zeros"),
                oweight=cat("oweight"), bias=cat("bias"), group_size=parts[0].group_size)
        else:
            out[k] = torch.stack(parts)
    return out


def _load(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def import_reference_packed(path: str, cfg, ckpt: Optional[Dict] = None,
                            device=None) -> Tuple[Dict, str]:
    """A reference packed checkpoint -> (the port's packed tree on
    ``device``, family).  ``cfg``: the model's ``LlamaConfig`` (the
    reference stores none); ``ckpt``: the dict already loaded, so that a
    large file is read once.  ``device`` defaults to the GPU, which must
    exist."""
    from qeft_tpu_torch.quant.reorder import sparse_to_dense_ids

    device = resolve_device(device)
    if ckpt is None:
        ckpt = _load(path)
    if not ckpt.get("packing"):
        raise ValueError(f"{path} is not a packed reference checkpoint")
    sd = ckpt["model_state_dict"]
    group_size = int(ckpt.get("group_size", 128))
    quantinfos = ckpt.get("quantinfos", {})
    if quantinfos and not all(getattr(qi, "reorder", False) for qi in quantinfos.values()):
        raise NotImplementedError(
            "only OGR (--reorder) reference checkpoints are supported: "
            "non-reordered ones keep per-layer scattered outlier columns "
            "(reference forward_outlier), a layout this importer does not "
            "translate"
        )
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        blk = {"input_ln": _bf16(sd[pre + "input_layernorm.weight"], device),
               "post_ln": _bf16(sd[pre + "post_attention_layernorm.weight"], device)}
        for ours, theirs in _HF_LLAMA_LINEARS.items():
            blk[ours] = _import_linear(sd, pre + theirs, group_size, device)
        # the o-projection's run-time input gather (its input, the attention
        # output, is head-ordered and cannot be permuted statically)
        oid = sd.get(pre + "self_attn.o_proj.outlieridx")
        if oid is not None and len(oid):
            blk["o_reorder"] = sparse_to_dense_ids(
                torch.as_tensor(oid, dtype=torch.int64, device=device),
                blk["o"].in_features).to(torch.int32)
        blocks.append(blk)
    params = {
        "embed": _bf16(sd["model.embed_tokens.weight"], device),
        "layers": _stack(blocks),
        "final_ln": _bf16(sd["model.norm.weight"], device),
        "lm_head": _bf16(torch.as_tensor(sd["lm_head.weight"]).t().contiguous(), device),
    }
    return params, "llama"


def import_reference_wct(path: str, cfg, base_path: Optional[str] = None,
                         ckpt: Optional[Dict] = None, device=None) -> Tuple[Dict, str]:
    """A reference WCT checkpoint (the tuned slabs only, ``{
    'oweight_state_dict', 'base_path'}``) -> the imported packed base with
    those slabs laid over it.  ``base_path`` overrides the absolute path the
    checkpoint stores (a base moved with it)."""
    device = resolve_device(device)
    if ckpt is None:
        ckpt = _load(path)
    if "oweight_state_dict" not in ckpt:
        raise ValueError(f"{path} is not a reference WCT checkpoint")
    params, family = import_reference_packed(base_path or ckpt["base_path"], cfg,
                                             device=device)
    # keys are module paths, e.g. model.layers.0.self_attn.q_proj
    inv = {v.rstrip("."): k for k, v in _HF_LLAMA_LINEARS.items()}
    for name, ow in ckpt["oweight_state_dict"].items():
        parts = name.split(".")
        lin = params["layers"][inv[".".join(parts[3:])]]  # stacked [L, ...]
        if lin.oweight is None:
            raise ValueError(f"WCT overlay for '{name}' but the packed base has no outlier "
                             "slab there: wrong base checkpoint?")
        lin.oweight[int(parts[2])] = _bf16(torch.as_tensor(ow).t(), device)
    return params, family


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("src", help="reference packed (or WCT) .pth/.pt")
    parser.add_argument("dst", help="the port's packed checkpoint to write")
    parser.add_argument("--model", required=True,
                        help="preset name (llama2-7b, ...) or Hugging Face directory of the "
                        "config the checkpoint was made from")
    parser.add_argument("--base", default=None,
                        help="packed base of a WCT checkpoint (overrides the absolute "
                        "base_path stored in it)")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    args = parser.parse_args(argv)

    from qeft_tpu_torch.checkpoint import save_packed
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS

    device = resolve_device(args.device)
    if args.model in LLAMA_PRESETS:
        cfg = LLAMA_PRESETS[args.model]
    else:
        from qeft_tpu_torch.models.hf_loader import config_from_hf

        cfg = config_from_hf(args.model)
    ckpt = _load(args.src)
    if "oweight_state_dict" in ckpt:
        params, family = import_reference_wct(args.src, cfg, base_path=args.base, ckpt=ckpt,
                                              device=device)
    else:
        params, family = import_reference_packed(args.src, cfg, ckpt=ckpt, device=device)
    save_packed(args.dst, params, cfg, family=family)
    print(f"imported reference checkpoint -> {args.dst}.npz")


if __name__ == "__main__":
    main()
