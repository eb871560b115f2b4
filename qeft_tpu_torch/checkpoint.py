"""Packed, fake and WCT checkpoints, read and written.

The format is the JAX package's (``qeft_tpu/checkpoint.py``): one ``.npz`` of
path-addressed leaves (``layers::qkv::qweight``; a linear's fields end in its
``__group_size`` sentinel) and a JSON manifest with the format tag, the
model family and its config.  numpy cannot store bfloat16, so those leaves
are stored as uint16 under a key ending in ``@bf16``; they are viewed back
as ``torch.bfloat16`` bit for bit.  A WCT checkpoint holds only the tuned
weak-column slabs (``oweight::<linear>``) and the base checkpoint's path.
A fake checkpoint holds the fake-quantized dense tree (member names:
``layers::q``, ...) and each linear's quantizer state under
``__quant::<block>::<name>::<field>`` (``scale_group``, ``zero_group``,
``out_ids``, ``flags`` = [sym, bits, group size], and ``perm_ids`` under
act-order), so that it can be packed later (``convert``).  The two
packages read each other's checkpoints of every format.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.ops.packing import QLinearParams

_SEP = "::"
_BF16_TAG = "@bf16"
_QFIELDS = ("qweight", "scales", "scaled_zeros", "oweight", "bias", "reorder_ids",
            "__group_size")
# TPU-layout operands a JAX tree may carry; the port gathers with o_reorder
_DROPPED = ("o_band", "o_tail")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _to_tensor(key: str, a: np.ndarray) -> Tuple[str, torch.Tensor]:
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True, order="C")
    if key.endswith(_BF16_TAG):
        return key[: -len(_BF16_TAG)], torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return key, torch.from_numpy(a)


def from_flat(flat: Dict[str, np.ndarray]) -> Dict:
    """Nested parameter dict (CPU tensors; packed linears as QLinearParams)
    from the flat key format of ``qeft_tpu.checkpoint._flatten``."""
    tree: Dict = {}
    qnodes: Dict[str, Dict] = {}
    for raw_key, arr in flat.items():
        if raw_key.endswith(_SEP + "__group_size"):
            key, val = raw_key, int(np.asarray(arr))
        else:
            key, val = _to_tensor(raw_key, np.asarray(arr))
        parts = key.split(_SEP)
        if parts[-1] in _DROPPED:
            continue
        if len(parts) >= 2 and parts[-1] in _QFIELDS:
            qnodes.setdefault(_SEP.join(parts[:-1]), {})[parts[-1]] = val
            continue
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    for node_key, fields in qnodes.items():
        parts = node_key.split(_SEP)
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = QLinearParams(
            qweight=fields["qweight"], scales=fields["scales"],
            scaled_zeros=fields["scaled_zeros"], oweight=fields.get("oweight"),
            bias=fields.get("bias"), reorder_ids=fields.get("reorder_ids"),
            group_size=fields["__group_size"],
        )
    return tree


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Apply ``fn`` to every tensor of a parameter tree."""
    if isinstance(tree, QLinearParams):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cfg_from_dict(d: Dict, family: str = "llama"):
    from qeft_tpu_torch.models.api import get_model_api

    d = dict(d)
    d["dtype"] = _DTYPES[d["dtype"]]
    return get_model_api(family).config_cls(**d)


def _paths(path: str) -> Tuple[str, str]:
    stem = path[:-4] if path.endswith(".npz") else path
    return stem + ".npz", stem + ".json"


def _manifest(path: str, fmt: str = None) -> Dict:
    with open(_paths(path)[1]) as f:
        manifest = json.load(f)
    if fmt is not None and manifest["format"] != fmt:
        raise ValueError(f"{path} is a {manifest['format']!r} checkpoint, not {fmt}")
    return manifest


def load_packed(path: str, device=None):
    """-> (packed params on ``device``, config, family).  ``device`` defaults
    to the GPU and raises without one."""
    device = resolve_device(device)
    manifest = _manifest(path, "packed")
    with np.load(_paths(path)[0]) as z:
        params = from_flat({k: z[k] for k in z.files})
    family = manifest.get("family", "llama")
    params = tree_map(lambda t: t.to(device), params)
    return params, cfg_from_dict(manifest["config"], family), family


# ---------------------------------------------------------------------------
# writing, and the WCT overlay


def _encode(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def to_flat(params: Dict) -> Dict[str, np.ndarray]:
    """Inverse of `from_flat`: the key format of ``qeft_tpu.checkpoint._flatten``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, QLinearParams):
            for field in _QFIELDS[:-1]:
                t = getattr(node, field)
                if t is not None:
                    walk(prefix + _SEP + field, t)
            flat[prefix + _SEP + "__group_size"] = np.asarray(node.group_size)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + _SEP + k if prefix else k, v)
        elif node is not None:
            tag, a = _encode(node)
            flat[prefix + tag] = a

    walk("", params)
    return flat


def _save(path: str, flat: Dict[str, np.ndarray], manifest: Dict) -> None:
    npz, mpath = _paths(path)
    os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
    np.savez(npz, **flat)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)


def cfg_to_dict(cfg) -> Dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return d


def save_packed(path: str, params: Dict, cfg, family: str = "llama") -> None:
    """A packed checkpoint in the JAX package's format (fused stages are
    written under their fused names, as ``qeft_tpu`` writes a fused tree)."""
    _save(path, to_flat(params),
          {"format": "packed", "family": family, "config": cfg_to_dict(cfg)})


def _linear_names(path: str) -> set:
    """Names of the layer linears that carry an oweight in a checkpoint."""
    with np.load(_paths(path)[0]) as z:
        return {k.split(_SEP)[1] for k in z.files
                if k.startswith("layers" + _SEP) and k.split(_SEP)[-1].startswith("oweight")}


def save_wct(path: str, oweights: Dict, base_path: str) -> None:
    """Oweight-only overlay on the packed checkpoint ``base_path``, in the
    JAX package's format: one f32 ``[L, r, N]`` slab per linear, under the
    linear names the base checkpoint holds.  ``oweights`` maps a stage to
    its per-layer leaves (or to a stacked tensor); a fused stage whose name
    the base does not hold is cut into its members."""
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.pipeline import member_widths, split_fused

    manifest = _manifest(base_path, "packed")
    family = manifest.get("family", "llama")
    stacked = {name: (torch.stack([t.detach() for t in w]) if isinstance(w, (list, tuple))
                      else w.detach()).to(torch.float32)
               for name, w in oweights.items()}
    meta = get_model_meta(family)
    cfg = cfg_from_dict(manifest["config"], family)
    per_name = split_fused(stacked, meta, member_widths(cfg, meta), keep=_linear_names(base_path))
    _save(path, {f"oweight{_SEP}{name}": _encode(t)[1] for name, t in per_name.items()},
          {"format": "wct", "base_path": os.path.abspath(base_path)})


def read_wct(path: str) -> Tuple[Dict[str, torch.Tensor], str]:
    """-> (per-linear f32 slabs on the CPU, as written, and the base path)."""
    base = _manifest(path, "wct")["base_path"]
    with np.load(_paths(path)[0]) as z:
        slabs = dict(_to_tensor(k, z[k]) for k in z.files)
    return {k.split(_SEP, 1)[1]: v for k, v in slabs.items()}, base


def load_wct(path: str, device=None):
    """Base packed model with the tuned slabs laid over it, each cast to its
    linear's scales dtype (as ``qeft_tpu.checkpoint.load_wct`` does), then
    stage-fused.  -> (params, config, family)."""
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.pipeline import fuse_packed_stages

    slabs, base = read_wct(path)
    params, cfg, family = load_packed(base, device)
    layers = dict(params["layers"])
    for name, w in slabs.items():
        lin = layers[name]
        layers[name] = dataclasses.replace(
            lin, oweight=w.to(device=lin.scales.device, dtype=lin.scales.dtype))
    params = fuse_packed_stages({**params, "layers": layers}, get_model_meta(family))
    return params, cfg, family


_QUANT = "__quant" + _SEP


def save_fake(path: str, params: Dict, quantizers: Dict, cfg, family: str = "llama") -> None:
    """A fake-quantized checkpoint: the dense tree and the quantizer states
    (``qeft_tpu/checkpoint.py::save_fake``'s keys and manifest)."""
    flat = to_flat(params)
    for (i, name), st in quantizers.items():
        base = f"{_QUANT}{i}{_SEP}{name}{_SEP}"
        flat[base + "scale_group"] = _encode(st.scale_group)[1]
        flat[base + "zero_group"] = _encode(st.zero_group)[1]
        flat[base + "out_ids"] = _encode(st.out_ids)[1]
        flat[base + "flags"] = np.asarray([int(st.sym), st.bits, st.group_size])
        if st.perm_ids is not None:
            flat[base + "perm_ids"] = _encode(st.perm_ids)[1]
    _save(path, flat, {"format": "fake", "family": family, "config": cfg_to_dict(cfg)})


def load_fake(path: str, device=None):
    """-> (dense tree with member names, {(block, name): QuantizerState},
    config, family), on ``device`` (default: the GPU, which must exist)."""
    from qeft_tpu_torch.pipeline import QuantizerState

    device = resolve_device(device)
    manifest = _manifest(path, "fake")
    with np.load(_paths(path)[0]) as z:
        flat = {k: z[k] for k in z.files}
    fields: Dict = {}
    for key in [k for k in flat if k.startswith(_QUANT)]:
        _, i, name, field = key.split(_SEP)
        fields.setdefault((int(i), name), {})[field] = _to_tensor(key, flat.pop(key))[1]
    states = {}
    for key, f in fields.items():
        sym, bits, group_size = f["flags"].tolist()
        perm = f.get("perm_ids")
        states[key] = QuantizerState(
            scale_group=f["scale_group"].to(device), zero_group=f["zero_group"].to(device),
            out_ids=f["out_ids"].to(device), sym=bool(sym), bits=int(bits),
            group_size=int(group_size), perm_ids=None if perm is None else perm.to(device))
    family = manifest.get("family", "llama")
    params = tree_map(lambda t: t.to(device), from_flat(flat))
    return params, states, cfg_from_dict(manifest["config"], family), family


def checkpoint_bytes(path: str) -> int:
    """Bytes of the arrays a `load_model` of ``path`` reads (the ``.npz``;
    a WCT checkpoint's base)."""
    if _manifest(path)["format"] == "wct":
        path = _manifest(path)["base_path"]
    return os.path.getsize(_paths(path)[0])


def load_model(path: str, device=None):
    """Dispatch on the manifest's format: ``packed``, ``wct`` or ``fake``.
    -> (params, config, family), as ``qeft_tpu.checkpoint.load_model``;
    pass a packed tree through ``fuse_packed_stages``, a fake one (member
    names) through ``fuse_dense_stages``."""
    fmt = _manifest(path)["format"]
    if fmt == "packed":
        return load_packed(path, device)
    if fmt == "wct":
        return load_wct(path, device)
    if fmt == "fake":
        params, _, cfg, family = load_fake(path, device)
        return params, cfg, family
    raise ValueError(f"unknown checkpoint format {fmt}")
