"""Single-query decode attention over the static KV cache: bf16 (K4), int8
codes with per-vector f32 scales (K4q), and the stacked-cache variant with
the current token as an extra term (K8).

Kernels (``csrc/decode_attention.cu``), each beside its plain PyTorch
version:

- `decode_attention` without scales replaces the bf16 branch of
  ``qeft_tpu/ops/pallas_attention.py::decode_attention``: one query per
  (batch, head) attends cache slots ``<= pos`` (the current token's K/V are
  already written), GQA included, at every cache length.
- `decode_attention` with ``k_scale``/``v_scale`` replaces its int8 branch:
  the caches hold int8 codes; the K scale multiplies each score after the
  ``D**-0.5`` scale, the running sum takes the unscaled probabilities, and
  the V scale multiplies them only for the P.V product.
- `decode_attention_stacked` replaces ``pallas_attention.py::
  decode_attention_stacked``: layer ``layer`` of the whole stacked cache
  ``[L, B, Hkv, S, D]`` (bf16, or int8 plus ``[L, B, Hkv, S]`` scales),
  slots ``< pos`` only -- slot ``pos`` is stale -- plus the current token's
  unquantized ``k_new``/``v_new`` as one extra softmax term.

The plain versions are the masked f32 softmax of ``qeft_tpu/models/
llama.py::_attention`` over the same slots, with the scales applied as the
kernels apply them.

``pos`` is a Python int or an int64 scalar tensor (the position of a decode
step captured once as a CUDA graph and replayed at every position).  The
kernels read a CUDA position on the device, launched over the split count
of the whole cache, and give the bit-identical output of the host-int
launch at that position; its range is the caller's to check, once per
loop.  The plain versions take a CPU position as the int it holds, and
`decode_attention_plain` masks the whole cache by a CUDA one (the dense
reference model's decode step on the card), which reads no host value.
"""

from __future__ import annotations

from typing import Optional

import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.ops.flash import masked_attention

# keys per block of the split pass; equals the block size in csrc
KV_CHUNK = 256


def _scores(q, k, d):
    """f32 q.k^T * D**-0.5 per kv-head group: q [B, Hkv, rep, D], k [B, Hkv,
    S, D] -> [B, Hkv, rep, S]."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)


def _int8_attention(q, k_codes, v_codes, k_scale, v_scale, k_new=None, v_new=None, valid=None):
    """f32 softmax of q over int8 slots (and an optional unquantized extra
    key/value); q [B, H, D], codes [B, Hkv, S, D], scales [B, Hkv, S];
    ``valid`` [S]: the slots attended (default all)."""
    b, h, d = q.shape
    hkv = k_codes.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d)
    s = _scores(qg, k_codes, d) * k_scale.float()[:, :, None, :]
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    if k_new is not None:
        s = torch.cat([s, _scores(qg, k_new[:, :, None], d)], dim=-1)
    p = torch.softmax(s, dim=-1)
    n = k_codes.shape[2]
    ctx = torch.matmul(p[..., :n] * v_scale.float()[:, :, None, :], v_codes.float())
    if v_new is not None:
        ctx = ctx + p[..., n:] * v_new.float()[:, :, None]
    return ctx.reshape(b, h, d).to(q.dtype)


def _host_pos(pos) -> int:
    """A position as the int it holds; a CUDA tensor is refused (reading it
    would wait for the device, and fail inside a graph capture)."""
    if isinstance(pos, torch.Tensor) and pos.is_cuda:
        raise ValueError("this path takes the position as a host int or a CPU tensor")
    return int(pos)


def decode_attention_plain(q, k_cache, v_cache, pos, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    b, h, d = q.shape
    if isinstance(pos, torch.Tensor) and pos.is_cuda:
        valid = torch.arange(k_cache.shape[2], device=q.device) <= pos  # [S]
        if k_scale is not None:
            return _int8_attention(q, k_cache, v_cache, k_scale, v_scale, valid=valid)
        return masked_attention(q[:, None], k_cache, v_cache, valid).reshape(b, h, d)
    pos = _host_pos(pos)
    if k_scale is not None:
        return _int8_attention(q, k_cache[:, :, : pos + 1], v_cache[:, :, : pos + 1],
                               k_scale[:, :, : pos + 1], v_scale[:, :, : pos + 1])
    ctx = masked_attention(q[:, None], k_cache[:, :, : pos + 1],
                           v_cache[:, :, : pos + 1], None)
    return ctx.reshape(b, h, d)


def decode_attention_stacked_plain(q, k_cache, v_cache, layer: int, pos, k_new, v_new,
                                   k_scale=None, v_scale=None) -> torch.Tensor:
    pos = _host_pos(pos)
    kc, vc = k_cache[layer, :, :, :pos], v_cache[layer, :, :, :pos]
    if k_scale is not None:
        return _int8_attention(q, kc, vc, k_scale[layer, :, :, :pos],
                               v_scale[layer, :, :, :pos], k_new, v_new)
    b, h, d = q.shape
    dtype = q.dtype
    k_all = torch.cat([kc.to(dtype), k_new[:, :, None].to(dtype)], dim=2)
    v_all = torch.cat([vc.to(dtype), v_new[:, :, None].to(dtype)], dim=2)
    return masked_attention(q[:, None], k_all, v_all, None).reshape(b, h, d)


def _check(name: str, t: torch.Tensor, dtype) -> None:
    if t.dtype != dtype or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_caches(q, k_cache, v_cache, k_scale, v_scale):
    """The checks both wrappers share: heads, head_dim, dtypes (bf16, or
    int8 codes with f32 scales), contiguity, alignment and shapes."""
    _, h, d = q.shape
    hkv = k_cache.shape[-3]
    if h % hkv or d not in (64, 128, 256):
        raise ValueError(f"unsupported heads {h}/{hkv} or head_dim {d}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    kv_dtype = torch.int8 if k_scale is not None else torch.bfloat16
    _check("q", q, torch.bfloat16)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, t, kv_dtype)
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("k and v caches disagree")
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(name, t, torch.float32)
            if tuple(t.shape) != tuple(k_cache.shape[:-1]):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                                 f"{tuple(k_cache.shape[:-1])}")


def _launch_pos(pos, s_max: int, span: int):
    """(pos_dev tensor or None, host pos, n_split) of a launch over ``span``
    valid slots: ``pos + 1`` (K4) or ``pos`` (K8).  A tensor position is read
    on the device, over the split count of the whole cache; a host int is
    range-checked here."""
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or not pos.is_cuda:
            raise ValueError("a tensor position must be one int64 on the card")
        return pos, 0, -(-s_max // KV_CHUNK)
    pos = int(pos)
    if not 0 <= pos < s_max:
        raise IndexError(f"pos {pos} outside a {s_max}-slot cache")
    return None, pos, max(1, -(-span(pos) // KV_CHUNK))


def _scratch(n_split: int, bh: int, d: int, device):
    """Per-split partial results, combined by the kernel's second pass."""
    part_acc = torch.empty(n_split, bh, d, dtype=torch.float32, device=device)
    part_ml = torch.empty(2, n_split, bh, dtype=torch.float32, device=device)
    return part_acc, part_ml


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, D] (RoPE applied); caches [B, Hkv, S, D] bf16, or int8 codes
    with f32 ``k_scale``/``v_scale`` [B, Hkv, S]; ``pos`` the index of the
    current token, an int or an int64 scalar on the card.  Returns [B, H, D]."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, pos, k_scale, v_scale)
    b, h, d = q.shape
    _, hkv, s_max, _ = k_cache.shape
    _check_caches(q, k_cache, v_cache, k_scale, v_scale)
    if k_cache.shape[0] != b:
        raise ValueError("cache shapes disagree with q")
    pos_dev, pos, n_split = _launch_pos(pos, s_max, lambda p: p + 1)
    part_acc, part_ml = _scratch(n_split, b * h, d, q.device)
    out = torch.empty(b, h, d, dtype=torch.bfloat16, device=q.device)
    tail = (cuda_lib.ptr(pos_dev), cuda_lib.ptr(out), cuda_lib.ptr(part_acc),
            cuda_lib.ptr(part_ml[0]), cuda_lib.ptr(part_ml[1]), b, h, hkv, s_max, d, pos, n_split)
    if k_scale is None:
        cuda_lib.launch("decode_attention", cuda_lib.ptr(q), cuda_lib.ptr(k_cache),
                        cuda_lib.ptr(v_cache), *tail)
    else:
        cuda_lib.launch("decode_attention_int8", cuda_lib.ptr(q), cuda_lib.ptr(k_cache),
                        cuda_lib.ptr(v_cache), cuda_lib.ptr(k_scale), cuda_lib.ptr(v_scale),
                        *tail)
    return out


def decode_attention_stacked(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             layer: int, pos, k_new: torch.Tensor, v_new: torch.Tensor,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, D] (RoPE applied); the stacked caches [L, B, Hkv, S, D] (bf16,
    or int8 with f32 scales [L, B, Hkv, S]) whose slot ``pos`` is stale;
    k_new/v_new [B, Hkv, D] the current token's K/V.  Attends slots ``<
    pos`` of layer ``layer`` plus the new token.  Returns [B, H, D]."""
    if not q.is_cuda:
        return decode_attention_stacked_plain(q, k_cache, v_cache, layer, pos, k_new, v_new,
                                              k_scale, v_scale)
    b, h, d = q.shape
    n_layers, b_c, hkv, s_max, _ = k_cache.shape
    layer = int(layer)
    _check_caches(q, k_cache, v_cache, k_scale, v_scale)
    if b_c != b:
        raise ValueError("cache shapes disagree with q")
    pos_dev, pos, n_split = _launch_pos(pos, s_max, lambda p: p)
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range for {n_layers} layers")
    kn, vn = cuda_lib.aligned(k_new), cuda_lib.aligned(v_new)
    for name, t in (("k_new", kn), ("v_new", vn)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (b, hkv, d):
            raise ValueError(f"{name} must be bfloat16 of shape {(b, hkv, d)}")
    part_acc, part_ml = _scratch(n_split, b * h, d, q.device)
    out = torch.empty(b, h, d, dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch(
        "decode_attention_stacked",
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache), cuda_lib.ptr(k_scale),
        cuda_lib.ptr(v_scale), cuda_lib.ptr(kn), cuda_lib.ptr(vn), cuda_lib.ptr(pos_dev),
        cuda_lib.ptr(out),
        cuda_lib.ptr(part_acc), cuda_lib.ptr(part_ml[0]), cuda_lib.ptr(part_ml[1]),
        n_layers, b, h, hkv, s_max, d, layer, pos, n_split,
    )
    return out
