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

- `decode_latent_attention` has no counterpart in ``qeft_tpu``: DeepSeek-V2's
  multi-head latent attention at decode, 16 query heads over one cached
  576-wide row a token (the normalised latent and the roped key), the
  values the same rows' first 512 dims.  All heads of a sequence read each
  row once (the heads are the M rows of the tensor cores' tiles), split-K
  over the valid slots in one cluster launch, as K4's grouped-head path.

The plain versions are the masked f32 softmax of ``qeft_tpu/models/
llama.py::_attention`` over the same slots, with the scales applied as the
kernels apply them.

The three are one kernel template: one launch of a thread block cluster
of `SPLITS` blocks per (sequence, kv head), each over a chunk of
`split_chunk` keys from key 0, combined in rank order through the
cluster's shared memory -- no scratch and no second pass.  `decode_attention`
on a bf16 cache whose kv head serves `GROUP_MIN` or more query heads
(Falcon's 71 over 1) takes the kernel's grouped-head path instead: the
group's query rows on the tensor cores, K and V streamed once, and the
splits that `group_grid` gives, combined the same way.

``pos`` is a Python int or an int64 scalar tensor (the position of a decode
step captured once as a CUDA graph and replayed at every position).  The
kernels read a CUDA position on the device over the same grid as a host
int, cut the same chunks and give the bit-identical output of the host-int
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

# blocks of a cluster: the splits of one (sequence, kv head)'s keys (csrc kC)
SPLITS = 8
# the grouped-head path: from this many query heads a kv head (csrc
# kGroupMin), with at most this many splits a cluster (kGroupSplits)
GROUP_MIN = 16
GROUP_SPLITS = 16


def split_chunk(length: int, splits: int = SPLITS) -> int:
    """Keys a split takes of ``length`` valid keys: ceil(length / splits)
    rounded up to a multiple of 16, from key 0 (the twin of csrc's
    ``split_chunk``); split r takes keys [r * chunk, (r + 1) * chunk)."""
    per = -(-length // splits)
    return -(-per // 16) * 16


def group_grid(b: int, h: int, hkv: int, d: int, sms: int) -> tuple:
    """(splits, warps, row blocks) of the grouped-head path (the twin of
    csrc's ``launch_group`` on a card that schedules clusters of
    `GROUP_SPLITS`): a warp a 16-row tile of the group's ``h // hkv`` query
    heads, at most 8 a block (4 at ``d`` = 256), blocks along z for more;
    splits enough that the grid covers ``sms`` SMs once."""
    rep = h // hkv
    warps = min(-(-rep // 16), 4 if d == 256 else 8)
    blocks = -(-rep // (16 * warps))
    return max(1, min(GROUP_SPLITS, sms // (b * hkv * blocks))), warps, blocks


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


def _launch_pos(pos, s_max: int):
    """(pos_dev tensor or None, host pos) of a launch: a tensor position is
    read on the device; a host int is range-checked here."""
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or not pos.is_cuda:
            raise ValueError("a tensor position must be one int64 on the card")
        return pos, 0
    pos = int(pos)
    if not 0 <= pos < s_max:
        raise IndexError(f"pos {pos} outside a {s_max}-slot cache")
    return None, pos


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
    pos_dev, pos = _launch_pos(pos, s_max)
    out = torch.empty(b, h, d, dtype=torch.bfloat16, device=q.device)
    tail = (cuda_lib.ptr(pos_dev), cuda_lib.ptr(out), b, h, hkv, s_max, d, pos)
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
    pos_dev, pos = _launch_pos(pos, s_max)
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range for {n_layers} layers")
    kn, vn = cuda_lib.aligned(k_new), cuda_lib.aligned(v_new)
    for name, t in (("k_new", kn), ("v_new", vn)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (b, hkv, d):
            raise ValueError(f"{name} must be bfloat16 of shape {(b, hkv, d)}")
    out = torch.empty(b, h, d, dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch(
        "decode_attention_stacked",
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache), cuda_lib.ptr(k_scale),
        cuda_lib.ptr(v_scale), cuda_lib.ptr(kn), cuda_lib.ptr(vn), cuda_lib.ptr(pos_dev),
        cuda_lib.ptr(out), n_layers, b, h, hkv, s_max, d, layer, pos,
    )
    return out


# the latent path (csrc kLatHeads, kLatK, kLatV)
LATENT_HEADS, LATENT_DIM, LATENT_VALUE = 16, 576, 512


def decode_latent_attention_plain(q, cache, pos, scale: float,
                                  value_dim: int = LATENT_VALUE) -> torch.Tensor:
    """q [B, H, D] against the rows of ``cache`` [B, S, D] at slots <= pos
    (an int, or an int64 scalar tensor: the whole cache masked, no host
    read), in f32; the values are each row's first ``value_dim`` dims.
    Returns [B, H, value_dim] in q's dtype."""
    c = cache.to(torch.float32)
    s = torch.matmul(q.to(torch.float32), c.transpose(1, 2)) * scale  # [B, H, S]
    valid = torch.arange(cache.shape[1], device=q.device) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    out = torch.matmul(torch.softmax(s, dim=-1), c[..., :value_dim])
    return out.to(q.dtype)


def decode_latent_attention(q: torch.Tensor, cache: torch.Tensor, pos,
                            scale: float) -> torch.Tensor:
    """q [B, 16, 576] (the absorbed query and the roped q_pe); ``cache`` [B,
    S, 576] one layer's latent rows, the current token's written; ``pos``
    its index, an int or an int64 scalar on the card; ``scale`` the softmax
    scale.  Returns [B, 16, 512]."""
    if not q.is_cuda:
        return decode_latent_attention_plain(q, cache, pos, scale)
    b, h, d = q.shape
    if (h, d) != (LATENT_HEADS, LATENT_DIM) or cache.dim() != 3 or cache.shape[0] != b \
            or cache.shape[2] != d:
        raise ValueError(f"latent attention takes q [B, {LATENT_HEADS}, {LATENT_DIM}] and a "
                         f"cache [B, S, {LATENT_DIM}], got {tuple(q.shape)}, "
                         f"{tuple(cache.shape)}")
    _check("q", q, torch.bfloat16)
    _check("cache", cache, torch.bfloat16)
    s_max = cache.shape[1]
    pos_dev, pos = _launch_pos(pos, s_max)
    out = torch.empty(b, h, LATENT_VALUE, dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch("decode_latent_attention", cuda_lib.ptr(q), cuda_lib.ptr(cache),
                    cuda_lib.ptr(pos_dev), cuda_lib.ptr(out), b, h, s_max, d, LATENT_VALUE, pos,
                    float(scale))
    return out
