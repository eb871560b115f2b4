"""Causal window attention for prefill and full-sequence forwards (K3).

`flash_window_attention` replaces ``qeft_tpu/ops/pallas_flash.py::
flash_window_attention`` with ``csrc/flash.cu``: query ``i`` sits at absolute
position ``pos + i`` and attends keys ``<= pos + i`` of a head-major K/V
slab, GQA included.  The kernel runs on the tensor cores (``mma.sync``,
bf16 operands, f32 accumulators) over fixed chunks of `CHUNK` keys from key
0, with the probabilities rounded to bf16 for the P.V product; a row's
output does not depend on the window width or on the other rows.  Its plain
version, `flash_window_attention_plain`, is the masked softmax of
``qeft_tpu/models/llama.py::_attention``.  `flash_window_attention_any`
takes f32 activations too, through bf16 operands on the GPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from qeft_tpu_torch.ops import cuda_lib

# keys a chunk of the kernel's online softmax, from key 0 (csrc kF_KEYS)
CHUNK = 64


def masked_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, S, H, D]; k/v [B, Hkv, Sk, D]; mask broadcastable to
    [B, H, S, Sk]: a boolean one (True = attend) or an additive f32 bias
    (the families' causal bias, with Bloom's ALiBi).  Scores in q's dtype,
    then f32 for the scale, the mask and the softmax; returns [B, S, H*D]."""
    b, s, h, d = q.shape
    n_rep = h // k_all.shape[1]
    dtype = q.dtype
    k_rep = k_all.repeat_interleave(n_rep, dim=1) if n_rep > 1 else k_all
    v_rep = v_all.repeat_interleave(n_rep, dim=1) if n_rep > 1 else v_all
    scores = torch.matmul(q.transpose(1, 2), k_rep.to(dtype).transpose(2, 3)).to(torch.float32)
    scores = scores * (d ** -0.5)
    if mask is not None:
        scores = (scores.masked_fill(~mask, float("-inf")) if mask.dtype == torch.bool
                  else scores + mask)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.matmul(probs, v_rep.to(dtype))  # [B, H, S, D]
    return ctx.transpose(1, 2).reshape(b, s, h * d)


def _positions(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1).to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def flash_window_attention_plain(q, k_all, v_all, pos) -> torch.Tensor:
    b, s = q.shape[:2]
    qpos = _positions(pos, b, q.device)[:, None] + torch.arange(s, device=q.device)
    kpos = torch.arange(k_all.shape[2], device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B, S, Sk]
    return masked_attention(q, k_all, v_all, mask[:, None])


def flash_window_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                           pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """q [B, S, H, D] (RoPE applied); k/v [B, Hkv, Sk, D]; ``pos`` an int or
    a [B] tensor of per-sequence offsets.  Returns ctx [B, S, H*D]."""
    if not q.is_cuda:
        return flash_window_attention_plain(q, k_all, v_all, pos)
    b, s, h, d = q.shape
    _, hkv, s_k, _ = k_all.shape
    if h % hkv or d not in (64, 128, 256):
        raise ValueError(f"unsupported heads {h}/{hkv} or head_dim {d}")
    for name, t in (("q", q), ("k", k_all), ("v", v_all)):
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError(f"{name} must be a bfloat16 CUDA tensor")
    if tuple(v_all.shape) != tuple(k_all.shape) or k_all.shape[0] != b:
        raise ValueError("k/v shapes disagree with q")
    pos_arr = None
    pos0 = 0
    if isinstance(pos, torch.Tensor):  # read by the kernel as int64, as the engine keeps it
        pos_arr = pos.reshape(-1).to(device=q.device, dtype=torch.int64).expand(b).contiguous()
    else:
        pos0 = int(pos)
    qc, kc, vc = (cuda_lib.aligned(t) for t in (q, k_all, v_all))
    out = torch.empty(b, s, h * d, dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch(
        "flash_window_attention",
        cuda_lib.ptr(qc), cuda_lib.ptr(kc), cuda_lib.ptr(vc), cuda_lib.ptr(pos_arr),
        cuda_lib.ptr(out), b, s, h, hkv, s_k, d, pos0,
    )
    return out


def flash_window_attention_any(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                               pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """`flash_window_attention` for activations of any float dtype: on the
    GPU K3 takes q/k/v rounded to bf16 (the kernel reads bf16 only) and its
    output is cast back to q's dtype; on the CPU the plain version runs in
    q's dtype.  The attention of the quantization pipeline's calibration
    forwards and of a fake-quantized model's eval, as the JAX package runs
    its flash kernel there on the TPU.  Under ``QEFT_FLASH_ATTN=0`` the
    plain version, in q's dtype."""
    from qeft_tpu_torch import env

    if not env.FLASH_ATTN:
        env.announce("QEFT_FLASH_ATTN")
        return flash_window_attention_plain(q, k_all, v_all, pos)
    if not q.is_cuda or q.dtype == torch.bfloat16:
        return flash_window_attention(q, k_all, v_all, pos)
    bf = torch.bfloat16
    return flash_window_attention(q.to(bf), k_all.to(bf), v_all.to(bf), pos).to(q.dtype)
