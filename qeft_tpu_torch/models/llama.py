"""Llama-family decoder in PyTorch (Llama, Llama-2, GQA, and gemma through
the config switches).

Counterpart of ``qeft_tpu/models/llama.py``, with its layout conventions:
dense weights are ``[K, N]`` (``y = x @ w``); per-layer parameters are
stacked on a leading layer axis; the KV cache is static and head-major,
``[L, B, H_kv, S_max, Dh]``.  The layer loop is a Python loop, and every
packed linear is addressed as (stacked linear, layer index).

Two kinds of parameter tree run through the same functions:

- packed trees (``QLinearParams`` stages ``qkv``/``o``/``upgate``/``down``,
  see ``pipeline.fuse_packed_stages``) run the kernel wrappers, which launch
  the CUDA kernels on the GPU and their plain versions on the CPU;
- dense trees (stacked ``[L, K, N]`` tensors, ``testing.dense_model``) are
  the reference model of the oracle and run plain PyTorch throughout,
  attention included, on any device.

Serving runs `llama_block`; training runs `llama_block_train`, a separate
differentiable block (norms and residuals outside the linears, plain
attention) so that the serving path and its kernel launches stay as they
are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from qeft_tpu_torch.ops.attention import decode_attention, decode_attention_plain
from qeft_tpu_torch.ops.flash import (
    flash_window_attention,
    flash_window_attention_plain,
    masked_attention,
)
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.ops.qlinear import qlinear_apply, qlinear_fused_stage
from qeft_tpu_torch.ops.qmm import rms_norm

__all__ = [
    "LlamaConfig", "LLAMA_PRESETS", "rms_norm", "rope_tables", "apply_rope",
    "init_kv_cache", "llama_forward", "llama_prefill", "llama_decode_step",
    "causal_mask", "llama_block_train",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    act: str = "silu"  # "silu" | "gelu_tanh"
    rms_one_offset: bool = False  # gemma: norm scale is (1 + w)
    embed_scale: bool = False  # gemma: embeddings scaled by sqrt(hidden)


LLAMA_PRESETS: Dict[str, LlamaConfig] = {
    "llama2-7b": LlamaConfig(),
    "llama2-13b": LlamaConfig(
        hidden_size=5120, intermediate_size=13824, num_layers=40, num_heads=40,
        num_kv_heads=40,
    ),
    "llama2-70b": LlamaConfig(
        hidden_size=8192, intermediate_size=28672, num_layers=80, num_heads=64,
        num_kv_heads=8,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
    ),
    "llama3-70b": LlamaConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
    ),
    "tiny": LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, max_position_embeddings=256,
    ),
    "tiny-v2": LlamaConfig(
        vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=4,
        num_heads=4, num_kv_heads=4, head_dim=128, max_position_embeddings=512,
    ),
    "gemma-2b": LlamaConfig(
        vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6,
        act="gelu_tanh", rms_one_offset=True, embed_scale=True,
    ),
    "gemma-7b": LlamaConfig(
        vocab_size=256000, hidden_size=3072, intermediate_size=24576,
        num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6,
        act="gelu_tanh", rms_one_offset=True, embed_scale=True,
    ),
    "tiny-gemma": LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, max_position_embeddings=256,
        act="gelu_tanh", rms_one_offset=True, embed_scale=True,
    ),
}


# ---------------------------------------------------------------------------
# primitives


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables [..., Dh] for integer ``positions``."""
    dh = cfg.head_dim
    exponent = torch.arange(0, dh, 2, dtype=torch.float32, device=positions.device) / dh
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE.  x [B, S, H, Dh]; cos/sin [B?, S, Dh] cast to x's dtype."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return x * c + rotated * s


def _act(gate: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu_tanh":
        return F.gelu(gate, approximate="tanh")
    return F.silu(gate)


def _split_upgate(ug: torch.Tensor, cfg: LlamaConfig):
    """(up, gate) from a fused [up | gate] output; also accepts the
    [up | 0pad | gate | 0pad] layout the JAX loader pads to."""
    f_pad = ug.shape[-1] // 2
    f = min(cfg.intermediate_size, f_pad)
    return ug[..., :f], ug[..., f_pad: f_pad + f]


def _embed(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _lm_head(params: Dict, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps, cfg.rms_one_offset)
    return torch.matmul(x, params["lm_head"].to(x.dtype))


def is_packed(params: Dict) -> bool:
    return isinstance(params["layers"]["qkv"], QLinearParams)


# ---------------------------------------------------------------------------
# decoder block


def _stage(layers: Dict, name: str, l: int, x: torch.Tensor, cfg: LlamaConfig,
           lnw: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[residual +] (rms_norm(x) if lnw else x) @ W`` of one stage."""
    lin = layers[name]
    if isinstance(lin, QLinearParams):
        return qlinear_fused_stage(x, lin, l, lnw=lnw, residual=residual,
                                   eps=cfg.rms_norm_eps, one_offset=cfg.rms_one_offset)
    if lnw is not None:
        x = rms_norm(x, lnw, cfg.rms_norm_eps, cfg.rms_one_offset)
    y = torch.matmul(x, lin[l].to(x.dtype))
    return y if residual is None else residual + y


def llama_block(layers: Dict, l: int, x: torch.Tensor, cfg: LlamaConfig,
                cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[Dict] = None, pos: int = 0) -> torch.Tensor:
    """Decoder block ``l`` of the stacked ``layers``; x [B, S, D].

    With ``cache`` this block's K/V are written at ``pos`` -- in place, which
    saves the copy of the whole slab a functional update would make -- before
    attention reads slots ``<= pos + i``.  Without it attention runs causally
    over the window itself."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    packed = isinstance(layers["qkv"], QLinearParams)

    qkv = _stage(layers, "qkv", l, x, cfg, lnw=layers["input_ln"][l])
    q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
    k = qkv[..., hq * dh: (hq + hkv) * dh].reshape(b, s, hkv, dh)
    v = qkv[..., (hq + hkv) * dh:].reshape(b, s, hkv, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kh = k.transpose(1, 2)  # [B, Hkv, S, Dh] head-major
    vh = v.transpose(1, 2)

    if cache is not None:
        k_all, v_all = cache["k"][l], cache["v"][l]
        k_all[:, :, pos: pos + s] = kh
        v_all[:, :, pos: pos + s] = vh
    else:
        k_all, v_all = kh.contiguous(), vh.contiguous()

    if s == 1 and cache is not None:
        attend = decode_attention if packed else decode_attention_plain
        ctx = attend(q[:, 0], k_all, v_all, pos).reshape(b, 1, hq * dh)
    else:
        attend = flash_window_attention if packed else flash_window_attention_plain
        ctx = attend(q.contiguous(), k_all, v_all, pos)

    o_reorder = layers.get("o_reorder")
    o_in = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
    x = _stage(layers, "o", l, o_in, cfg, residual=x)
    ug = _stage(layers, "upgate", l, x, cfg, lnw=layers["post_ln"][l])
    up, gate = _split_upgate(ug, cfg)
    return _stage(layers, "down", l, _act(gate, cfg.act) * up, cfg, residual=x)


def causal_mask(s: int, device=None) -> torch.Tensor:
    """[1, 1, S, S] bool, True where query i may attend key j (j <= i)."""
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()[None, None]


def _train_linear(layers: Dict, name: str, l: int, x: torch.Tensor) -> torch.Tensor:
    lin = layers[name]
    if isinstance(lin, QLinearParams):
        return qlinear_apply(x, lin.layer(l))
    return torch.matmul(x, lin[l].to(x.dtype))


def llama_block_train(layers: Dict, l: int, x: torch.Tensor, cfg: LlamaConfig,
                      cos: torch.Tensor, sin: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Differentiable decoder block ``l`` over a whole window (no cache):
    the unfused branch of ``qeft_tpu/models/llama.py::llama_block``.

    The norms and residual adds run outside the linears, every packed stage
    goes through the autograd linear (`ops.qlinear.qlinear_apply`, K2 forward
    and K7 backward on the GPU), and attention is the plain masked softmax
    with f32 scores (`masked_attention`): the training forward takes no
    attention kernel, as in the JAX package.  A packed stage's ``oweight``
    may be a list of per-layer trainable leaves (``finetune.merge_wct``);
    dense stages (``[L, K, N]`` tensors or lists of ``[K, N]``) run
    ``torch.matmul``."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps, one = cfg.rms_norm_eps, cfg.rms_one_offset

    h = rms_norm(x, layers["input_ln"][l], eps, one)
    qkv = _train_linear(layers, "qkv", l, h)
    q = apply_rope(qkv[..., : hq * dh].reshape(b, s, hq, dh), cos, sin)
    k = apply_rope(qkv[..., hq * dh: (hq + hkv) * dh].reshape(b, s, hkv, dh), cos, sin)
    v = qkv[..., (hq + hkv) * dh:].reshape(b, s, hkv, dh)
    ctx = masked_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask)

    o_reorder = layers.get("o_reorder")
    o_in = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
    x = x + _train_linear(layers, "o", l, o_in)
    h2 = rms_norm(x, layers["post_ln"][l], eps, one)
    up, gate = _split_upgate(_train_linear(layers, "upgate", l, h2), cfg)
    return x + _train_linear(layers, "down", l, _act(gate, cfg.act) * up)


def _num_layers(params: Dict) -> int:
    return params["layers"]["input_ln"].shape[0]


# ---------------------------------------------------------------------------
# full model


def llama_forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Full-sequence causal forward without a cache -> logits [B, S, V]."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, torch.arange(s, device=tokens.device)[None, :])
    for l in range(_num_layers(params)):
        x = llama_block(params["layers"], l, x, cfg, cos, sin)
    return _lm_head(params, x, cfg)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Dict:
    """Zeroed head-major static cache {"k", "v"}: [L, B, H_kv, S_max, Dh]."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def llama_prefill(params: Dict, tokens: torch.Tensor, cache: Dict, cfg: LlamaConfig):
    """Fills cache slots [0, S) in place; returns (logits [B, S, V], cache)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, torch.arange(s, device=tokens.device)[None, :])
    for l in range(_num_layers(params)):
        x = llama_block(params["layers"], l, x, cfg, cos, sin, cache=cache, pos=0)
    return _lm_head(params, x, cfg), cache


def llama_decode_step(params: Dict, token: torch.Tensor, cache: Dict, pos: int,
                      cfg: LlamaConfig):
    """One token [B, 1] at position ``pos`` (a Python int); writes its K/V
    into the cache in place and returns (logits [B, V], cache)."""
    x = _embed(params, token, cfg)
    positions = torch.arange(pos, pos + 1, device=token.device)[None, :]
    cos, sin = rope_tables(cfg, positions)
    for l in range(_num_layers(params)):
        x = llama_block(params["layers"], l, x, cfg, cos, sin, cache=cache, pos=pos)
    return _lm_head(params, x, cfg)[:, 0, :], cache
