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
- dense trees (stacked ``[L, K, N]`` tensors: ``testing.dense_model``, the
  reference model of the serving oracle, and the fake-quantized trees of
  the quantization pipeline) run plain PyTorch, attention included unless
  the caller passes K3 as ``attend`` (the pipeline's calibration forwards
  and the eval of a fake-quantized tree on the GPU do); with ``capture``
  a block hands back the inputs of its four quantization stages.

Serving runs `llama_block` (prefill, windows, single-sequence decode) and
the ragged window forward of continuous batching and speculative decoding;
training runs `llama_block_train`, a separate differentiable block (norms
and residuals outside the linears, plain attention) so that the serving
path and its kernel launches stay as they are.

The KV cache is bf16 (or the activation dtype), or int8 codes with one f32
scale per cached vector (``init_kv_cache(quantized=True)``).  Every cache
write is in place and, like JAX's ``dynamic_update_slice``, clamps its
window into the cache.

The decode step takes its position as a Python int or as an int64 scalar
tensor, with bit-identical logits: a tensor position is read on the device
(RoPE, the clamped cache write by ``index_copy_``, the attention kernels),
so a step captured once as a CUDA graph replays at every position
(`generate.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.models.common import init_generator, write_window
from qeft_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_stacked,
)
from qeft_tpu_torch.ops.flash import (
    flash_window_attention,
    flash_window_attention_plain,
    masked_attention,
)
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.ops.qlinear import qlinear_apply, qlinear_apply_stacked, qlinear_fused_stage
from qeft_tpu_torch.ops.qmm import rms_norm

__all__ = [
    "LlamaConfig", "LLAMA_PRESETS", "rms_norm", "rope_tables", "apply_rope",
    "init_params", "init_kv_cache", "cache_quantized", "llama_forward", "llama_prefill",
    "llama_forward_window", "llama_forward_window_ragged", "llama_decode_step",
    "llama_decode_step_ragged", "causal_mask", "llama_block_train",
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
# params


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=None, device=None) -> Dict:
    """Random dense model (counterpart of ``qeft_tpu/models/llama.py::
    init_params``: weights ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02^2), unit
    norms), built on ``device`` (default: the GPU, which must exist) in the
    port's dense layout: fused ``qkv`` = [q | k | v] and ``upgate`` = [up |
    gate] stages, stacked ``[L, K, N]``.  The values come from a
    ``torch.Generator`` and differ from JAX's."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = init_generator(device, seed)
    d, f, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(kin, kout):
        w = torch.randn((kin, kout), generator=gen, device=device) * kin ** -0.5
        return w.to(dtype)

    def stack(widths, kin):
        return torch.stack([torch.cat([lin(kin, n) for n in widths], dim=1)
                            for _ in range(n_layers)])

    layers = {
        "input_ln": torch.ones(n_layers, d, dtype=dtype, device=device),
        "post_ln": torch.ones(n_layers, d, dtype=dtype, device=device),
        "qkv": stack((hq * dh, hkv * dh, hkv * dh), d),
        "o": stack((d,), hq * dh),
        "upgate": stack((f, f), d),
        "down": stack((d,), f),
    }
    embed = torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02
    return {"embed": embed.to(dtype), "layers": layers,
            "final_ln": torch.ones(d, dtype=dtype, device=device),
            "lm_head": lin(d, cfg.vocab_size)}


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
    """Final norm and the head: a dense ``[D, V]`` tensor, or a packed one
    (``pipeline.rtn_pack_linear``) through `qlinear_apply` -- K5 for a
    decode step, K2 for a window -- as JAX's ``apply_linear`` runs it."""
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps, cfg.rms_one_offset)
    head = params["lm_head"]
    if isinstance(head, QLinearParams):
        return qlinear_apply(x, head)
    return torch.matmul(x, head.to(x.dtype))


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


def _split_qkv(qkv: torch.Tensor, cfg: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor):
    """The qkv stage's output [B, S, (H + 2 Hkv) Dh] -> q [B, S, H, Dh], k and
    v [B, S, Hkv, Dh], RoPE applied to q and k."""
    b, s, _ = qkv.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
    k = qkv[..., hq * dh: (hq + hkv) * dh].reshape(b, s, hkv, dh)
    v = qkv[..., (hq + hkv) * dh:].reshape(b, s, hkv, dh)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _block_out(layers: Dict, l: int, x: torch.Tensor, ctx: torch.Tensor,
               cfg: LlamaConfig, capture: Optional[Dict] = None) -> torch.Tensor:
    """o-projection, residual, MLP stage pair of block ``l`` (fused stages);
    ``capture`` as in `llama_block`."""
    o_reorder = layers.get("o_reorder")
    o_in = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
    x = _stage(layers, "o", l, o_in, cfg, residual=x)
    lnw = layers["post_ln"][l]
    if capture is not None:
        capture["o_in"] = ctx
        h2 = capture["ffn1_in"] = rms_norm(x, lnw, cfg.rms_norm_eps, cfg.rms_one_offset)
        ug = _stage(layers, "upgate", l, h2, cfg)
    else:
        ug = _stage(layers, "upgate", l, x, cfg, lnw=lnw)
    up, gate = _split_upgate(ug, cfg)
    act = _act(gate, cfg.act) * up
    if capture is not None:
        capture["ffn2_in"] = act
    return _stage(layers, "down", l, act, cfg, residual=x)


def _cached_attention(cache: Dict, l: int, q: torch.Tensor, kh: torch.Tensor,
                      vh: torch.Tensor, pos, packed: bool) -> torch.Tensor:
    """Writes this window's K/V (head-major [B, Hkv, S, Dh]) into layer
    ``l`` of the cache at ``pos`` -- in place, which saves the copy of the
    whole slab a functional update would make, and clamped into the cache as
    ``dynamic_update_slice`` clamps -- then attends slots ``<= pos + i``.

    One token runs the decode kernel (K4, or K4q on int8 codes); a window
    runs K3, over the dequantized valid prefix for an int8 cache."""
    b, s = q.shape[:2]
    s_max = cache["k"].shape[3]
    quantized = cache_quantized(cache)
    for name, t in _cache_entries(kh, vh, quantized).items():
        write_window(cache[name][l], t, pos, 2)
    k_all, v_all = cache["k"][l], cache["v"][l]
    if s == 1:
        attend = decode_attention if packed else decode_attention_plain
        scales = ({"k_scale": cache["k_scale"][l], "v_scale": cache["v_scale"][l]}
                  if quantized else {})
        return attend(q[:, 0], k_all, v_all, pos, **scales).reshape(b, 1, -1)
    if quantized:
        n = min(pos + s, s_max)  # keys past the window's last position are never read
        k_all = _kv_dequantize(k_all[:, :, :n], cache["k_scale"][l][:, :, :n], q.dtype)
        v_all = _kv_dequantize(v_all[:, :, :n], cache["v_scale"][l][:, :, :n], q.dtype)
    attend = flash_window_attention if packed else flash_window_attention_plain
    return attend(q.contiguous(), k_all, v_all, pos)


def llama_block(layers: Dict, l: int, x: torch.Tensor, cfg: LlamaConfig,
                cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[Dict] = None, pos: int = 0,
                capture: Optional[Dict] = None, attend=None) -> torch.Tensor:
    """Decoder block ``l`` of the stacked ``layers``; x [B, S, D].

    With ``cache`` this block's K/V are written at ``pos`` before attention
    reads slots ``<= pos + i`` (see `_cached_attention`).  Without it
    attention runs causally over the window itself, through ``attend``
    (default: K3 for a packed tree, the plain version for a dense one).

    ``capture`` (dense trees, no cache) receives the inputs of the four
    quantization stages, as JAX's ``llama_block(capture=True)`` returns
    them: ``qkv_in`` (the normed residual), ``o_in`` (the attention context
    before the o-gather), ``ffn1_in`` and ``ffn2_in``."""
    packed = isinstance(layers["qkv"], QLinearParams)
    lnw = layers["input_ln"][l]
    if capture is not None:
        if packed or cache is not None:
            raise ValueError("capture runs on a dense tree without a cache")
        x_in = capture["qkv_in"] = rms_norm(x, lnw, cfg.rms_norm_eps, cfg.rms_one_offset)
        qkv = _stage(layers, "qkv", l, x_in, cfg)
    else:
        qkv = _stage(layers, "qkv", l, x, cfg, lnw=lnw)
    q, k, v = _split_qkv(qkv, cfg, cos, sin)
    kh = k.transpose(1, 2)  # [B, Hkv, S, Dh] head-major
    vh = v.transpose(1, 2)
    if cache is not None:
        ctx = _cached_attention(cache, l, q, kh, vh, pos, packed)
    else:
        if attend is None:
            attend = flash_window_attention if packed else flash_window_attention_plain
        ctx = attend(q.contiguous(), kh.contiguous(), vh.contiguous(), 0)
    return _block_out(layers, l, x, ctx, cfg, capture)


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
    eps, one = cfg.rms_norm_eps, cfg.rms_one_offset

    h = rms_norm(x, layers["input_ln"][l], eps, one)
    q, k, v = _split_qkv(_train_linear(layers, "qkv", l, h), cfg, cos, sin)
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


def llama_forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                  attend=None) -> torch.Tensor:
    """Full-sequence causal forward without a cache -> logits [B, S, V];
    ``attend`` as in `llama_block`."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, torch.arange(s, device=tokens.device)[None, :])
    for l in range(_num_layers(params)):
        x = llama_block(params["layers"], l, x, cfg, cos, sin, attend=attend)
    return _lm_head(params, x, cfg)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None, quantized: bool = False) -> Dict:
    """Zeroed head-major static cache {"k", "v"}: [L, B, H_kv, S_max, Dh].

    ``quantized=True`` (or ``QEFT_KV_DTYPE=int8`` in the environment) stores
    int8 codes plus f32 per-vector scales {"k_scale", "v_scale"} [L, B, H_kv,
    S_max]: half the bytes a decode step streams.  The slot count is kept as
    given (the JAX package rounds it to 128 for its TPU kernel)."""
    if os.environ.get("QEFT_KV_DTYPE", "").lower() == "int8":
        quantized = True
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_quantized(cache: Dict) -> bool:
    return "k_scale" in cache


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., S, Dh] -> (int8 codes, f32 per-vector scales [..., S]): symmetric,
    scale = max|x| / 127, codes rounded half to even (``jnp.round``)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _cache_entries(k: torch.Tensor, v: torch.Tensor, quantized: bool) -> Dict:
    """New K/V vectors as the cache stores them, by cache entry name."""
    if not quantized:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def llama_forward_window(params: Dict, tokens: torch.Tensor, cache: Dict, pos,
                         cfg: LlamaConfig):
    """A window of tokens [B, W] at offset ``pos`` (a Python int; for a
    decode step also an int64 scalar tensor on the device) through the
    cache: query i sits at position pos + i and attends slots <= pos + i.
    Prefill is pos = 0, a decode step W = 1, the speculative verify window
    W = gamma + 1.  Writes the window's K/V in place; returns (logits [B, W,
    V], cache)."""
    b, w = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, (pos + torch.arange(w, device=tokens.device))[None, :])
    for l in range(_num_layers(params)):
        x = llama_block(params["layers"], l, x, cfg, cos, sin, cache=cache, pos=pos)
    return _lm_head(params, x, cfg), cache


def llama_prefill(params: Dict, tokens: torch.Tensor, cache: Dict, cfg: LlamaConfig):
    """Fills cache slots [0, S) in place; returns (logits [B, S, V], cache)."""
    return llama_forward_window(params, tokens, cache, 0, cfg)


def _stacked_attn_enabled() -> bool:
    """The stacked-cache decode step (`_decode_step_stacked_attn`, K8):
    ``QEFT_ATTN_STACKED=1`` turns it on, and it is off by default, as in the
    JAX package."""
    v = os.environ.get("QEFT_ATTN_STACKED")
    return v is not None and v not in ("0", "false", "off")


def _decode_step_stacked_attn(params: Dict, token: torch.Tensor, cache: Dict, pos,
                              cfg: LlamaConfig):
    """Decode step whose attention reads the whole stacked cache at each
    layer (K8): slots < pos plus this layer's new K/V, unquantized, as an
    extra term.  Nothing is written during the layer loop; the token's K/V
    of every layer are written once after it."""
    layers = params["layers"]
    x = _embed(params, token, cfg)
    cos, sin = rope_tables(cfg, (pos + torch.arange(1, device=token.device))[None, :])
    quantized = cache_quantized(cache)
    scales = ({"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
              if quantized else {})
    new_k, new_v = [], []
    for l in range(_num_layers(params)):
        qkv = _stage(layers, "qkv", l, x, cfg, lnw=layers["input_ln"][l])
        q, k, v = _split_qkv(qkv, cfg, cos, sin)
        kn, vn = k[:, 0], v[:, 0]  # [B, Hkv, Dh]
        ctx = decode_attention_stacked(q[:, 0], cache["k"], cache["v"], l, pos, kn, vn,
                                       **scales).reshape(x.shape[0], 1, -1)
        new_k.append(kn)
        new_v.append(vn)
        x = _block_out(layers, l, x, ctx, cfg)
    # [L, B, Hkv, Dh] per entry, one write each
    for name, t in _cache_entries(torch.stack(new_k), torch.stack(new_v), quantized).items():
        write_window(cache[name], t.unsqueeze(3), pos, 3)
    return _lm_head(params, x, cfg)[:, 0, :], cache


def llama_decode_step(params: Dict, token: torch.Tensor, cache: Dict, pos,
                      cfg: LlamaConfig):
    """One token [B, 1] at position ``pos`` (a Python int or an int64 scalar
    tensor on the token's device: bit-identical logits); writes its K/V
    into the cache in place and returns (logits [B, V], cache).  A packed
    model takes the stacked-cache step when ``QEFT_ATTN_STACKED`` is on."""
    if _stacked_attn_enabled() and is_packed(params):
        return _decode_step_stacked_attn(params, token, cache, pos, cfg)
    logits, cache = llama_forward_window(params, token, cache, pos, cfg)
    return logits[:, 0, :], cache


def _ragged_linear(layers: Dict, name: str, l: int, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` of stage ``name`` of layer ``l``: no norm, no residual (the
    composed stages of the JAX ragged block)."""
    lin = layers[name]
    if isinstance(lin, QLinearParams):
        return qlinear_apply_stacked(x, lin, l)
    return torch.matmul(x, lin[l].to(x.dtype))


def _write_ragged(cache_l: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """Sequence b's window ``new[b]`` ([Hkv, W(, Dh)]) into ``cache_l[b]``
    ([Hkv, S(, Dh)]) at slot ``start[b]``, by one indexed write on the device."""
    b, _, w = new.shape[:3]
    rows = torch.arange(b, device=start.device)[:, None]
    slots = start[:, None] + torch.arange(w, device=start.device)  # [B, W]
    cache_l[rows, :, slots] = new.transpose(1, 2).to(cache_l.dtype)


def llama_forward_window_ragged(params: Dict, tokens: torch.Tensor, cache: Dict,
                                pos: torch.Tensor, cfg: LlamaConfig):
    """A window of W tokens per sequence at per-sequence offsets ``pos`` [B]
    (a tensor, kept on the device): sequence b writes its K/V at [pos[b],
    pos[b] + W) -- clamped into the cache -- and query i attends slots <=
    pos[b] + i.  W = 1 is the continuous-batching decode step, W = gamma + 1
    the batched speculative verify.

    The block is composed as in the JAX package: norm, then the packed
    linear without norm or residual (K6 for at most 8 rows, K2 above), then
    the residual add; attention is K3 at every width (over the dequantized
    slab for an int8 cache).  Returns (logits [B, W, V], cache)."""
    b, w = tokens.shape
    layers = params["layers"]
    eps, one = cfg.rms_norm_eps, cfg.rms_one_offset
    packed = is_packed(params)
    attend = flash_window_attention if packed else flash_window_attention_plain
    pos = pos.to(device=tokens.device, dtype=torch.int64)
    start = pos.clamp(0, cache["k"].shape[3] - w)
    quantized = cache_quantized(cache)
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, pos[:, None] + torch.arange(w, device=tokens.device))
    for l in range(_num_layers(params)):
        h = rms_norm(x, layers["input_ln"][l], eps, one)
        q, k, v = _split_qkv(_ragged_linear(layers, "qkv", l, h), cfg, cos, sin)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        for name, t in _cache_entries(kh, vh, quantized).items():
            _write_ragged(cache[name][l], t, start)
        if quantized:
            k_read = _kv_dequantize(cache["k"][l], cache["k_scale"][l], x.dtype)
            v_read = _kv_dequantize(cache["v"][l], cache["v_scale"][l], x.dtype)
        else:
            k_read, v_read = cache["k"][l], cache["v"][l]
        ctx = attend(q.contiguous(), k_read, v_read, pos)
        o_reorder = layers.get("o_reorder")
        o_in = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
        x = x + _ragged_linear(layers, "o", l, o_in)
        h2 = rms_norm(x, layers["post_ln"][l], eps, one)
        up, gate = _split_upgate(_ragged_linear(layers, "upgate", l, h2), cfg)
        x = x + _ragged_linear(layers, "down", l, _act(gate, cfg.act) * up)
    return _lm_head(params, x, cfg), cache


def llama_decode_step_ragged(params: Dict, tokens: torch.Tensor, cache: Dict,
                             pos: torch.Tensor, cfg: LlamaConfig):
    """Batched decode at per-sequence positions: tokens [B, 1], pos [B].
    Returns (logits [B, V], cache)."""
    logits, cache = llama_forward_window_ragged(params, tokens, cache, pos, cfg)
    return logits[:, 0, :], cache
