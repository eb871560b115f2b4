"""DeepSeek-V2 decoder: multi-head latent attention (MLA), a leading dense
SwiGLU MLP, then mixture-of-experts layers of routed and shared SwiGLU
experts, RMSNorm, YaRN rotary on a 64-dim share of each head, untied head.
``qeft_tpu`` has no such family; the equations are the published modelling
code's (``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite).

Attention.  ``q`` maps the residual to H heads of ``qk_nope + qk_rope``
dims (no q LoRA); ``kv_a`` maps it to a ``kv_lora_rank``-wide latent ``c``
and a ``qk_rope``-wide key ``k_pe`` that all heads share; ``kv_a_ln``
(RMSNorm) normalises ``c``; ``kv_b`` maps ``c`` to each head's ``k_nope``
and value.  RoPE runs on ``q_pe`` and ``k_pe`` in the published
interleaved-pair layout, with YaRN's frequencies; the softmax scale is
``q_head_dim ** -0.5`` times YaRN's ``mscale(factor, mscale_all_dim) ** 2``.

The cache holds one row a token and layer: ``[c, k_pe]`` (576 bf16 at
DeepSeek-V2-Lite), ``{"k": [L, B, 1, S, 576]}`` (one shared key head,
whose values are the rows' first 512 dims).

- A window (prefill, or attention without a cache) runs the uncompressed
  form: ``kv_b`` (K2) over the window's latents gives every head's keys and
  values, and SDPA attends causally.
- A decode step (one token over the cache) runs the absorbed form:
  ``q_lat[h] = q_nope[h] . W_UK[h]`` and ``out[h] = W_UV[h] . o_lat[h]``
  with ``kv_b``'s weight held dequantized in bf16 per head (``w_uk``
  [L, H, qk_nope, rank], ``w_uv`` [L, H, rank, v]: 4 MiB a layer at
  DeepSeek-V2-Lite), and `ops.attention.decode_latent_attention` (on the
  card its kernel) attends ``[q_lat, q_pe]`` over the cached rows.

MLP.  Layers below ``first_k_dense_replace`` run a dense SwiGLU (``gate_up``
fused, ``down``); the rest run `ops.moe.moe_layer`: a bf16 router scored
in f32, softmax, greedy top-k without renormalisation, the routed experts'
packed ``experts_gate_up`` / ``experts_down`` ([L_moe, E, ...]) and the
shared experts as one SwiGLU of ``n_shared_experts`` times the expert
width.  A decode step runs the experts through the grouped matvec, so it
is captured as one CUDA graph; a prefill runs them eagerly.

Packed linears follow `models.common`'s conventions (``[K, N]``, stacked on
a leading layer axis; the MoE leaves on the MoE layers only, the dense MLP
on the leading dense layers only).  OGR's global reorder is offline: the
residual stream, the latent basis (``kv_a``'s latent outputs,
``kv_a_ln``'s weight and ``kv_b``'s inputs, so ``kv_b``'s weak rows are
its last) and each MLP's inner basis (gate/up's outputs with down's
inputs) are permuted in the tree; only the o projection keeps a gather
(``o_reorder``)."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from qeft_tpu_torch import env
from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.models.api import ModelApi
from qeft_tpu_torch.models.common import linear, write_window
from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.ops.attention import decode_latent_attention, decode_latent_attention_plain
from qeft_tpu_torch.ops.moe import mlp, moe_layer
from qeft_tpu_torch.ops.packing import QLinearParams, dequantize_weight
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.ops.qmm import rms_norm
from qeft_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # rope_scaling (type yarn)
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_position_embeddings: int = 163840
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a cached row: the latent and the shared roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def softmax_scale(self) -> float:
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.q_head_dim ** -0.5 * m * m


DEEPSEEK_V2_PRESETS: Dict[str, DeepseekV2Config] = {
    "deepseek-v2-lite": DeepseekV2Config(),
    "deepseek-v2-tiny": DeepseekV2Config(
        vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_layers=2, num_heads=4, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, max_position_embeddings=512),
}


# ---------------------------------------------------------------- YaRN


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> Tuple[float, float]:
    """The dims between which YaRN ramps from interpolated to original
    frequencies (``yarn_find_correction_range``)."""
    dim, base, ctx = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_original_max_position

    def correction_dim(rotations):
        return dim * math.log(ctx / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = math.floor(correction_dim(cfg.rope_beta_fast))
    high = math.ceil(correction_dim(cfg.rope_beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config, device) -> torch.Tensor:
    """f32 [qk_rope / 2] inverse frequencies, computed on ``device`` from
    Python constants (no host copy: a captured decode step computes them)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exponent
    inter = 1.0 / (cfg.rope_factor * base ** exponent)
    low, high = yarn_correction_range(cfg)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_tables(cfg: DeepseekV2Config, positions: torch.Tensor):
    """f32 cos/sin [W, qk_rope] of integer ``positions`` [W], times YaRN's
    ``mscale / mscale_all_dim`` ratio (1 at DeepSeek-V2-Lite)."""
    freqs = positions.to(torch.float32)[:, None] * yarn_inv_freq(cfg, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return torch.cos(emb) * m, torch.sin(emb) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., W, (H,) d] in the interleaved-pair layout -> rotated, in the
    published code's de-interleaved layout, in f32 and rounded once.
    ``cos``/``sin`` [W, d], broadcast over the heads when x has them."""
    d = x.shape[-1]
    xf = x.to(torch.float32).unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rotated = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    if x.dim() == 4:  # [B, W, H, d]
        cos, sin = cos[:, None], sin[:, None]
    return (xf * cos + rotated * sin).to(x.dtype)


# -------------------------------------------------------------- the tree


def _dense(gen, lead, k, n, dtype, device):
    return (torch.randn((*lead, k, n), generator=gen, device=device) * k ** -0.5).to(dtype)


def linear_shapes(cfg: DeepseekV2Config):
    """(name, leading axes, K, N) of every packed linear of the tree."""
    d, h, n = cfg.hidden_size, cfg.num_heads, cfg.num_layers
    nd, nm, e = cfg.first_k_dense_replace, cfg.moe_layers, cfg.n_routed_experts
    fe, fs = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
    return (("q", (n,), d, h * cfg.q_head_dim),
            ("kv_a", (n,), d, cfg.latent_dim),
            ("kv_b", (n,), cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            ("o", (n,), h * cfg.v_head_dim, d),
            ("gate_up", (nd,), d, 2 * cfg.intermediate_size),
            ("down", (nd,), cfg.intermediate_size, d),
            ("shared_gate_up", (nm,), d, 2 * fs),
            ("shared_down", (nm,), fs, d),
            ("experts_gate_up", (nm, e), d, 2 * fe),
            ("experts_down", (nm, e), fe, d))


def absorbed(kv_b: QLinearParams, cfg: DeepseekV2Config):
    """(w_uk [L, H, qk_nope, rank], w_uv [L, H, rank, v]): the packed
    ``kv_b``'s effective weight (the INT4 part plus the weak rows' slab, in
    f32) cut into each head's key and value columns, rounded once to the
    dtype of its scales."""
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    uk, uv = [], []
    for l in range(cfg.num_layers):
        p = kv_b.layer(l)
        w = dequantize_weight(p, torch.float32)
        if p.oweight is not None:
            w[w.shape[0] - p.n_outlier:] += p.oweight.to(torch.float32)
        w = w.reshape(w.shape[0], h, dn + dv)
        uk.append(w[..., :dn].permute(1, 2, 0))
        uv.append(w[..., dn:].permute(1, 0, 2))
    dtype = kv_b.scales.dtype
    return torch.stack(uk).to(dtype).contiguous(), torch.stack(uv).to(dtype).contiguous()


def with_absorbed(params: Dict, cfg: DeepseekV2Config) -> Dict:
    """``params`` with ``w_uk`` / ``w_uv`` (`absorbed`) among its layers,
    made from its packed ``kv_b``."""
    layers = dict(params["layers"])
    layers["w_uk"], layers["w_uv"] = absorbed(layers["kv_b"], cfg)
    return {**params, "layers": layers}


def build_packed(cfg: DeepseekV2Config, seed: int = 0, g: int = 128, r: int = 128,
                 dtype=torch.bfloat16, device=None) -> Dict:
    """Random packed model on ``device`` (default: the GPU): every linear
    but the router and the head packed at group ``g`` (64 where K is no
    multiple of ``g``) with ``r`` weak rows, weights of std about
    1/sqrt(K); the absorbed ``kv_b`` made from the packed one."""
    from qeft_tpu_torch.testing import random_packed_linear

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = cfg.num_layers
    layers: Dict = {}
    for name, lead, k, out in linear_shapes(cfg):
        gk = g if k % g == 0 else 64
        lin = random_packed_linear(gen, math.prod(lead), k, out, gk, r, dtype, fan_in=True)
        layers[name] = lin.map(lambda t: t.reshape(*lead, *t.shape[1:]))
    d = cfg.hidden_size
    for name, width in (("input_ln", d), ("post_ln", d), ("kv_a_ln", cfg.kv_lora_rank)):
        layers[name] = torch.ones(n, width, dtype=dtype, device=device)
    layers["router"] = _dense(gen, (cfg.moe_layers,), d, cfg.n_routed_experts, dtype, device)
    k_o = cfg.num_heads * cfg.v_head_dim
    layers["o_reorder"] = torch.stack([torch.randperm(k_o, generator=gen, device=device)
                                       for _ in range(n)]).to(torch.int32)
    params = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=device) * 0.02).to(dtype),
        "layers": layers,
        "final_ln": torch.ones(d, dtype=dtype, device=device),
        "lm_head": _dense(gen, (), d, cfg.vocab_size, dtype, device),
    }
    return with_absorbed(params, cfg)


# ------------------------------------------------------------ the cache


def init_kv_cache(cfg: DeepseekV2Config, batch: int, max_len: int, dtype=None, device=None,
                  quantized: bool = False) -> Dict:
    """The zeroed latent cache: ``{"k": [L, B, 1, S, kv_lora_rank +
    qk_rope]}``, one row a token: the normalised latent (the values), then
    the roped shared key."""
    if quantized:
        raise NotImplementedError("the latent cache is bf16; the int8 cache serves the llama "
                                  "family only (ROADMAP F2)")
    k = torch.zeros((cfg.num_layers, batch, 1, max_len, cfg.latent_dim),
                    dtype=dtype or cfg.dtype, device=device)
    return {"k": k}


# ---------------------------------------------------------- the block


def _latent_kernel(q: torch.Tensor, cache_l: torch.Tensor) -> bool:
    """Whether a decode step's latent attention launches the kernel: bf16
    queries over a bf16 cache on the card (else, and under
    ``QEFT_PALLAS_ATTN=0``, the plain version)."""
    if not (q.is_cuda and q.dtype == torch.bfloat16 and cache_l.dtype == torch.bfloat16):
        return False
    if not env.PALLAS_ATTN:
        env.announce("QEFT_PALLAS_ATTN")
        return False
    return True


def attention(layers: Dict, l: int, x: torch.Tensor, cfg: DeepseekV2Config, rope,
              cache: Optional[Dict], pos) -> torch.Tensor:
    """MLA of layer ``l`` over the normalised window x [B, W, D] at ``pos``
    -> [B, W, D]: the absorbed form for one token over a cache, else the
    uncompressed form over the window's (and the cache's earlier) latents."""
    with span("qeft.model.mla"):
        b, w, _ = x.shape
        h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        rank = cfg.kv_lora_rank
        cos, sin = rope
        q = linear(layers, "q", l, x).reshape(b, w, h, dn + dr)
        q_nope, q_pe = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
        ckv = linear(layers, "kv_a", l, x)
        c = rms_norm(ckv[..., :rank], layers["kv_a_ln"][l], cfg.rms_norm_eps)
        rows = torch.cat([c, apply_rope(ckv[..., rank:], cos, sin)], dim=-1)  # [B, W, rank + dr]
        if cache is not None:
            write_window(cache["k"][l], rows[:, None], pos, 2)
        if cache is not None and w == 1:
            ctx = _absorbed_attention(layers, l, q_nope[:, 0], q_pe[:, 0], cache["k"][l][:, 0],
                                      pos, cfg)
        else:
            if cache is not None:
                if isinstance(pos, torch.Tensor):
                    raise ValueError("a window of more than one token takes a host position")
                rows = cache["k"][l][:, 0, : pos + w]
            ctx = _uncompressed_attention(layers, l, q_nope, q_pe, rows, pos, cfg)
        o_reorder = layers.get("o_reorder")
        ctx = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
        return linear(layers, "o", l, ctx)


def _absorbed_attention(layers, l, q_nope, q_pe, cache_l, pos, cfg) -> torch.Tensor:
    """One token a sequence: q_nope [B, H, dn], q_pe [B, H, dr] roped,
    cache_l [B, S, rank + dr] -> [B, 1, H * v]."""
    b, h, _ = q_nope.shape
    q_lat = torch.bmm(q_nope.transpose(0, 1), layers["w_uk"][l]).transpose(0, 1)  # [B, H, rank]
    qf = torch.cat([q_lat, q_pe], dim=-1)
    if _latent_kernel(qf, cache_l):
        o_lat = decode_latent_attention(cuda_lib.aligned(qf), cache_l, pos, cfg.softmax_scale)
    else:
        o_lat = decode_latent_attention_plain(qf, cache_l, pos, cfg.softmax_scale,
                                              cfg.kv_lora_rank)
    out = torch.bmm(o_lat.transpose(0, 1), layers["w_uv"][l]).transpose(0, 1)  # [B, H, v]
    return out.reshape(b, 1, h * cfg.v_head_dim)


def _uncompressed_attention(layers, l, q_nope, q_pe, rows, pos, cfg) -> torch.Tensor:
    """The window's queries [B, W, H, ...] over the keys and values
    ``kv_b`` makes from ``rows`` [B, Sk, rank + dr] (keys 0 .. pos + W - 1),
    causal, through SDPA -> [B, W, H * v]."""
    b, w, h, dn = q_nope.shape
    dr, dv, rank = cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    sk = rows.shape[1]
    kv = linear(layers, "kv_b", l, rows[..., :rank]).reshape(b, sk, h, dn + dv)
    k = torch.cat([kv[..., :dn], rows[..., None, rank:].expand(b, sk, h, dr)], dim=-1)
    v = kv[..., dn:]
    d = dn + dr
    if dv < d:  # one head size for every SDPA back end; the padding adds zeros
        v = F.pad(v, (0, d - dv))
    q = torch.cat([q_nope, q_pe], dim=-1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if sk != w:  # a window after earlier cached tokens: key j <= pos + i
        keys = torch.arange(sk, device=q.device)
        mask = keys[None, :] <= (pos + torch.arange(w, device=q.device))[:, None]
    with _sdpa_backends(q):
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=mask is None,
                                             scale=cfg.softmax_scale)
    return ctx[..., :dv].transpose(1, 2).reshape(b, w, h * dv)


def _sdpa_backends(q: torch.Tensor):
    """On the card the fused SDPA back ends only (no score tensor over the
    batch); the CPU's math back end elsewhere."""
    if not q.is_cuda:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])


def mlp_block(layers: Dict, l: int, x: torch.Tensor, cfg: DeepseekV2Config,
              decode: bool) -> torch.Tensor:
    """Layer ``l``'s MLP of the normalised x [B, W, D]: the dense SwiGLU
    below ``first_k_dense_replace``, the expert layer above (``decode``:
    the grouped matvec)."""
    nd = cfg.first_k_dense_replace
    if l < nd:
        return mlp(x, layers["gate_up"].layer(l), layers["down"].layer(l))
    m = l - nd
    return moe_layer(x, layers["router"][m], layers["experts_gate_up"].layer(m),
                     layers["experts_down"].layer(m), layers["shared_gate_up"].layer(m),
                     layers["shared_down"].layer(m), cfg.num_experts_per_tok,
                     cfg.routed_scaling_factor, grouped=decode)


def block(layers: Dict, l: int, x: torch.Tensor, cfg: DeepseekV2Config, rope,
          cache: Optional[Dict] = None, pos=0) -> torch.Tensor:
    """Pre-norm block ``l``: x + attn(norm(x)), then + mlp(norm(x))."""
    eps = cfg.rms_norm_eps
    x = x + attention(layers, l, rms_norm(x, layers["input_ln"][l], eps), cfg, rope, cache, pos)
    decode = cache is not None and x.shape[1] == 1
    return x + mlp_block(layers, l, rms_norm(x, layers["post_ln"][l], eps), cfg, decode)


# ------------------------------------------------------ the entry points


def forward_window(params: Dict, tokens: torch.Tensor, cache: Optional[Dict], pos,
                   cfg: DeepseekV2Config):
    """tokens [B, W] at offset ``pos`` (an int; a decode step's may be an
    int64 scalar on the device); with ``cache`` the window's rows are
    written in place.  Returns (logits [B, W, V], cache)."""
    w = tokens.shape[1]
    positions = pos + torch.arange(w, device=tokens.device)
    rope = rope_tables(cfg, positions)
    with span("qeft.model.embed"):
        x = params["embed"][tokens]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        with span("qeft.model.block"):
            x = block(layers, l, x, cfg, rope, cache, pos)
    with span("qeft.model.head"):
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return torch.matmul(x, params["lm_head"].to(x.dtype)), cache


def forward(params: Dict, tokens: torch.Tensor, cfg: DeepseekV2Config) -> torch.Tensor:
    """Full-sequence causal forward without a cache -> logits [B, S, V]."""
    return forward_window(params, tokens, None, 0, cfg)[0]


def prefill(params: Dict, tokens: torch.Tensor, cache: Dict, cfg: DeepseekV2Config):
    """Fills cache slots [0, S) in place; returns (logits [B, S, V], cache)."""
    return forward_window(params, tokens, cache, 0, cfg)


def decode_step(params: Dict, token: torch.Tensor, cache: Dict, pos, cfg: DeepseekV2Config):
    """One token [B, 1] at ``pos`` (an int or an int64 scalar tensor) ->
    (logits [B, V], cache)."""
    logits, cache = forward_window(params, token, cache, pos, cfg)
    return logits[:, 0, :], cache


def _unported(what: str, item: str):
    def raise_(*_args, **_kwargs):
        raise NotImplementedError(f"DeepSeek-V2 {what} (ROADMAP {item})")
    return raise_


_QUANTIZE = _unported("quantization waits for weights and calibration sets that the "
                      "repository does not hold", "A7b")
MODEL_API = ModelApi(
    family="deepseek_v2", forward=forward, prefill=prefill, decode_step=decode_step,
    forward_window=forward_window, init_cache=init_kv_cache, config_cls=DeepseekV2Config,
    forward_train=_unported("training (WCT of its expert slabs) is not ported", "F1"),
    embed=_QUANTIZE, calibration_block=_QUANTIZE)
