"""Pieces the OPT, Phi, Bloom and Falcon decoders share: LayerNorm, the
linear of one layer (packed or dense, with its bias leaf), the plain masked
softmax attention, the KV cache and its in-place write, and the layer loop
with the generation surface (`forward`, `prefill`, `decode_step`,
`forward_window`) that each family drives through its `Decoder` hooks.

The families keep the JAX package's conventions (``qeft_tpu/models/opt.py``
and its siblings): dense weights are ``[K, N]``, per-layer parameters are
stacked on a leading layer axis, every linear's bias is its own leaf
``<name>_b`` [L, N], and the KV cache is head-major ``[L, B, H_kv, S_max,
Dh]``.  A packed linear is addressed as ``QLinearParams.layer(l)``, an
unstacked view, so it reaches `ops.qlinear.qlinear_apply`: K5 at decode,
K2 for a prefill window.  Attention is plain PyTorch, as the JAX families
run XLA's ``_attention`` and no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.qlinear import qlinear_apply


def init_generator(device: torch.device, seed: int) -> torch.Generator:
    """The ``torch.Generator`` a family's ``init_params`` draws from, seeded;
    on the ``meta`` device (the tree's shapes and dtypes without values) a
    CPU one, since a generator cannot live there."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised in f32 (biased variance), cast to x's dtype, then scaled
    and shifted in x's dtype, as ``qeft_tpu/models/opt.py::layer_norm``
    rounds it; the statistics are one ``F.layer_norm`` call."""
    xf = torch.nn.functional.layer_norm(x.to(torch.float32), x.shape[-1:], eps=eps)
    return xf.to(x.dtype) * w + b


def linear(layers: Dict, name: str, l: int, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` of linear ``name`` of layer ``l``.  A packed linear
    without a bias of its own takes the ``<name>_b`` leaf into the kernel's
    epilogue (one rounding where the JAX package adds it after); a dense one
    runs ``torch.matmul`` and adds the bias."""
    lin = layers[name]
    b = layers.get(name + "_b")
    b = None if b is None else b[l]
    if isinstance(lin, QLinearParams):
        p = lin.layer(l)  # a fresh view: its bias may be set here
        if b is not None and p.bias is None:
            p.bias, b = b, None
        y = qlinear_apply(x, p)
    else:
        y = torch.matmul(x, lin[l].to(x.dtype))
    return y if b is None else y + b.to(y.dtype)


def dense(w, x: torch.Tensor) -> torch.Tensor:
    """A model-level projection (lm_head, OPT's project_in/out): a dense
    ``[K, N]`` tensor, or a packed one (``pipeline.rtn_pack_linear``) through
    `qlinear_apply`, as JAX's ``apply_linear`` runs it."""
    if isinstance(w, QLinearParams):
        return qlinear_apply(x, w)
    return torch.matmul(x, w.to(x.dtype))


def gelu(y: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu computed in f32, cast back (as the JAX blocks)."""
    return torch.nn.functional.gelu(y.to(torch.float32), approximate="tanh").to(y.dtype)


def attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax attention (``qeft_tpu/models/llama.py::_attention``):
    q [B, Sq, H, Dh]; k/v [B, H_kv, Sk, Dh] head-major; ``mask`` an additive
    f32 bias broadcastable to [B, H, Sq, Sk].  Scores in x's dtype, then f32
    for the scale, the bias and the softmax.  Returns ctx [B, Sq, H*Dh]."""
    b, sq, h, dh = q.shape
    dtype = q.dtype
    n_rep = h // k_all.shape[1]
    k, v = k_all.to(dtype), v_all.to(dtype)
    if n_rep > 1:
        k, v = k.repeat_interleave(n_rep, dim=1), v.repeat_interleave(n_rep, dim=1)
    scores = torch.matmul(q.transpose(1, 2), k.transpose(2, 3)).to(torch.float32) * dh ** -0.5
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, sq, h * dh)


def causal_bias(query_pos: torch.Tensor, n_keys: int) -> torch.Tensor:
    """[1, 1, W, n_keys] f32: 0 where key j <= the query's position, -inf
    elsewhere."""
    key_pos = torch.arange(n_keys, device=query_pos.device)
    allowed = key_pos[None, :] <= query_pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=query_pos.device)
    return torch.where(allowed, zero, float("-inf"))[None, None]


def init_kv_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
                  quantized: bool = False) -> Dict:
    """Zeroed head-major static cache {"k", "v"}: [L, B, H_kv, S_max, Dh].
    The int8 cache is the llama family's only, as in the JAX package."""
    if quantized:
        raise NotImplementedError("the int8 KV cache serves the llama family only")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_window(cache_l: torch.Tensor, t: torch.Tensor, pos, dim: int) -> None:
    """``t`` into ``cache_l`` along ``dim`` at slot ``pos`` -- a Python int,
    or an int64 scalar tensor read on the device -- in place, the window
    clamped into the cache as ``dynamic_update_slice`` clamps it."""
    s, s_max = t.shape[dim], cache_l.shape[dim]
    if isinstance(pos, torch.Tensor):
        slots = pos.reshape(()).clamp(0, s_max - s) + torch.arange(s, device=pos.device)
        cache_l.index_copy_(dim, slots, t.to(cache_l.dtype))
    else:
        start = min(max(pos, 0), s_max - s)
        cache_l.narrow(dim, start, s).copy_(t)


def cache_write(cache: Dict, l: int, kh: torch.Tensor, vh: torch.Tensor, pos):
    """Layer ``l``'s window K/V (head-major [B, H_kv, W, Dh]) into the cache
    at ``pos`` (an int, or an int64 scalar tensor read on the device), in
    place and clamped into the cache as ``dynamic_update_slice`` clamps;
    returns the layer's whole K and V."""
    for name, t in (("k", kh), ("v", vh)):
        write_window(cache[name][l], t.to(cache[name].dtype), pos, 2)
    return cache["k"][l], cache["v"][l]


@dataclasses.dataclass(frozen=True)
class Decoder:
    """A family's hooks into the shared layer loop: what differs between OPT,
    Phi, Bloom and Falcon is the embedding, the block and the head."""
    norm: str  # a per-layer leaf of every layer tree; its length is the depth
    embed: Callable  # (params, tokens [B, W], positions [W], cfg) -> x [B, W, D]
    block: Callable  # (layers, l, x, cfg, mask, rope, cache, pos, capture) -> x
    final: Callable  # (params, x, cfg) -> logits
    rope: Optional[Callable] = None  # (cfg, positions [1, W]) -> (cos, sin)
    score_bias: Optional[Callable] = None  # (cfg, n_keys, device) -> added to the mask


def forward_window(dec: Decoder, params: Dict, tokens: torch.Tensor, cache: Optional[Dict],
                   pos, cfg):
    """A window of tokens [B, W] at offset ``pos`` (an int; for a decode
    step also an int64 scalar tensor on the device, with bit-identical
    logits: nothing here reads it on the host); with ``cache`` its K/V
    are written in place and attention reads the whole cache (prefill at
    pos = 0, a decode step at W = 1), without one it attends within the
    window.  Returns (logits [B, W, V], cache)."""
    w = tokens.shape[1]
    positions = pos + torch.arange(w, device=tokens.device)
    n_keys = w if cache is None else cache["k"].shape[3]
    mask = causal_bias(positions, n_keys)
    if dec.score_bias is not None:
        mask = mask + dec.score_bias(cfg, n_keys, tokens.device)
    rope = None if dec.rope is None else dec.rope(cfg, positions[None, :])
    x = dec.embed(params, tokens, positions, cfg)
    layers = params["layers"]
    for l in range(layers[dec.norm].shape[0]):
        x = dec.block(layers, l, x, cfg, mask, rope, cache, pos)
    return dec.final(params, x, cfg), cache


def pipeline_block_forward(dec: Decoder, layers: Dict, x: torch.Tensor, cfg,
                           capture: Optional[Dict] = None) -> torch.Tensor:
    """Block 0 of ``layers`` over a whole window x [B, S, D] without a cache,
    as the quantization pipeline runs a dense block (the JAX families'
    ``pipeline_block_forward``); ``capture`` receives the inputs of its four
    quantization stages."""
    mask, rope = full_window(dec, cfg, x.shape[1], x.device)
    return dec.block(layers, 0, x, cfg, mask, rope, capture=capture)


def full_window(dec: Decoder, cfg, s: int, device):
    """(mask, rope) of a window of ``s`` tokens at position 0 without a
    cache: the causal mask (plus the family's score bias) and the rotary
    tables, if the family has them."""
    positions = torch.arange(s, device=device)
    mask = causal_bias(positions, s)
    if dec.score_bias is not None:
        mask = mask + dec.score_bias(cfg, s, device)
    rope = None if dec.rope is None else dec.rope(cfg, positions[None, :])
    return mask, rope


def forward_train(dec: Decoder, params: Dict, tokens: torch.Tensor, cfg,
                  remat: bool = True) -> torch.Tensor:
    """`forward` under autograd: the blocks' packed linears run the autograd
    linear (``ops.qlinear.qlinear_apply``: K2 forward, K7 for ``dx``, the
    ``reorder_ids`` gather differentiated), each block rematerialised with
    ``torch.utils.checkpoint`` when ``remat`` is on (the JAX package
    checkpoints the whole forward: the same loss and gradients)."""
    from torch.utils.checkpoint import checkpoint

    mask, rope = full_window(dec, cfg, tokens.shape[1], tokens.device)
    x = dec.embed(params, tokens, torch.arange(tokens.shape[1], device=tokens.device), cfg)
    layers = params["layers"]
    for l in range(layers[dec.norm].shape[0]):
        if remat:
            x = checkpoint(dec.block, layers, l, x, cfg, mask, rope, use_reentrant=False)
        else:
            x = dec.block(layers, l, x, cfg, mask, rope)
    return dec.final(params, x, cfg)


def forward(dec: Decoder, params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence causal forward without a cache -> logits [B, S, V]."""
    return forward_window(dec, params, tokens, None, 0, cfg)[0]


def prefill(dec: Decoder, params: Dict, tokens: torch.Tensor, cache: Dict, cfg):
    """Fills cache slots [0, S) in place; returns (logits [B, S, V], cache)."""
    return forward_window(dec, params, tokens, cache, 0, cfg)


def decode_step(dec: Decoder, params: Dict, token: torch.Tensor, cache: Dict, pos, cfg):
    """One token [B, 1] at position ``pos`` (an int or an int64 scalar
    tensor); returns (logits [B, V], cache)."""
    logits, cache = forward_window(dec, params, token, cache, pos, cfg)
    return logits[:, 0, :], cache
