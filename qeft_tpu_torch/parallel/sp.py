"""Sequence parallelism over an ``sp`` mesh axis.  Counterpart of
``qeft_tpu/parallel/sp.py``.

- `llama_prefill_sp`: the prompt splits over ``sp``; projections, norms and
  the MLP are per token and run locally (K2 on each rank's rows), and
  attention is a causal ring: each rank's query chunk accumulates an online
  softmax against the K/V chunks that rotate around the ring, one
  `Mesh.ppermute` a step, so no rank holds the S x S scores.  The softmax
  runs in plain f32 PyTorch, as JAX runs it in XLA.
- `llama_decode_step_sp`: one token over a cache sharded on its slot axis;
  each rank attends its own slab and the partial (max, denominator,
  accumulator) combine exactly in one pmax and two psums.  The new token's
  K/V is written by the rank that owns its slot.

Every linear is the per-layer ``qlinear_apply`` (K5 at decode, K2 for a
window), as JAX's ``apply_linear`` of a scan-sliced layer; a dense tree runs
``torch.matmul``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from qeft_tpu_torch.models.llama import (
    LlamaConfig,
    _act,
    _embed,
    _kv_dequantize,
    _kv_quantize,
    _lm_head,
    _split_upgate,
    _train_linear,
    apply_rope,
    cache_quantized,
    rms_norm,
    rope_tables,
)
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30  # a finite mask value keeps the online softmax free of NaN


def _qkv(layers: Dict, l: int, h: torch.Tensor, cfg: LlamaConfig):
    b, s, _ = h.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = _train_linear(layers, "qkv", l, h)
    return (qkv[..., : hq * dh].reshape(b, s, hq, dh),
            qkv[..., hq * dh: (hq + hkv) * dh].reshape(b, s, hkv, dh),
            qkv[..., (hq + hkv) * dh:].reshape(b, s, hkv, dh))


def _mlp_out(layers: Dict, l: int, x: torch.Tensor, ctx: torch.Tensor,
             cfg: LlamaConfig) -> torch.Tensor:
    eps, one = cfg.rms_norm_eps, cfg.rms_one_offset
    o_reorder = layers.get("o_reorder")
    x = x + _train_linear(layers, "o", l, apply_o_reorder(
        ctx, None if o_reorder is None else o_reorder[l]))
    h2 = rms_norm(x, layers["post_ln"][l], eps, one)
    up, gate = _split_upgate(_train_linear(layers, "upgate", l, h2), cfg)
    return x + _train_linear(layers, "down", l, _act(gate, cfg.act) * up)


def _ring_attention(q, k, v, q_off: int, mesh: Mesh, dtype) -> torch.Tensor:
    """Causal attention of the local query chunk q [B, Hq, Sl, Dh] (global
    rows [q_off, q_off + Sl)) against the ring of K/V chunks [B, Hkv, Sl,
    Dh], GQA by grouped products (no repeat of K/V)."""
    n_sp, p = mesh.shape["sp"], mesh.index("sp")
    b, hq, sl, dh = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    qg = (q.float() * dh ** -0.5).reshape(b, hkv, rep, sl, dh)
    acc = torch.zeros(b, hkv, rep, sl, dh, dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, rep, sl), _NEG, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    qpos = q_off + torch.arange(sl, device=q.device)
    kc, vc = k, v
    for r in range(n_sp):
        k_off = ((p - r) % n_sp) * sl  # the global chunk kc/vc hold
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kc.float())
        causal = qpos[:, None] >= (k_off + torch.arange(sl, device=q.device))[None, :]
        s = s.masked_fill(~causal, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        denom = denom * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", pexp, vc.float())
        m = m_new
        if r < n_sp - 1:  # the last chunk goes nowhere
            kc, vc = mesh.ppermute(kc, "sp"), mesh.ppermute(vc, "sp")
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sl, dh).to(dtype)


@torch.inference_mode()
def llama_prefill_sp(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                     mesh: Mesh) -> Tuple[torch.Tensor, Dict]:
    """Sequence-sharded prefill of tokens [B, S] (every rank passes them
    all and takes its chunk).  Returns (logits [B, S, V], {"k", "v": [L, B,
    H_kv, S, Dh]}), both gathered over ``sp``."""
    mesh.check(params["embed"])
    n_sp, p = mesh.shape["sp"], mesh.index("sp")
    b, s = tokens.shape
    if s % n_sp:
        raise ValueError(f"prompt of {s} tokens does not split over sp={n_sp}")
    sl = s // n_sp
    off = p * sl
    toks = tokens[:, off: off + sl]
    layers = params["layers"]
    x = _embed(params, toks, cfg)
    cos, sin = rope_tables(cfg, (off + torch.arange(sl, device=toks.device))[None, :])
    ks, vs = [], []
    for l in range(layers["input_ln"].shape[0]):
        h = rms_norm(x, layers["input_ln"][l], cfg.rms_norm_eps, cfg.rms_one_offset)
        q, k, v = _qkv(layers, l, h, cfg)
        q = apply_rope(q, cos, sin).transpose(1, 2)
        k = apply_rope(k, cos, sin).transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        ctx = _ring_attention(q, k, v, off, mesh, x.dtype)
        x = _mlp_out(layers, l, x, ctx.transpose(1, 2).reshape(b, sl, -1), cfg)
        ks.append(k)
        vs.append(v)
    logits = _lm_head(params, x, cfg)
    kv = {"k": mesh.all_gather(torch.stack(ks), "sp", dim=3),
          "v": mesh.all_gather(torch.stack(vs), "sp", dim=3)}
    return mesh.all_gather(logits, "sp", dim=1), kv


@torch.inference_mode()
def llama_decode_step_sp(params: Dict, tokens: torch.Tensor, cache: Dict, pos: int,
                         cfg: LlamaConfig, mesh: Mesh) -> Tuple[torch.Tensor, Dict]:
    """One token [B, 1] at position ``pos`` over this rank's slab of a cache
    sharded on its slot axis (leaves [L, B, H_kv, S_max / sp(, Dh)]; rank p
    owns slots [p S_loc, (p + 1) S_loc)).  Returns (logits [B, V]
    replicated, cache), the new K/V written in place by its owner."""
    mesh.check(params["embed"])
    p = mesh.index("sp")
    b = tokens.shape[0]
    s_loc = cache["k"].shape[3]
    lo = p * s_loc
    owns = lo <= pos < lo + s_loc
    quantized = cache_quantized(cache)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = hq // hkv
    layers = params["layers"]
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, torch.full((1, 1), pos, device=tokens.device))
    valid = (lo + torch.arange(s_loc, device=tokens.device)) <= pos
    for l in range(layers["input_ln"].shape[0]):
        h = rms_norm(x, layers["input_ln"][l], cfg.rms_norm_eps, cfg.rms_one_offset)
        q, k, v = _qkv(layers, l, h, cfg)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)  # [B, H_kv, 1, Dh]
        if owns:
            if quantized:
                (kq, ksc), (vq, vsc) = _kv_quantize(kh), _kv_quantize(vh)
                cache["k"][l, :, :, pos - lo] = kq[:, :, 0]
                cache["v"][l, :, :, pos - lo] = vq[:, :, 0]
                cache["k_scale"][l, :, :, pos - lo] = ksc[:, :, 0]
                cache["v_scale"][l, :, :, pos - lo] = vsc[:, :, 0]
            else:
                cache["k"][l, :, :, pos - lo] = kh[:, :, 0].to(cache["k"].dtype)
                cache["v"][l, :, :, pos - lo] = vh[:, :, 0].to(cache["v"].dtype)
        if quantized:
            k_read = _kv_dequantize(cache["k"][l], cache["k_scale"][l], x.dtype)
            v_read = _kv_dequantize(cache["v"][l], cache["v_scale"][l], x.dtype)
        else:
            k_read, v_read = cache["k"][l], cache["v"][l]
        qg = (q.transpose(1, 2).float() * dh ** -0.5).reshape(b, hkv, rep, 1, dh)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k_read.float())
        s = s.masked_fill(~valid, _NEG)
        m = mesh.pmax(s.amax(dim=-1), "sp")
        pexp = torch.exp(s - m[..., None])
        denom = mesh.psum(pexp.sum(dim=-1), "sp")
        acc = mesh.psum(torch.einsum("bgrqk,bgkd->bgrqd", pexp, v_read.float()), "sp")
        ctx = (acc / denom.clamp_min(1e-30)[..., None]).to(x.dtype)
        x = _mlp_out(layers, l, x, ctx.reshape(b, hq, 1, dh).transpose(1, 2).reshape(b, 1, -1),
                     cfg)
    return _lm_head(params, x, cfg)[:, 0, :], cache
