"""Tensor-parallel serving, Megatron style: every rank holds its weight shard
and runs the single-device kernels on it, with two all-gathers and two
psums a block.  Counterpart of ``qeft_tpu/parallel/tp_forward.py``.

Sharding contract (the JAX package's, bit for bit):

- qkv / upgate (column-parallel): the fused N dimension is interleaved on
  the host so shard ``t`` holds ``[q_t | k_t | v_t]`` (``[up_t | gate_t]``);
  qweight, scales, zero points, oweight and bias shard on N.  Each rank runs
  K1 (norm prologue) on its shard at decode, the norm and K2 above 8 rows.
- o / down (row-parallel): the packed word rows are put in shard-major order
  (`_shard_major_words`) so shard ``t`` is exactly ``pack_codes`` of K rows
  ``[t K/tp, (t+1) K/tp)``, its scales and zero points with it (whole
  groups a shard: the group count must divide tp).  The local contraction
  runs K6 (K2 above 8 rows) without a slab; the weak-column slab -- the
  tail of K -- and the bias are added once, on the last shard, before the
  psum.
- the KV cache shards over kv heads, the head over the vocabulary; the
  residual stream is replicated.

`tp_generate` and `tp_decode_burst` run their token loops eagerly, one
window forward a token, where JAX runs each loop as one ``shard_map``
program: collectives over Gloo cannot be captured in a CUDA graph.  In a
burst every rank draws the same token: each rank's generator is seeded
alike and draws over the same gathered logits.

A dense tree laid out by `tp_shard_packed_params` (its ``[L, K, N]``
stages permuted and sliced the same way) runs the same functions, its
linears as ``torch.matmul`` on their column and row shards."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qeft_tpu_torch.generate import SampleConfig, _sample_token
from qeft_tpu_torch.models.llama import (
    LlamaConfig,
    _act,
    _cache_entries,
    _cached_attention,
    _embed,
    _kv_dequantize,
    _lm_head,
    _num_layers,
    _split_qkv,
    _stage,
    _window_attention,
    _write_ragged,
    cache_quantized,
    is_packed,
    rope_tables,
)
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.permute import apply_o_reorder
from qeft_tpu_torch.ops.qlinear import qlinear_apply_stacked
from qeft_tpu_torch.parallel.mesh import Mesh, shard_leaf


def _interleave_perm(sizes, tp: int) -> np.ndarray:
    """Column permutation turning [A|B|...] into concat_t [A_t|B_t|...]."""
    offs = np.cumsum([0] + list(sizes[:-1]))
    pieces = []
    for t in range(tp):
        for off, s in zip(offs, sizes):
            w = s // tp
            pieces.append(np.arange(off + t * w, off + (t + 1) * w))
    return np.concatenate(pieces)


def _shard_major_words(qw: torch.Tensor, group_size: int, tp: int) -> torch.Tensor:
    """Packed word rows from the global group interleave (word row ``jj*G +
    gi``) to shard-major order ``(t, jj, gi_local)``, so the t-th contiguous
    1/tp of the rows is ``pack_codes`` of K rows ``[t K/tp, (t+1) K/tp)``
    in the local interleave (word row ``jj*(G/tp) + gi_local``) the
    kernels read."""
    *lead, k8, n = qw.shape
    g = group_size if group_size > 0 else k8 * 8
    h = g // 8
    n_groups = k8 // h
    if tp == 1 or n_groups == 1:
        return qw
    if n_groups % tp:
        raise ValueError(f"{n_groups} quantization groups do not divide tp={tp}")
    nl = len(lead)
    w = qw.reshape(*lead, h, tp, n_groups // tp, n)
    w = w.permute(*range(nl), nl + 1, nl, nl + 2, nl + 3)
    return w.reshape(*lead, k8, n)


def _unpad_upgate_halves(lin, intermediate_size: int):
    """A fused upgate written as [up | 0pad | gate | 0pad] (JAX's padded
    load layout) back to [up | gate]; the column interleave assumes N = 2 f.
    The port reads that layout but never writes it."""
    f = intermediate_size
    f_pad = lin.shape[-1] // 2 if isinstance(lin, torch.Tensor) else lin.out_features // 2
    if f_pad == f:
        return lin

    def cut(a):
        return None if a is None else torch.cat([a[..., :f], a[..., f_pad: f_pad + f]], dim=-1)

    if isinstance(lin, torch.Tensor):
        return cut(lin)
    return dataclasses.replace(lin, qweight=cut(lin.qweight), scales=cut(lin.scales),
                               scaled_zeros=cut(lin.scaled_zeros), oweight=cut(lin.oweight),
                               bias=cut(lin.bias))


def tp_shard_packed_params(params: Dict, mesh: Mesh, cfg: LlamaConfig,
                           pp_axis: Optional[str] = None) -> Dict:
    """This rank's part of a stage-fused model (packed, or dense ``[L, K,
    N]`` stages) under the contract of the module docstring: each leaf
    equals the device shard of the JAX package's ``tp_shard_packed_params``
    on the same tree.  ``pp_axis``: the stacked layer axis also shards over
    that mesh axis (the tp x pp composition, `tp_pp`)."""
    tp, t = mesh.shape["tp"], mesh.index("tp")
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"{hq} query and {hkv} kv heads must divide tp={tp}")

    def lay(a):  # the layer span of a per-layer leaf
        return None if a is None else shard_leaf(a, (pp_axis,), mesh) if pp_axis else a

    def cols(a, idx):  # this rank's columns after the interleave
        return None if a is None else lay(a).index_select(-1, idx.to(a.device)).contiguous()

    def rows(a, dim):  # this rank's contiguous block of ``dim``
        if a is None:
            return None
        a = lay(a)
        w = a.shape[dim] // tp
        return a.narrow(dim, t * w, w).contiguous()

    def col_linear(leaf, perm):
        w = len(perm) // tp
        idx = torch.as_tensor(perm[t * w: (t + 1) * w], dtype=torch.int64)
        if isinstance(leaf, torch.Tensor):
            return cols(leaf, idx)
        return QLinearParams(qweight=cols(leaf.qweight, idx), scales=cols(leaf.scales, idx),
                             scaled_zeros=cols(leaf.scaled_zeros, idx),
                             oweight=cols(leaf.oweight, idx), bias=cols(leaf.bias, idx),
                             group_size=leaf.group_size)

    def row_linear(name, leaf):
        if isinstance(leaf, torch.Tensor):
            return rows(leaf, 1)
        if leaf.reorder_ids is not None:
            # as qeft_tpu's layout: a per-linear gather of the whole K axis
            # would need every rank's K rows before its own shard's
            raise ValueError(f"{name}: a row-parallel linear cannot carry its own reorder_ids "
                             "(the tp layout takes a stage-fused, statically reordered model)")
        g = leaf.group_size if leaf.group_size > 0 else leaf.in_features
        n_groups = leaf.in_features // g
        if n_groups % tp:
            raise ValueError(f"{name}: {n_groups} quantization groups must divide tp={tp} "
                             "(row-parallel shards whole groups)")
        return QLinearParams(qweight=rows(_shard_major_words(leaf.qweight, leaf.group_size, tp), 1),
                             scales=rows(leaf.scales, 1), scaled_zeros=rows(leaf.scaled_zeros, 1),
                             oweight=lay(leaf.oweight), bias=lay(leaf.bias),
                             group_size=leaf.group_size)

    layers = params["layers"]
    f = cfg.intermediate_size
    qkv_perm = _interleave_perm([hq * dh, hkv * dh, hkv * dh], tp)
    ug_perm = _interleave_perm([f, f], tp)
    new_layers = {}
    for name, leaf in layers.items():
        if name == "qkv":
            new_layers[name] = col_linear(leaf, qkv_perm)
        elif name == "upgate":
            new_layers[name] = col_linear(_unpad_upgate_halves(leaf, f), ug_perm)
        elif name in ("o", "down"):
            new_layers[name] = row_linear(name, leaf)
        elif isinstance(leaf, QLinearParams):
            raise ValueError(f"{name}: tensor parallelism takes the fused stages "
                             "(pipeline.fuse_packed_stages)")
        else:
            new_layers[name] = lay(leaf)
    head = params["lm_head"]
    if not isinstance(head, torch.Tensor):
        raise ValueError("tensor parallelism takes a dense lm_head (not QEFT_QUANT_LMHEAD)")
    return {"embed": params["embed"], "layers": new_layers, "final_ln": params["final_ln"],
            "lm_head": shard_leaf(head, (None, "tp"), mesh)}


def tp_cache_specs(cache: Dict, pp_axis: Optional[str] = None,
                   dp_axis: Optional[str] = None) -> Dict:
    """Specs of the head-major cache on the tp layouts (JAX's ``_tp_specs``):
    kv heads over ``tp``, layers over ``pp_axis``, batch rows over
    ``dp_axis``."""
    return {name: (pp_axis, dp_axis, "tp", None, None)[: leaf.dim()]
            for name, leaf in cache.items()}


def tp_shard_cache(cache: Dict, mesh: Mesh, pp_axis: Optional[str] = None,
                   dp_axis: Optional[str] = None) -> Dict:
    """This rank's part of a whole cache under `tp_cache_specs`."""
    specs = tp_cache_specs(cache, pp_axis, dp_axis)
    return {name: shard_leaf(leaf, specs[name], mesh) for name, leaf in cache.items()}


def _local_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config with this rank's head counts (what `_split_qkv` reads)."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def _row_parallel_apply(lin, l: int, x_full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's part of row-parallel stage ``l`` on the gathered input:
    the local K rows through K6 (K2 above 8 rows) without a slab; on the
    last shard also the weak-column slab (the tail of K) and the bias, so
    the caller's psum counts them once.  A dense stage is one matmul."""
    tp, my = mesh.shape["tp"], mesh.index("tp")
    if isinstance(lin, torch.Tensor):
        ks = lin.shape[1]
        return torch.matmul(x_full[..., my * ks: (my + 1) * ks], lin[l].to(x_full.dtype))
    ks = lin.in_features
    local = QLinearParams(lin.qweight, lin.scales, lin.scaled_zeros, group_size=lin.group_size)
    part = qlinear_apply_stacked(x_full[..., my * ks: (my + 1) * ks], local, l)
    if my == tp - 1:
        if lin.oweight is not None:
            r = lin.oweight.shape[-2]
            slab = torch.matmul(x_full[..., -r:], lin.oweight[l].to(x_full.dtype))
            part = part + slab.to(part.dtype)
        if lin.bias is not None:
            part = part + lin.bias[l].to(part.dtype)
    return part


def _tp_block(layers: Dict, l: int, x: torch.Tensor, lcfg: LlamaConfig, cos, sin,
              mesh: Mesh, attend) -> torch.Tensor:
    """Decoder block ``l`` on the local shards: K1 (or the norm and K2) on
    this rank's qkv columns, ``attend(l, q, kh, vh)`` over its kv heads,
    the context gathered over ``tp`` for the o-gather and the row-parallel
    o, then the same for the MLP."""
    qkv = _stage(layers, "qkv", l, x, lcfg, lnw=layers["input_ln"][l])
    q, k, v = _split_qkv(qkv, lcfg, cos, sin)
    ctx = attend(l, q, k.transpose(1, 2), v.transpose(1, 2))
    # heads were interleaved shard-contiguously: the tiled gather is the
    # whole head-ordered context
    ctx = mesh.all_gather(ctx, "tp", dim=-1)
    o_reorder = layers.get("o_reorder")
    o_in = apply_o_reorder(ctx, None if o_reorder is None else o_reorder[l])
    x = x + mesh.psum(_row_parallel_apply(layers["o"], l, o_in, mesh), "tp")
    ug = _stage(layers, "upgate", l, x, lcfg, lnw=layers["post_ln"][l])
    f_l = ug.shape[-1] // 2
    act = _act(ug[..., f_l:], lcfg.act) * ug[..., :f_l]
    # the local act is exactly down's K shard; the slab needs the tail, so
    # gather once, as JAX does
    act = mesh.all_gather(act, "tp", dim=-1)
    return x + mesh.psum(_row_parallel_apply(layers["down"], l, act, mesh), "tp")


def _tp_window_body(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                    mesh: Mesh) -> torch.Tensor:
    """A W-token window at offset ``pos`` through the local shards; the
    local cache [L, B, H_kv/tp, S, Dh] is written in place.  Attention is
    the single-device choice (`models.llama._cached_attention`): K4 / K4q
    for one token, K3 for a window.  Returns the local logits [B, W, V/tp]."""
    mesh.check(params["embed"])
    lcfg = _local_cfg(cfg, mesh.shape["tp"])
    packed = is_packed(params)
    w = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, (pos + torch.arange(w, device=tokens.device))[None, :])

    def attend(l, q, kh, vh):
        return _cached_attention(cache, l, q, kh, vh, pos, packed)

    for l in range(_num_layers(params)):
        x = _tp_block(params["layers"], l, x, lcfg, cos, sin, mesh, attend)
    return _lm_head(params, x, cfg)


def tp_forward_window(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                      mesh: Mesh):
    """A W-token window (W = prompt: prefill; 1: decode; gamma + 1: verify)
    on the tp mesh.  ``params`` from `tp_shard_packed_params`, ``cache`` this
    rank's kv heads.  Returns (logits [B, W, V] replicated, cache)."""
    logits = _tp_window_body(params, tokens, cache, pos, cfg, mesh)
    return mesh.all_gather(logits, "tp", dim=-1), cache


def tp_decode_step(params: Dict, token: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                   mesh: Mesh):
    """One decode step on the tp mesh: (logits [B, V], cache)."""
    logits = _tp_window_body(params, token, cache, pos, cfg, mesh)
    return mesh.all_gather(logits[:, 0, :], "tp", dim=-1), cache


def _tp_window_body_ragged(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                           cfg: LlamaConfig, mesh: Mesh) -> torch.Tensor:
    """Ragged twin of `_tp_window_body`: sequence b's window lands at [pos[b],
    pos[b] + W) of its cache rows (clamped) and query i attends slots <=
    pos[b] + i, through K3 at every width (over the dequantized slab for an
    int8 cache), as the single-device ragged forward.  Returns the local
    logits [B, W, V/tp]."""
    mesh.check(params["embed"])
    lcfg = _local_cfg(cfg, mesh.shape["tp"])
    attn = _window_attention(is_packed(params))
    w = tokens.shape[1]
    pos = pos.to(device=tokens.device, dtype=torch.int64)
    start = pos.clamp(0, cache["k"].shape[3] - w)
    quantized = cache_quantized(cache)
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, pos[:, None] + torch.arange(w, device=tokens.device))

    def attend(l, q, kh, vh):
        for name, t in _cache_entries(kh, vh, quantized).items():
            _write_ragged(cache[name][l], t, start)
        if quantized:
            k_read = _kv_dequantize(cache["k"][l], cache["k_scale"][l], q.dtype)
            v_read = _kv_dequantize(cache["v"][l], cache["v_scale"][l], q.dtype)
        else:
            k_read, v_read = cache["k"][l], cache["v"][l]
        return attn(q.contiguous(), k_read, v_read, pos)

    for l in range(_num_layers(params)):
        x = _tp_block(params["layers"], l, x, lcfg, cos, sin, mesh, attend)
    return _lm_head(params, x, cfg)


def tp_forward_window_ragged(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                             cfg: LlamaConfig, mesh: Mesh):
    """Ragged W-token window at per-sequence offsets ``pos`` [B]: (logits
    [B, W, V] replicated, cache)."""
    logits = _tp_window_body_ragged(params, tokens, cache, pos, cfg, mesh)
    return mesh.all_gather(logits, "tp", dim=-1), cache


def tp_decode_step_ragged(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                          cfg: LlamaConfig, mesh: Mesh):
    """The continuous-batching decode tick on the tp mesh: (logits [B, V],
    cache)."""
    logits = _tp_window_body_ragged(params, tokens, cache, pos, cfg, mesh)
    return mesh.all_gather(logits[:, 0, :], "tp", dim=-1), cache


def tp_decode_burst(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                    cfg: LlamaConfig, mesh: Mesh, n: int, sc: SampleConfig,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """``n`` ragged ticks with no host read between them -> tokens [B, n].
    Each tick gathers the [B, V] logits and every rank samples the same
    token from its own generator (seeded alike by the caller)."""
    out = torch.empty(tokens.shape[0], n, dtype=torch.int64, device=tokens.device)
    for i in range(n):
        logits, _ = tp_decode_step_ragged(params, tokens, cache, pos + i, cfg, mesh)
        nxt = _sample_token(logits, generator, sc)
        out[:, i] = nxt
        tokens = nxt[:, None]
    return out


@torch.inference_mode()
def tp_generate(params: Dict, prompt: torch.Tensor, cache: Dict, cfg: LlamaConfig, mesh: Mesh,
                max_new_tokens: int, return_logits: bool = False):
    """Greedy generation on the tp mesh: the prefill window, then one decode
    step a token, each gathering only the last position's [B, V/tp] logits.
    Returns (tokens [B, max_new_tokens], cache), with ``return_logits`` also
    the f32 logits [B, max_new_tokens, V] each token was chosen from."""
    b, s = prompt.shape
    logits = _tp_window_body(params, prompt, cache, 0, cfg, mesh)
    last = mesh.all_gather(logits[:, -1, :], "tp", dim=-1)
    out = torch.empty(b, max_new_tokens, dtype=torch.int64, device=prompt.device)
    seen = []
    for i in range(max_new_tokens):
        if i:
            logits = _tp_window_body(params, out[:, i - 1: i], cache, s + i - 1, cfg, mesh)
            last = mesh.all_gather(logits[:, 0, :], "tp", dim=-1)
        out[:, i] = torch.argmax(last, dim=-1)
        if return_logits:
            seen.append(last.float())
    if return_logits:
        return out, cache, torch.stack(seen, dim=1)
    return out, cache
