"""Tensor x pipeline (x data) parallel decode on a ("pp", "tp") mesh, or
("dp", "pp", "tp") with batch rows over the outer ``dp`` axis.  Counterpart
of ``qeft_tpu/parallel/tp_pp.py``: layers shard over ``pp`` (one span a
stage, the GPipe schedule of `pp`), and inside a stage every block's
weights shard over ``tp`` with the collectives of `tp_forward`.  The tp
collectives run in each stage's row subgroup, the ring step in each
column's ``pp`` subgroup; no collective crosses ``dp`` but the final
gather of the rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from qeft_tpu_torch.models.llama import LlamaConfig, _cached_attention, is_packed, rope_tables
from qeft_tpu_torch.parallel.mesh import Mesh
from qeft_tpu_torch.parallel.pp import _pick_m_count, gpipe_window
from qeft_tpu_torch.parallel.tp_forward import (
    _local_cfg,
    _tp_block,
    tp_shard_cache,
    tp_shard_packed_params,
)


def _dp_axis(mesh: Mesh):
    return "dp" if "dp" in mesh.shape else None


def tppp_shard_params(params: Dict, cache: Dict, mesh: Mesh,
                      cfg: LlamaConfig) -> Tuple[Dict, Dict]:
    """This rank's part of a stage-fused model and its cache: layers on
    ``pp``, weights on ``tp`` (the `tp_forward` contract), kv heads on
    ``tp``, batch rows on ``dp``."""
    sharded = tp_shard_packed_params(params, mesh, cfg, pp_axis="pp")
    return sharded, tp_shard_cache(cache, mesh, pp_axis="pp", dp_axis=_dp_axis(mesh))


def _rows(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dp = mesh.shape.get("dp", 1)
    if tokens.shape[0] % dp:
        raise ValueError(f"batch {tokens.shape[0]} does not split over dp={dp}")
    bl = tokens.shape[0] // dp
    return tokens[mesh.index("dp") * bl: (mesh.index("dp") + 1) * bl]


@torch.inference_mode()
def tppp_forward_window(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                        mesh: Mesh, n_microbatches: int = 0) -> Tuple[torch.Tensor, Dict]:
    """A pipelined, tensor-parallel W-token window over the global tokens [B,
    W] (this rank takes its dp rows).  Returns (last-position f32 logits
    [B, V] replicated, this rank's cache)."""
    n_pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    if cfg.num_layers % n_pp:
        raise ValueError(f"{cfg.num_layers} layers do not split into {n_pp} stages")
    toks = _rows(tokens, mesh)
    m_count = _pick_m_count(toks.shape[0], n_pp, n_microbatches)
    lcfg = _local_cfg(cfg, tp)
    packed = is_packed(params)
    cos, sin = rope_tables(cfg, (pos + torch.arange(toks.shape[1], device=toks.device))[None, :])
    layers = params["layers"]
    n_local = layers["input_ln"].shape[0]

    def run_span(x, c_mb):
        def attend(l, q, kh, vh):
            return _cached_attention(c_mb, l, q, kh, vh, pos, packed)

        for l in range(n_local):
            x = _tp_block(layers, l, x, lcfg, cos, sin, mesh, attend)
        return x

    v_local = params["lm_head"].shape[-1]
    logits = gpipe_window(params, toks, cache, pos, cfg, mesh, m_count, run_span, v_local)
    logits = mesh.all_gather(logits.reshape(toks.shape[0], v_local), "tp", dim=-1)
    return mesh.all_gather(logits, "dp", dim=0), cache


def tppp_decode_step(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                     mesh: Mesh, n_microbatches: int = 0) -> Tuple[torch.Tensor, Dict]:
    """One decode step on the 2-D (3-D) mesh: (logits [B, V], cache)."""
    return tppp_forward_window(params, tokens, cache, pos, cfg, mesh, n_microbatches)


@torch.inference_mode()
def tppp_generate(params: Dict, prompt: torch.Tensor, cache: Dict, cfg: LlamaConfig, mesh: Mesh,
                  max_new_tokens: int, n_microbatches: int = 0) -> torch.Tensor:
    """Greedy generation on the mesh; ``params``/``cache`` from
    `tppp_shard_params`.  Returns tokens [B, max_new_tokens] (all rows,
    replicated)."""
    b, s = prompt.shape
    logits, cache = tppp_forward_window(params, prompt, cache, 0, cfg, mesh, n_microbatches)
    out = torch.empty(b, max_new_tokens, dtype=torch.int64, device=prompt.device)
    out[:, 0] = torch.argmax(logits, dim=-1)
    for i in range(1, max_new_tokens):
        logits, cache = tppp_forward_window(params, out[:, i - 1: i], cache, s + i - 1, cfg,
                                            mesh, n_microbatches)
        out[:, i] = torch.argmax(logits, dim=-1)
    return out
