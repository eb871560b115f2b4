"""GPipe pipeline parallelism over a ``pp`` mesh axis.  Counterpart of
``qeft_tpu/parallel/pp.py``, the successor of the reference's only
multi-GPU path (``model_multigpu``, which round-robins blocks over GPUs
with blocking copies, one batch at a time).

- The stacked layer axis and the cache's layer axis shard over ``pp``:
  stage ``p`` holds layers ``[p L/P, (p+1) L/P)``.
- The batch splits into M microbatches (`_pick_m_count`) that flow through
  the stages on the dense GPipe schedule: at tick ``t`` stage ``p`` runs
  microbatch ``t - p``.
- Activations move stage to stage with one `Mesh.ppermute` ring step a
  tick; the last stage projects the logits, and one masked psum replicates
  them.

Each stage runs the single-device block (`models.llama.llama_block`: K1 at
decode, K2 and K3 for a window, K4 / K4q attention) over a microbatch's
view of its cache rows, so every write lands in the cache.  The schedule
runs eagerly; a stage with no microbatch at a tick computes nothing and
sends zeros.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from qeft_tpu_torch.models.llama import LlamaConfig, _embed, _lm_head, llama_block, rope_tables
from qeft_tpu_torch.parallel.mesh import Mesh, shard_tree


def pp_shardings(params: Dict, cache: Dict, mesh: Mesh):
    """Spec trees placing the layer axis on ``pp``, everything else
    replicated; apply with `mesh.shard_tree`."""
    from qeft_tpu_torch.ops.packing import QLinearParams

    def lay(leaf):
        if isinstance(leaf, QLinearParams):
            return QLinearParams(**{f: None if getattr(leaf, f) is None else ("pp",)
                                    for f in ("qweight", "scales", "scaled_zeros", "oweight",
                                              "bias", "reorder_ids")},
                                 group_size=leaf.group_size)
        return ("pp",)

    p_sh = {k: ({n: lay(v2) for n, v2 in v.items()} if k == "layers"
                else (None,) * v.dim()) for k, v in params.items()}
    if not isinstance(params["lm_head"], torch.Tensor):
        p_sh["lm_head"] = params["lm_head"].map(lambda t: (None,) * t.dim())
    return p_sh, {k: ("pp",) for k in cache}


def _pick_m_count(b: int, n_pp: int, n_microbatches: int) -> int:
    if n_microbatches:
        m_count = n_microbatches
    else:
        # the largest divisor of b that is at most the stage count
        m_count = max(m for m in range(1, min(n_pp, b) + 1) if b % m == 0)
    if b % m_count:
        raise ValueError(f"batch {b} does not split into {m_count} microbatches")
    return m_count


def gpipe_window(params_l: Dict, toks: torch.Tensor, cache_l: Dict, pos, cfg: LlamaConfig,
                 mesh: Mesh, m_count: int, run_span, vocab: int) -> torch.Tensor:
    """The GPipe schedule of one W-token window on this stage: ``run_span(x,
    c_mb)`` runs the local layer span over a microbatch's activation and
    cache view.  Returns the last position's f32 logits [m_count, mb,
    ``vocab``] after the masked psum over ``pp`` (every stage holds them)."""
    mesh.check(params_l["embed"])
    n_pp, p = mesh.shape["pp"], mesh.index("pp")
    b, w = toks.shape
    mb = b // m_count
    x0 = _embed(params_l, toks, cfg).reshape(m_count, mb, w, -1)
    logits_acc = torch.zeros(m_count, mb, vocab, dtype=torch.float32, device=toks.device)
    carry = torch.zeros_like(x0[0])
    for t in range(n_pp + m_count - 1):
        m = t - p  # this stage's microbatch at tick t
        if 0 <= m < m_count:
            c_mb = {k: v[:, m * mb: (m + 1) * mb] for k, v in cache_l.items()}
            x_out = run_span(x0[m] if p == 0 else carry, c_mb)
            if p == n_pp - 1:
                logits_acc[m] = _lm_head(params_l, x_out[:, -1:, :], cfg)[:, 0, :].float()
        else:
            x_out = torch.zeros_like(carry)
        carry = mesh.ppermute(x_out, "pp")
    return mesh.psum(logits_acc, "pp")


def _pp_stage_window(params_l, toks, cache_l, pos, cfg, mesh, m_count):
    w = toks.shape[1]
    cos, sin = rope_tables(cfg, (pos + torch.arange(w, device=toks.device))[None, :])
    layers = params_l["layers"]
    n_local = layers["input_ln"].shape[0]

    def run_span(x, c_mb):
        for l in range(n_local):
            x = llama_block(layers, l, x, cfg, cos, sin, cache=c_mb, pos=pos)
        return x

    logits = gpipe_window(params_l, toks, cache_l, pos, cfg, mesh, m_count, run_span,
                          cfg.vocab_size)
    return logits.reshape(toks.shape[0], -1)


@torch.inference_mode()
def pp_forward_window(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                      mesh: Mesh, n_microbatches: int = 0) -> Tuple[torch.Tensor, Dict]:
    """A pipelined W-token window (W = prompt: the sharded prefill; 1: a
    decode step) over this stage's layer span (``params``/``cache`` laid
    out by `pp_shardings`).  Returns (last-position f32 logits [B, V]
    replicated, cache)."""
    n_pp = mesh.shape["pp"]
    if cfg.num_layers % n_pp:
        raise ValueError(f"{cfg.num_layers} layers do not split into {n_pp} stages")
    m_count = _pick_m_count(tokens.shape[0], n_pp, n_microbatches)
    return _pp_stage_window(params, tokens, cache, pos, cfg, mesh, m_count), cache


def pp_decode_step(params: Dict, tokens: torch.Tensor, cache: Dict, pos, cfg: LlamaConfig,
                   mesh: Mesh, n_microbatches: int = 0) -> Tuple[torch.Tensor, Dict]:
    """One pipelined decode step: (logits [B, V], cache).  The microbatch
    count defaults to the stage count where it divides B."""
    return pp_forward_window(params, tokens, cache, pos, cfg, mesh, n_microbatches)


@torch.inference_mode()
def pp_generate(params: Dict, prompt: torch.Tensor, cache: Dict, cfg: LlamaConfig, mesh: Mesh,
                max_new_tokens: int, n_microbatches: int = 0) -> torch.Tensor:
    """Greedy pipelined generation from the whole tree and cache on every
    rank: each stage keeps its layer span (views, no copy), runs the
    pipelined prefill, then one pipelined step a token.  Returns tokens [B,
    max_new_tokens]."""
    p_sh, c_sh = pp_shardings(params, cache, mesh)
    params, cache = shard_tree(params, p_sh, mesh), shard_tree(cache, c_sh, mesh)
    b, s = prompt.shape
    logits, cache = pp_forward_window(params, prompt, cache, 0, cfg, mesh, n_microbatches)
    out = torch.empty(b, max_new_tokens, dtype=torch.int64, device=prompt.device)
    out[:, 0] = torch.argmax(logits, dim=-1)
    for i in range(1, max_new_tokens):
        logits, cache = pp_forward_window(params, out[:, i - 1: i], cache, s + i - 1, cfg, mesh,
                                          n_microbatches)
        out[:, i] = torch.argmax(logits, dim=-1)
    return out
