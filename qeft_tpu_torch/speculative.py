"""Speculative (assisted) decoding: draft-model candidates, one target
verify window, KV rollback by position.  Counterpart of
``qeft_tpu/speculative.py``.

A draft model proposes ``gamma`` tokens per sequence (ragged decode steps,
each sequence at its own position); the target scores them in one ragged
window forward (W = gamma + 1); the longest agreeing prefix is accepted
plus one corrected token; and the static cache "rolls back" by not
advancing a sequence's position past what it kept (stale slots beyond are
masked, then overwritten).  Greedy verification reproduces the target's own
greedy output; sampled verification (`speculative_accept`) emits tokens
distributed exactly as sampling the target alone.

JAX's ``while_loop`` / ``fori_loop`` are Python loops here whose tokens stay
on the device; the batched generator reads one flag a round (whether any
sequence still needs tokens).  Random draws use an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.generate import SampleConfig, default_generator, sample_from, warp_logits
from qeft_tpu_torch.models.llama import (
    LlamaConfig,
    llama_decode_step_ragged,
    llama_forward_window_ragged,
    llama_prefill,
)
from qeft_tpu_torch.ops.packing import QLinearParams


def _warp_probs(logits: torch.Tensor, sc: SampleConfig) -> torch.Tensor:
    """The distribution draft, target and plain sampler all sample from."""
    return torch.softmax(warp_logits(logits, sc), dim=-1)


def speculative_accept(cand: torch.Tensor, probs_d: torch.Tensor, probs_t: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
    """The accept / resample rule of speculative sampling (Leviathan et al.),
    over any leading batch dims: cand [..., gamma] draft tokens, probs_d
    [..., gamma, V] the draft distributions they were drawn from, probs_t
    [..., gamma + 1, V] the target's (the last is the bonus position).

    Draft token i is accepted with probability min(1, p_t(x_i) / p_d(x_i));
    at the first rejection the corrected token is drawn from norm((p_t -
    p_d)+), or from p_t[gamma] when all were accepted.  Returns (n_accept,
    corrected), int64 [...]."""
    gamma = cand.shape[-1]
    u = torch.rand(cand.shape, generator=generator, device=cand.device)
    p_t_x = torch.gather(probs_t[..., :gamma, :], -1, cand[..., None])[..., 0]
    p_d_x = torch.gather(probs_d, -1, cand[..., None])[..., 0]
    accept = u * p_d_x < p_t_x  # u < p_t / p_d, safe where p_d == 0
    stop = torch.cat([~accept, torch.ones_like(accept[..., :1])], dim=-1)
    n_accept = torch.argmax(stop.to(torch.int8), dim=-1)  # first rejection, or gamma

    def at(probs, idx):
        return torch.gather(probs, -2, idx[..., None, None].expand(
            *idx.shape, 1, probs.shape[-1]))[..., 0, :]

    pt_n = at(probs_t, n_accept)
    residual = (pt_n - at(probs_d, n_accept.clamp_max(gamma - 1))).clamp_min(0.0)
    dist = torch.where((n_accept == gamma)[..., None], pt_n, residual)
    # a degenerate residual (p_t == p_d exactly) falls back to p_t
    dist = torch.where((dist.sum(-1) > 0.0)[..., None], dist, pt_n)
    return n_accept, sample_from(dist, generator)


def layer_sliced_draft(params: Dict, cfg: LlamaConfig, n_layers: int):
    """Self-speculative draft: ``n_layers`` evenly strided decoder layers of
    the target itself (always the first and the last), with the target's
    embedding, final norm and lm_head.  The layers are gathered into their
    own stacked buffers (a copy of those layers' weights).  Returns
    (draft_params, draft_cfg)."""
    if not 1 <= n_layers <= cfg.num_layers:
        raise ValueError(f"n_layers must be in 1..{cfg.num_layers}, got {n_layers}")
    idx_np = np.unique(np.round(np.linspace(0, cfg.num_layers - 1, n_layers)).astype(np.int64))
    idx = torch.as_tensor(idx_np, device=params["embed"].device)
    layers = {name: leaf.map(lambda t: t[idx]) if isinstance(leaf, QLinearParams) else leaf[idx]
              for name, leaf in params["layers"].items()}
    return {**params, "layers": layers}, dataclasses.replace(cfg, num_layers=int(idx.numel()))


def _check_vocab(cfg_t: LlamaConfig, cfg_d: LlamaConfig) -> None:
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError(
            f"the draft's vocabulary ({cfg_d.vocab_size}) differs from the target's "
            f"({cfg_t.vocab_size}); its embedding cannot read the target's tokens")


def spec_round(target_params: Dict, draft_params: Dict, last: torch.Tensor, t_cache: Dict,
               d_cache: Dict, base_pos: torch.Tensor, cfg_t: LlamaConfig, cfg_d: LlamaConfig,
               gamma: int, sc: SampleConfig, greedy: bool,
               generator: Optional[torch.Generator] = None):
    """One batched round: gamma ragged draft steps, one ragged target verify
    window, per-sequence accept / resample.  ``last`` [B, 1] is each
    sequence's last emitted token at position ``base_pos`` [B].

    Returns (emit [B, gamma + 1], n_accept [B], t_cache, d_cache): sequence
    b emits emit[b, :n_accept[b] + 1]."""
    b = last.shape[0]
    cand, pd = [], []
    cur = last
    for i in range(gamma):
        logits, d_cache = llama_decode_step_ragged(draft_params, cur, d_cache, base_pos + i,
                                                   cfg_d)
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = _warp_probs(logits, sc)
            nxt = sample_from(probs, generator)
            pd.append(probs)
        cand.append(nxt)
        cur = nxt[:, None]
    # one more draft step writes the last candidate's K/V at base_pos + gamma:
    # after a full accept the next round starts past it, and a hole there
    # would lower every later round's acceptance
    _, d_cache = llama_decode_step_ragged(draft_params, cur, d_cache, base_pos + gamma, cfg_d)
    cand = torch.stack(cand, dim=1)  # [B, gamma]

    window = torch.cat([last, cand], dim=1)  # [B, gamma + 1]
    t_logits, t_cache = llama_forward_window_ragged(target_params, window, t_cache, base_pos,
                                                    cfg_t)
    if greedy:
        t_pred = torch.argmax(t_logits, dim=-1)  # [B, gamma + 1]
        disagree = torch.cat([cand != t_pred[:, :gamma],
                              torch.ones(b, 1, dtype=torch.bool, device=cand.device)], dim=1)
        n_accept = torch.argmax(disagree.to(torch.int8), dim=1)
        corrected = torch.gather(t_pred, 1, n_accept[:, None])[:, 0]
    else:
        n_accept, corrected = speculative_accept(cand, torch.stack(pd, dim=1),
                                                 _warp_probs(t_logits, sc), generator)
    idx = torch.arange(gamma + 1, device=cand.device)
    padded = torch.cat([cand, torch.zeros_like(cand[:, :1])], dim=1)
    emit = torch.where(idx[None, :] < n_accept[:, None], padded, corrected[:, None])
    return emit, n_accept, t_cache, d_cache


@torch.inference_mode()
def speculative_generate_batched(target_params: Dict, draft_params: Dict, prompt: torch.Tensor,
                                 t_cache: Dict, d_cache: Dict, cfg_t: LlamaConfig,
                                 cfg_d: LlamaConfig, max_new_tokens: int,
                                 generator: Optional[torch.Generator] = None, gamma: int = 4,
                                 sc: SampleConfig = SampleConfig(greedy=False),
                                 greedy: bool = False, device=None) -> Tuple[torch.Tensor, Dict]:
    """Batched speculative decoding with per-sequence accept lengths and
    positional rollback.  ``greedy=True`` reproduces each sequence's own
    greedy decode; otherwise each emitted token is distributed as
    target-only sampling.

    Caches need >= S_prompt + max_new_tokens + gamma + 1 slots.  A sequence
    that has finished keeps running rounds (its windows clamped into the
    cache) until every sequence has.  Returns (tokens [B, max_new_tokens],
    telemetry)."""
    device = resolve_device(device)
    check_on(target_params["embed"], device, "the target model")
    check_on(draft_params["embed"], device, "the draft model")
    check_on(t_cache["k"], device, "the target KV cache")
    _check_vocab(cfg_t, cfg_d)
    if generator is None:
        generator = default_generator(device)
    prompt = prompt.to(device=device, dtype=torch.int64)
    b, s_prompt = prompt.shape
    t_logits, t_cache = llama_prefill(target_params, prompt, t_cache, cfg_t)
    _, d_cache = llama_prefill(draft_params, prompt, d_cache, cfg_d)
    last_logits = t_logits[:, -1, :]
    first = (torch.argmax(last_logits, dim=-1) if greedy
             else sample_from(_warp_probs(last_logits, sc), generator))

    width = max_new_tokens + gamma + 1
    out = torch.zeros(b, width, dtype=torch.int64, device=device)
    out[:, 0] = first
    n_done = torch.ones(b, dtype=torch.int64, device=device)
    rounds = torch.zeros(b, dtype=torch.int64, device=device)
    accepted = torch.zeros(b, dtype=torch.int64, device=device)
    rows = torch.arange(b, device=device)
    steps = torch.arange(gamma + 1, device=device)
    while bool((n_done < max_new_tokens).any()):
        last = out[rows, n_done - 1][:, None]
        base_pos = s_prompt + n_done - 1
        emit, n_accept, t_cache, d_cache = spec_round(
            target_params, draft_params, last, t_cache, d_cache, base_pos, cfg_t, cfg_d,
            gamma, sc, greedy, generator)
        active = n_done < max_new_tokens
        emitted = torch.where(active, n_accept + 1, 0)
        # sequence b's emitted tokens at its own offset; finished ones write nothing
        idx = (n_done[:, None] + steps).clamp_max(width - 1)
        out.scatter_(1, idx, torch.where(steps < emitted[:, None], emit, out.gather(1, idx)))
        n_done = n_done + emitted
        rounds = rounds + active.to(torch.int64)
        accepted = accepted + torch.where(active, n_accept, 0)
    per_seq = accepted.to(torch.float32) / rounds.clamp_min(1).to(torch.float32)
    telemetry = {"rounds": rounds.max(), "rounds_per_seq": rounds,
                 "accepted_per_seq": accepted, "mean_accept_length": per_seq.mean()}
    return out[:, :max_new_tokens], telemetry


def _single_seq_telemetry(tel: Dict) -> Dict:
    return {"rounds": tel["rounds"], "accepted_total": tel["accepted_per_seq"][0],
            "mean_accept_length": tel["mean_accept_length"]}


def speculative_generate(target_params: Dict, draft_params: Dict, prompt: torch.Tensor,
                         t_cache: Dict, d_cache: Dict, cfg_t: LlamaConfig, cfg_d: LlamaConfig,
                         max_new_tokens: int, gamma: int = 4, device=None):
    """Greedy speculative decoding of one sequence (B = 1): equals the
    target's own greedy decode.  Returns (tokens [1, max_new_tokens],
    telemetry {rounds, accepted_total, mean_accept_length})."""
    if prompt.shape[0] != 1:
        raise ValueError("use speculative_generate_batched for B > 1")
    out, tel = speculative_generate_batched(
        target_params, draft_params, prompt, t_cache, d_cache, cfg_t, cfg_d, max_new_tokens,
        gamma=gamma, greedy=True, device=device)
    return out, _single_seq_telemetry(tel)


def speculative_generate_sampled(target_params: Dict, draft_params: Dict, prompt: torch.Tensor,
                                 t_cache: Dict, d_cache: Dict, cfg_t: LlamaConfig,
                                 cfg_d: LlamaConfig, max_new_tokens: int,
                                 generator: Optional[torch.Generator] = None, gamma: int = 4,
                                 sc: SampleConfig = SampleConfig(greedy=False), device=None):
    """Speculative sampling of one sequence (B = 1): distributed as sampling
    the target alone."""
    if prompt.shape[0] != 1:
        raise ValueError("use speculative_generate_batched for B > 1")
    out, tel = speculative_generate_batched(
        target_params, draft_params, prompt, t_cache, d_cache, cfg_t, cfg_d, max_new_tokens,
        generator, gamma=gamma, sc=sc, greedy=False, device=device)
    return out, _single_seq_telemetry(tel)
