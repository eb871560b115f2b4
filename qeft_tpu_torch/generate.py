"""Generation: prefill, then a plain Python loop of decode steps over the
static KV cache.  Counterpart of ``qeft_tpu/generate.py``: greedy and
temperature / top-k / top-p sampling (`SampleConfig`, `warp_logits`), and
the EOS variant.  The loop never waits for the device, except that the EOS
variant reads once a step whether every sequence has finished; tokens stay
on the device until the caller reads them.

Randomness comes from an explicit ``torch.Generator`` on the device.  Its
streams differ from JAX's keys, so sampled outputs match the JAX package in
distribution, not token for token; greedy outputs match exactly."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.models.api import ModelApi, get_model_api


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0  # 0 = no top-k
    top_p: float = 1.0  # 1.0 = no nucleus filtering


def warp_logits(logits: torch.Tensor, sc: SampleConfig) -> torch.Tensor:
    """The temperature / top-k / top-p logits warper (HF semantics), in f32:
    the one definition plain sampling and both sides of speculative
    sampling share.  Top-p keeps the smallest descending prefix whose mass
    reaches ``top_p`` (the token that crosses the threshold is kept)."""
    logits = logits.to(torch.float32) / sc.temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if sc.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -sc.top_k][..., None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < sc.top_p  # mass before this token
        n_keep = keep.sum(dim=-1, keepdim=True).clamp_min(1)
        cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def sample_from(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``probs`` [..., V] -> int64 [...]."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  sc: SampleConfig) -> torch.Tensor:
    """logits [..., V] -> int64 tokens [...]; greedy never draws."""
    if sc.greedy:
        return torch.argmax(logits, dim=-1)
    return sample_from(torch.softmax(warp_logits(logits, sc), dim=-1), generator)


def default_generator(device, seed: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@torch.inference_mode()
def generate(params: Dict, prompt: torch.Tensor, cache: Dict, cfg, max_new_tokens: int,
             sc: SampleConfig = SampleConfig(), generator: Optional[torch.Generator] = None,
             api: Optional[ModelApi] = None, eos_id: Optional[int] = None,
             device=None) -> Tuple[torch.Tensor, Dict]:
    """prompt [B, S_prompt] -> (tokens [B, max_new_tokens], cache).

    The first token comes from the prefill's last logits; token ``i`` then
    from the decode step at position ``S_prompt + i - 1``.  With ``eos_id``
    the loop stops once every sequence has emitted it, and finished
    sequences are padded with it.  ``generator`` (default: seed 0 on the
    device) draws the sampled tokens."""
    device = resolve_device(device)
    check_on(params["embed"], device, "the model")
    check_on(cache["k"], device, "the KV cache")
    api = api or get_model_api("llama")
    if generator is None and not sc.greedy:
        generator = default_generator(device)
    prompt = prompt.to(device=device, dtype=torch.int64)
    b, s_prompt = prompt.shape
    logits, cache = api.prefill(params, prompt, cache, cfg)
    tokens = torch.full((b, max_new_tokens), -1 if eos_id is None else eos_id,
                        dtype=torch.int64, device=device)
    tokens[:, 0] = _sample_token(logits[:, -1, :], generator, sc)
    done = tokens[:, 0] == eos_id if eos_id is not None else None
    for i in range(1, max_new_tokens):
        if done is not None and bool(done.all()):
            break
        logits, cache = api.decode_step(params, tokens[:, i - 1: i], cache,
                                        s_prompt + i - 1, cfg)
        nxt = _sample_token(logits, generator, sc)
        if done is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        tokens[:, i] = nxt
    return tokens, cache
