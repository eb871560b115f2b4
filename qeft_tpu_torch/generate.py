"""Generation: prefill, then the decode loop over the static KV cache.
Counterpart of ``qeft_tpu/generate.py``: greedy and temperature / top-k /
top-p sampling (`SampleConfig`, `warp_logits`), and the EOS variant.

On the card, without ``eos_id``, the decode loop runs as one CUDA graph, as
the JAX package runs it as one compiled program (``_decode_loop``, a
``lax.fori_loop`` under ``jit``): the prefill runs eagerly (JAX's separate
``_prefill_first``); the first decode step runs eagerly through the same
`DecodeLoop.step` the graph captures, which is the warm-up a capture needs;
then that step is captured once and replayed for every further token.  The
step reads the current token and its position from device buffers and
advances both itself, so nothing returns to the host between tokens.  The
EOS variant (JAX's ``while_loop``, which exits early), the CPU and
``graph=False`` run a Python loop of the same steps at host-int positions,
which never waits for the device except that the EOS variant reads once a
step whether every sequence has finished.  Tokens stay on the device until
the caller reads them.

Randomness comes from an explicit ``torch.Generator`` on the device,
registered with the graph so that each replay draws new numbers.  Its
streams differ from JAX's keys, so sampled outputs match the JAX package in
distribution, not token for token; greedy outputs match exactly."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.models.api import ModelApi, get_model_api
from qeft_tpu_torch.ops import cuda_lib


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
    if sc.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -sc.top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < sc.top_p  # mass before this token
        n_keep = keep.sum(dim=-1, keepdim=True).clamp_min(1)
        cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_from(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``probs`` [..., V] -> int64 [...]: the method
    ``torch.multinomial`` uses for one draw (the argmax of p / E, E ~ Exp(1)),
    which gives its numbers from the same generator, without its checks of
    the probabilities, which read the device from the host (and cannot be
    captured in a CUDA graph)."""
    noise = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / noise).argmax(dim=-1)


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


class DecodeLoop:
    """The decode loop's state on the device -- the current token [B, 1],
    its position (an int64 scalar) and the index of the next token in
    ``tokens`` [B, T] -- and `step`, which runs the decode step at that
    position, samples, writes the token and advances all three.  `step`
    reads no device value on the host, so `capture` records it as one CUDA
    graph; replaying it is the decode loop."""

    def __init__(self, api: ModelApi, params: Dict, cache: Dict, cfg, tokens: torch.Tensor,
                 pos: int, sc: SampleConfig, generator: Optional[torch.Generator]):
        self.api, self.params, self.cache, self.cfg = api, params, cache, cfg
        self.tokens, self.sc, self.generator = tokens, sc, generator
        self.cur = tokens[:, :1].clone()
        self.pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
        self.idx = torch.ones(1, dtype=torch.int64, device=tokens.device)

    def step(self) -> None:
        logits, _ = self.api.decode_step(self.params, self.cur, self.cache, self.pos, self.cfg)
        nxt = _sample_token(logits, self.generator, self.sc)[:, None]
        self.tokens.index_copy_(1, self.idx, nxt)
        self.cur.copy_(nxt)
        self.pos += 1
        self.idx += 1

    def capture(self, stream: torch.cuda.Stream) -> cuda_lib.Graph:
        """`step` as a CUDA graph on ``stream``, where it has run before."""
        gens = () if self.generator is None else (self.generator,)
        return cuda_lib.Graph(self.step, stream, generators=gens)


def _graph_loop(api, params, cache, cfg, tokens, s_prompt, sc, generator) -> None:
    """Tokens 1.. of ``tokens``: the first decode step eagerly on a side
    stream, then the step captured there and replayed for the rest.  The
    positions are range-checked here, once.  Returns when the replays are
    done: the graph and its memory pool are released after them."""
    n = tokens.shape[1]
    if s_prompt + n - 1 > cache["k"].shape[3]:
        raise IndexError(f"{s_prompt} + {n} tokens do not fit a {cache['k'].shape[3]}-slot cache")
    loop = DecodeLoop(api, params, cache, cfg, tokens, s_prompt, sc, generator)
    caller = torch.cuda.current_stream(tokens.device)
    stream = torch.cuda.Stream(tokens.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        loop.step()
    graph = loop.capture(stream) if n > 2 else None
    if graph is not None:
        graph.replay(n - 2)
    caller.wait_stream(stream)
    stream.synchronize()  # before `graph` goes


@torch.inference_mode()
def generate(params: Dict, prompt: torch.Tensor, cache: Dict, cfg, max_new_tokens: int,
             sc: SampleConfig = SampleConfig(), generator: Optional[torch.Generator] = None,
             api: Optional[ModelApi] = None, eos_id: Optional[int] = None,
             device=None, graph: bool = True) -> Tuple[torch.Tensor, Dict]:
    """prompt [B, S_prompt] -> (tokens [B, max_new_tokens], cache).

    The first token comes from the prefill's last logits; token ``i`` then
    from the decode step at position ``S_prompt + i - 1``.  With ``eos_id``
    the loop stops once every sequence has emitted it, and finished
    sequences are padded with it.  ``generator`` (default: seed 0 on the
    device) draws the sampled tokens.  On the card without ``eos_id`` the
    decode loop is one captured CUDA graph unless ``graph=False`` (the eager
    loop, as on the CPU)."""
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
    if graph and eos_id is None and device.type == "cuda" and max_new_tokens > 1:
        _graph_loop(api, params, cache, cfg, tokens, s_prompt, sc, generator)
        return tokens, cache
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


def generate_simple(params: Dict, prompt: torch.Tensor, cfg, max_new_tokens: int,
                    max_len: Optional[int] = None, sc: SampleConfig = SampleConfig(),
                    cache_dtype=None, api: Optional[ModelApi] = None,
                    device=None) -> torch.Tensor:
    """`generate` with the cache allocated for the caller
    (``qeft_tpu/generate.py::generate_simple``): ``max_len`` slots (default
    prompt + new tokens) of ``cache_dtype`` (default the config's).  Runs on
    the card unless ``device="cpu"`` is given.  -> tokens [B,
    max_new_tokens]."""
    device = resolve_device(device)
    api = api or get_model_api("llama")
    b, s = prompt.shape
    cache = api.init_cache(cfg, b, max_len or (s + max_new_tokens), dtype=cache_dtype,
                           device=device)
    return generate(params, prompt, cache, cfg, max_new_tokens, sc, api=api, device=device)[0]
