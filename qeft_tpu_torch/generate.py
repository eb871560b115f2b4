"""Generation: prefill, then the decode loop over the static KV cache.
Counterpart of ``qeft_tpu/generate.py``: greedy and temperature / top-k /
top-p sampling (`SampleConfig`, `warp_logits`), and the EOS variant.

On the card, without ``eos_id``, the decode loop runs as one CUDA graph, as
the JAX package runs it as one compiled program (``_decode_loop``, a
``lax.fori_loop`` under ``jit``): the prefill runs eagerly (JAX's separate
``_prefill_first``); the decode step (`DecodeLoop.step`) is replayed for
every further token.  The step reads the current token and its position
from device buffers and advances both itself, so nothing returns to the
host between tokens.  The captured step is kept, one a device, for the next
call whose step would read the same memory (`step_key`: the same tensors of
the model and the cache, the same shapes and settings), as a server that
reuses one cache calls it; such a call only resets the loop's buffers and
replays.  Any other call releases the kept step, runs the first step
eagerly (the warm-up a capture needs), captures the step and keeps it.  The
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

import collections
import dataclasses
import os
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from qeft_tpu_torch import env
from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.models.api import ModelApi, get_model_api
from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.utils.profiling import span


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
    ``out`` [B, T] -- and `step`, which runs the decode step at that
    position, samples, writes the token into ``out`` and advances all
    three.  `step` reads no device value on the host, so `capture` records
    it as one CUDA graph; replaying it is the decode loop, and `reset`
    starts it again at another request's first token and position."""

    def __init__(self, api: ModelApi, params: Dict, cache: Dict, cfg, out: torch.Tensor,
                 pos: int, sc: SampleConfig, generator: Optional[torch.Generator]):
        self.decode_step = api.decode_step
        self.params, self.cache, self.cfg = params, cache, cfg
        self.out, self.sc, self.generator = out, sc, generator
        self.cur = out[:, :1].clone()
        self.pos = torch.full((), pos, dtype=torch.int64, device=out.device)
        self.idx = torch.ones(1, dtype=torch.int64, device=out.device)

    def reset(self, tokens: torch.Tensor, pos: int) -> None:
        """Start at token 1 of ``tokens`` [B, n], whose token 0 stands at
        position ``pos``: three writes on the device, no host read."""
        self.cur.copy_(tokens[:, :1])
        self.pos.fill_(pos)
        self.idx.fill_(1)

    def step(self) -> None:
        logits, _ = self.decode_step(self.params, self.cur, self.cache, self.pos, self.cfg)
        nxt = _sample_token(logits, self.generator, self.sc)[:, None]
        self.out.index_copy_(1, self.idx, nxt)
        self.cur.copy_(nxt)
        self.pos += 1
        self.idx += 1

    def capture(self, stream: torch.cuda.Stream) -> cuda_lib.Graph:
        """`step` as a CUDA graph on ``stream``, where it has run before."""
        gens = () if self.generator is None else (self.generator,)
        return cuda_lib.Graph(self.step, stream, generators=gens)


# the decode loops' side stream of each device, by device index
_side_streams: Dict[int, torch.cuda.Stream] = {}
# the kept captured step of each device, by device index: one at most, so
# that what a device holds for it is one step's graph pool.  Like the side
# stream, it serves one `generate` at a time on a device.
_kept: Dict[int, "_Kept"] = {}
# decode steps captured and kept steps reused by `generate`, counted as
# `cuda_lib.launches` is
graph_counts: collections.Counter = collections.Counter()


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the decode loops run and are captured on, one a device
    for the process: PyTorch keeps a cuBLAS workspace (32 MiB on an H100)
    for every stream a matmul has run on, so a fresh stream a request would
    hold one more workspace after every request."""
    index = _device_index(device)
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


def _leaves(tree, tensors: List[torch.Tensor], plain: List) -> None:
    """The tensors of ``tree`` (dicts, lists, tuples and dataclasses of
    them) into ``tensors``, in order; its keys and every other value into
    ``plain``."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            plain.append(k)
            _leaves(v, tensors, plain)
    elif isinstance(tree, (list, tuple)):
        plain.append(len(tree))
        for v in tree:
            _leaves(v, tensors, plain)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        plain.append(type(tree))
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), tensors, plain)
    else:
        plain.append(tree)


@dataclasses.dataclass(frozen=True)
class StepKey:
    """What a captured decode step reads, as far as the host can tell:
    ``settings`` compared by value (the decode step function, the config,
    the sampling, the device, the kernel-path selectors, the trees' keys
    and plain values, the tensors' shapes and addresses), ``tensors`` (of
    the model and the cache) and ``generator`` by identity."""
    settings: tuple
    tensors: tuple
    generator: Optional[torch.Generator]

    def hits(self, kept: tuple) -> bool:
        """Whether a step captured under ``kept`` (`kept_form` of a key)
        reads what this key names: the same settings and the same live
        objects.  A dead reference misses."""
        settings, refs, generator = kept
        return (settings == self.settings and generator is self.generator
                and len(refs) == len(self.tensors)
                and all(r() is t for r, t in zip(refs, self.tensors)))

    def kept_form(self) -> tuple:
        """(settings, weak references to the tensors, the generator): what
        a kept step holds, so that it keeps no model or cache alive.  The
        generator is held as it is: a CUDA ``torch.Generator`` takes no weak
        reference, and the graph holds its state anyway."""
        return self.settings, tuple(weakref.ref(t) for t in self.tensors), self.generator


def step_key(api: ModelApi, params: Dict, cache: Dict, cfg, batch: int, sc: SampleConfig,
             generator: Optional[torch.Generator], device: torch.device) -> StepKey:
    """The `StepKey` of a decode step of ``api`` over ``params`` and
    ``cache`` at ``batch`` rows.  ``api`` enters through its decode step
    alone, so an api with another prefill (``dataclasses.replace(api,
    prefill=...)``) keys the same step."""
    tensors: List[torch.Tensor] = []
    plain: List = []
    _leaves((params, cache), tensors, plain)
    selectors = (env.STACKED_GEMV, env.FUSED_DECODE, env.PALLAS, env.PALLAS_ATTN,
                 env.GEMV_F32W, os.environ.get("QEFT_ATTN_STACKED"))
    settings = (api.decode_step, cfg, batch, sc, device, selectors, tuple(plain),
                tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors))
    return StepKey(settings, tuple(tensors), generator)


@dataclasses.dataclass
class _Kept:
    key: tuple  # `StepKey.kept_form`
    loop: DecodeLoop  # its buffers only: the model and the cache let go
    graph: cuda_lib.Graph


def _release(index: int) -> None:
    """Drop the kept step of device ``index``, once its stream is done."""
    kept = _kept.pop(index, None)
    if kept is not None:
        kept.graph.stream.synchronize()


def _graph_loop(api, params, cache, cfg, tokens, s_prompt, sc, generator) -> None:
    """Tokens 1.. of ``tokens`` on a side stream, from the kept captured
    step where `step_key` hits it: the loop's buffers reset, then ``n - 1``
    replays.  Otherwise the kept step is released, a new loop runs the
    first step eagerly, captures it, replays it ``n - 2`` times and is kept
    (also at ``n == 2``, for the next call).  The loop writes its own
    buffer [B, slots]; its tokens 1.. are copied into ``tokens`` after the
    replays.  The positions are range-checked here, once.  Returns when the
    replays are done."""
    b, n = tokens.shape
    slots = cache["k"].shape[3]
    if s_prompt + n - 1 > slots:
        raise IndexError(f"{s_prompt} + {n} tokens do not fit a {slots}-slot cache")
    device = tokens.device
    index = _device_index(device)
    key = step_key(api, params, cache, cfg, b, sc, generator, device)
    caller = torch.cuda.current_stream(device)
    stream = _side_stream(device)
    kept = _kept.get(index)
    if kept is not None and key.hits(kept.key):
        with span("qeft.generate.first_step"):
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                kept.loop.reset(tokens, s_prompt)
        graph_counts["reused"] += 1
        loop, graph, replays = kept.loop, kept.graph, n - 1
    else:
        _release(index)
        with span("qeft.generate.first_step"):
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                out = tokens.new_empty((b, slots))
                out[:, :1] = tokens[:, :1]
                loop = DecodeLoop(api, params, cache, cfg, out, s_prompt, sc, generator)
                loop.step()
        with span("qeft.generate.capture"):
            graph = loop.capture(stream)
        loop.params = loop.cache = None  # held weakly, by the key
        _kept[index] = _Kept(key.kept_form(), loop, graph)
        graph_counts["captured"] += 1
        replays = n - 2
    with span("qeft.generate.replay"):
        graph.replay(replays)
        with torch.cuda.stream(stream):
            tokens[:, 1:].copy_(loop.out[:, 1:n])
    with span("qeft.generate.wait"):
        caller.wait_stream(stream)
        stream.synchronize()


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
    with span("qeft.generate.prefill"):
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
