"""Continuous-batching serving over the ragged decode step, with or without
speculative decoding.  Counterpart of the single-chip part of
``qeft_tpu/serving.py``.

Host side: a queue and a slot map.  Requests join a fixed-size batch as
slots free up; each sequence decodes at its own position in its own slot of
one KV cache; finished sequences (EOS, max tokens or an exhausted slot)
retire and their slots are refilled.  Device side: the ragged window
forward over the whole batch each tick (`_decode_batch`, or `_decode_burst`
for ``burst`` ticks between host reads), and per-request prefill into a
slot through a view of the cache, so every write lands in the cache
itself.

On a tensor-parallel mesh (``Engine(mesh=...)``) every rank runs the same
host loop over the same request stream, its device programs the tp
layouts of `parallel.tp_forward` on its shard of the weights and of the kv
heads; `MultiHostEngine` serves replicas side by side, each request routed
to one of them by its id.

Not ported: the JAX package's power-of-two padding of prefill windows (it
bounds XLA compilations; PyTorch runs eagerly and the outputs are the same
without it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qeft_tpu_torch.device import check_on, resolve_device
from qeft_tpu_torch.generate import SampleConfig, _sample_token, default_generator
from qeft_tpu_torch.models.llama import (
    LlamaConfig,
    init_kv_cache,
    llama_decode_step_ragged,
    llama_forward_window,
)
from qeft_tpu_torch.speculative import _check_vocab, spec_round


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # [S]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _slot_view(cache: Dict, slot: int) -> Dict:
    """Batch slot ``slot`` of every cache entry, as views: writes through them
    land in the cache, and each layer of a view is contiguous."""
    return {name: leaf[:, slot: slot + 1] for name, leaf in cache.items()}


def _prefill_window_into_slot(params: Dict, window: torch.Tensor, cache: Dict, slot: int,
                              pos: int, cfg: LlamaConfig, last_idx: int) -> torch.Tensor:
    """A window [1, W] of one request into slot ``slot`` of the whole cache
    at offset ``pos``; returns the logits [1, V] at window index
    ``last_idx``."""
    logits, _ = llama_forward_window(params, window, _slot_view(cache, slot), pos, cfg)
    return logits[:, last_idx, :]


def _tp_prefill_window_into_slot(params: Dict, window: torch.Tensor, cache: Dict, slot: int,
                                 pos: int, cfg: LlamaConfig, mesh, last_idx: int) -> torch.Tensor:
    """`_prefill_window_into_slot` on the tp mesh: the window through the
    local shards into this rank's kv heads of the slot; the logits at
    ``last_idx`` gathered over ``tp``."""
    from qeft_tpu_torch.parallel.tp_forward import _tp_window_body

    logits = _tp_window_body(params, window, _slot_view(cache, slot), pos, cfg, mesh)
    return mesh.all_gather(logits[:, last_idx, :], "tp", dim=-1)


def _prefill_into_slot(params: Dict, prompt: torch.Tensor, cache: Dict, slot: int,
                       cfg: LlamaConfig, chunk: int = 0, mesh=None) -> torch.Tensor:
    """Prefill of one request [1, S] into its slot.  Unchunked: one window
    of the whole prompt.  Chunked (``chunk`` set): windows of ``chunk``
    tokens, the ragged tail left-overlapping to full width (it rewrites a
    few cached positions with the same values).  Returns the last prompt
    position's logits [1, V]."""
    s = prompt.shape[1]

    def window(w, start, last_idx):
        if mesh is None:
            return _prefill_window_into_slot(params, w, cache, slot, start, cfg, last_idx)
        return _tp_prefill_window_into_slot(params, w, cache, slot, start, cfg, mesh, last_idx)

    if not chunk or s <= chunk:
        return window(prompt, 0, s - 1)
    last = None
    for start in range(0, s, chunk):
        start = min(start, s - chunk)
        last = window(prompt[:, start: start + chunk], start, chunk - 1)
    return last


def _decode_batch(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                  cfg: LlamaConfig, sc: SampleConfig, generator) -> torch.Tensor:
    """One ragged decode tick over the batch: tokens [B, 1] at ``pos`` [B]
    -> the next tokens [B]."""
    logits, _ = llama_decode_step_ragged(params, tokens, cache, pos, cfg)
    return _sample_token(logits, generator, sc)


def _tp_decode_batch(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                     cfg: LlamaConfig, mesh, sc: SampleConfig, generator) -> torch.Tensor:
    """`_decode_batch` on the tp mesh: every rank samples the same token from
    the gathered logits with its generator, seeded alike."""
    from qeft_tpu_torch.parallel.tp_forward import tp_decode_step_ragged

    logits, _ = tp_decode_step_ragged(params, tokens, cache, pos, cfg, mesh)
    return _sample_token(logits, generator, sc)


def _tp_decode_burst(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                     cfg: LlamaConfig, mesh, sc: SampleConfig, n: int, generator) -> torch.Tensor:
    from qeft_tpu_torch.parallel.tp_forward import tp_decode_burst

    return tp_decode_burst(params, tokens, cache, pos, cfg, mesh, n, sc, generator)


def _decode_burst(params: Dict, tokens: torch.Tensor, cache: Dict, pos: torch.Tensor,
                  cfg: LlamaConfig, sc: SampleConfig, n: int, generator) -> torch.Tensor:
    """``n`` ragged decode ticks with no host read between them -> [B, n].
    Slots that finish mid-burst keep decoding; the host drops their surplus
    tokens at harvest."""
    out = torch.empty(tokens.shape[0], n, dtype=torch.int64, device=tokens.device)
    for i in range(n):
        nxt = _decode_batch(params, tokens, cache, pos + i, cfg, sc, generator)
        out[:, i] = nxt
        tokens = nxt[:, None]
    return out


class Engine:
    """Continuous-batching engine on one GPU (or the CPU, when named).

    Greedy by default; ``sample_config`` samples (one config for the engine,
    draws from a generator seeded with ``rng_seed``).  ``burst`` ticks run
    between host reads.

    ``mesh``: a `parallel.mesh.Mesh` with a ``tp`` axis; ``params`` must
    then come from `parallel.tp_forward.tp_shard_packed_params`, the cache
    holds this rank's kv heads, and the engine runs on the mesh's device.
    Every rank of the tp group runs the same engine over the same requests
    and gets the same tokens."""

    def __init__(self, params: Dict, cfg: LlamaConfig, max_batch: int = 8,
                 max_len: int = 2048, eos_id: Optional[int] = None,
                 cache_dtype=torch.bfloat16,
                 sample_config: SampleConfig = SampleConfig(greedy=True), rng_seed: int = 0,
                 prefill_chunk: int = 0, burst: int = 1, mesh=None, device=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        check_on(params["embed"], self.device, "the model")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        # 8-aligned slot length, as the JAX engine rounds it (decides when a
        # slot is exhausted)
        max_len = -(-max_len // 8) * 8
        self.max_len = max_len
        self.eos_id = eos_id
        self.sc = sample_config
        self.generator = default_generator(self.device, rng_seed)
        self.prefill_chunk = prefill_chunk
        self.burst = burst
        cache_cfg = cfg
        if mesh is not None:
            from qeft_tpu_torch.parallel.tp_forward import _local_cfg

            cache_cfg = _local_cfg(cfg, mesh.shape["tp"])
        self.cache = init_kv_cache(cache_cfg, max_batch, max_len, dtype=cache_dtype,
                                   device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros((max_batch,), np.int64)
        self.cur_token = np.zeros((max_batch, 1), np.int64)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.ticks = 0  # device dispatches of `step` (a burst counts `burst`)
        # slots retire when pos crosses max_len - slack (spec ticks write up
        # to gamma tokens past the accepted point)
        self._retire_slack = 1

    def submit(self, req: Request):
        if len(req.prompt) + 1 > self.max_len - self._retire_slack:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit a max_len={self.max_len} "
                f"cache (retire slack {self._retire_slack}); raise max_len or truncate")
        self.queue.append(req)

    def _prompt(self, req: Request) -> torch.Tensor:
        return torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.int64,
                               device=self.device)

    def _prefill_request(self, req: Request, slot: int) -> torch.Tensor:
        """Prefill one admitted request into its slot; returns its last
        logits.  SpecEngine adds the draft cache's prefill."""
        return _prefill_into_slot(self.params, self._prompt(req), self.cache, slot, self.cfg,
                                  chunk=self.prefill_chunk, mesh=self.mesh)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                last_logits = self._prefill_request(req, slot)
                first = int(_sample_token(last_logits, self.generator, self.sc)[0])
                req.output.append(first)
                self.slots[slot] = req
                self.pos[slot] = len(req.prompt)
                self.cur_token[slot, 0] = first
                self._maybe_finish(slot)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if (len(req.output) >= req.max_new_tokens
                or self.pos[slot] >= self.max_len - self._retire_slack  # slot exhausted
                or (self.eos_id is not None and req.output and req.output[-1] == self.eos_id)):
            req.done = True
            self.finished.append(req)
            self.slots[slot] = None
            self.pos[slot] = 0

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine tick: admit waiting requests, decode ``burst`` tokens
        for every active slot between host reads, retire finished
        sequences.  A slot that finishes mid-burst holds its slot until the
        burst ends; its surplus tokens are dropped and its surplus K/V
        writes are masked, then overwritten by the next prefill."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        tokens, pos = self._device(self.cur_token), self._device(self.pos)
        if self.burst > 1:
            if self.mesh is not None:
                out = _tp_decode_burst(self.params, tokens, self.cache, pos, self.cfg, self.mesh,
                                       self.sc, self.burst, self.generator)
            else:
                out = _decode_burst(self.params, tokens, self.cache, pos, self.cfg, self.sc,
                                    self.burst, self.generator)
            out = out.cpu().numpy()
            self.ticks += self.burst
            for slot in active:
                req = self.slots[slot]
                room = self.max_len - self._retire_slack - self.pos[slot]
                n_valid = min(self.burst, req.max_new_tokens - len(req.output), room)
                for t in out[slot, :n_valid]:
                    req.output.append(int(t))
                    self.pos[slot] += 1
                    if self.eos_id is not None and int(t) == self.eos_id:
                        break
                self.cur_token[slot, 0] = req.output[-1]
                self._maybe_finish(slot)
            return True
        if self.mesh is not None:
            nxt = _tp_decode_batch(self.params, tokens, self.cache, pos, self.cfg, self.mesh,
                                   self.sc, self.generator)
        else:
            nxt = _decode_batch(self.params, tokens, self.cache, pos, self.cfg, self.sc,
                                self.generator)
        nxt = nxt.cpu().numpy()
        self.ticks += 1
        for slot in active:
            req = self.slots[slot]
            req.output.append(int(nxt[slot]))
            self.pos[slot] += 1
            self.cur_token[slot, 0] = int(nxt[slot])
            self._maybe_finish(slot)
        return True

    def run(self, max_ticks: int = 100000) -> List[Request]:
        ticks = 0
        while (self.queue or any(s is not None for s in self.slots)) and ticks < max_ticks:
            progressed = self.step()
            ticks += 1
            if not progressed and not self.queue:
                break
        return self.finished


def measure_engine_throughput(params: Dict, cfg: LlamaConfig, *, slots: int = 8,
                              burst: int = 16, requests: int = 16, ctx: int = 64,
                              gen: int = 128, reps: int = 2, mesh=None,
                              sample_config: SampleConfig = SampleConfig(greedy=True),
                              seed: int = 0, device=None) -> float:
    """Served tokens/s of a fresh Engine over ``requests`` random prompts of
    ``ctx`` tokens, ``gen`` new tokens each: the one definition of the
    serving benchmark.  Engine construction, admission and prefill are
    inside the timed region; the best of ``reps`` after one warm-up serve.
    On the GPU each serve ends in a device synchronisation.  With ``mesh``
    (a tp mesh, ``params`` its shards) every rank of it calls this alike."""
    device = mesh.device if mesh is not None else resolve_device(device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=ctx) for _ in range(requests)]

    def serve():
        eng = Engine(params, cfg, max_batch=slots, max_len=ctx + gen + 1,
                     sample_config=sample_config, burst=burst, mesh=mesh, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt=p, max_new_tokens=gen))
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return done

    serve()  # warm-up: kernel build and first launches
    best, done = float("inf"), None
    for _ in range(reps):
        tick = time.perf_counter()
        done = serve()
        best = min(best, time.perf_counter() - tick)
    return sum(len(r.output) for r in done) / best


class MultiHostEngine:
    """Continuous batching over replicas: data-parallel engines side by side,
    tensor parallelism inside each (JAX: one replica a host).  A replica is
    a ``dp`` coordinate of ``mesh`` (its ranks form one tp engine), or,
    without a mesh, one rank of the world.  Requests are routed by
    ``request_id % replicas``, a pure function every rank evaluates alike,
    so no coordinator is needed; decode never crosses replicas.

    Every rank calls `submit` with the same global request stream and keeps
    its replica's share; `run` serves it; `stats` sums the replicas'
    totals with one all-reduce over the world.  In a single process it is a
    plain Engine.  ``engine_kw`` go to the engine (``device`` among them);
    ``mesh`` reaches it only for a tp axis larger than one."""

    def __init__(self, params: Dict, cfg: LlamaConfig, engine_cls=Engine, mesh=None,
                 **engine_kw):
        import torch.distributed as dist

        if mesh is not None:
            self.process_index, self.process_count = mesh.index("dp"), mesh.shape.get("dp", 1)
            self.leader = mesh.index("tp") == 0  # counts its replica once in `stats`
            if mesh.shape.get("tp", 1) > 1:
                engine_kw["mesh"] = mesh
            else:
                engine_kw.setdefault("device", mesh.device)
        elif dist.is_initialized():
            self.process_index, self.process_count = dist.get_rank(), dist.get_world_size()
            self.leader = True
        else:
            self.process_index, self.process_count, self.leader = 0, 1, True
        self.engine = engine_cls(params, cfg, **engine_kw)
        self.routed = 0  # global requests seen (routing sanity)

    def route(self, request_id: int) -> int:
        """The replica that owns a request."""
        return request_id % self.process_count

    def submit(self, req: Request) -> bool:
        """Offer a request of the global stream; True if this replica took it."""
        self.routed += 1
        if self.route(req.request_id) != self.process_index:
            return False
        self.engine.submit(req)
        return True

    def run(self, max_ticks: int = 100000) -> List[Request]:
        """Serve this replica's share to completion."""
        return self.engine.run(max_ticks=max_ticks)

    def stats(self) -> Dict[str, int]:
        """Totals over every replica (one all-reduce over the world at
        reporting time) beside this replica's own."""
        import torch.distributed as dist

        done = self.engine.finished
        local = [len(done), sum(len(r.output) for r in done)]
        total = list(local)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
            t = torch.tensor(local if self.leader else [0, 0], dtype=torch.int64, device=dev)
            dist.all_reduce(t)
            total = t.tolist()
        return {"requests_local": local[0], "tokens_local": local[1],
                "requests_total": int(total[0]), "tokens_total": int(total[1]),
                "requests_seen": self.routed}


class SpecEngine(Engine):
    """Continuous batching with speculative decoding: each tick drafts gamma
    tokens for every slot, verifies them in one target window and advances
    each slot by its own accept length.  Slots may be written up to gamma
    tokens past a sequence's accepted length, so ``max_len`` needs prompt +
    max_new + gamma + 1 slots."""

    def __init__(self, params: Dict, cfg: LlamaConfig, draft_params: Dict,
                 draft_cfg: LlamaConfig, gamma: int = 4, **kw):
        if kw.get("mesh") is not None:
            raise NotImplementedError(
                "SpecEngine does not ride a TP mesh yet; use Engine(mesh=...)")
        _check_vocab(cfg, draft_cfg)
        super().__init__(params, cfg, **kw)
        check_on(draft_params["embed"], self.device, "the draft model")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        dtype = torch.bfloat16 if "k_scale" in self.cache else self.cache["k"].dtype
        self.d_cache = init_kv_cache(draft_cfg, self.max_batch, self.max_len, dtype=dtype,
                                     device=self.device)
        self.accepted_total = 0
        self.rounds_total = 0
        self.slot_rounds = 0  # each round counted once per active slot
        self._retire_slack = gamma + 2

    def _prefill_request(self, req: Request, slot: int) -> torch.Tensor:
        last_logits = super()._prefill_request(req, slot)
        _prefill_into_slot(self.draft_params, self._prompt(req), self.d_cache, slot,
                           self.draft_cfg, chunk=self.prefill_chunk)
        return last_logits

    @torch.inference_mode()
    def step(self) -> bool:
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        emit, elen = _spec_tick(self.params, self.draft_params, self._device(self.cur_token),
                                self.cache, self.d_cache, self._device(self.pos), self.cfg,
                                self.draft_cfg, self.gamma, self.sc, self.sc.greedy,
                                self.generator)
        emit, elen = emit.cpu().numpy(), elen.cpu().numpy()
        self.rounds_total += 1
        self.slot_rounds += len(active)
        self.ticks += 1
        for slot in active:
            req = self.slots[slot]
            kept = 0
            for i in range(int(elen[slot])):
                if len(req.output) >= req.max_new_tokens:
                    break
                tok = int(emit[slot, i])
                req.output.append(tok)
                kept += 1
                if self.eos_id is not None and tok == self.eos_id:
                    break
            self.accepted_total += max(kept - 1, 0)
            # positional rollback: pos advances only by what was kept
            self.pos[slot] += kept
            self.cur_token[slot, 0] = req.output[-1]
            self._maybe_finish(slot)
        return True


def _spec_tick(params_t: Dict, params_d: Dict, tokens: torch.Tensor, t_cache: Dict,
               d_cache: Dict, pos: torch.Tensor, cfg_t: LlamaConfig, cfg_d: LlamaConfig,
               gamma: int, sc: SampleConfig, greedy: bool, generator):
    """One speculative tick over the whole batch, through the one round
    definition (`speculative.spec_round`).  Returns (emit [B, gamma + 1],
    emitted length [B])."""
    emit, n_accept, _, _ = spec_round(params_t, params_d, tokens, t_cache, d_cache, pos,
                                      cfg_t, cfg_d, gamma, sc, greedy, generator)
    return emit, n_accept + 1
