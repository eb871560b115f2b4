"""Decode cells: requests through ``qeft_tpu_torch.generate.generate`` in a
closed loop, one at a time, over one static cache allocated in set-up and
reused by every request, as a static-cache server holds it.

Set-up makes the weights and the cache and warms every prompt length of
the mix once (prefill, first eager step, capture, replay).  The window
walks the mix (`traffic.walk`) from the seed until ``seconds`` have passed,
and the last request runs to its end.  Each request's first token is timed
by two CUDA events, one recorded at its issue and one by the model API's
prefill as it returns (the API ``generate`` is given wraps the port's), so
the path gains no host sync.  ``check`` then holds a sample of the served
requests against the reference (`portbench.check`)."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from portbench import program, traffic, weights
from portbench.trace import Tracer, reduce, span


class Served:
    """What the window served: per request its lengths, its times and its
    tokens on the device (read back once the window has closed)."""

    def __init__(self):
        self.requests: List[Dict] = []
        self.tokens: List[torch.Tensor] = []


def _timed_api(api, marks: List):
    """The port's model API whose prefill marks its return: a CUDA event on
    the card (recorded on the stream, no sync), the host clock elsewhere."""

    def prefill(params, tokens, cache, cfg):
        with span("prefill"):
            out = api.prefill(params, tokens, cache, cfg)
        ev = None
        if tokens.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        marks.append((ev, time.perf_counter()))
        return out

    return dataclasses.replace(api, prefill=prefill)


def serve(ctx, model, order, stop, served: Served, tag: str = "window", tracer=None) -> None:
    """Requests 0, 1, ... of the walk ``order`` (repeated as needed) until
    ``stop(i)`` is true before request ``i``.  With ``tracer``, the mix's
    ``trace`` stretch (``skip`` requests in, ``requests`` long) is traced."""
    from qeft_tpu_torch.generate import SampleConfig, generate

    mix, dims = ctx.mix, ctx.dims
    b = mix["batch"]
    cuda = ctx.device.type == "cuda"
    at = mix.get("trace", {})
    first_traced = at.get("skip", 1)
    last_traced = first_traced + at.get("requests", 1) - 1
    i = 0
    while not stop(i):
        prompt_len, out_len = order[i % len(order)]
        if tracer is not None and i == first_traced:
            tracer.start()
        prompt = traffic.prompt_tokens(ctx.seed, f"{tag}{i}", b, prompt_len, dims.vocab,
                                       ctx.device)
        marks: List = []
        ev0 = None
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        with span("request", i):
            tokens, _ = generate(model["params"], prompt, model["cache"], model["cfg"], out_len,
                                 SampleConfig(greedy=True), api=_timed_api(model["api"], marks),
                                 device=ctx.device)
        if tracer is not None and i == last_traced:
            ctx.raw_trace = tracer.stop()
        ev1, t_first = marks[0]
        served.requests.append({"key": f"{tag}{i}", "prompt": prompt_len,
                                "output": out_len, "batch": b,
                                "traced": tracer is not None and first_traced <= i <= last_traced,
                                "marks": (ev0, ev1, (t_first - t0) * 1e3)})
        served.tokens.append(tokens)
        i += 1


def build(ctx) -> Dict:
    raw = weights.make(ctx.dims, ctx.seed, ctx.device)
    api = program.api(ctx.dims)
    cfg = program.config(ctx.dims)
    cache = api.init_cache(cfg, ctx.mix["batch"], ctx.mix["cache_slots"], device=ctx.device)
    return {"params": program.tree(ctx.dims, raw), "api": api, "cfg": cfg, "cache": cache}


def run(ctx) -> None:
    """Set-up, window and the served record into ``ctx``."""
    model = build(ctx)
    order = traffic.walk(ctx.mix, ctx.seed)
    warm_order = [(p, 3) for p in sorted({p for p, _ in order}, reverse=True)]
    serve(ctx, model, warm_order, lambda i: i >= len(warm_order), Served(), tag="warm")
    ctx.mark_setup()
    served = Served()
    tracer = Tracer() if ctx.tracing else None
    start = time.perf_counter()
    serve(ctx, model, order, lambda i: time.perf_counter() - start >= ctx.seconds, served,
          tracer=tracer)
    ctx.window_s = time.perf_counter() - start
    ctx.note_peak()
    for r in served.requests:
        ev0, ev1, host_ms = r.pop("marks")
        r["ttft_ms"] = ev0.elapsed_time(ev1) if ev0 is not None else host_ms
    ctx.requests = served.requests
    ctx.served_tokens = [t.cpu() for t in served.tokens]
    ctx.traced = {"requests": [(r["prompt"], r["output"], r["batch"])
                               for r in served.requests if r["traced"]]}
    if ctx.raw_trace is not None:
        ctx.trace = reduce(ctx.raw_trace)
        ctx.raw_trace = None
