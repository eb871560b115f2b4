"""P1: where a batch-1 decode step's time goes (``scripts/entry_overhead_probe.py``).

[A] The cost of one kernel entry.  `add_one` replaces the script's
    ``_tiny_call`` (``_tiny_kernel``: an f32 [8, 128] tile plus 1).  512
    data-dependent launches are chained four ways -- the kernel eagerly
    through ``cuda_lib.launch``, the kernel inside one captured CUDA graph,
    ``torch.add`` eagerly (the counterpart of the script's "xla chain") and
    ``torch.add`` in a graph -- and each is read in µs per entry, on the host
    clock and on CUDA events.  Multiplied by the kernels of one decode step
    (the wrappers' launches plus the profiler's count of every kernel), the
    eager and graph costs bound what a graph of the step saves.
[A2] The same graphs of 512 entries, `add_one`'s and ``torch.add``'s,
    timed as interleaved pairs (ABAB, PAIRS pairs) on CUDA events: the
    device side of an entry, each pair's ratio and their median.
[A3] The eager entry taken apart: each step of ``cuda_lib.launch`` and of
    the wrapper timed alone over 512 calls on the host clock -- the build
    check ``cuda_lib.load()`` (under its lock), ``torch.cuda.
    current_stream()``, ``torch.empty_like``, ``cuda_lib.ptr``, the entry
    point's lookup, the ctypes call with the function and the stream
    cached (the launch itself), the count -- beside the whole ``add_one``.
[B] Each fused decode stage (K1) alone at Llama-2-7B shapes (qkv
    4096->12288, o 4096->4096, upgate 4096->22016, down 11008->4096): 64
    data-dependent calls in a graph, as the script chains them, beside the
    same chain with the kernel's output held fixed (its glue alone).
[C] The full decode step at positions 448..511 of a 512-slot bf16 cache,
    64 greedy steps, as graph replays of `generate.DecodeLoop.step` and as
    the eager loop: ms per token, and the step minus 32 x the sum of the
    stages (attention, lm_head and glue).

    python -m qeft_tpu_torch.probes.entry_overhead [--device cpu]
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch
import torch.nn.functional as F

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common

ITERS = 512  # chained entries of [A]; calls of each part in [A3]
PAIRS = 9  # ABAB pairs of [A2]
STAGE_ITERS = 64  # chained calls of a stage in [B]
STEPS, CACHE_SLOTS, FIRST_POS = 64, 512, 448  # [C]
STAGES = (("qkv", True), ("o", False), ("upgate", True), ("down", False))  # (stage, normed)


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 of an f32 tensor: one launch of the P1 kernel on the card."""
    if not x.is_cuda:
        return add_one_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("add_one takes a contiguous float32 CUDA tensor")
    y = torch.empty_like(x)
    cuda_lib.launch("add_one", cuda_lib.ptr(x), cuda_lib.ptr(y), x.numel())
    return y


def chain(fn, x: torch.Tensor, n: int = ITERS) -> torch.Tensor:
    for _ in range(n):
        x = fn(x)
    return x


def _graph(fn, stream) -> cuda_lib.Graph:
    """``fn`` run once on ``stream`` (warm-up), then captured there."""
    with torch.cuda.stream(stream):
        fn()
    return cuda_lib.Graph(fn, stream)


def _timed(run, stream, reps: int = 7):
    """Median (host-clock ms, CUDA-event ms) of ``run()`` on ``stream``, each
    repetition from an idle card to a synchronise."""
    host, dev = [], []
    with torch.cuda.stream(stream):
        run()
        for _ in range(reps):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            tick = time.perf_counter()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - tick) * 1e3)
            dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def measure_entry(device) -> dict:
    """[A]: µs per entry of the four chains, host clock and CUDA events; the
    chains' results are checked (exactly 512)."""
    stream = torch.cuda.Stream(device)
    x0 = torch.zeros(8, 128, dtype=torch.float32, device=device)
    graphs = {name: _graph(lambda fn=fn: chain(fn, x0), stream)
              for name, fn in (("kernel", add_one), ("torch.add", add_one_plain))}
    runs = {"kernel eager": lambda: chain(add_one, x0),
            "kernel graph": lambda: graphs["kernel"].replay(),
            "torch.add eager": lambda: chain(add_one_plain, x0),
            "torch.add graph": lambda: graphs["torch.add"].replay()}
    out = {}
    for name, run in runs.items():
        host, dev = _timed(run, stream)
        out[name] = {"host_us": host * 1e3 / ITERS, "device_us": dev * 1e3 / ITERS}
    torch.cuda.synchronize()
    for g in graphs.values():
        if not torch.equal(g.output, torch.full_like(x0, float(ITERS))):
            raise AssertionError("a chain of add_one did not add 512")
    if not torch.equal(chain(add_one, x0), torch.full_like(x0, float(ITERS))):
        raise AssertionError("the eager chain of add_one did not add 512")
    return out


def measure_graph_pairs(device, pairs: int = PAIRS) -> dict:
    """[A2]: µs per entry (CUDA events) of the two graphs of 512 entries,
    add_one's then torch.add's, ``pairs`` times in turn."""
    stream = torch.cuda.Stream(device)
    x0 = torch.zeros(8, 128, dtype=torch.float32, device=device)
    graphs = [_graph(lambda fn=fn: chain(fn, x0), stream) for fn in (add_one, add_one_plain)]
    kernel, library = [], []
    for _ in range(pairs):
        for g, out in zip(graphs, (kernel, library)):
            out.append(_timed(g.replay, stream, reps=3)[1] * 1e3 / ITERS)
    ratios = [k / t for k, t in zip(kernel, library)]
    return {"kernel_us": kernel, "torch_add_us": library, "ratios": ratios,
            "median_kernel_us": statistics.median(kernel),
            "median_torch_add_us": statistics.median(library),
            "median_ratio": statistics.median(ratios)}


def _host_us(fn, calls: int = ITERS, reps: int = 7) -> float:
    """Median host-clock µs of one ``fn()`` over ``reps`` runs of ``calls``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        tick = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - tick) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure_entry_parts(device) -> dict:
    """[A3]: host-clock µs of each part of an eager `add_one` entry, their
    sum (``ptr`` twice: x and y) and the whole call."""
    x = torch.zeros(8, 128, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    libs = cuda_lib.load()
    fn = getattr(libs[cuda_lib._ENTRY_POINTS["add_one"][0]], "add_one")
    stream = torch.cuda.current_stream(device).cuda_stream
    px, py, n = cuda_lib.ptr(x), cuda_lib.ptr(y), x.numel()
    counts = cuda_lib.launches.copy()

    def count():
        counts["add_one"] += 1

    parts = {
        "cuda_lib.load": _host_us(cuda_lib.load),
        "current_stream": _host_us(lambda: torch.cuda.current_stream().cuda_stream),
        "empty_like": _host_us(lambda: torch.empty_like(x)),
        "ptr": _host_us(lambda: cuda_lib.ptr(x)),
        "lookup": _host_us(lambda: getattr(libs[cuda_lib._ENTRY_POINTS["add_one"][0]], "add_one")),
        "ctypes_call": _host_us(lambda: fn(px, py, n, stream)),
        "count": _host_us(count),
    }
    parts["sum"] = sum(parts.values()) + parts["ptr"]
    parts["add_one"] = _host_us(lambda: add_one(x))
    return parts


def measure_stages(params, cfg, device) -> dict:
    """[B]: ms per call of each K1 stage at layer 0, 64 chained calls in a
    graph, and the chain's glue alone (the stage's output held fixed)."""
    from qeft_tpu_torch.ops.qmm import qgemv_stacked_fused

    layers = params["layers"]
    stream = torch.cuda.Stream(device)
    out = {}
    for name, normed in STAGES:
        lin = layers[name]
        k_in, n = lin.in_features, lin.out_features
        lnw = layers["input_ln"][0] if normed else None
        x0 = torch.full((1, 1, k_in), 0.01, dtype=torch.bfloat16, device=device)
        w = min(k_in, n)

        def body(a, y=None):
            if y is None:
                y = qgemv_stacked_fused(a, lin, 0, lnw=lnw, eps=cfg.rms_norm_eps)
            # keep a real data dependency from call to call, as the script does
            return a + F.pad(y[..., :w] * 1e-8, (0, k_in - w))

        y_fixed = qgemv_stacked_fused(x0, lin, 0, lnw=lnw, eps=cfg.rms_norm_eps)
        full = _graph(lambda: chain(body, x0, STAGE_ITERS), stream)
        glue = _graph(lambda: chain(lambda a: body(a, y_fixed), x0, STAGE_ITERS), stream)
        t_full = _timed(full.replay, stream)[1] / STAGE_ITERS
        t_glue = _timed(glue.replay, stream)[1] / STAGE_ITERS
        out[name] = {"ms": t_full, "glue_ms": t_glue, "kernel_ms": t_full - t_glue}
    out["sum_ms"] = sum(out[n]["ms"] for n, _ in STAGES)
    return out


def _step_kernels(api, params, cfg, cache, tok, device) -> dict:
    """Wrapper launches and device kernels (torch.profiler) of one eager
    decode step."""
    from torch.profiler import ProfilerActivity, profile

    before = dict(cuda_lib.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.decode_step(params, tok, cache, FIRST_POS, cfg)
        torch.cuda.synchronize()
    wrapped = sum(cuda_lib.launches.values()) - sum(before.values())
    kernels = sum(e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                  and getattr(e, "self_device_time_total", 0) > 0)
    return {"wrapper_launches": wrapped, "device_kernels": kernels}


@torch.inference_mode()
def measure_step(params, cfg, device, stages: dict = None) -> dict:
    """[C]: the decode step at positions 448..511 of a 512-slot bf16 cache,
    64 greedy steps as graph replays and as the eager loop (tokens equal),
    ms per token on both clocks."""
    from qeft_tpu_torch.generate import DecodeLoop, SampleConfig
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api("llama")
    cache = api.init_cache(cfg, 1, CACHE_SLOTS, dtype=torch.bfloat16, device=device)
    tokens = torch.zeros(1, STEPS + 1, dtype=torch.int64, device=device)
    loop = DecodeLoop(api, params, cache, cfg, tokens, FIRST_POS, SampleConfig(), None)
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        loop.step()  # the warm-up a capture needs
    graph = loop.capture(stream)

    def replays():
        loop.pos.fill_(FIRST_POS)
        loop.idx.fill_(1)
        loop.cur.zero_()
        graph.replay(STEPS)

    eager_tokens = []

    def eager():
        tok = torch.zeros(1, 1, dtype=torch.int64, device=device)
        eager_tokens.clear()
        for i in range(STEPS):
            logits, _ = api.decode_step(params, tok, cache, FIRST_POS + i, cfg)
            tok = logits.argmax(-1)[:, None]
            eager_tokens.append(tok)

    g_host, g_dev = _timed(replays, stream, reps=3)
    e_host, e_dev = _timed(eager, stream, reps=3)
    torch.cuda.synchronize()
    if not torch.equal(tokens[:, 1:], torch.cat(eager_tokens, 1)):
        raise AssertionError("the graph replays and the eager loop chose other tokens")
    out = {"graph_ms_token": g_host / STEPS, "graph_device_ms_token": g_dev / STEPS,
           "eager_ms_token": e_host / STEPS, "eager_device_ms_token": e_dev / STEPS,
           **_step_kernels(api, params, cfg, cache, tokens[:, :1], device)}
    if stages is not None:
        out["step_minus_stages_ms"] = out["graph_ms_token"] - cfg.num_layers * stages["sum_ms"]
    return out


def measure(params, cfg, device) -> dict:
    """[A], [A2], [A3], [B] and [C] on a packed Llama model, and [A]'s
    costs times the kernels of one step."""
    res = {"entry": measure_entry(device), "pairs": measure_graph_pairs(device),
           "parts": measure_entry_parts(device), "stages": measure_stages(params, cfg, device)}
    res["step"] = measure_step(params, cfg, device, res["stages"])
    kernels = res["step"]["device_kernels"]
    res["projection_ms_token"] = {
        "eager": kernels * res["entry"]["kernel eager"]["host_us"] * 1e-3,
        "graph": kernels * res["entry"]["kernel graph"]["device_us"] * 1e-3}
    return res


def print_summary(res: dict, cfg) -> None:
    """The lines the script printed, from `measure`'s result."""
    for name, t in res["entry"].items():
        print(f"[A] {name}: {t['host_us']:.3f} us per entry (host clock), "
              f"{t['device_us']:.3f} us (CUDA events)", flush=True)
    p = res["pairs"]
    print(f"[A2] in a graph, {len(p['ratios'])} ABAB pairs: add_one "
          f"{p['median_kernel_us']:.4f} us per entry, torch.add {p['median_torch_add_us']:.4f} "
          f"(medians; CUDA events); add_one / torch.add {p['median_ratio']:.4f} (pairs "
          + ", ".join(f"{r:.4f}" for r in p["ratios"]) + ")", flush=True)
    parts = res["parts"]
    print("[A3] eager add_one, host us per call over 512: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items() if k not in ("sum", "add_one"))
          + f"; sum (ptr twice) {parts['sum']:.3f}; the whole add_one {parts['add_one']:.3f}",
          flush=True)
    for name, _ in STAGES:
        t = res["stages"][name]
        print(f"[B] {name}: {t['ms'] * 1e3:.1f} us per call in the graph chain, glue alone "
              f"{t['glue_ms'] * 1e3:.1f} us (x{cfg.num_layers} = {t['ms'] * cfg.num_layers:.2f} "
              f"ms/token)", flush=True)
    s = res["step"]
    print(f"[B] sum of 4 stages x{cfg.num_layers} = "
          f"{res['stages']['sum_ms'] * cfg.num_layers:.2f} ms/token", flush=True)
    print(f"[C] decode step: graph {s['graph_ms_token']:.3f} ms/token (host clock; device "
          f"{s['graph_device_ms_token']:.3f}), eager {s['eager_ms_token']:.3f} ms/token "
          f"(device {s['eager_device_ms_token']:.3f}); step - stages = "
          f"{s['step_minus_stages_ms']:.3f} ms/token of attention + lm_head + glue; "
          f"{s['wrapper_launches']} wrapper launches, {s['device_kernels']} device kernels a step "
          f"-> entries cost {res['projection_ms_token']['eager']:.2f} ms/token eagerly, "
          f"{res['projection_ms_token']['graph']:.3f} in a graph", flush=True)


def main(argv=None) -> dict:
    def flags(ap):
        ap.add_argument("--preset", default="llama2-7b", help="llama preset for [B] and [C]")
        ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: all)")

    args, device = common.parse_device(argv, __doc__.splitlines()[0], flags)
    if device.type != "cuda":
        x = chain(add_one, torch.zeros(8, 128))
        res = {"device": "cpu", "chain_value": x[0, 0].item(), "times": "not measured"}
        common.report(res)
        return res
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    cfg = LLAMA_PRESETS[args.preset]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = build_packed_model(cfg, seed=0, g=128, r=128, device=device)
    res = measure(params, cfg, device)
    print_summary(res, cfg)
    res["device"] = torch.cuda.get_device_name(device)
    common.report(res)
    return res


if __name__ == "__main__":
    main()
