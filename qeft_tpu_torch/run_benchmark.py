"""CLI: end-to-end generation and serving benchmark, the port of
``qeft_tpu/run_benchmark.py``.

Workload: a ``--context`` token prompt (default 64) and ``--gen`` new
tokens (default 256), timed as the best of ``--reps`` runs after one
warm-up; one JSON line of results.  Methods:

  fp          dense bf16 weights (random, from ``--seed``), plain PyTorch
  qeft        packed INT4 + weak columns through the CUDA kernels
  qeft-x      the same model with ``QEFT_PALLAS=0``: every packed linear
              dequantized, then multiplied by ``torch.matmul`` (JAX's
              XLA-dequant ablation, the path without the kernels)
  spec        qeft target, greedy (or ``--sample``) speculative decoding, B = 1
  spec-batch  batched speculative decoding over ``--batch`` sequences
  engine      continuous-batching serving: ``--requests`` prompts over
              ``--batch`` slots, ``--burst`` ticks between host reads

    python -m qeft_tpu_torch.run_benchmark --method engine
    python -m qeft_tpu_torch.run_benchmark --method spec-batch --draft_layers 8
    python -m qeft_tpu_torch.run_benchmark --method engine --model tiny --device cpu
    python -m qeft_tpu_torch.run_benchmark --method engine --tp 2
    torchrun --nproc_per_node 2 -m qeft_tpu_torch.run_benchmark --method engine --tp 2

``--tp N`` (methods ``qeft`` and ``engine``) serves on an N-way tensor-
parallel mesh (`parallel.tp_forward`): under torchrun the ranks join its
group (its world must be N); alone the command starts N ranks on this host
itself (`parallel.multihost.launch_ranks`).  Ranks that share a card
exchange their collectives over Gloo through host memory.  Rank 0 prints
the one result line, with ``"tp"``.

Runs on the GPU unless ``--device cpu`` is given.  ``--load`` serves a
packed checkpoint of any family through ``fp``/``qeft``; the speculative and
engine methods run the llama family's ragged forward and raise for the
others, as in the JAX package.  The speculative methods
need a draft with the target's vocabulary: ``--draft_layers N`` slices the
target itself; the default ``--draft_model tiny-v2`` (512 tokens) fits only
a 512-token target.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qeft_tpu_torch import env
from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.generate import SampleConfig, generate
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.llama import LLAMA_PRESETS, init_params


def _load(args, device):
    """(params, cfg, api) of the target the flags name."""
    cfg = LLAMA_PRESETS[args.model]
    if args.load:
        from qeft_tpu_torch.checkpoint import load_model
        from qeft_tpu_torch.models.registry import get_model_meta
        from qeft_tpu_torch.pipeline import fuse_packed_stages

        params, cfg, family = load_model(args.load, device=device)
        return fuse_packed_stages(params, get_model_meta(family)), cfg, get_model_api(family)
    if args.method == "fp":
        return init_params(cfg, args.seed, dtype=torch.bfloat16, device=device), cfg, \
            get_model_api("llama")
    from qeft_tpu_torch.testing import build_packed_model

    return build_packed_model(cfg, seed=args.seed, device=device), cfg, get_model_api("llama")


def _emit(result, logfile):
    line = json.dumps(result)
    print(line)
    if logfile:
        with open(logfile, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--method", type=str, default="qeft",
                        choices=["fp", "qeft", "qeft-x", "spec", "spec-batch", "engine"])
    parser.add_argument("--model", type=str, default="llama2-7b")
    parser.add_argument("--draft_model", type=str, default="tiny-v2")
    parser.add_argument("--draft_layers", type=int, default=0,
                        help="self-speculative draft: this many evenly strided layers of "
                             "the target itself (overrides --draft_model)")
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--context", type=int, default=64)
    parser.add_argument("--gen", type=int, default=256)
    parser.add_argument("--gamma", type=int, default=4)
    parser.add_argument("--batch", type=int, default=4,
                        help="sequences for --method spec-batch; engine slots for --method engine")
    parser.add_argument("--requests", type=int, default=0,
                        help="engine: total requests to serve (default 2x batch)")
    parser.add_argument("--burst", type=int, default=16,
                        help="engine: decode ticks per host read")
    parser.add_argument("--sample", action="store_true",
                        help="sampling instead of greedy (spec: speculative sampling)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ways: the weights shard over a tp mesh of this "
                             "many ranks (methods qeft and engine)")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    parser.add_argument("--logfile", type=str, default="")
    args = parser.parse_args(argv)
    if args.tp > 1 and args.method not in ("qeft", "engine"):
        parser.error("--tp applies to --method qeft or engine")
    if args.method == "qeft-x":  # the environment as it was afterwards
        with env.setting(QEFT_PALLAS="0"):
            return _run(args)
    return _run(args)


def _run(args) -> dict:
    device = resolve_device(args.device)
    if args.tp > 1:
        return _main_tp(args, device)
    params, cfg, api = _load(args, device)
    if api.family not in ("llama", "gemma") and args.method in ("spec", "spec-batch", "engine"):
        raise NotImplementedError("the speculative and engine methods run the llama-family "
                                  "ragged window forward")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sc = SampleConfig(greedy=not args.sample, temperature=args.temperature, top_k=args.top_k,
                      top_p=args.top_p)
    model = args.load or args.model
    if args.method == "engine":
        from qeft_tpu_torch.serving import measure_engine_throughput

        n_req = args.requests or 2 * args.batch
        tps = measure_engine_throughput(
            params, cfg, slots=args.batch, burst=args.burst, requests=n_req, ctx=args.context,
            gen=args.gen, reps=args.reps, sample_config=SampleConfig(greedy=not args.sample),
            seed=args.seed, device=device)
        result = {"method": "engine", "model": model, "requests": n_req, "slots": args.batch,
                  "burst": args.burst, "context": args.context, "gen": args.gen,
                  "served_tokens_per_s": round(tps, 2), "device": str(device)}
        _emit(result, args.logfile)
        return result

    spec = args.method in ("spec", "spec-batch")
    bsz = args.batch if args.method == "spec-batch" else 1
    prompt = torch.as_tensor(
        np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (bsz, args.context)),
        device=device)
    # speculative rounds write up to gamma + 1 positions past the accepted point
    max_len = args.context + args.gen + (args.gamma + 1 if spec else 0)
    max_len = -(-max_len // 8) * 8

    def new_cache(c):
        return api.init_cache(c, bsz, max_len, dtype=torch.bfloat16, device=device)

    if spec:
        from qeft_tpu_torch import speculative as sp

        if args.draft_layers:
            draft, dcfg = sp.layer_sliced_draft(params, cfg, args.draft_layers)
        else:
            dcfg = LLAMA_PRESETS[args.draft_model]
            draft = init_params(dcfg, seed=1, dtype=torch.bfloat16, device=device)

        def run():
            t_cache, d_cache = new_cache(cfg), new_cache(dcfg)
            if args.method == "spec-batch":
                gen = torch.Generator(device=device)
                gen.manual_seed(args.seed)
                out, telem = sp.speculative_generate_batched(
                    params, draft, prompt, t_cache, d_cache, cfg, dcfg, args.gen, gen,
                    gamma=args.gamma, sc=sc, greedy=not args.sample, device=device)
            elif args.sample:
                gen = torch.Generator(device=device)
                gen.manual_seed(args.seed)
                out, telem = sp.speculative_generate_sampled(
                    params, draft, prompt, t_cache, d_cache, cfg, dcfg, args.gen, gen,
                    gamma=args.gamma, sc=sc, device=device)
            else:
                out, telem = sp.speculative_generate(
                    params, draft, prompt, t_cache, d_cache, cfg, dcfg, args.gen, args.gamma,
                    device=device)
            out.cpu()
            return telem
    else:
        def run():
            out, _ = generate(params, prompt, new_cache(cfg), cfg, args.gen, sc, api=api,
                              device=device)
            out.cpu()
            return None

    telem = run()  # warm-up: kernel build and first launches
    best = float("inf")
    for _ in range(args.reps):
        sync()
        tick = time.perf_counter()
        telem = run()
        sync()
        best = min(best, time.perf_counter() - tick)

    result = {"method": args.method, "model": model,
              "tokens_per_s": round(args.gen / best, 2),
              "ms_per_token": round(best / args.gen * 1e3, 3),
              "context": args.context, "gen": args.gen, "device": str(device)}
    if args.method == "spec-batch":
        result["batch"] = bsz
        result["seq_tokens_per_s"] = round(bsz * args.gen / best, 2)
    if telem is not None:
        result["mean_accept_length"] = round(float(telem["mean_accept_length"]), 3)
        result["rounds"] = int(telem["rounds"])
        result["draft"] = (f"self:{args.draft_layers}-layers" if args.draft_layers
                           else args.draft_model)
    _emit(result, args.logfile)
    return result


def _main_tp(args, device) -> dict:
    """``--tp N``: join torchrun's group, or start N ranks here; rank 0's
    result."""
    import os

    from qeft_tpu_torch.parallel.multihost import init_distributed, launch_ranks

    if os.environ.get("WORLD_SIZE"):
        init_distributed(device=device)
        return _tp_rank(args)
    return launch_ranks(_tp_rank, args.tp, device.type, args)[0]


def _tp_rank(args) -> dict:
    """One rank of ``--tp``: its shard of the target, then the timed
    method; rank 0 prints the line."""
    from qeft_tpu_torch.models.llama import init_kv_cache
    from qeft_tpu_torch.parallel.mesh import make_mesh
    from qeft_tpu_torch.parallel.tp_forward import _local_cfg, tp_generate, tp_shard_packed_params

    mesh = make_mesh((1, args.tp), ("dp", "tp"), device=args.device)
    device = mesh.device
    params, cfg, api = _load(args, device)
    if api.family not in ("llama", "gemma"):
        raise NotImplementedError("--tp runs the llama-family tp layouts")
    params = tp_shard_packed_params(params, mesh, cfg)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the whole tree is gone; only the shard stays
    model = args.load or args.model
    if args.method == "engine":
        from qeft_tpu_torch.serving import measure_engine_throughput

        n_req = args.requests or 2 * args.batch
        tps = measure_engine_throughput(
            params, cfg, slots=args.batch, burst=args.burst, requests=n_req, ctx=args.context,
            gen=args.gen, reps=args.reps, mesh=mesh,
            sample_config=SampleConfig(greedy=not args.sample), seed=args.seed)
        result = {"method": "engine", "model": model, "requests": n_req, "slots": args.batch,
                  "burst": args.burst, "context": args.context, "gen": args.gen,
                  "served_tokens_per_s": round(tps, 2), "device": str(device), "tp": args.tp}
    else:
        if args.sample:
            raise ValueError("--tp with --method qeft is greedy only")
        prompt = torch.as_tensor(
            np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (1, args.context)),
            device=device)
        max_len = -(-(args.context + args.gen) // 8) * 8
        lcfg = _local_cfg(cfg, args.tp)

        def run():
            out, _ = tp_generate(params, prompt, init_kv_cache(lcfg, 1, max_len, device=device),
                                 cfg, mesh, args.gen)
            out.cpu()

        run()  # warm-up
        best = float("inf")
        for _ in range(args.reps):
            tick = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - tick)
        result = {"method": args.method, "model": model,
                  "tokens_per_s": round(args.gen / best, 2),
                  "ms_per_token": round(best / args.gen * 1e3, 3),
                  "context": args.context, "gen": args.gen, "device": str(device), "tp": args.tp}
    if mesh.rank == 0:
        _emit(result, args.logfile)
    return result


if __name__ == "__main__":
    main()
