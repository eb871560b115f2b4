"""CLI: load a packed or WCT checkpoint, evaluate PPL and benchmark greedy
decoding.

The ``--load ... --eval --benchmark`` surface of ``qeft_tpu/main.py``.  The
model API follows the checkpoint's family (llama, gemma, OPT, Phi, Bloom,
Falcon), as ``qeft_tpu/main.py`` picks it; a WCT checkpoint
(``run_finetune``'s ``wct_final``) loads as its base model with the tuned
weak-column slabs laid over it:

    python -m qeft_tpu_torch.main --load ckpt/llama2_7b_packed --eval \\
        --eval_windows 4 --seqlen 2048 --benchmark 256

Runs on the GPU unless ``--device cpu`` is given.  ``--benchmark N`` reports
(a) decode throughput of generate(): a 64-token prompt, then N greedy tokens,
timed after one warm-up run; and (b) the per-token protocol: N data tokens fed
one at a time through the decode step, each step timed to a device
synchronisation, with the streaming PPL of those steps.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from qeft_tpu_torch.checkpoint import load_model
from qeft_tpu_torch.data import get_loaders
from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.pipeline import fuse_packed_stages

BENCH_CONTEXT = 64  # prompt tokens of the throughput benchmark


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(params, cfg, api, n: int, device: torch.device, dataset: str,
              seed: int) -> dict:
    results = {}
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, BENCH_CONTEXT)),
        device=device)

    def run():
        cache = api.init_cache(cfg, 1, BENCH_CONTEXT + n, dtype=torch.bfloat16, device=device)
        tokens, _ = generate(params, prompt, cache, cfg, n, api=api, device=device)
        return tokens.cpu()

    run()  # warm-up: kernel build and first launches
    tick = time.perf_counter()
    run()
    dt = time.perf_counter() - tick
    results["decode_tokens_per_s"] = n / dt
    results["ms_per_token"] = dt / n * 1e3
    print(f"decode: {results['decode_tokens_per_s']:.2f} tokens/s "
          f"({results['ms_per_token']:.3f} ms/token, prefill {BENCH_CONTEXT} + {n} greedy)")

    data = get_loaders(dataset, nsamples=1, seed=seed, seqlen=n, train=True,
                       vocab_size=cfg.vocab_size)
    ids = torch.as_tensor(np.asarray(data)[:1, :n], device=device)
    cache = api.init_cache(cfg, 1, n, dtype=torch.bfloat16, device=device)
    times, nll = [], 0.0
    with torch.inference_mode():
        for i in range(n):
            tick = time.perf_counter()
            logits, cache = api.decode_step(params, ids[:, i: i + 1], cache, i, cfg)
            _sync(device)
            times.append(time.perf_counter() - tick)
            if i != n - 1:
                logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
                nll -= float(logp[0, ids[0, i + 1]])
    results["median_token_latency_ms"] = float(np.median(times)) * 1e3
    results["min_token_latency_ms"] = float(np.min(times)) * 1e3
    results["streaming_ppl"] = float(np.exp(nll / max(n - 1, 1)))
    line = (f"per-token: median {results['median_token_latency_ms']:.3f} ms, "
            f"min {results['min_token_latency_ms']:.3f} ms, "
            f"streaming ppl {results['streaming_ppl']:.4f}")
    if device.type == "cuda":
        results["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        line += f", peak mem {results['peak_memory_gb']:.3f} GB"
    print(line)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--load", required=True, help="packed or WCT checkpoint (.npz + .json)")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval", action="store_true", help="PPL over --eval_windows")
    parser.add_argument("--eval_windows", type=int, default=0)
    parser.add_argument("--seqlen", type=int, default=0,
                        help="eval window (default: the model's context length)")
    parser.add_argument("--benchmark", type=int, default=0, help="tokens to decode")
    args = parser.parse_args(argv)

    if os.environ.get("QEFT_QUANT_LMHEAD", "0") not in ("0", "", "false"):
        # qeft_tpu/main.py packs the lm_head to RTN int4 under this variable;
        # serving the bf16 head instead would change the logits silently
        raise NotImplementedError(
            "QEFT_QUANT_LMHEAD is set: the port has no packed lm_head yet (ROADMAP A6: "
            "rtn_pack_linear and a packed head); unset it or set it to 0")
    device = resolve_device(args.device)
    params, cfg, family = load_model(args.load, device=device)
    params = fuse_packed_stages(params, get_model_meta(family))
    api = get_model_api(family)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    print(f"loaded {args.load}: family {family}, {cfg.num_layers} layers, on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    results = {"device": str(device)}
    if args.eval:
        test = get_loaders(args.dataset, train=False, vocab_size=cfg.vocab_size)
        seqlen = args.seqlen or cfg.max_position_embeddings
        ppl = eval_ppl(params, test, cfg, seqlen=seqlen, max_windows=args.eval_windows,
                       api=api, device=device)
        results[f"ppl_{args.dataset}"] = ppl
        print(f"{args.dataset} ppl: {ppl:.4f}")
    if args.benchmark:
        results.update(benchmark(params, cfg, api, args.benchmark, device, args.dataset,
                                 args.seed))
    return results


if __name__ == "__main__":
    main()
