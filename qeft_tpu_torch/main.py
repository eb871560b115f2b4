"""CLI: quantize a model (GPTQ-OWQ with OGR's global reorder), or load a
packed, fake or WCT checkpoint; evaluate PPL and benchmark greedy decoding.

The surface of ``qeft_tpu/main.py``, with the port's flag convention
(``--model``, ``--dataset``, ``--device`` where JAX takes positional
``model dataset``)::

    # quantize (after extract_outidx), save fake and packed checkpoints, and
    # hold the packed model's PPL against the fake one's (the reference's
    # oracle)
    python -m qeft_tpu_torch.main --model llama2-7b --wbits 4 --groupsize 128 \
        --target_rank 128 --reorder --outidx_file outidx/w4_r128/outidx.npy \
        --fake --packing --save ckpt/llama2_7b --eval --eval_windows 2

    # load a packed checkpoint, evaluate and benchmark decoding
    python -m qeft_tpu_torch.main --load ckpt/llama2_7b_packed --eval \
        --eval_windows 4 --seqlen 2048 --benchmark 256

The model API follows the checkpoint's family (llama, gemma, OPT, Phi,
Bloom, Falcon); a WCT checkpoint loads as its base with the tuned slabs laid
over it.  Quantization takes a preset of any family (random weights from
``--seed``) or a Hugging Face directory (``--model <dir>``); Falcon is
quantized at ``percdamp`` 1.0, as the reference does.  With
``QEFT_QUANT_LMHEAD`` set (any value but "0", "" and "false") ``--load``
packs the lm_head round-to-nearest to int4 (g = 128), as the JAX package
does.  Runs on the GPU unless ``--device cpu`` is given.

A model larger than the card stays in host memory: a preset or Hugging
Face model too large to quantize on the card (``load_model_and_meta``) is
quantized and packed block by block, and a checkpoint that does not fit
(``device.fits_on_device``) is read to the host; ``--eval`` of a llama-
family tree held on the host runs ``eval_ppl_streamed``, one block on the
card at a time, as JAX's ``stream_eval`` rule picks it.  ``--eval_datasets
a,b`` evaluates each set (default: ``--dataset``), and ``--logfile`` appends
one JSON line ``{"model", **args, **results}``, as the JAX package writes
it.  ``--benchmark N``
reports (a) decode throughput of generate(): a 64-token prompt, then N
greedy tokens, timed after one warm-up run; and (b) the per-token protocol:
N data tokens fed one at a time through the decode step, each step timed to
a device synchronisation, with the streaming PPL of those steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from qeft_tpu_torch.checkpoint import (
    checkpoint_bytes,
    load_model,
    save_fake,
    save_packed,
    tree_map,
)
from qeft_tpu_torch.data import get_loaders
from qeft_tpu_torch.device import fits_on_device, resolve_device
from qeft_tpu_torch.eval import eval_ppl, eval_ppl_streamed
from qeft_tpu_torch.extract_outidx import (
    add_common_quant_args,
    build_quantize_args,
    calibration,
    load_model_and_meta,
    resolve_dtype,
    tree_bytes,
)
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.ops.flash import flash_window_attention_any
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.pipeline import (
    fuse_dense_stages,
    fuse_packed_stages,
    pack_model,
    quantize_model,
    rtn_pack_linear,
)

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


def quant_lmhead_enabled() -> bool:
    """``QEFT_QUANT_LMHEAD`` as ``qeft_tpu/main.py`` reads it."""
    return os.environ.get("QEFT_QUANT_LMHEAD", "0") not in ("0", "", "false")


def load_for_serving(path: str, device) -> tuple:
    """A checkpoint as ``main --load`` serves it -> (params, config,
    family): a packed (or WCT) tree stage-fused, a fake one fused into the
    dense stages, and the lm_head packed under ``QEFT_QUANT_LMHEAD``.  On
    ``device`` where it fits there (`device.fits_on_device`), else in host
    memory."""
    device = torch.device(device)
    home = device if fits_on_device(checkpoint_bytes(path), device) else torch.device("cpu")
    params, cfg, family = load_model(path, device=home)
    meta = get_model_meta(family)
    params = fuse_dense_stages(params, meta) if _is_dense(params) else fuse_packed_stages(
        params, meta)
    if quant_lmhead_enabled() and not isinstance(params["lm_head"], QLinearParams):
        params["lm_head"] = rtn_pack_linear(params["lm_head"].to(torch.float32))
    return params, cfg, family


def _is_dense(params) -> bool:
    return not any(isinstance(v, QLinearParams) for v in params["layers"].values())


def _streamed(params, device: torch.device) -> bool:
    """Whether a tree is held in host memory while the run is on the card
    (a model larger than the card): its blocks stream."""
    return device.type == "cuda" and params["embed"].device.type == "cpu"


def _ppl(params, test, cfg, meta, seqlen, windows, device) -> float:
    """PPL of a tree where it lives: a llama-family tree held in host
    memory while the run is on the card streams its blocks
    (`eval_ppl_streamed`, JAX's ``stream_eval`` rule); any other evaluates
    whole (`eval_ppl`)."""
    if _streamed(params, device):
        if meta.family not in ("llama", "gemma"):
            raise ValueError(f"a {meta.family} model held in host memory cannot be evaluated: "
                             "eval_ppl_streamed covers the llama family, as JAX's does")
        return eval_ppl_streamed(params, test, cfg, meta, seqlen=seqlen, max_windows=windows,
                                 device=device)
    return eval_ppl(params, test, cfg, seqlen=seqlen, max_windows=windows,
                    api=_eval_api(params, meta.family), device=device)


def _eval_api(params, family: str):
    """The model API an eval runs: a dense llama-family tree (a fake or
    unquantized model) takes K3 on the GPU, as the JAX package's dense
    forward takes its flash kernel on the TPU."""
    api = get_model_api(family)
    if family in ("llama", "gemma") and _is_dense(params):
        return dataclasses.replace(api, forward=functools.partial(
            api.forward, attend=flash_window_attention_any))
    return api


def _quantize(args, device, results):
    """The quantize path: the preset's random model or the Hugging Face
    checkpoint, GPTQ-OWQ over the calibration crops (with the global
    reorder from ``--outidx_file``)."""
    params, cfg, meta = load_model_and_meta(args.model, resolve_dtype(args.dtype), device,
                                            args.seed)
    quantizers = None
    if args.wbits < 16:
        if args.reorder and args.outidx_file is None:
            raise ValueError("--reorder needs --outidx_file: run "
                             "python -m qeft_tpu_torch.extract_outidx first")
        outidx = np.load(args.outidx_file) if args.reorder else None
        qargs = build_quantize_args(args)
        qargs.reorder = args.reorder
        if meta.family == "falcon":  # the reference quantizes falcon at percdamp 1.0
            qargs.percdamp = 1.0
        tick = time.perf_counter()
        params, quantizers = quantize_model(params, calibration(args, cfg), cfg, meta, qargs,
                                            outidx, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        results["quantize_time_s"] = time.perf_counter() - tick
        print(f"Reconstruction done in {results['quantize_time_s']:.1f} s")
    return params, cfg, meta, quantizers


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_quant_args(parser, model_required=False)
    parser.add_argument("--load", default="", help="packed, fake or WCT checkpoint")
    parser.add_argument("--reorder", action="store_true")
    parser.add_argument("--outidx_file", default=None)
    parser.add_argument("--save", default="", help="checkpoint stem: <save>_fake, <save>_packed")
    parser.add_argument("--fake", action="store_true")
    parser.add_argument("--packing", action="store_true")
    parser.add_argument("--fuse_stages", action="store_true",
                        help="pack q/k/v -> qkv and up/gate -> upgate (needs --reorder)")
    parser.add_argument("--eval", action="store_true", help="PPL over --eval_windows")
    parser.add_argument("--eval_datasets", default="",
                        help="comma list of sets to evaluate (default: --dataset)")
    parser.add_argument("--eval_windows", type=int, default=0)
    parser.add_argument("--benchmark", type=int, default=0, help="tokens to decode")
    parser.add_argument("--logfile", default="", help="append the run's JSON line here")
    args = parser.parse_args(argv)
    if not args.load and not args.model:
        parser.error("give --model (quantize) or --load (a checkpoint)")

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    results = {"device": str(device)}
    quantizers = None
    if args.load:
        params, cfg, family = load_for_serving(args.load, device)
        meta = get_model_meta(family)
        print(f"loaded {args.load}: family {family}, {cfg.num_layers} layers, on {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    else:
        params, cfg, meta, quantizers = _quantize(args, device, results)
    family = meta.family

    packed = None
    if args.save:
        if not (args.fake or args.packing):
            raise ValueError("--save needs --fake and/or --packing")
        if args.fake:
            save_fake(args.save + "_fake", params, quantizers, cfg, family=family)
            print(f"fake ckpt -> {args.save}_fake.npz")
        if args.packing:
            packed = pack_model(params, quantizers, cfg, meta, fuse_stages=args.fuse_stages,
                                device=device)
            save_packed(args.save + "_packed", packed, cfg, family=family)
            print(f"packed ckpt -> {args.save}_packed.npz")
    if _is_dense(params) and not _streamed(params, device):
        params = fuse_dense_stages(params, meta)

    if args.eval:
        seqlen = args.seqlen or cfg.max_position_embeddings
        if packed is not None:
            packed = fuse_packed_stages(packed, meta)
            if _streamed(packed, device) and fits_on_device(tree_bytes(packed), device):
                packed = tree_map(lambda t: t.to(device), packed)  # one transfer, not per window
        for ds in [s.strip() for s in args.eval_datasets.split(",") if s.strip()] or [
                args.dataset]:
            test = get_loaders(ds, train=False, vocab_size=cfg.vocab_size)
            ppl = _ppl(params, test, cfg, meta, seqlen, args.eval_windows, device)
            results[f"ppl_{ds}"] = ppl
            print(f"{ds} ppl: {ppl:.4f}")
            if packed is not None:
                # the reference's oracle: the packed path's PPL against the
                # fake-quantized model's
                ppl_packed = _ppl(packed, test, cfg, meta, seqlen, args.eval_windows, device)
                delta = abs(ppl_packed - ppl) / max(ppl, 1e-9)
                results[f"ppl_{ds}_packed"] = ppl_packed
                results["fake_vs_packed_delta"] = delta
                print(f"{ds} ppl (packed): {ppl_packed:.4f}  (fake-vs-packed delta "
                      f"{delta:.4%})")
    if args.benchmark:
        results.update(benchmark(params, cfg, get_model_api(family), args.benchmark, device,
                                 args.dataset, args.seed))
    if device.type == "cuda":
        results["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        since = " (since the last quantized block's start)" if quantizers is not None else ""
        print(f"peak device memory {results['peak_memory_gb']:.3f} GB{since}")
    if args.logfile:
        with open(args.logfile, "a") as f:
            f.write(json.dumps({"model": args.model, **vars(args), **results}, default=str)
                    + "\n")
    return results


if __name__ == "__main__":
    main()
