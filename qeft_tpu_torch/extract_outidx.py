"""CLI: OGR step 1 -- extract the global weak ("outlier") channel set.

The ``extract_outidx`` surface of ``qeft_tpu/extract_outidx.py``, with the
port's flag convention (``--model``, ``--dataset``, ``--device`` where JAX
takes positional ``model dataset``)::

    python -m qeft_tpu_torch.extract_outidx --model llama2-7b --dataset synthetic \\
        --wbits 4 --target_rank 128 --no_frob_norm --output_dir outidx

``--model`` is a preset name of any family (random weights from ``--seed``,
built on the device) or a Hugging Face directory (``config.json`` and
safetensors shards, read by ``models.hf_loader``).  ``--dataset`` is
``synthetic`` or a ``.npy`` token file.  Writes ``<output_dir>/w{bits}_r
{rank}/outidx.npy`` and each qkv/ffn1 linear's own ids as ``layer{i}.
{name}.npy``.  Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def add_common_quant_args(parser: argparse.ArgumentParser, model_required: bool = True) -> None:
    parser.add_argument("--model", required=model_required,
                        help="preset name (llama2-7b, opt-6.7b, tiny, ...) or a Hugging Face "
                        "directory")
    parser.add_argument("--dataset", default="synthetic", help="synthetic | *.npy")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    parser.add_argument("--nsamples", type=int, default=128)
    parser.add_argument("--wbits", type=int, default=4, choices=[2, 3, 4, 16])
    parser.add_argument("--target_bit", type=float, default=None)
    parser.add_argument("--target_rank", type=int, default=None)
    parser.add_argument("--tuning", default="mse", choices=["mse", "minmax"])
    parser.add_argument("--no_frob_norm", action="store_true")
    parser.add_argument("--percdamp", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sym", action="store_true")
    parser.add_argument("--groupsize", type=int, default=-1)
    parser.add_argument("--seqlen", type=int, default=None,
                        help="calibration length (default: min(context, 2048))")
    parser.add_argument("--act-order", dest="act_order", action="store_true")
    parser.add_argument("--true-sequential", dest="true_sequential", action="store_true")
    parser.add_argument("--nearest_owq", action="store_true")
    parser.add_argument("--nearest", action="store_true", help="plain RTN, no weak columns")
    parser.add_argument("--perhead", type=int, default=None)
    parser.add_argument("--layers", nargs="*", default=None,
                        help="weak columns only in these linears (the others take none)")
    parser.add_argument("--dtype", default="auto", choices=["auto", *_DTYPES],
                        help="weights' dtype (auto: float32 for a preset, as qeft_tpu)")


def resolve_dtype(name):
    return None if name in (None, "auto") else _DTYPES[name]


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (``meta`` tensors included)."""
    from qeft_tpu_torch.checkpoint import tree_map

    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()) or t, tree)
    return sum(sizes)


_POOL = (1 << 24) + 1  # odd: rows of power-of-two width fall out of step at each wrap


def host_init_params(module, cfg, seed: int = 0, dtype=torch.float32):
    """A family's random dense tree in host memory, shaped as its
    ``init_params`` makes it, at the speed of a copy
    (``qeft_tpu/extract_outidx.py::_fast_host_init``): drawing each of a
    70B model's 69 G values from a CPU ``torch.Generator`` takes minutes, so
    one pool of 2^24 + 1 normal values is drawn from it (seed ``seed``),
    scaled and cast once per distinct scale, and tiled into each leaf from a
    rolling offset.  Leaves by role: norm
    scales 1, biases 0, embeddings N(0, 0.02^2), matrices N(0, 1/K) in the
    ``[K, N]`` layout."""
    spec = module.init_params(cfg, seed=seed, dtype=dtype, device="meta")
    gen = torch.Generator()
    gen.manual_seed(seed)
    pool = torch.randn(_POOL, generator=gen)
    pools = {}
    offset = 0

    def draw(scale: float, shape) -> torch.Tensor:
        nonlocal offset
        if scale not in pools:
            pools[scale] = (pool * scale).to(dtype)
        src = pools[scale]
        n = int(np.prod(shape))
        out = torch.empty(n, dtype=dtype)
        pos, off = 0, offset
        while pos < n:
            k = min(_POOL - off, n - pos)
            out[pos: pos + k] = src[off: off + k]
            pos, off = pos + k, (off + k) % _POOL
        offset = off
        return out.reshape(shape)

    def fill(name: str, t: torch.Tensor) -> torch.Tensor:
        if "ln" in name and not name.endswith("_b"):
            return torch.ones(t.shape, dtype=t.dtype)
        if name.endswith("_b"):
            return torch.zeros(t.shape, dtype=t.dtype)
        if "embed" in name:
            return draw(0.02, t.shape)
        return draw(float(t.shape[-2]) ** -0.5 if t.dim() >= 2 else 1.0, t.shape)

    params = {k: fill(k, v) for k, v in spec.items() if k != "layers"}
    params["layers"] = {k: fill(k, v) for k, v in spec["layers"].items()}
    return params


def load_model_and_meta(model: str, dtype=None, device=None, seed: int = 0):
    """Preset name -> (random dense tree, config, meta): f32 unless
    ``dtype`` says otherwise, as the JAX package initialises presets (the
    values come from a ``torch.Generator`` and differ from JAX's).  A
    directory with a ``config.json`` -> its Hugging Face checkpoint
    (`models.hf_loader`), bf16 unless ``dtype`` says otherwise.

    The tree is placed on ``device`` when it fits there twice (the tree and
    its quantized copy) beside `device.DEVICE_MARGIN`; a larger one stays in
    host memory (a preset drawn by `host_init_params`), and the pipeline
    streams its blocks to the card, as the JAX package holds a model larger
    than its chip on the host."""
    import importlib

    from qeft_tpu_torch.checkpoint import tree_map
    from qeft_tpu_torch.device import fits_on_device, resolve_device
    from qeft_tpu_torch.models.registry import get_model_meta

    device = resolve_device(device)
    for family in ("llama", "opt", "phi", "bloom", "falcon"):
        module = importlib.import_module(f"qeft_tpu_torch.models.{family}")
        presets = getattr(module, f"{family.upper()}_PRESETS")
        if model in presets:
            cfg, dtype = presets[model], dtype or torch.float32
            meta = get_model_meta("gemma" if "gemma" in model else family)
            spec = module.init_params(cfg, seed=seed, dtype=dtype, device="meta")
            if fits_on_device(2 * tree_bytes(spec), device):
                return module.init_params(cfg, seed=seed, dtype=dtype, device=device), cfg, meta
            return host_init_params(module, cfg, seed, dtype), cfg, meta
    if os.path.isdir(model):
        from qeft_tpu_torch.models.hf_loader import load_hf_model

        params, cfg, family = load_hf_model(model, dtype=dtype or torch.bfloat16, device="cpu")
        if fits_on_device(2 * tree_bytes(params), device):
            params = tree_map(lambda t: t.to(device), params)
        return params, cfg, get_model_meta(family)
    raise ValueError(f"unknown model {model!r}: neither a preset nor a Hugging Face directory")


def build_quantize_args(args):
    from qeft_tpu_torch.pipeline import QuantizeArgs
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    nearest = getattr(args, "nearest", False)
    return QuantizeArgs(
        spec=QuantSpec(bits=args.wbits, sym=args.sym, mse=args.tuning == "mse",
                       group_size=args.groupsize),
        target_rank=None if nearest else args.target_rank,
        target_bit=None if nearest else args.target_bit,
        percdamp=args.percdamp, act_order=args.act_order, no_frob_norm=args.no_frob_norm,
        rtn=nearest or getattr(args, "nearest_owq", False),
        true_sequential=getattr(args, "true_sequential", False), nsamples=args.nsamples,
        perhead=args.perhead,
        owq_layers=tuple(args.layers) if getattr(args, "layers", None) else None,
    )


def calibration(args, cfg) -> np.ndarray:
    from qeft_tpu_torch.data import get_calibration_tokens

    seqlen = args.seqlen or min(cfg.max_position_embeddings, 2048)
    return get_calibration_tokens(args.dataset, args.nsamples, args.seed, seqlen,
                                  model=args.model, vocab_size=cfg.vocab_size)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_quant_args(parser)
    parser.add_argument("--output_dir", default="outidx")
    args = parser.parse_args(argv)
    if args.target_rank is None and args.perhead is None:
        parser.error("--target_rank or --perhead is required: the global weak set is a top-k "
                     "over the sensitivity sum")

    from qeft_tpu_torch.device import resolve_device
    from qeft_tpu_torch.pipeline import extract_global_outidx

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, cfg, meta = load_model_and_meta(args.model, resolve_dtype(args.dtype), device,
                                            args.seed)
    calib = calibration(args, cfg)
    qargs = build_quantize_args(args)
    tick = time.perf_counter()
    outidx, per_layer = extract_global_outidx(params, calib, cfg, meta, qargs)
    seconds = time.perf_counter() - tick
    rank = qargs.target_rank if qargs.perhead is None else qargs.perhead * cfg.num_heads
    dirname = os.path.join(args.output_dir, f"w{args.wbits}_r{rank}")
    os.makedirs(dirname, exist_ok=True)
    np.save(os.path.join(dirname, "outidx.npy"), outidx)
    for (i, name), ids in per_layer.items():
        np.save(os.path.join(dirname, f"layer{i}.{name}.npy"), ids)
    print(f"OutlierIdx : {outidx.tolist()}")
    line = f"saved to {dirname}/outidx.npy (extraction {seconds:.1f} s on {device}"
    if device.type == "cuda":
        line += (f", {torch.cuda.get_device_name(device)}, peak memory "
                 f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")
    print(line + ")")
    return {"outidx": outidx, "dir": dirname, "extract_time_s": seconds}


if __name__ == "__main__":
    main()
