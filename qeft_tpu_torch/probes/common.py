"""Helpers the probes share: the command line, timing with CUDA events, the
cold rotation over copies of an operand, the kernels' zeroed workspaces."""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, Tuple

import torch

from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.ops import cuda_lib

PEAK_HBM = 3.35e12  # bytes/s, H100 SXM data sheet
PEAK_BF16 = 989e12  # dense bf16 tensor FLOP/s, H100 SXM data sheet
COLD_BYTES = 200e6  # the copies of a cold rotation exceed this together: four L2s


def parse_device(argv, description: str, extra: Callable = None):
    """``--device`` (default: the GPU, which must exist) and the probe's own
    flags -> (args, device)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the plain versions only")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)


def bound_ms(nbytes: float, flops: float = 0.0, peak_ops: float = PEAK_BF16) -> Tuple[float, str]:
    """The least time of the work on the card: bytes over the HBM rate or
    operations over ``peak_ops``, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_HBM * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn: Callable[[int], object], inner: int = 10, reps: int = 7) -> float:
    """Median device time of one ``fn(i)`` call over ``reps`` batches of
    ``inner`` calls, with CUDA events.  A sleep kernel keeps the card busy
    while the host enqueues each batch, so host time between launches is
    not counted."""
    fn(0)
    times = []
    for r in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(inner):
            fn(r * inner + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def n_copies(nbytes: float) -> int:
    """Copies of an operand of ``nbytes`` for a cold rotation: at least four,
    together more than `COLD_BYTES`, so each launch finds its operand out of
    the 50 MB L2."""
    return max(4, int(COLD_BYTES // nbytes) + 1)


def hot_cold(fn: Callable, copies, inner: int = 10, reps: int = 7) -> Dict[str, float]:
    """``fn(operand)`` timed on one buffer again and again (hot: it stays in
    L2 where it fits) and rotating over ``copies`` (cold)."""
    hot = time_ms(lambda i: fn(copies[0]), inner, reps)
    cold = time_ms(lambda i: fn(copies[i % len(copies)]), inner, reps)
    return {"hot_ms": hot, "cold_ms": cold}


_WORKSPACES: Dict[tuple, torch.Tensor] = {}


def workspace(device, n: int, dtype) -> torch.Tensor:
    """A zeroed buffer of ``n`` elements kept per (device, size, dtype): the
    probe kernels add their partial sums into it and leave it zeroed, so it
    is zeroed once here and never again.  Launches that share one run one
    after another, on one stream."""
    key = (str(device), n, dtype)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = torch.zeros(n, dtype=dtype, device=device)
    return _WORKSPACES[key]


def tickets(device, n_cols: int) -> torch.Tensor:
    """One zeroed arrival counter per 128-column tile (the kernels reset it)."""
    return workspace(device, -(-n_cols // 128), torch.int32)


def row_split(rows: int, tiles: int, device, multiple: int = 1) -> int:
    """Rows a block takes, so that ``tiles`` column tiles times the row
    splits give about four blocks an SM, in a multiple of ``multiple``."""
    splits = max(1, min(rows, -(-4 * cuda_lib.sm_count(device) // tiles)))
    per = -(-rows // splits)
    return max(multiple, -(-per // multiple) * multiple)


def check_int32_words(qw: torch.Tensor) -> None:
    if qw.dtype != torch.int32 or qw.dim() != 2 or not qw.is_contiguous() or not qw.is_cuda:
        raise ValueError("qw must be a contiguous 2-D int32 CUDA tensor")
    if qw.shape[1] % 4 or qw.data_ptr() % 16:
        raise ValueError("qw's rows must be 16-byte aligned: N a multiple of 4")


def report(result: Dict) -> None:
    """The probe's result as one JSON line, the last of its output."""
    print(json.dumps(result), flush=True)
