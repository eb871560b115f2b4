"""Helpers the probes share: the command line, timing with CUDA events, the
cold rotation over copies of an operand, the kernels' zeroed workspaces, and
`stream_plan`, the grid and ring of the bulk-copy probes (P2's
`unpack_only`, P3)."""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
from typing import Callable, Dict, Iterator, List, Tuple

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


def tickets(device, n_tiles: int) -> torch.Tensor:
    """One zeroed arrival counter a column tile (the kernels reset it)."""
    return workspace(device, n_tiles, torch.int32)


def row_split(rows: int, tiles: int, device) -> int:
    """Rows a block takes, so that ``tiles`` column tiles times the row
    splits give about four blocks an SM."""
    splits = max(1, min(rows, -(-4 * cuda_lib.sm_count(device) // tiles)))
    return -(-rows // splits)


# dma_tile's plan (unpack_only passes its own): blocks an SM, a stage (the
# word rows that fit it; one row where a row is larger) and a block's ring,
# chosen from a sweep on the H100 (`probes/ring_sweep.py`, PERF.md §6)
BLOCKS_PER_SM = 3
STAGE_BYTES = 32 << 10
RING_BYTES = 64 << 10
# a ring's dynamic shared memory: a block's 227 KB less the most static shared
# memory a ring kernel has (unpack_ring_kernel's red[4][128] words and flag)
SMEM_LIMIT = 232448 - (4 * 128 * 4 + 16)
STAGE_BYTES_LIMIT = (1 << 20) - 1  # the bytes an mbarrier phase counts


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """How the bulk-copy ring (``csrc/common.cuh:RowRing``) walks int32
    words [k8, n]: a grid of ``tiles`` column tiles of ``bn`` words times
    ``splits`` row splits, block (tile, split) taking rows ``split *
    rows_per_block`` onwards of its tile, in stages of ``stage_rows`` rows
    through a ring of ``stages`` slots, sized for ``blocks_per_sm``."""

    k8: int
    n: int
    bn: int
    tiles: int
    splits: int
    rows_per_block: int
    stage_rows: int
    stages: int
    blocks_per_sm: int

    @property
    def row_bytes(self) -> int:
        return 4 * self.bn

    @property
    def smem(self) -> int:
        """A block's dynamic shared memory: the slots, then a full and an
        empty mbarrier a slot (``RowRing::smem_bytes``)."""
        return self.stages * self.stage_rows * self.row_bytes + 16 * self.stages

    @property
    def in_flight(self) -> int:
        """The most bytes a block has in flight: its ring, or all its rows."""
        return min(self.rows_per_block, self.stages * self.stage_rows) * self.row_bytes

    def in_flight_per_sm(self, sms: int) -> int:
        """The bytes in flight an SM, its blocks resident together."""
        blocks = self.tiles * self.splits
        return min(self.blocks_per_sm, -(-blocks // sms)) * self.in_flight

    def blocks(self) -> Iterator[Tuple[int, int, int]]:
        """(first column, first row, end row) of each block."""
        for split in range(self.splits):
            r0 = split * self.rows_per_block
            for tile in range(self.tiles):
                yield tile * self.bn, r0, min(self.k8, r0 + self.rows_per_block)

    def stages_of(self, r0: int, r1: int) -> List[Tuple[int, int]]:
        """(first row, rows) of each stage of the block of rows [r0, r1)."""
        return [(r, min(self.stage_rows, r1 - r)) for r in range(r0, r1, self.stage_rows)]


@functools.lru_cache(maxsize=64)
def stream_plan(k8: int, n: int, bn: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM,
                stage_bytes: int = STAGE_BYTES, ring_bytes: int = RING_BYTES) -> StreamPlan:
    """The grid and ring for int32 words [k8, n] in column tiles of ``bn``
    on a card of ``sms`` SMs: about ``blocks_per_sm`` blocks an SM whatever
    ``bn`` is (each tile's rows split evenly, in whole stages), stages of
    about ``stage_bytes`` and a ring of about ``ring_bytes`` a block, so that
    the bytes in flight an SM do not depend on ``bn``.  Raises ValueError on
    what the kernels do not take."""
    if k8 < 1 or n < 4 or bn < 4 or bn % 4 or n % bn:
        raise ValueError(f"the ring takes k8 >= 1 and column tiles of bn words with 4 | bn, "
                         f"bn | n; got k8={k8}, n={n}, bn={bn}")

    def cdiv(a, b):
        return -(-a // b)

    tiles, row_bytes = n // bn, 4 * bn
    stage_rows = max(1, min(k8, stage_bytes // row_bytes))
    stage = stage_rows * row_bytes
    splits = max(1, min(cdiv(k8, stage_rows), blocks_per_sm * max(1, sms) // tiles))
    rows_per_block = cdiv(cdiv(k8, splits), stage_rows) * stage_rows
    splits = cdiv(k8, rows_per_block)
    stages = min(cdiv(rows_per_block, stage_rows), max(2, ring_bytes // stage))
    plan = StreamPlan(k8, n, bn, tiles, splits, rows_per_block, stage_rows, stages, blocks_per_sm)
    if stage > STAGE_BYTES_LIMIT or plan.smem > SMEM_LIMIT:
        raise ValueError(f"a ring of {stages} x {stage} bytes does not fit a block's "
                         f"{SMEM_LIMIT} bytes of shared memory (bn={bn})")
    return plan


def check_int32_words(qw: torch.Tensor) -> None:
    if qw.dtype != torch.int32 or qw.dim() != 2 or not qw.is_contiguous() or not qw.is_cuda:
        raise ValueError("qw must be a contiguous 2-D int32 CUDA tensor")
    if qw.shape[1] % 4 or qw.data_ptr() % 16:
        raise ValueError("qw's rows must be 16-byte aligned: N a multiple of 4")


def report(result: Dict) -> None:
    """The probe's result as one JSON line, the last of its output."""
    print(json.dumps(result), flush=True)
