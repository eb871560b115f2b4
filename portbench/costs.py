"""Operations and bytes of each kernel call and of a whole step, from the
shapes alone (the yardstick of every roofline and mfu metric).

A packed linear of K inputs and N outputs, group size g and r weak rows
reads K*N/2 bytes of codes, 4*(K/g)*N of bf16 scales and scaled zeros and
2*r*N of its bf16 slab.  Its decode matvec (K5) and its GEMM (K2) multiply
over all K rows and then over the r weak rows again: 2*M*N*(K + r)
operations.  The transposed GEMM (K7, ``dx``) multiplies over K rows only
(the slab's share of ``dx`` is a separate f32 product).  The arithmetic
follows ``chip_smoke.py``'s byte and operation counts (``train_step_flops``,
the bytes a token of ``phase_opt``), with training counted without the
recomputed forward: operations the step needs, not the ones remat spends.

Attention counts what its inputs need: causal pairs only, and at decode the
keys up to the position, never the whole static cache.  A whole step's
count is the family's (`portbench.families`): which linears a step reads,
and how often, is the family's to state."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from portbench.families import family
from portbench.shapes import Dims

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """{"flops": dense bf16 operations/s, "bytes": HBM bytes/s} of the card
    named, or None where the table has no such card (then no roofline or
    mfu is reported)."""
    table = json.loads(PEAKS.read_text())
    return table.get(device_name)


def least_time(ops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """Seconds the card needs at best: the larger of its two bounds."""
    return max(ops / pk["flops"], nbytes / pk["bytes"])


def weight_bytes(k: int, n: int, g: int, r: int, bias: bool) -> int:
    return k * n // 2 + 4 * (k // g) * n + 2 * r * n + (2 * n if bias else 0)


def qgemv_call(m: int, k: int, n: int, g: int, r: int, bias: bool):
    """(operations, bytes) of one decode matvec (K5): every input byte once."""
    return 2 * m * n * (k + r), weight_bytes(k, n, g, r, bias) + 2 * m * k + 2 * m * n


def qgemm_call(m: int, k: int, n: int, g: int, r: int):
    """(operations, bytes) of one GEMM (K2) and its split-K sum."""
    return 2 * m * n * (k + r), weight_bytes(k, n, g, r, False) + 2 * m * k + 2 * m * n


def qgemm_t_call(m: int, k: int, n: int, g: int, r_tail: int):
    """(operations, bytes) of one transposed GEMM (K7): g [M, N] in, dx [M, K]
    out, the f32 tail [M, r] added."""
    return 2 * m * k * n, weight_bytes(k, n, g, 0, False) + 2 * m * n + 2 * m * k + 4 * m * r_tail


def attention_pairs(seq: int) -> int:
    """Causal (query, key) pairs of one sequence."""
    return seq * (seq + 1) // 2


def decode_step(dims: Dims, *step):
    """(operations, bytes) one decode step needs; ``step`` is one entry of
    the family's ``expect_decode`` steps (the dense families: batch and
    cached keys)."""
    return family(dims.family).decode_step(dims, *step)


def train_step_ops(dims: Dims, batch: int, seq: int) -> int:
    """Operations one WCT step of ``batch`` rows of ``seq`` tokens needs,
    without the recomputed forward (the family's count)."""
    return family(dims.family).train_step_ops(dims, batch, seq)
