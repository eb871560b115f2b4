"""What decides ``correct``: the numbers a cell compares, each against the
limit in ``cells/<cell>.json`` (``limits``).  They are read once the window
has closed and the program's state is freed, from what the timed path
produced, against the plain reference (``reference/``) over the same
inputs, which the reference makes again from the seed.

- Decode cells: ``gap``, the widest gap by which a served token's logit
  lies below the reference's best at its position, over a sample of the
  window's finished requests drawn from the seed, the longest among them.
- Training cells: ``loss``, the worst relative gap of the first steps'
  losses (read, and compared only where the cell's limits name it);
  ``grad``, the worst slab's gap between the norms of its first
  clipped gradient (the program's as its optimizer got it) and the
  reference's; ``change``, the same of the slabs' change after those steps,
  leaving out slabs whose reference gradient is under a thousandth of the
  median slab's.  A slab's gap is measured against the larger of its own
  reference norm and the median slab's."""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic, weights
from portbench.reference import common
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.seeds import derive


def sample(ctx) -> List[int]:
    """Indices of the checked requests: the longest, then ones drawn from
    the seed among the rest, ``check.requests`` in all."""
    reqs = ctx.requests
    k = ctx.mix["check"]["requests"]
    longest = max(range(len(reqs)), key=lambda j: (reqs[j]["prompt"] + reqs[j]["output"], -j))
    rest = [j for j in range(len(reqs)) if j != longest]
    rng = np.random.default_rng(derive(ctx.seed, "check"))
    drawn = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(int(j) for j in drawn)


def decode_seqs(ctx, picked: List[int]):
    out = []
    for j in picked:
        r = ctx.requests[j]
        prompt = traffic.prompt_tokens(ctx.seed, r["key"], r["batch"], r["prompt"],
                                       ctx.dims.vocab, ctx.device)
        out.append((prompt, r["prompt"], ctx.served_tokens[j].to(ctx.device)))
    return out


def decode(ctx, control: bool = False) -> Dict[str, float]:
    raw = weights.make(ctx.dims, ctx.seed, ctx.device)
    return ref_serve.gaps(ctx.dims, raw, decode_seqs(ctx, sample(ctx)), control=control)


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys)


def compare_train(prog: Dict, ref: Dict, grad1_ref: Dict[str, float]) -> Dict[str, float]:
    """The three numbers of a training cell from the program's readings and
    the reference's (``grad1_ref``: the reference's first gradients, which
    decide the slabs left out of ``change``)."""
    median = statistics.median(grad1_ref.values())
    moving = {k for k, g in grad1_ref.items() if g >= 1e-3 * median}
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss": loss, "grad": _worst(prog["grad1"], ref["grad1"]),
            "change": _worst(prog["change"], ref["change"], moving)}


def train(ctx) -> Dict[str, float]:
    raw = weights.make(ctx.dims, ctx.seed, ctx.device)
    ids, labels = ctx.check_rows
    ref = ref_train.run(ctx.dims, raw, ctx.mix, ids, labels)
    ctx.reference_numbers = ref
    return compare_train(ctx.program_numbers, ref, ref["grad1"])


def train_planted(ctx, ar=common.F32, half_batch: bool = False) -> Dict[str, float]:
    """The reference put in the program's place, in ``ar`` or with half of
    each batch left out, held against the reference (after `train`)."""
    raw = weights.make(ctx.dims, ctx.seed, ctx.device)
    ids, labels = ctx.check_rows
    other = ref_train.run(ctx.dims, raw, ctx.mix, ids, labels, ar=ar, half_batch=half_batch)
    base = ctx.reference_numbers
    return compare_train(other, base, base["grad1"])


def run(ctx) -> Dict[str, float]:
    """The cell's numbers, its kind's check, on the freed card."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return decode(ctx) if ctx.mix["kind"] == "decode" else train(ctx)
