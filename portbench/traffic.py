"""The one traffic generator.  A mix is a data file ``traffic/<name>.json``;
its ``kind`` names the driver (``drivers/<kind>.py``) and the rest are
parameters read here:

- ``prompt`` / ``output`` / ``response``: a length distribution
  (``loguniform`` or ``uniform`` between ``min`` and ``max``), taken at its
  quantiles, so every seed has the same multiset of lengths;
- ``prompt.classes`` distinct prompt lengths, each ``repeats`` times, each
  time with its own output length (the output quantiles dealt to the
  classes by a fixed stride, so long prompts do not go with long answers);
- the walk: rounds of every class once, so any stretch of the walk holds
  the classes in equal measure; the seed chooses the order within each
  round and which of its output lengths a class takes in it, unless
  ``order`` is ``fixed`` (a window of a few long requests, where which
  ones it holds would change its work): then every seed walks the classes
  in one spread order, by the dealing stride.

Token ids are drawn on the device from (seed, request index), uniform over
the vocabulary.  Training rows are prompt-masked SFT rows as the port's
``data/sft.py`` builds them (a copy: prompt then response, truncated to the
row, labels ``IGNORE_INDEX`` on the prompt and the padding)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.seeds import derive

IGNORE_INDEX = -100


def quantile_lengths(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the mid-quantiles (i + 1/2) / n of ``spec``."""
    lo, hi = spec["min"], spec["max"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))) for q in qs]
    elif spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(v)) for v in vals]


def _stride(n: int) -> int:
    """The fixed dealing stride: the first one above n/2 prime to n."""
    return next((s for s in range(n // 2 + 1, n) if math.gcd(s, n) == 1), 1)


def classes(mix: Dict, second: str = "output") -> Tuple[List[int], List[List[int]]]:
    """(prompt length of each class, the ``repeats`` second lengths of each)."""
    n_cls, rep = mix["prompt"]["classes"], mix.get("repeats", 1)
    prompts = quantile_lengths(mix["prompt"], n_cls)
    n = n_cls * rep
    seconds = quantile_lengths(mix[second], n)
    st = _stride(n)
    dealt = [seconds[(i * st) % n] for i in range(n)]
    return prompts, [dealt[c * rep:(c + 1) * rep] for c in range(n_cls)]


def walk(mix: Dict, seed: int, second: str = "output") -> List[Tuple[int, int]]:
    """One pass of (prompt length, second length) in the seed's order: rounds
    of every class once; the walk repeats the pass when it runs out."""
    prompts, seconds = classes(mix, second)
    n = len(prompts)
    if mix.get("order", "seeded") == "fixed":
        return [(prompts[(i * _stride(n)) % n], seconds[(i * _stride(n)) % n][r])
                for r in range(len(seconds[0])) for i in range(n)]
    rng = np.random.default_rng(derive(seed, "walk"))
    dealt = [list(rng.permutation(s)) for s in seconds]
    return [(prompts[c], int(dealt[c][r])) for r in range(len(seconds[0]))
            for c in rng.permutation(n)]


def prompt_tokens(seed: int, key: str, batch: int, length: int, vocab: int,
                  device) -> torch.Tensor:
    """int64 [batch, length] ids of the request named ``key`` (its place in
    the window, or in the warm-up)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "prompt", key))
    return torch.randint(0, vocab, (batch, length), generator=gen, device=device)


def train_rows(mix: Dict, seed: int, steps: int, vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, labels) int64 [steps, batch, seq]: every row a prompt of a
    class and a response of the walk, ids uniform, never two rows alike."""
    b, s = mix["batch"], mix["seq"]
    rng = np.random.default_rng(derive(seed, "rows"))
    ids = np.zeros((steps, b, s), np.int64)
    labels = np.full((steps, b, s), IGNORE_INDEX, np.int64)
    order: List[Tuple[int, int]] = []
    for i in range(steps * b):
        if not order:
            order = walk(mix, derive(seed, "rows", i), second="response")
        pl, rl = order.pop(0)
        st, row = divmod(i, b)
        seq = rng.integers(0, vocab, pl + rl)[:s]
        ids[st, row, :len(seq)] = seq
        start = min(pl, s)
        labels[st, row, start:len(seq)] = seq[start:]
    return ids, labels
