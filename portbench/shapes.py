"""The sizes a configuration file states, read once: the model's widths and
each packed linear's (K, N).  Weights, costs and the reference all read
their shapes from here, never from the program.  Each family's module
(`portbench.families`) reads its configurations; `Dims` holds what the
generic modules read, and a family may subclass it with fields of its own."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from portbench.families import family


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    group: int
    n_outlier: int
    linears: Tuple[Tuple[str, int, int], ...]  # (name, K, N) of each packed linear

    def linear(self, name: str) -> Tuple[int, int]:
        for n, k, out in self.linears:
            if n == name:
                return k, out
        raise KeyError(name)


def dims(cfg: Dict) -> Dims:
    """``cfg``: a configuration file's dict (Hugging Face keys plus ``qeft``)."""
    return family(cfg["family"]).dims(cfg)
