"""Random packed weights made on the device from the seed, in the layout the
port serves (``qeft_tpu_torch/ops/packing.py``'s contract):

- int32 words ``[L, K/8, N]``, eight 4-bit codes a word, uniform codes;
- bf16 scales and scaled zeros ``[L, K/g, N]``: scales (0.75..1.25) /
  (4.61 sqrt(K)) (4.61 is the std of a uniform 4-bit code), zero points
  7.25..7.75, so each weight has a std of about 1/sqrt(K) and logits a sane
  scale;
- a bf16 weak-column slab ``[L, r, N]``, N(0, 1/K), for the last r K-rows;
- each with ``lead`` axes after the layer's where the family asks (an
  expert axis: ``[L, E, K/8, N]``);
- the rest the family's own (`portbench.families`, ``leaves``, which
  also lays the packed linears out in the tree): norms, embeddings, biases
  and gathers.

Each tensor draws from a generator of its own, seeded from (seed, its
name), so any one of them can be made again alone and equal.  The tree is
plain tensors; `portbench.program` wraps it for the port, and the reference
reads it as it is."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.families import family
from portbench.seeds import derive
from portbench.shapes import Dims

SERVE_DTYPE = torch.bfloat16


def generator(device, seed: int, *keys) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", *keys))
    return gen


def slab(dims: Dims, seed: int, name: str, device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """The weak-column slab of linear ``name``, all layers: bf16 [L, *lead, r, N]."""
    k, n = dims.linear(name)
    gen = generator(device, seed, name, "oweight")
    w = torch.randn((dims.layers, *lead, dims.n_outlier, n), generator=gen, device=device)
    return (w * k ** -0.5).to(SERVE_DTYPE)


def packed(dims: Dims, seed: int, name: str, device,
           lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Linear ``name`` of every layer: {"qweight", "scales", "szeros",
    "oweight"}, each [L, *lead, ...]."""
    k, n = dims.linear(name)
    g = dims.group
    lay = (dims.layers, *lead)
    gen = generator(device, seed, name, "codes")
    words = torch.randint(0, 256, (*lay, k // 8, n, 4), generator=gen, dtype=torch.uint8,
                          device=device).view(torch.int32).reshape(*lay, k // 8, n)
    gen = generator(device, seed, name, "scales")
    s = (torch.rand((*lay, k // g, n), generator=gen, device=device) * 0.5 + 0.75) / (4.61 * k ** 0.5)
    zero = torch.rand((*lay, k // g, n), generator=gen, device=device) * 0.5 + 7.25
    return {"qweight": words, "scales": s.to(SERVE_DTYPE), "szeros": (-s * zero).to(SERVE_DTYPE),
            "oweight": slab(dims, seed, name, device, lead)}


def make(dims: Dims, seed: int, device) -> Dict:
    """The whole model as plain tensors: the family's ``leaves``
    (`portbench.families`), which makes its packed linears by `packed`."""
    return family(dims.family).leaves(dims, seed, device)
