"""Random packed weights made on the device from the seed, in the layout the
port serves (``qeft_tpu_torch/ops/packing.py``'s contract):

- int32 words ``[L, K/8, N]``, eight 4-bit codes a word, uniform codes;
- bf16 scales and scaled zeros ``[L, K/g, N]``: scales (0.75..1.25) /
  (4.61 sqrt(K)) (4.61 is the std of a uniform 4-bit code), zero points
  7.25..7.75, so each weight has a std of about 1/sqrt(K) and logits a sane
  scale;
- a bf16 weak-column slab ``[L, r, N]``, N(0, 1/K), for the last r K-rows;
- biases N(0, 0.02^2) where the family has them, unit norms, embeddings
  N(0, 0.02^2), the head tied to the embedding (held as embed^T, contiguous),
  and the o-projection's input gather ``o_reorder`` [L, K], a random
  permutation of each layer.

Each tensor draws from a generator of its own, seeded from (seed, its
name), so any one of them can be made again alone and equal.  The tree is
plain tensors; `portbench.program` wraps it for the port, and the reference
reads it as it is."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.seeds import derive
from portbench.shapes import Dims

SERVE_DTYPE = torch.bfloat16


def _gen(device, seed: int, *keys) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", *keys))
    return gen


def slab(dims: Dims, seed: int, name: str, device) -> torch.Tensor:
    """The weak-column slab of linear ``name``, all layers: bf16 [L, r, N]."""
    k, n = dims.linear(name)
    gen = _gen(device, seed, name, "oweight")
    w = torch.randn((dims.layers, dims.n_outlier, n), generator=gen, device=device)
    return (w * k ** -0.5).to(SERVE_DTYPE)


def packed(dims: Dims, seed: int, name: str, device) -> Dict[str, torch.Tensor]:
    """Linear ``name`` of every layer: {"qweight", "scales", "szeros", "oweight"}."""
    k, n = dims.linear(name)
    lay, g = dims.layers, dims.group
    gen = _gen(device, seed, name, "codes")
    words = torch.randint(0, 256, (lay, k // 8, n, 4), generator=gen, dtype=torch.uint8,
                          device=device).view(torch.int32).reshape(lay, k // 8, n)
    gen = _gen(device, seed, name, "scales")
    s = (torch.rand((lay, k // g, n), generator=gen, device=device) * 0.5 + 0.75) / (4.61 * k ** 0.5)
    zero = torch.rand((lay, k // g, n), generator=gen, device=device) * 0.5 + 7.25
    return {"qweight": words, "scales": s.to(SERVE_DTYPE), "szeros": (-s * zero).to(SERVE_DTYPE),
            "oweight": slab(dims, seed, name, device)}


def make(dims: Dims, seed: int, device) -> Dict:
    """The whole model as plain tensors: {"embed", "lm_head", "final_ln",
    "final_ln_b", ["embed_pos"], "layers": {linear: packed dict,
    "<linear>_b", "attn_ln", "attn_ln_b", ["final_ln", "final_ln_b"],
    "o_reorder"}}."""
    lay, d = dims.layers, dims.hidden
    ones = torch.ones((lay, d), dtype=SERVE_DTYPE, device=device)
    layers: Dict = {"attn_ln": ones, "attn_ln_b": torch.zeros_like(ones)}
    if dims.family == "opt":
        layers["final_ln"], layers["final_ln_b"] = ones.clone(), torch.zeros_like(ones)
    for name, k, n in dims.linears:
        layers[name] = packed(dims, seed, name, device)
        if dims.biases:
            gen = _gen(device, seed, name, "bias")
            layers[name + "_b"] = (torch.randn((lay, n), generator=gen, device=device)
                                   * 0.02).to(SERVE_DTYPE)
    gen = _gen(device, seed, "o_reorder")
    k_out = dims.linear(dims.out_linear)[0]
    layers["o_reorder"] = torch.argsort(torch.rand((lay, k_out), generator=gen, device=device),
                                        dim=-1).to(torch.int32)
    gen = _gen(device, seed, "embed")
    embed = (torch.randn((dims.vocab, d), generator=gen, device=device) * 0.02).to(SERVE_DTYPE)
    tree = {"embed": embed, "lm_head": embed.t().contiguous(), "layers": layers,
            "final_ln": torch.ones(d, dtype=SERVE_DTYPE, device=device),
            "final_ln_b": torch.zeros(d, dtype=SERVE_DTYPE, device=device)}
    if dims.family == "opt":
        gen = _gen(device, seed, "embed_pos")
        tree["embed_pos"] = (torch.randn((dims.positions + 2, d), generator=gen, device=device)
                             * 0.02).to(SERVE_DTYPE)
    return tree
