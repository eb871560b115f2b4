"""What the dense families (``opt``, ``falcon``) share: every layer holds the
same packed linears, every linear is read once a step, one LayerNorm (or
two) a layer, the head tied to the token embedding, and the attention output
projection's input gathered by ``o_reorder``.  Each family's module gives
its own glue (sizes, norms, positions, the port's config) and takes the
rest from here."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from portbench import costs, weights
from portbench.shapes import Dims


@dataclasses.dataclass(frozen=True)
class DenseDims(Dims):
    ffn: int
    positions: int
    biases: bool
    eps: float
    rope_theta: float
    out_linear: str  # the attention output projection, whose input o_reorder gathers
    # linears that read the block's first norm of its input: in layer 0 that
    # is the embedding, so their input needs no gradient (no dx when training)
    norm_fed: Tuple[str, ...]


def dims(cfg: Dict, kv: int, ffn: int, eps: float, theta: float,
         norm_fed: Tuple[str, ...]) -> DenseDims:
    """The sizes of ``cfg`` with the family's own ``kv`` heads, ``ffn``
    width, norm ``eps``, rotary ``theta`` and ``norm_fed`` linears."""
    q = cfg["qeft"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim", d // h)
    size = {"hidden": d, "ffn": ffn, "qkv": (h + 2 * kv) * head_dim}
    linears = tuple((name, size[k], size[n]) for name, (k, n) in q["linears"].items())
    return DenseDims(family=cfg["family"], layers=cfg["num_hidden_layers"], hidden=d, heads=h,
                     kv_heads=kv, head_dim=head_dim, vocab=cfg["vocab_size"],
                     group=q["group_size"], n_outlier=q["n_outlier"], linears=linears,
                     ffn=ffn, positions=cfg["max_position_embeddings"],
                     biases=bool(q["biases"]), eps=eps, rope_theta=theta,
                     out_linear=q["out_linear"], norm_fed=norm_fed)


def tree(dims: DenseDims, raw: Dict) -> Dict:
    """The port's parameter tree over ``raw`` (`weights.make`): each packed
    linear a stacked ``QLinearParams``, the rest as it is."""
    from qeft_tpu_torch.ops.packing import QLinearParams

    layers = dict(raw["layers"])
    for name, _, _ in dims.linears:
        lin = raw["layers"][name]
        layers[name] = QLinearParams(qweight=lin["qweight"], scales=lin["scales"],
                                     scaled_zeros=lin["szeros"], oweight=lin["oweight"],
                                     group_size=dims.group)
    return {**raw, "layers": layers}


def leaves(dims: DenseDims, seed: int, device, norms: Tuple[str, ...] = ("attn_ln",)) -> Dict:
    """{"embed", "lm_head", "final_ln", "final_ln_b", "layers": {each of
    ``norms`` and its "_b", each packed linear (`weights.packed`, no leading
    axes) and its "_b", "o_reorder"}}: unit norms, biases N(0, 0.02^2)
    where the family has them, embeddings N(0, 0.02^2), the head tied to
    the embedding (held as embed^T, contiguous), and the o-projection's
    input gather, a random permutation of each layer."""
    lay, d = dims.layers, dims.hidden
    dt = weights.SERVE_DTYPE
    layers: Dict = {}
    for norm in norms:
        layers[norm] = torch.ones((lay, d), dtype=dt, device=device)
        layers[norm + "_b"] = torch.zeros((lay, d), dtype=dt, device=device)
    for name, _, n in dims.linears:
        layers[name] = weights.packed(dims, seed, name, device)
        if dims.biases:
            gen = weights.generator(device, seed, name, "bias")
            layers[name + "_b"] = (torch.randn((lay, n), generator=gen, device=device)
                                   * 0.02).to(dt)
    gen = weights.generator(device, seed, "o_reorder")
    k_out = dims.linear(dims.out_linear)[0]
    layers["o_reorder"] = torch.argsort(torch.rand((lay, k_out), generator=gen, device=device),
                                        dim=-1).to(torch.int32)
    gen = weights.generator(device, seed, "embed")
    embed = (torch.randn((dims.vocab, d), generator=gen, device=device) * 0.02).to(dt)
    return {"embed": embed, "lm_head": embed.t().contiguous(), "layers": layers,
            "final_ln": torch.ones(d, dtype=dt, device=device),
            "final_ln_b": torch.zeros(d, dtype=dt, device=device)}


def decode_step(dims: DenseDims, batch: int, keys: int):
    """(operations, bytes) one decode step needs at ``keys`` cached positions
    (the new one included): the packed linears, their slabs, scales and
    biases, the head, and K and V of every layer up to the position."""
    ops = nbytes = 0
    for _, k, n in dims.linears:
        o, _ = costs.qgemv_call(batch, k, n, dims.group, dims.n_outlier, dims.biases)
        ops += o
        nbytes += costs.weight_bytes(k, n, dims.group, dims.n_outlier, dims.biases)
    ops *= dims.layers
    nbytes *= dims.layers
    ops += 4 * batch * dims.heads * dims.head_dim * keys * dims.layers
    nbytes += 2 * 2 * dims.layers * batch * dims.kv_heads * keys * dims.head_dim
    ops += 2 * batch * dims.hidden * dims.vocab
    nbytes += 2 * dims.hidden * dims.vocab
    return ops, nbytes


def train_step_ops(dims: DenseDims, batch: int, seq: int) -> int:
    """Operations one WCT step needs, without the recomputed forward: each
    packed linear forward over K + r rows, its ``dx`` over K rows (not for the
    first layer's linears fed by the embedding's norm, whose input needs no
    gradient), the slab's
    gradient and its share of ``dx``; causal attention forward and twice
    backward; the head forward and its ``dx``."""
    m = batch * seq
    per_layer = first_layer = 0
    for name, k, n in dims.linears:
        r = dims.n_outlier
        fwd = 2 * m * n * (k + r)
        dx = 2 * m * k * n
        slab = 2 * (2 * m * r * n)
        per_layer += fwd + dx + slab
        first_layer += fwd + (0 if name in dims.norm_fed else dx) + slab
    attn = 3 * 4 * batch * dims.heads * dims.head_dim * costs.attention_pairs(seq)
    head = 2 * (2 * m * dims.hidden * dims.vocab)
    return (dims.layers - 1) * (per_layer + attn) + first_layer + attn + head


def expect_decode(run) -> Dict[str, List]:
    """K5 calls of the decode steps, K2 calls of the prefills, and (batch,
    keys) of every decode step of the traced requests.  The first token
    comes from the prefill, so a request of T tokens runs T - 1 steps."""
    d = run.dims
    qgemv, qgemm, steps = [], [], []
    for prompt, output, batch in run.traced["requests"]:
        for _, k, n in d.linears:
            qgemv += [(batch, k, n, d.group, d.n_outlier, d.biases)] * (d.layers * (output - 1))
            qgemm += [(batch * prompt, k, n, d.group, d.n_outlier, d.biases)] * d.layers
        steps += [(batch, prompt + i) for i in range(1, output)]
    return {"qgemv": qgemv, "qgemm": qgemm, "steps": steps}


def expect_train(run) -> Dict[str, List]:
    """K2 calls (each linear forward and once more recomputed, remat on) and
    K7 calls (each linear's dx but the first layer's norm-fed ones) of the
    traced steps."""
    d, mix = run.dims, run.mix
    m = mix["batch"] * mix["seq"]
    remat = 2 if mix["optimizer"]["remat"] else 1
    qgemm, qgemm_t = [], []
    for _ in range(run.traced["steps"]):
        for name, k, n in d.linears:
            call = (m, k, n, d.group, d.n_outlier, d.biases)
            qgemm += [call] * (remat * d.layers)
            qgemm_t += [call] * (d.layers - (name in d.norm_fed))
    return {"qgemm": qgemm, "qgemm_t": qgemm_t}
