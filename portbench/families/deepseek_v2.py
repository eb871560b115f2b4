"""DeepSeek-V2 (``configs/deepseek-v2-lite.json``): multi-head latent
attention over a cache of one ``kv_lora_rank + qk_rope_head_dim`` row a
token, a leading dense SwiGLU MLP, then mixture-of-experts layers (a bf16
router, ``num_experts_per_tok`` of ``n_routed_experts`` SwiGLU experts and
the shared experts as one SwiGLU), RMSNorm, an untied head.  Its plain
reference is ``reference/deepseek_v2.py``.

The experts' linears are held with ``lead=(experts,)`` on the MoE layers
only, the dense MLP on the leading dense layers only.  A decode step's
bytes count the experts its tokens are expected to touch under uniform
routing, ``E (1 - (1 - k/E)^B)`` of them a layer, each read once: the
yardstick reads the shapes and the traffic, never what the program routed.
A decode step reads ``kv_b``'s weight as the port holds it for the absorbed
form, dequantized bf16 per head (``w_uk``, ``w_uv``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from portbench import costs, weights
from portbench.shapes import Dims

port_family = "deepseek_v2"

# (linear, the leading axes of its layers): "all" every layer, "dense" the
# leading dense layers, "moe" the MoE layers, "experts" the MoE layers x experts
LINEARS = (("q", "all"), ("kv_a", "all"), ("kv_b", "all"), ("o", "all"),
           ("gate_up", "dense"), ("down", "dense"),
           ("shared_gate_up", "moe"), ("shared_down", "moe"),
           ("experts_gate_up", "experts"), ("experts_down", "experts"))
# the linears a decode step runs through the packed linear (kv_b: the absorbed
# bf16 form instead), by where they live
DECODE_DENSE = ("q", "kv_a", "o", "gate_up", "down", "shared_gate_up", "shared_down")


@dataclasses.dataclass(frozen=True)
class DeepseekDims(Dims):
    ffn: int  # the dense MLP's width
    expert_ffn: int
    experts: int
    top_k: int
    shared: int
    routed_scale: float  # routed_scaling_factor
    dense_layers: int
    rank: int  # kv_lora_rank
    nope: int
    rope: int
    v: int
    eps: float
    rope_theta: float
    rope_scaling: Tuple[Tuple[str, float], ...]
    groups: Tuple[Tuple[str, int], ...]  # each packed linear's group size

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    @property
    def row(self) -> int:
        """Width of a cached row: the latent and the shared roped key."""
        return self.rank + self.rope

    def group_of(self, name: str) -> int:
        return dict(self.groups)[name]

    def stack(self, name: str) -> Tuple[int, ...]:
        """The leading axes linear ``name`` is held with: (layers,) or
        (MoE layers, experts)."""
        where = dict(LINEARS)[name]
        return {"all": (self.layers,), "dense": (self.dense_layers,),
                "moe": (self.moe_layers,), "experts": (self.moe_layers, self.experts)}[where]


def dims(cfg: Dict) -> DeepseekDims:
    q = cfg["qeft"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                           cfg["kv_lora_rank"])
    fe, shared = cfg["moe_intermediate_size"], cfg["n_shared_experts"]
    size = {"hidden": d, "q": h * (nope + rope), "latent_row": rank + rope, "kv_lora_rank": rank,
            "kv_b": h * (nope + v), "attn_out": h * v, "intermediate_size": cfg["intermediate_size"],
            "dense_gate_up": 2 * cfg["intermediate_size"], "shared_width": shared * fe,
            "shared_gate_up": 2 * shared * fe, "moe_intermediate_size": fe,
            "expert_gate_up": 2 * fe}
    linears = tuple((name, size[spec[0]], size[spec[1]]) for name, spec in q["linears"].items())
    g = q["group_size"]
    groups = tuple((name, g if k % g == 0 else 64) for name, k, _ in linears)
    scaling = tuple(sorted((k, float(x)) for k, x in cfg["rope_scaling"].items() if k != "type"))
    return DeepseekDims(
        family=cfg["family"], layers=cfg["num_hidden_layers"], hidden=d, heads=h, kv_heads=1,
        head_dim=nope + rope, vocab=cfg["vocab_size"], group=g, n_outlier=q["n_outlier"],
        linears=linears, ffn=cfg["intermediate_size"], expert_ffn=fe,
        experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"], shared=shared,
        routed_scale=float(cfg["routed_scaling_factor"]), dense_layers=cfg["first_k_dense_replace"], rank=rank, nope=nope, rope=rope, v=v,
        eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]), rope_scaling=scaling,
        groups=groups)


def config(dims: DeepseekDims):
    from qeft_tpu_torch.models.deepseek_v2 import DeepseekV2Config

    rs = dict(dims.rope_scaling)
    return DeepseekV2Config(
        vocab_size=dims.vocab, hidden_size=dims.hidden, intermediate_size=dims.ffn,
        moe_intermediate_size=dims.expert_ffn, num_layers=dims.layers, num_heads=dims.heads,
        n_routed_experts=dims.experts, n_shared_experts=dims.shared,
        num_experts_per_tok=dims.top_k, routed_scaling_factor=dims.routed_scale,
        first_k_dense_replace=dims.dense_layers,
        kv_lora_rank=dims.rank, qk_nope_head_dim=dims.nope, qk_rope_head_dim=dims.rope,
        v_head_dim=dims.v, rms_norm_eps=dims.eps, rope_theta=dims.rope_theta,
        rope_factor=rs["factor"], rope_original_max_position=int(rs["original_max_position_embeddings"]),
        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"], rope_mscale=rs["mscale"],
        rope_mscale_all_dim=rs["mscale_all_dim"])


def tree(dims: DeepseekDims, raw: Dict) -> Dict:
    """The port's tree over ``raw``: each packed linear a ``QLinearParams``
    with its leading axes, the absorbed ``kv_b`` made by the port."""
    from qeft_tpu_torch.models.deepseek_v2 import with_absorbed
    from qeft_tpu_torch.ops.packing import QLinearParams

    layers = dict(raw["layers"])
    for name, _, _ in dims.linears:
        lin = raw["layers"][name]
        layers[name] = QLinearParams(qweight=lin["qweight"], scales=lin["scales"],
                                     scaled_zeros=lin["szeros"], oweight=lin["oweight"],
                                     group_size=dims.group_of(name))
    return with_absorbed({**raw, "layers": layers}, config(dims))


def leaves(dims: DeepseekDims, seed: int, device) -> Dict:
    """{"embed", "lm_head", "final_ln", "layers": {"input_ln", "post_ln",
    "kv_a_ln", each packed linear (`weights.packed` over its own layers,
    the experts' with ``lead=(experts,)``), "router", "o_reorder"}}: unit
    norms, embeddings N(0, 0.02^2), the router and the untied head N(0,
    1/hidden), the o-projection's input gather a random permutation of each
    layer."""
    lay, d = dims.layers, dims.hidden
    dt = weights.SERVE_DTYPE
    layers: Dict = {name: torch.ones((lay, width), dtype=dt, device=device)
                    for name, width in (("input_ln", d), ("post_ln", d), ("kv_a_ln", dims.rank))}
    for name, _, _ in dims.linears:
        stack = dims.stack(name)
        own = dataclasses.replace(dims, layers=stack[0], group=dims.group_of(name))
        layers[name] = weights.packed(own, seed, name, device, lead=stack[1:])
    gen = weights.generator(device, seed, "router")
    layers["router"] = (torch.randn((dims.moe_layers, d, dims.experts), generator=gen,
                                    device=device) * d ** -0.5).to(dt)
    gen = weights.generator(device, seed, "o_reorder")
    k_out = dims.linear("o")[0]
    layers["o_reorder"] = torch.argsort(torch.rand((lay, k_out), generator=gen, device=device),
                                        dim=-1).to(torch.int32)
    gen = weights.generator(device, seed, "embed")
    embed = (torch.randn((dims.vocab, d), generator=gen, device=device) * 0.02).to(dt)
    gen = weights.generator(device, seed, "lm_head")
    head = (torch.randn((d, dims.vocab), generator=gen, device=device) * d ** -0.5).to(dt)
    return {"embed": embed, "lm_head": head, "layers": layers,
            "final_ln": torch.ones(d, dtype=dt, device=device)}


def expected_experts(dims: DeepseekDims, tokens: int) -> float:
    """Distinct experts ``tokens`` tokens touch in a layer under uniform
    routing: E (1 - (1 - k/E)^tokens)."""
    e, k = dims.experts, dims.top_k
    return e * (1.0 - (1.0 - k / e) ** tokens)


def expert_bytes(dims: DeepseekDims, name: str) -> int:
    """Bytes of one expert's linear ``name``: codes, scales and slab."""
    k, n = dims.linear(name)
    return costs.weight_bytes(k, n, dims.group_of(name), dims.n_outlier, False)


def moe_call(dims: DeepseekDims, tokens: int, name: str):
    """(operations, bytes) of one grouped expert matvec (``qgemv_moe``) of
    ``tokens`` tokens, each through ``top_k`` experts: the expected distinct
    experts' codes, scales and slabs once each, the rows in and out."""
    k, n = dims.linear(name)
    rows = tokens * dims.top_k
    ops = 2 * rows * n * (k + dims.n_outlier)
    return ops, expected_experts(dims, tokens) * expert_bytes(dims, name) + 2 * rows * (k + n)


def latent_call(dims: DeepseekDims, batch: int, keys: int):
    """(operations, bytes) of one latent decode attention of a layer:
    ``batch`` x ``keys`` cached rows once, the queries in, the output out."""
    h = dims.heads
    ops = 2 * batch * h * keys * (dims.row + dims.rank)
    return ops, 2 * batch * keys * dims.row + 2 * batch * h * (dims.row + dims.rank)


def _dense_calls(dims: DeepseekDims):
    """(name, K, N, layers it runs on) of the linears a token passes
    through as one packed linear each (not the experts)."""
    for name in DECODE_DENSE:
        k, n = dims.linear(name)
        yield name, k, n, dims.stack(name)[0]


def decode_step(dims: DeepseekDims, batch: int, keys: int):
    """(operations, bytes) one decode step needs at ``keys`` cached
    positions: the packed linears, the experts its ``batch`` tokens are
    expected to touch (`expected_experts`), the absorbed ``kv_b`` (bf16),
    the router, the cache rows up to the position, the head."""
    r = dims.n_outlier
    ops = nbytes = 0
    for name, k, n, lay in _dense_calls(dims):
        ops += lay * 2 * batch * n * (k + r)
        nbytes += lay * costs.weight_bytes(k, n, dims.group_of(name), r, False)
    for name in ("experts_gate_up", "experts_down"):
        ops += dims.moe_layers * moe_call(dims, batch, name)[0]
        nbytes += dims.moe_layers * expected_experts(dims, batch) * expert_bytes(dims, name)
    absorbed = dims.heads * dims.rank * (dims.nope + dims.v)  # elements of w_uk and w_uv
    ops += dims.layers * 2 * batch * absorbed
    nbytes += dims.layers * 2 * absorbed
    ops += dims.moe_layers * 2 * batch * dims.hidden * dims.experts
    nbytes += dims.moe_layers * 2 * dims.hidden * dims.experts
    ops += dims.layers * latent_call(dims, batch, keys)[0]
    nbytes += dims.layers * 2 * batch * keys * dims.row
    ops += 2 * batch * dims.hidden * dims.vocab
    nbytes += 2 * dims.hidden * dims.vocab
    return ops, nbytes


def expect_decode(run) -> Dict[str, List]:
    """The calls the shapes fix in the traced requests: K5 (at most 8 rows)
    or K2 calls of the packed linears a decode step runs (the experts
    apart), the prefills' K2 calls of every linear but the experts' (a
    prefill runs the experts one at a time over the rows the routing gave
    them: those calls depend on the routing and are not listed), the grouped
    expert matvecs (``moe``: (tokens, linear) a call), the latent attention
    calls (``latent``: (batch, keys)) and the decode steps (batch, keys)."""
    d = run.dims
    r = d.n_outlier
    qgemv, qgemm, moe, latent, steps = [], [], [], [], []
    for prompt, output, batch in run.traced["requests"]:
        m = batch * prompt
        for name, k, n, lay in _dense_calls(d):
            qgemm += [(m, k, n, d.group_of(name), r, False)] * lay
        k, n = d.linear("kv_b")
        qgemm += [(m, k, n, d.group_of("kv_b"), r, False)] * d.layers
        for i in range(1, output):
            for name, k, n, lay in _dense_calls(d):
                call = (batch, k, n, d.group_of(name), r, False)
                (qgemv if batch <= 8 else qgemm).extend([call] * lay)
            moe += [(batch, name) for name in ("experts_gate_up", "experts_down")] * d.moe_layers
            latent += [(batch, prompt + i)] * d.layers
            steps.append((batch, prompt + i))
    return {"qgemv": qgemv, "qgemm": qgemm, "moe": moe, "latent": latent, "steps": steps}
