"""Which linears a decoder block holds, by sequential quantization stage,
their per-layer outlier budget ratios and the block's norm names.
Counterpart of ``qeft_tpu/models/registry.py`` (every family, the same name
dispatch).

The four stages: [0] qkv-like (input = residual stream), [1] out-like
(input = attention head space), [2] ffn1-like (input = residual stream),
[3] ffn2-like (input = MLP internal space)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    family: str
    qkv: Tuple[str, ...]  # input = residual stream
    out: Tuple[str, ...]  # input = attention head space
    ffn1: Tuple[str, ...]  # input = residual stream
    ffn2: Tuple[str, ...]  # input = MLP internal space
    ratios: Dict[str, float] = dataclasses.field(default_factory=dict, hash=False)
    ln: Tuple[str, ...] = ("input_ln", "post_ln")  # norm scales permuted with the stream
    latent: Tuple[str, ...] = ()  # input = a latent space of attention (DeepSeek-V2's kv_b)

    @property
    def all_linears(self) -> Tuple[str, ...]:
        return self.qkv + self.out + self.ffn1 + self.ffn2 + self.latent


_LLAMA_STAGES = dict(qkv=("q", "k", "v"), out=("o",), ffn1=("up", "gate"), ffn2=("down",))
_FC_STAGES = dict(qkv=("q", "k", "v"), out=("o",), ffn1=("fc1",), ffn2=("fc2",))
_FUSED_QKV_STAGES = dict(qkv=("qkv",), out=("dense",), ffn1=("fc1",), ffn2=("fc2",))

_METAS: Dict[str, ModelMeta] = {
    "llama": ModelMeta(family="llama", **_LLAMA_STAGES, ratios={
        "q": 1.0, "k": 1.0, "v": 1.0, "o": 1.0, "up": 0.375, "gate": 0.375, "down": 0.375}),
    "gemma": ModelMeta(family="gemma", **_LLAMA_STAGES, ratios={
        "q": 1.0, "k": 1.0, "v": 1.0, "o": 1.0, "up": 0.125, "gate": 0.125, "down": 0.125}),
    "opt": ModelMeta(family="opt", **_FC_STAGES, ratios={
        "q": 1.0, "k": 1.0, "v": 1.0, "o": 1.0, "fc1": 0.25, "fc2": 0.25},
        ln=("attn_ln", "final_ln")),
    # phi's block is parallel: one LayerNorm feeds attention and the MLP
    "phi": ModelMeta(family="phi", **_FC_STAGES, ratios={
        "q": 1.0, "k": 1.0, "v": 1.0, "o": 1.0, "fc1": 0.25, "fc2": 0.25},
        ln=("input_ln",)),
    "bloom": ModelMeta(family="bloom", **_FUSED_QKV_STAGES, ratios={
        "qkv": 3.0, "dense": 1.0, "fc1": 0.25, "fc2": 0.25}, ln=("attn_ln", "post_ln")),
    # mlp_ln exists only on the falcon-40B lineage's blocks (dual_ln)
    "falcon": ModelMeta(family="falcon", **_FUSED_QKV_STAGES, ratios={
        "qkv": 3.0, "dense": 1.0, "fc1": 0.25, "fc2": 0.25}, ln=("attn_ln", "mlp_ln")),
    # the port's own family: the dense MLP on the leading layers, the shared
    # and routed experts' on the rest; kv_b reads the normalised latent
    "deepseek_v2": ModelMeta(
        family="deepseek_v2", qkv=("q", "kv_a"), out=("o",),
        ffn1=("gate_up", "shared_gate_up", "experts_gate_up"),
        ffn2=("down", "shared_down", "experts_down"), latent=("kv_b",),
        ln=("input_ln", "post_ln", "kv_a_ln")),
}


def get_model_meta(name: str) -> ModelMeta:
    """Name-based dispatch, in the JAX package's order."""
    low = name.lower()
    if "deepseek" in low:
        return _METAS["deepseek_v2"]
    if "opt" in low:
        return _METAS["opt"]
    if "llama" in low or "vicuna" in low or "stablebeluga" in low:
        return _METAS["llama"]
    for family in ("gemma", "phi", "bloom", "falcon"):
        if family in low:
            return _METAS[family]
    if low in _METAS:
        return _METAS[low]
    raise NotImplementedError(f"{name} model family is not implemented")
