"""Falcon (``configs/falcon-*.json``): parallel attention and MLP under one
shared LayerNorm, the fused qkv linear over ``num_kv_heads`` K/V heads
(one under ``multi_query``), rotary positions, no biases.  Its plain
reference is ``reference/falcon.py``."""

from __future__ import annotations

from typing import Dict

from portbench.families import dense
from portbench.families.dense import DenseDims
# the hooks every dense family shares
from portbench.families.dense import (decode_step, expect_decode, expect_train,  # noqa: F401
                                      train_step_ops, tree)

port_family = "falcon"


def dims(cfg: Dict) -> DenseDims:
    h = cfg["num_attention_heads"]
    return dense.dims(cfg, kv=cfg.get("num_kv_heads", 1 if cfg.get("multi_query") else h),
                      ffn=cfg.get("ffn_hidden_size", 4 * cfg["hidden_size"]),
                      eps=cfg["layer_norm_epsilon"], theta=cfg["rope_theta"],
                      norm_fed=("qkv", "fc1"))  # one norm feeds attention and the MLP


def config(dims: DenseDims):
    from qeft_tpu_torch.models.falcon import FalconConfig

    return FalconConfig(vocab_size=dims.vocab, hidden_size=dims.hidden, num_layers=dims.layers,
                        num_heads=dims.heads, num_kv_heads=dims.kv_heads,
                        max_position_embeddings=dims.positions, layer_norm_eps=dims.eps,
                        rope_theta=dims.rope_theta)


def leaves(dims: DenseDims, seed: int, device) -> Dict:
    return dense.leaves(dims, seed, device)
