"""OPT (``configs/opt-*.json``): multi-head attention, q, k and v unfused,
two LayerNorms a layer, a learned position embedding, biases.  Its plain
reference is ``reference/opt.py``."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import weights
from portbench.families import dense
from portbench.families.dense import DenseDims
# the hooks every dense family shares
from portbench.families.dense import (decode_step, expect_decode, expect_train,  # noqa: F401
                                      train_step_ops, tree)

port_family = "opt"


def dims(cfg: Dict) -> DenseDims:
    return dense.dims(cfg, kv=cfg["num_attention_heads"], ffn=cfg["ffn_dim"],
                      eps=cfg.get("layer_norm_eps", 1e-5), theta=0.0, norm_fed=("q", "k", "v"))


def config(dims: DenseDims):
    from qeft_tpu_torch.models.opt import OPTConfig

    return OPTConfig(vocab_size=dims.vocab, hidden_size=dims.hidden, ffn_dim=dims.ffn,
                     num_layers=dims.layers, num_heads=dims.heads,
                     max_position_embeddings=dims.positions, layer_norm_eps=dims.eps)


def leaves(dims: DenseDims, seed: int, device) -> Dict:
    """The dense leaves with the second norm of each layer (``final_ln``)
    and the position embedding N(0, 0.02^2), read at position + 2."""
    out = dense.leaves(dims, seed, device, norms=("attn_ln", "final_ln"))
    gen = weights.generator(device, seed, "embed_pos")
    out["embed_pos"] = (torch.randn((dims.positions + 2, dims.hidden), generator=gen,
                                    device=device) * 0.02).to(weights.SERVE_DTYPE)
    return out
