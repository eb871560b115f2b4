"""The system under test, ``qeft_tpu_torch``, as the benchmark reaches it:
its model configuration, its model API and its tree of packed linears, built
around the benchmark's own tensors (no copy).  Only the drivers import
this module."""

from __future__ import annotations

from typing import Dict

from portbench.shapes import Dims


def config(dims: Dims):
    """The port's configuration object of the family."""
    if dims.family == "opt":
        from qeft_tpu_torch.models.opt import OPTConfig

        return OPTConfig(vocab_size=dims.vocab, hidden_size=dims.hidden, ffn_dim=dims.ffn,
                         num_layers=dims.layers, num_heads=dims.heads,
                         max_position_embeddings=dims.positions, layer_norm_eps=dims.eps)
    from qeft_tpu_torch.models.falcon import FalconConfig

    return FalconConfig(vocab_size=dims.vocab, hidden_size=dims.hidden, num_layers=dims.layers,
                        num_heads=dims.heads, num_kv_heads=dims.kv_heads,
                        max_position_embeddings=dims.positions, layer_norm_eps=dims.eps,
                        rope_theta=dims.rope_theta)


def api(dims: Dims):
    from qeft_tpu_torch.models.api import get_model_api

    return get_model_api(dims.family)


def tree(dims: Dims, raw: Dict) -> Dict:
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
