"""The sizes a configuration file states, read once: the model's widths and
each packed linear's (K, N).  Weights, costs and the reference all read
their shapes from here, never from the program."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    ffn: int
    vocab: int
    positions: int
    group: int
    n_outlier: int
    biases: bool
    eps: float
    rope_theta: float
    linears: Tuple[Tuple[str, int, int], ...]  # (name, K, N) of each packed linear
    out_linear: str  # the attention output projection, whose input o_reorder gathers
    # linears that read the block's first norm of its input: in layer 0 that
    # is the embedding, so their input needs no gradient (no dx when training)
    norm_fed: Tuple[str, ...]

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def linear(self, name: str) -> Tuple[int, int]:
        for n, k, out in self.linears:
            if n == name:
                return k, out
        raise KeyError(name)


def dims(cfg: Dict) -> Dims:
    """``cfg``: a configuration file's dict (Hugging Face keys plus ``qeft``)."""
    family = cfg["family"]
    q = cfg["qeft"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if family == "opt":
        kv, ffn = h, cfg["ffn_dim"]
        eps, theta = cfg.get("layer_norm_eps", 1e-5), 0.0
        norm_fed = ("q", "k", "v")
    elif family == "falcon":
        kv = cfg.get("num_kv_heads", 1 if cfg.get("multi_query") else h)
        ffn = cfg.get("ffn_hidden_size", 4 * d)
        eps, theta = cfg["layer_norm_epsilon"], cfg["rope_theta"]
        norm_fed = ("qkv", "fc1")  # the parallel block: one norm feeds attention and the MLP
    else:
        raise ValueError(f"no reference for family {family!r}")
    size = {"hidden": d, "ffn": ffn, "qkv": (h + 2 * kv) * (d // h)}
    linears = tuple((name, size[k], size[n]) for name, (k, n) in q["linears"].items())
    return Dims(family=family, layers=cfg["num_hidden_layers"], hidden=d, heads=h, kv_heads=kv,
                ffn=ffn, vocab=cfg["vocab_size"], positions=cfg["max_position_embeddings"],
                group=q["group_size"], n_outlier=q["n_outlier"], biases=bool(q["biases"]),
                eps=eps, rope_theta=theta, linears=linears,
                out_linear=q["out_linear"], norm_fed=norm_fed)
