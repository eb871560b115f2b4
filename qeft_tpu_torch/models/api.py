"""Family-dispatched model API: the forward surfaces every caller (eval,
generation, benchmark) programs against.  Counterpart of
``qeft_tpu/models/api.py``; this slice carries the llama topology only
(llama and gemma)."""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelApi:
    family: str
    forward: Callable  # (params, tokens [B,S], cfg) -> logits [B,S,V]
    prefill: Callable  # (params, tokens, cache, cfg) -> (logits, cache)
    decode_step: Callable  # (params, token [B,1], cache, pos, cfg) -> (logits [B,V], cache)
    forward_window: Callable  # (params, tokens, cache, pos, cfg) -> (logits, cache)
    init_cache: Callable  # (cfg, batch, max_len, dtype, device, quantized) -> cache dict
    config_cls: type


def get_model_api(family: str) -> ModelApi:
    fam = family.lower()
    if fam not in ("llama", "gemma"):
        raise NotImplementedError(f"no model API for family {family!r} yet")
    from qeft_tpu_torch.models import llama as m

    return ModelApi(
        family=fam,
        forward=m.llama_forward,
        prefill=m.llama_prefill,
        decode_step=m.llama_decode_step,
        forward_window=m.llama_forward_window,
        init_cache=m.init_kv_cache,
        config_cls=m.LlamaConfig,
    )
