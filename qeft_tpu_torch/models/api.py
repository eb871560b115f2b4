"""Family-dispatched model API: the surfaces every caller (eval, generation,
training, quantization, benchmark) programs against, one value a family
module.  Counterpart of ``qeft_tpu/models/api.py``: llama (gemma on the same
topology), OPT, Phi, Bloom and Falcon; and DeepSeek-V2, which only the port has."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class ModelApi:
    family: str
    forward: Callable  # (params, tokens [B,S], cfg) -> logits [B,S,V]
    prefill: Callable  # (params, tokens, cache, cfg) -> (logits, cache)
    decode_step: Callable  # (params, token [B,1], cache, pos, cfg) -> (logits [B,V], cache)
    forward_window: Callable  # (params, tokens, cache, pos, cfg) -> (logits, cache)
    init_cache: Callable  # (cfg, batch, max_len, dtype, device, quantized) -> cache dict
    config_cls: type
    forward_train: Callable  # (params, tokens [B,S], cfg, remat) -> logits under autograd
    embed: Callable  # (params, tokens [B,S], cfg) -> block 0's input x [B,S,D]
    # (layers, cfg, s, device) -> block(x, capture) -> x: block 0 over s tokens, no cache,
    # as calibration (dense, ``capture`` gets the four stages' inputs) and eval_ppl_streamed run it
    calibration_block: Callable


# family -> (module under qeft_tpu_torch.models, the name of its ModelApi)
_FAMILIES = {
    "llama": ("llama", "MODEL_API"),
    "gemma": ("llama", "GEMMA_API"),
    "opt": ("opt", "MODEL_API"),
    "phi": ("phi", "MODEL_API"),
    "bloom": ("bloom", "MODEL_API"),
    "falcon": ("falcon", "MODEL_API"),
    "deepseek_v2": ("deepseek_v2", "MODEL_API"),
}
_CACHE: Dict[str, ModelApi] = {}


def get_model_api(family: str) -> ModelApi:
    fam = family.lower()
    if fam not in _FAMILIES:
        raise NotImplementedError(f"no model API for family {family!r}")
    if fam not in _CACHE:
        module, name = _FAMILIES[fam]
        _CACHE[fam] = getattr(importlib.import_module(f"qeft_tpu_torch.models.{module}"), name)
    return _CACHE[fam]
