"""Family-dispatched model API: the forward surfaces every caller (eval,
generation, benchmark) programs against.  Counterpart of
``qeft_tpu/models/api.py``: llama (gemma on the same topology), OPT, Phi,
Bloom and Falcon; and DeepSeek-V2, which only the port has."""

from __future__ import annotations

import dataclasses
import functools
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


# family -> (module under qeft_tpu_torch.models, its config class).  The
# llama module names its own llama_forward, _prefill, _decode_step and
# _forward_window, the deepseek_v2 module its own forward, prefill,
# decode_step and forward_window; every other family's module gives
# `models.common`'s layer loop its DECODER hooks.  gemma runs on the llama topology (LlamaConfig
# switches).
_FAMILIES = {
    "llama": ("llama", "LlamaConfig"),
    "gemma": ("llama", "LlamaConfig"),
    "opt": ("opt", "OPTConfig"),
    "phi": ("phi", "PhiConfig"),
    "bloom": ("bloom", "BloomConfig"),
    "falcon": ("falcon", "FalconConfig"),
    "deepseek_v2": ("deepseek_v2", "DeepseekV2Config"),
}
_CACHE: Dict[str, ModelApi] = {}


def get_model_api(family: str) -> ModelApi:
    fam = family.lower()
    if fam not in _FAMILIES:
        raise NotImplementedError(f"no model API for family {family!r}")
    if fam not in _CACHE:
        module, config = _FAMILIES[fam]
        m = importlib.import_module(f"qeft_tpu_torch.models.{module}")
        if module == "llama":
            fns = (m.llama_forward, m.llama_prefill, m.llama_decode_step,
                   m.llama_forward_window, m.init_kv_cache)
        elif module == "deepseek_v2":
            fns = (m.forward, m.prefill, m.decode_step, m.forward_window, m.init_kv_cache)
        else:
            from qeft_tpu_torch.models import common

            fns = (*(functools.partial(f, m.DECODER) for f in (
                common.forward, common.prefill, common.decode_step, common.forward_window)),
                common.init_kv_cache)
        _CACHE[fam] = ModelApi(fam, *fns, config_cls=getattr(m, config))
    return _CACHE[fam]
