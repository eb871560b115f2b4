"""One seam for a model family: each family module's `ModelApi` value
carries every surface, and its training and quantizer surfaces are the
functions they wrap, bit for bit, on tiny models in f32 on the CPU.
DeepSeek-V2's unported surfaces raise ``NotImplementedError`` and name
their ROADMAP item."""

import dataclasses

import pytest
import torch

from qeft_tpu_torch import finetune
from qeft_tpu_torch.models import (
    BLOOM_PRESETS,
    DEEPSEEK_V2_PRESETS,
    FALCON_PRESETS,
    LLAMA_PRESETS,
    OPT_PRESETS,
    PHI_PRESETS,
    bloom,
    common,
    falcon,
    llama,
    opt,
    phi,
)
from qeft_tpu_torch.models.api import ModelApi, get_model_api
from qeft_tpu_torch.ops.flash import flash_window_attention_any
from qeft_tpu_torch.testing import build_packed_model
from tests import torch_parity  # noqa: F401  (one torch thread a test worker)

# family -> (tiny config, its module, its Decoder or None for the llama loop)
TINY = {
    "llama": (LLAMA_PRESETS["tiny"], llama, None),
    "gemma": (LLAMA_PRESETS["tiny-gemma"], llama, None),
    "opt": (OPT_PRESETS["opt-tiny"], opt, opt.DECODER),
    "phi": (PHI_PRESETS["phi-tiny"], phi, phi.DECODER),
    "bloom": (BLOOM_PRESETS["bloom-tiny"], bloom, bloom.DECODER),
    "falcon": (FALCON_PRESETS["falcon-tiny"], falcon, falcon.DECODER),
}
B, S = 2, 12


def _tokens(cfg, b=B):
    return torch.randint(0, cfg.vocab_size, (b, S), generator=torch.Generator().manual_seed(1))


def _f32(family):
    cfg, module, dec = TINY[family]
    return dataclasses.replace(cfg, dtype=torch.float32), module, dec


@pytest.mark.parametrize("family", [*TINY, "deepseek_v2"])
def test_every_family_value_has_every_surface(family):
    api = get_model_api(family)
    assert isinstance(api, ModelApi) and api.family == family
    assert get_model_api(family.upper()) is api
    for field in dataclasses.fields(ModelApi)[1:]:
        assert callable(getattr(api, field.name)), field.name
    if family in TINY:
        cfg, module, dec = TINY[family]
        assert isinstance(cfg, api.config_cls)
        if dec is None:
            assert api.forward_window is llama.llama_forward_window
        else:
            assert api.forward_window.func is common.forward_window
            assert api.forward_window.args == (dec,)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("family", list(TINY))
def test_forward_train_is_the_function_it_wraps(family, remat):
    cfg, _, dec = _f32(family)
    params = build_packed_model(cfg, seed=3, g=32, r=8, dtype=torch.float32, device="cpu",
                                family=family)
    tokens = _tokens(cfg)
    got = get_model_api(family).forward_train(params, tokens, cfg, remat)
    if dec is None:
        want = llama.llama_forward_train(params, tokens, cfg, remat)
    else:
        want = common.forward_train(dec, params, tokens, cfg, remat)
    assert got.shape == (B, S, cfg.vocab_size)
    assert torch.equal(got, want)
    assert torch.equal(finetune.train_forward(params, tokens, cfg, remat, family), want)


@pytest.mark.parametrize("family", list(TINY))
def test_quantizer_surfaces_are_the_functions_they_wrap(family):
    cfg, module, dec = _f32(family)
    params = module.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    tokens = _tokens(cfg)
    api = get_model_api(family)
    x = api.embed(params, tokens, cfg)
    if dec is None:
        want_x = llama._embed(params, tokens, cfg)
    else:
        want_x = dec.embed(params, tokens, torch.arange(S), cfg)
    assert torch.equal(x, want_x)

    layers = params["layers"]
    block = api.calibration_block(layers, cfg, S, x.device)
    cos, sin = llama.rope_tables(cfg, torch.arange(S)[None, :]) if dec is None else (None, None)
    for i in range(B):
        cap, want_cap = {}, {}
        y = block(x[i: i + 1], cap)
        if dec is None:
            want = llama.llama_block(layers, 0, x[i: i + 1], cfg, cos, sin, capture=want_cap,
                                     attend=flash_window_attention_any)
        else:
            want = common.pipeline_block_forward(dec, layers, x[i: i + 1], cfg, want_cap)
        assert torch.equal(y, want)
        assert sorted(cap) == sorted(want_cap) == ["ffn1_in", "ffn2_in", "o_in", "qkv_in"]
        for k in cap:
            assert torch.equal(cap[k], want_cap[k]), k
        assert torch.equal(block(x[i: i + 1], None), want)


def test_deepseek_v2_unported_surfaces_name_their_item():
    cfg = dataclasses.replace(DEEPSEEK_V2_PRESETS["deepseek-v2-tiny"], dtype=torch.float32)
    params = build_packed_model(cfg, seed=0, g=32, r=8, dtype=torch.float32, device="cpu",
                                family="deepseek_v2")
    tokens = _tokens(cfg)
    api = get_model_api("deepseek_v2")
    with pytest.raises(NotImplementedError, match="F1"):
        finetune.train_forward(params, tokens, cfg, True, "deepseek_v2")
    oweights, frozen = finetune.split_wct(params)
    with pytest.raises(NotImplementedError, match="F1"):
        finetune.wct_loss(oweights, frozen, tokens, tokens, cfg, family="deepseek_v2")
    with pytest.raises(NotImplementedError, match="A7b"):
        api.embed(params, tokens, cfg)
    with pytest.raises(NotImplementedError, match="A7b"):
        api.calibration_block(params["layers"], cfg, S, tokens.device)
    assert api.forward(params, tokens, cfg).shape == (B, S, cfg.vocab_size)  # it serves
