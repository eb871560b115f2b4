"""Which decode steps of the OPT, Phi, Bloom and Falcon decoders run the
port's decode kernel (``models/common.py::decode_route``): the rule is a
function of the window, the dtypes, the device, the head size and the
family's score bias, so it is checked here on the CPU for each family's
configuration as it would run on the card.  No model is built and no
family's name is read: a one-token window over a bf16 cache on the card
routes where the head size is 64, 128 or 256 and no score bias (Bloom's
ALiBi) is added; a wider window, no cache or CPU tensors never route."""

import pytest
import torch

from qeft_tpu_torch.models import bloom, common, falcon, opt, phi

FAMILIES = {
    "falcon-7b": (falcon.FALCON_PRESETS["falcon-7b"], falcon.DECODER, True),
    "falcon-40b": (falcon.FALCON_PRESETS["falcon-40b"], falcon.DECODER, True),
    "opt-6.7b": (opt.OPT_PRESETS["opt-6.7b"], opt.DECODER, True),
    "phi-2": (phi.PHI_PRESETS["phi-2"], phi.DECODER, False),  # head size 80
    "bloom-7b1": (bloom.BLOOM_PRESETS["bloom-7b1"], bloom.DECODER, False),  # ALiBi
}
# (window, cache dtype or None, device): the decode step on the card and the
# three ways out of the route
CASES = {
    "decode step": (1, torch.bfloat16, "cuda"),
    "prefill window": (64, torch.bfloat16, "cuda"),
    "no cache": (1, None, "cuda"),
    "cpu": (1, torch.bfloat16, "cpu"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("model", list(FAMILIES))
def test_decode_route(model, case):
    cfg, dec, kernel_sized = FAMILIES[model]
    window, kv_dtype, device = CASES[case]
    routed = common.decode_route(window, torch.bfloat16, kv_dtype, device, cfg.head_dim,
                                 dec.score_bias)
    assert routed == (case == "decode step" and kernel_sized)


def test_decode_route_takes_bf16_only():
    """An f32 cache or f32 activations keep the plain path."""
    cfg = falcon.FALCON_PRESETS["falcon-7b"]
    assert common.decode_route(1, torch.bfloat16, torch.bfloat16, "cuda", cfg.head_dim, None)
    assert not common.decode_route(1, torch.float32, torch.bfloat16, "cuda", cfg.head_dim, None)
    assert not common.decode_route(1, torch.bfloat16, torch.float32, "cuda", cfg.head_dim, None)
