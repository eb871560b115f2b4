"""The decode step at a position held in a tensor, which the CUDA graph of the
decode loop replays (``qeft_tpu_torch/generate.py``), on the CPU.

- The decode step with a 0-dim int64 tensor ``pos`` gives logits (and cache
  contents) bit-identical to the same step with an int ``pos``: Llama over
  bf16-layout and int8 caches, with and without the stacked-cache step, and
  each of the four other families.
- The plain K4, K4q and K8 do the same.
- `DecodeLoop.step`, the function the graph captures, run eagerly as the
  replay loop calls it, gives greedy tokens identical to the JAX package's
  ``generate`` on the tiny models ``tests/torch_parity.py`` builds.
- Sampling draws as ``torch.multinomial`` draws, from the same generator.

Bit-identical (``rtol=0, atol=0``) throughout: a tensor position changes
where the position is read, not the arithmetic.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import llama as jl
from qeft_tpu_torch.generate import DecodeLoop, SampleConfig, generate, sample_from
from qeft_tpu_torch.models import bloom, falcon, opt, phi
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.llama import LLAMA_PRESETS
from qeft_tpu_torch.ops import attention
from qeft_tpu_torch.testing import build_packed_model
from tests.torch_parity import random_models, random_tokens

EXACT = dict(rtol=0, atol=0)
FAMILIES = {"opt": (opt, "opt-tiny"), "phi": (phi, "phi-tiny"), "bloom": (bloom, "bloom-tiny"),
            "falcon": (falcon, "falcon-tiny")}
# (family, int8 cache, stacked-cache step)
CASES = [("llama", False, False), ("llama", True, False), ("llama", False, True),
         ("llama", True, True)] + [(f, False, False) for f in FAMILIES]


def _model(family):
    if family == "llama":
        cfg = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=torch.float32)
        return cfg, build_packed_model(cfg, g=64, r=8, dtype=torch.float32, device="cpu")
    module, preset = FAMILIES[family]
    cfg = dataclasses.replace(getattr(module, f"{family.upper()}_PRESETS")[preset],
                              dtype=torch.float32)
    return cfg, build_packed_model(cfg, g=32, r=8, dtype=torch.float32, device="cpu",
                                   family=family)


@pytest.mark.parametrize("family,quantized,stacked", CASES)
def test_decode_step_at_a_tensor_position_is_bit_identical(monkeypatch, family, quantized,
                                                           stacked):
    monkeypatch.setenv("QEFT_ATTN_STACKED", "1" if stacked else "0")
    cfg, params = _model(family)
    api = get_model_api(family)
    prompt = torch.from_numpy(random_tokens(cfg.vocab_size, (2, 6), 0))
    caches = [api.init_cache(cfg, 2, 16, dtype=torch.float32, quantized=quantized)
              for _ in range(2)]
    for c in caches:
        api.prefill(params, prompt, c, cfg)
    tok = prompt[:, -1:]
    for pos in range(6, 12):
        by_int, _ = api.decode_step(params, tok, caches[0], pos, cfg)
        by_tensor, _ = api.decode_step(params, tok, caches[1], torch.tensor(pos), cfg)
        torch.testing.assert_close(by_tensor, by_int, **EXACT)
        for name in caches[0]:
            torch.testing.assert_close(caches[1][name], caches[0][name], **EXACT)
        tok = by_int.argmax(-1)[:, None]


@pytest.mark.parametrize("pos", [0, 5, 255, 256, 300])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_decode_attention_at_a_tensor_position(pos, int8):
    g = torch.Generator().manual_seed(pos)
    b, h, hkv, s, d = 2, 4, 2, 320, 64
    q = torch.randn(b, h, d, generator=g)
    kn, vn = torch.randn(b, hkv, d, generator=g), torch.randn(b, hkv, d, generator=g)
    if int8:
        shape = (3, b, hkv, s, d)
        k = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        v = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
        scales = {"k_scale": torch.rand(shape[:-1], generator=g) * 0.03,
                  "v_scale": torch.rand(shape[:-1], generator=g) * 0.03}
    else:
        k, v = torch.randn(3, b, hkv, s, d, generator=g), torch.randn(3, b, hkv, s, d, generator=g)
        scales = {}
    at = torch.tensor(pos)
    one = {n: t[1] for n, t in scales.items()}
    torch.testing.assert_close(attention.decode_attention(q, k[1], v[1], at, **one),
                               attention.decode_attention(q, k[1], v[1], pos, **one), **EXACT)
    torch.testing.assert_close(
        attention.decode_attention_stacked(q, k, v, 2, at, kn, vn, **scales),
        attention.decode_attention_stacked(q, k, v, 2, pos, kn, vn, **scales), **EXACT)


@pytest.fixture(scope="module")
def models():
    return random_models()


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_graph_step_run_eagerly_gives_jax_greedy_tokens(models, name):
    jparams, tparams, jcfg, tcfg, family = models[name]
    prompt = random_tokens(jcfg.vocab_size, (2, 8), 4)
    n, slots = 10, 18
    ref, _ = jax_generate(jparams, jnp.asarray(prompt), jl.init_kv_cache(jcfg, 2, slots,
                                                                        dtype=jnp.float32),
                          jcfg, n)
    api = get_model_api(family)
    cache = api.init_cache(tcfg, 2, slots, dtype=torch.float32)
    logits, cache = api.prefill(tparams, torch.from_numpy(prompt), cache, tcfg)
    tokens = torch.full((2, n), -1, dtype=torch.int64)
    tokens[:, 0] = logits[:, -1].argmax(-1)
    loop = DecodeLoop(api, tparams, cache, tcfg, tokens, prompt.shape[1], SampleConfig(), None)
    for _ in range(n - 1):  # as the replays run it: no host position, no host read
        loop.step()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    assert int(loop.pos) == prompt.shape[1] + n - 1 and int(loop.idx) == n
    eager, _ = generate(tparams, torch.from_numpy(prompt), api.init_cache(tcfg, 2, slots,
                                                                          dtype=torch.float32),
                        tcfg, n, device="cpu", api=api)
    torch.testing.assert_close(eager, tokens, **EXACT)


def test_sampling_draws_as_multinomial_draws():
    probs = torch.softmax(torch.randn(3, 5, 100, generator=torch.Generator().manual_seed(0)), -1)
    got = sample_from(probs, torch.Generator().manual_seed(7))
    want = torch.multinomial(probs.reshape(-1, 100), 1,
                             generator=torch.Generator().manual_seed(7)).reshape(3, 5)
    torch.testing.assert_close(got, want, **EXACT)
