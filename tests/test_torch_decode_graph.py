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
- `DecodeLoop.reset` starts the same loop again at a request's first token
  and position, and the steps after it give the same tokens again.
- `step_key`, which decides whether a kept captured step serves a call,
  hits for the same tensors and for an api with another prefill, and
  misses for a replaced leaf, another cache, batch, sampling, generator or
  kernel-path selector, and a leaf whose weak reference has died.
- Sampling draws as ``torch.multinomial`` draws, from the same generator.

Bit-identical (``rtol=0, atol=0``) throughout: a tensor position changes
where the position is read, not the arithmetic.
"""

import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import llama as jl
from qeft_tpu_torch import env
from qeft_tpu_torch.generate import DecodeLoop, SampleConfig, generate, sample_from, step_key
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


def test_reset_loop_gives_the_same_tokens_again(models):
    """A loop reset to the request's first token and position over the same
    cache steps through the same positions again: what a replay of a kept
    step does for a request that reuses the cache."""
    _, tparams, _, tcfg, family = models["tiny"]
    api = get_model_api(family)
    prompt = torch.from_numpy(random_tokens(tcfg.vocab_size, (2, 8), 5))
    cache = api.init_cache(tcfg, 2, 24, dtype=torch.float32)
    logits, cache = api.prefill(tparams, prompt, cache, tcfg)
    out = torch.full((2, 24), -1, dtype=torch.int64)
    out[:, 0] = logits[:, -1].argmax(-1)
    loop = DecodeLoop(api, tparams, cache, tcfg, out, 8, SampleConfig(), None)
    for _ in range(9):
        loop.step()
    first = out[:, :10].clone()
    out[:, 1:] = -1
    loop.reset(first, 8)
    for _ in range(9):
        loop.step()
    torch.testing.assert_close(out[:, :10], first, **EXACT)
    assert int(loop.pos) == 17 and int(loop.idx) == 10


def _key_case(family="opt", b=2, slots=16):
    cfg, params = _model(family)
    api = get_model_api(family)
    return api, params, api.init_cache(cfg, b, slots, dtype=torch.float32), cfg


def test_step_key_hits_what_the_captured_step_reads(monkeypatch):
    """The hit test of the kept decode graph, on CPU tensors: the same
    leaves hit, and so does the api with another prefill (as a caller
    that times its prefill passes it); every change of what the step reads
    misses, and so does a leaf that has died."""
    cpu = torch.device("cpu")
    api, params, cache, cfg = _key_case()
    sc, gen = SampleConfig(), torch.Generator()
    kept = step_key(api, params, cache, cfg, 2, sc, gen, cpu).kept_form()

    def hits(**change):
        args = dict(api=api, params=params, cache=cache, cfg=cfg, batch=2, sc=sc,
                    generator=gen, device=cpu)
        args.update(change)
        return step_key(**args).hits(kept)

    assert hits()
    assert hits(api=dataclasses.replace(api, prefill=lambda *a: api.prefill(*a)))
    _, prefilled = api.prefill(params, torch.zeros(2, 3, dtype=torch.int64), cache, cfg)
    assert hits(cache=prefilled)  # the prefill writes the cache in place
    swapped = dict(params, final_ln=params["final_ln"].clone())
    assert not hits(params=swapped)
    layers = dict(params["layers"])
    name = next(k for k, v in layers.items() if isinstance(v, torch.Tensor))
    layers[name] = layers[name].clone()
    assert not hits(params=dict(params, layers=layers))
    assert not hits(cache=api.init_cache(cfg, 2, 16, dtype=torch.float32))
    assert not hits(cache=api.init_cache(cfg, 2, 24, dtype=torch.float32))
    assert not hits(batch=3, cache=api.init_cache(cfg, 3, 16, dtype=torch.float32))
    assert not hits(sc=SampleConfig(greedy=False, temperature=0.7))
    assert not hits(generator=torch.Generator())
    assert not hits(generator=None)
    assert not hits(cfg=dataclasses.replace(cfg, num_layers=cfg.num_layers + 1))
    assert not hits(api=get_model_api("falcon"))
    with env.setting(QEFT_STACKED_GEMV="0"):
        assert not hits()
    monkeypatch.setenv("QEFT_ATTN_STACKED", "1")
    assert not hits()
    monkeypatch.delenv("QEFT_ATTN_STACKED")
    assert hits()


def test_step_key_misses_once_a_leaf_has_died():
    """The kept form holds every leaf weakly: it keeps no cache alive, and
    a cache built in the same place after the old one died misses."""
    cpu = torch.device("cpu")
    api, params, cache, cfg = _key_case()
    kept = step_key(api, params, cache, cfg, 2, SampleConfig(), None, cpu).kept_form()
    probe = [r for r in kept[1] if r() is cache["k"]]
    del cache
    gc.collect()
    assert probe and probe[0]() is None
    again = api.init_cache(cfg, 2, 16, dtype=torch.float32)
    assert not step_key(api, params, again, cfg, 2, SampleConfig(), None, cpu).hits(kept)


def test_sampling_draws_as_multinomial_draws():
    probs = torch.softmax(torch.randn(3, 5, 100, generator=torch.Generator().manual_seed(0)), -1)
    got = sample_from(probs, torch.Generator().manual_seed(7))
    want = torch.multinomial(probs.reshape(-1, 100), 1,
                             generator=torch.Generator().manual_seed(7)).reshape(3, 5)
    torch.testing.assert_close(got, want, **EXACT)
