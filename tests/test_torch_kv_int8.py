"""The int8 KV cache and the decode attention kernels beside it, against
``qeft_tpu`` on the CPU in f32.

- `_kv_quantize` / `_kv_dequantize`: bit-exact (both divide by the scale and
  round half to even).
- K4q: the plain `decode_attention` with ``k_scale``/``v_scale`` against the
  Pallas ``decode_attention`` (int8 branch) in interpret mode; K8: the plain
  `decode_attention_stacked` against the Pallas ``decode_attention_stacked``,
  bf16-layout (f32 values) and int8, with every slot >= pos poisoned.
  Tolerance 2e-5, the JAX attention tests' own: f32 softmaxes, blockwise
  online on the Pallas side and one masked softmax here.
- The model: int8 prefill and decode on the tiny and tiny-gemma packed
  models, and the stacked decode step (``QEFT_ATTN_STACKED=1`` on both
  sides) over 128-slot bf16-layout and int8 caches: logits within 1e-4 of
  the logit scale, as tests/test_torch_llama.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.models import llama as jl
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.ops.pallas_attention import decode_attention as jax_decode
from qeft_tpu.ops.pallas_attention import decode_attention_stacked as jax_stacked
from qeft_tpu.pipeline import fuse_packed_stages as jax_fuse
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.ops.attention import decode_attention, decode_attention_stacked
from tests.torch_parity import RANDOM_MODELS, f32, random_models, random_tokens, torch_cfg
from tests.torch_parity import assert_close_to_scale as _close

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    # random packed models (GPTQ and the real OGR gather: tests/test_torch_llama.py)
    return random_models()


def test_kv_quantize_is_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 3, 7, 64)) * rng.uniform(0.01, 30, size=(2, 3, 7, 1))).astype(
        np.float32)
    x[0, 1, 2] = 0.0  # an all-zero vector takes the 1e-8 floor
    x[1, 0, 3, :5] = [127.0, 63.5, -63.5, 0.5, -0.5]  # halves round to even
    jc, js = jl._kv_quantize(jnp.asarray(x))
    tc, ts = tl._kv_quantize(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tl._kv_dequantize(tc, ts, torch.float32).numpy(),
        np.asarray(jl._kv_dequantize(jc, js, jnp.float32)))


def _int8_cache(rng, *shape):
    codes = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales = rng.uniform(0.005, 0.02, size=shape[:-1]).astype(np.float32)
    return codes, scales


@pytest.mark.parametrize("pos", [0, 5, 128, 255])
@pytest.mark.parametrize("h,hkv,d", [(8, 4, 128), (4, 4, 64)])
def test_int8_decode_attention_matches_pallas(pos, h, hkv, d):
    rng = np.random.default_rng(pos)
    b, s = 2, 256
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc, ks = _int8_cache(rng, b, hkv, s, d)
    vc, vs = _int8_cache(rng, b, hkv, s, d)
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, blk=128,
                                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)), pos,
                           k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layer,pos", [(0, 0), (1, 5), (2, 130), (3, 255)])
def test_stacked_decode_attention_matches_pallas(quantized, layer, pos):
    rng = np.random.default_rng(10 + pos)
    n_layers, b, h, hkv, d, s = 4, 2, 8, 4, 128, 256
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kn = rng.normal(size=(b, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(b, hkv, d)).astype(np.float32)
    shape = (n_layers, b, hkv, s, d)
    if quantized:
        (kc, ks), (vc, vs) = _int8_cache(rng, *shape), _int8_cache(rng, *shape)
        # poison slots >= pos, the stale slot at pos included
        for c, sc in ((kc, ks), (vc, vs)):
            c[:, :, :, pos:] = 127
            sc[:, :, :, pos:] = 1e3
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        kc[:, :, :, pos:] = 1e4
        vc[:, :, :, pos:] = 1e4
        scales = {}
    ref = np.asarray(jax_stacked(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.int32(layer), jnp.int32(pos), jnp.asarray(kn),
                                 jnp.asarray(vn), blk=128,
                                 **{k: jnp.asarray(v) for k, v in scales.items()}))
    got = decode_attention_stacked(*(torch.from_numpy(a) for a in (q, kc, vc)), layer, pos,
                                   torch.from_numpy(kn), torch.from_numpy(vn),
                                   **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_int8_cache_layout_and_env(monkeypatch):
    cfg = torch_cfg("tiny")
    cache = tl.init_kv_cache(cfg, 2, 40, quantized=True)
    assert cache["k"].shape == (2, 2, 2, 40, 64) and cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (2, 2, 2, 40) and cache["k_scale"].dtype == torch.float32
    assert not tl.cache_quantized(tl.init_kv_cache(cfg, 1, 8))
    monkeypatch.setenv("QEFT_KV_DTYPE", "int8")
    assert tl.cache_quantized(tl.init_kv_cache(cfg, 1, 8))


@pytest.mark.parametrize("name", list(RANDOM_MODELS))
def test_int8_prefill_and_decode_match(models, name):
    jparams, tparams, jcfg, tcfg, _ = models[name]
    b, s, steps, max_len = 2, 10, 4, 128  # the JAX cache rounds to 128 slots
    toks = random_tokens(jcfg.vocab_size, (b, s + steps), 3)
    jcache = jl.init_kv_cache(jcfg, b, max_len, quantized=True)
    tcache = tl.init_kv_cache(tcfg, b, max_len, quantized=True)
    ref, jcache = jl.llama_prefill(jparams, jnp.asarray(toks[:, :s]), jcache, jcfg)
    got, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks[:, :s]), tcache, tcfg)
    _close(got, f32(ref))
    step = jax.jit(jl.llama_decode_step, static_argnums=4)  # one trace for every step
    for i in range(steps):
        pos = s + i
        tok = toks[:, pos: pos + 1]
        ref, jcache = step(jparams, jnp.asarray(tok), jcache, jnp.int32(pos), jcfg)
        got, tcache = tl.llama_decode_step(tparams, torch.from_numpy(tok), tcache, pos, tcfg)
        _close(got, f32(ref))
    _close(tcache["k_scale"], f32(jcache["k_scale"]))
    _close(tcache["v_scale"], f32(jcache["v_scale"]))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", list(RANDOM_MODELS))
def test_stacked_decode_step_matches(models, name, quantized, monkeypatch):
    jparams, tparams, jcfg, tcfg, family = models[name]
    jfused = jax_fuse(jparams, jax_meta(family))  # the JAX step wants fused stages
    b, s, steps, max_len = 2, 7, 3, 128
    toks = random_tokens(jcfg.vocab_size, (b, s + steps), 4)
    jcache = jl.init_kv_cache(jcfg, b, max_len, dtype=jnp.float32, quantized=quantized)
    tcache = tl.init_kv_cache(tcfg, b, max_len, dtype=torch.float32, quantized=quantized)
    _, jcache = jl.llama_prefill(jfused, jnp.asarray(toks[:, :s]), jcache, jcfg)
    _, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks[:, :s]), tcache, tcfg)
    monkeypatch.setenv("QEFT_ATTN_STACKED", "1")
    step = jax.jit(jl.llama_decode_step, static_argnums=4)  # traced with the gate on
    for i in range(steps):
        pos = s + i
        tok = toks[:, pos: pos + 1]
        ref, jcache = step(jfused, jnp.asarray(tok), jcache, jnp.int32(pos), jcfg)
        got, tcache = tl.llama_decode_step(tparams, torch.from_numpy(tok), tcache, pos, tcfg)
        _close(got, f32(ref))
    for key in tcache:
        if key in ("k", "v") and quantized:  # codes: one rounding step apart at most
            diff = np.abs(tcache[key].numpy().astype(np.int32) - np.asarray(jcache[key]))
            assert diff.max() <= 1
        else:
            _close(tcache[key], f32(jcache[key]))
