"""GPipe pipeline-parallel decode of the port (``qeft_tpu_torch.parallel.pp``)
on real Gloo ranks on the CPU, in f32, against ``qeft_tpu``'s single-device
decode on the same tree: the cases of tests/test_pp.py -- three decode
steps at (stages, microbatches) = (2, 2), (4, 2), (4, 4) with the caches
after them (2e-4, JAX's bound for the dense tree), a packed tree (2e-3),
the int8 cache (5e-2) and greedy ``pp_generate`` (tokens equal).

Four ranks are spawned once; two stages run as a (replica 2, pp 2) mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.generate import SampleConfig as JaxSampleConfig
from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import LLAMA_PRESETS, init_params
from qeft_tpu.models.llama import init_kv_cache, llama_decode_step, llama_prefill
from qeft_tpu.testing import build_packed_model
from tests import torch_ranks as R
from tests.torch_parity import dense_to_port, to_port, torch_cfg, torch_tree

CFG = dataclasses.replace(LLAMA_PRESETS["tiny"], num_layers=4)
TCFG = dataclasses.replace(torch_cfg("tiny"), num_layers=4)
B = 4


def _mesh(n_pp):
    return ((4 // n_pp, n_pp), ("rep", "pp")) if n_pp < 4 else ((4,), ("pp",))


def _steps_ref(params, cache, tok, pos0, steps):
    logits = []
    for i in range(steps):
        lg, cache = llama_decode_step(params, tok, cache, jnp.int32(pos0 + i), CFG)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
    return np.stack(logits), cache


@pytest.fixture(scope="module")
def run():
    refs, cases = {}, []
    rng = np.random.default_rng(0)
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    prompt = jnp.asarray(rng.integers(0, CFG.vocab_size, size=(B, 5)))
    cache = init_kv_cache(CFG, B, 16, dtype=jnp.float32)
    _, cache = llama_prefill(params, prompt, cache, CFG)
    tok = rng.integers(0, CFG.vocab_size, size=(B, 1))
    refs["dense"] = _steps_ref(params, cache, jnp.asarray(tok), 5, 3)
    dense = dense_to_port(params)
    for n_pp, n_mb in ((2, 2), (4, 2), (4, 4)):
        shape, names = _mesh(n_pp)
        cases.append((f"dense{n_pp}_{n_mb}", R.pp_steps, dict(
            params=dense, cfg=TCFG, cache=torch_tree(cache), tok=tok, pos0=5, steps=3,
            n_mb=n_mb, shape=shape, names=names)))

    cfg = dataclasses.replace(CFG, hidden_size=256)
    packed = build_packed_model(cfg, jax.random.PRNGKey(1), g=64, r=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(B, 5)))
    cache = init_kv_cache(cfg, B, 16, dtype=jnp.float32)
    _, cache = llama_prefill(packed, prompt, cache, cfg)
    tok = rng.integers(0, cfg.vocab_size, size=(B, 1))
    refs["packed"] = _steps_ref(packed, cache, jnp.asarray(tok), 5, 1)
    cases.append(("packed", R.pp_steps, dict(
        params=to_port(packed), cfg=TCFG, cache=torch_tree(cache), tok=tok, pos0=5, steps=1,
        n_mb=0, shape=(2, 2), names=("rep", "pp"))))

    params = init_params(CFG, jax.random.PRNGKey(6), dtype=jnp.float32)
    rng = np.random.default_rng(6)
    prompt = jnp.asarray(rng.integers(0, CFG.vocab_size, size=(B, 5)))
    cache = init_kv_cache(CFG, B, 16, dtype=jnp.float32, quantized=True)
    _, cache = llama_prefill(params, prompt, cache, CFG)
    tok = rng.integers(0, CFG.vocab_size, size=(B, 1))
    refs["int8"] = _steps_ref(params, cache, jnp.asarray(tok), 5, 1)
    cases.append(("int8", R.pp_steps, dict(
        params=dense_to_port(params), cfg=TCFG, cache=torch_tree(cache), tok=tok, pos0=5,
        steps=1, n_mb=0, shape=(2, 2), names=("rep", "pp"))))

    params = init_params(CFG, jax.random.PRNGKey(7), dtype=jnp.float32)
    prompt = np.random.default_rng(7).integers(0, CFG.vocab_size, size=(B, 5))
    refs["generate"], _ = jax_generate(params, jnp.asarray(prompt),
                                       init_kv_cache(CFG, B, 16, dtype=jnp.float32), CFG, 8,
                                       JaxSampleConfig(greedy=True))
    cases.append(("generate", R.pp_gen, dict(
        params=dense_to_port(params), cfg=TCFG, prompt=prompt, n=8, max_len=16, shape=(2, 2),
        names=("rep", "pp"))))
    return refs, R.spawn_cases(4, cases)


def _check_caches(results, name, ref_cache, tol):
    """Each stage's layer span of the caches after the steps."""
    for rank in range(4):
        res = R.result(results, name, rank)
        for k, ref in ref_cache.items():
            got = res[f"cache_{k}"]
            span, p = got.shape[0], res["coords"]["pp"]
            np.testing.assert_allclose(got, np.asarray(ref)[p * span: (p + 1) * span], **tol)


@pytest.mark.parametrize("n_pp,n_mb", [(2, 2), (4, 2), (4, 4)])
def test_pp_decode_matches_single_device(run, n_pp, n_mb):
    refs, results = run
    ref_logits, ref_cache = refs["dense"]
    tol = dict(rtol=2e-4, atol=2e-4)
    for rank in range(4):
        np.testing.assert_allclose(R.result(results, f"dense{n_pp}_{n_mb}", rank)["logits"],
                                   ref_logits, **tol)
    _check_caches(results, f"dense{n_pp}_{n_mb}", ref_cache, tol)


def test_pp_decode_packed_model(run):
    refs, results = run
    np.testing.assert_allclose(R.result(results, "packed")["logits"], refs["packed"][0],
                               rtol=2e-3, atol=2e-3)


def test_pp_decode_int8_kv_cache(run):
    refs, results = run
    np.testing.assert_allclose(R.result(results, "int8")["logits"], refs["int8"][0],
                               rtol=5e-2, atol=5e-2)


def test_pp_generate_matches_plain_generate(run):
    refs, results = run
    for rank in range(4):
        np.testing.assert_array_equal(R.result(results, "generate", rank)["tokens"],
                                      np.asarray(refs["generate"]))
