"""Sequence parallelism of the port (``qeft_tpu_torch.parallel.sp``) on real
Gloo ranks on the CPU, in f32, against ``qeft_tpu``'s single-device
prefill and decode on the same tree: the cases of tests/test_sp.py -- the
ring-attention prefill at sp 2 and 4 (logits and the K/V slab), the
prefill's K/V continued by single-device decoding, GQA on a packed tree,
and decode over a cache sharded on its slot axis (crossing the shard
boundary) with bf16-layout and int8 caches.  2e-4 of JAX's for the dense
tree, 2e-3 for the packed one, 5e-2 for int8 (JAX's bounds).

Four ranks are spawned once; sp 2 runs as a (replica 2, sp 2) mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.models import LLAMA_PRESETS, init_params
from qeft_tpu.models.llama import init_kv_cache, llama_decode_step, llama_prefill
from qeft_tpu.testing import build_packed_model
from tests import torch_ranks as R
from tests.torch_parity import dense_to_port, to_port, torch_cfg, torch_tree

CFG = LLAMA_PRESETS["tiny"]
TCFG = torch_cfg("tiny")
TOL = dict(rtol=2e-4, atol=2e-4)


def _mesh(n_sp):
    return ((4 // n_sp, n_sp), ("rep", "sp")) if n_sp < 4 else ((4,), ("sp",))


def _decode_ref(params, cache, tok, pos0, steps, cfg=CFG):
    logits = []
    for i in range(steps):
        lg, cache = llama_decode_step(params, tok, cache, jnp.int32(pos0 + i), cfg)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
    return np.stack(logits), cache


@pytest.fixture(scope="module")
def run():
    refs, cases = {}, []
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(0, CFG.vocab_size, size=(2, 16))
    refs["prefill"] = llama_prefill(params, jnp.asarray(prompt),
                                    init_kv_cache(CFG, 2, 32, dtype=jnp.float32), CFG)
    for n_sp in (2, 4):
        shape, names = _mesh(n_sp)
        cases.append((f"prefill{n_sp}", R.sp_prefill, dict(
            params=dense_to_port(params), cfg=TCFG, prompt=prompt, shape=shape, names=names)))

    params = init_params(CFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    prompt = np.random.default_rng(1).integers(0, CFG.vocab_size, size=(1, 8))
    logits, cache = llama_prefill(params, jnp.asarray(prompt),
                                  init_kv_cache(CFG, 1, 16, dtype=jnp.float32), CFG)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    refs["then_decode"] = (np.asarray(logits), _decode_ref(params, cache, tok, 8, 4)[0])
    cases.append(("then_decode", R.sp_prefill_then_decode, dict(
        params=dense_to_port(params), cfg=TCFG, prompt=prompt, steps=4, max_len=16,
        shape=(2, 2), names=("rep", "sp"))))

    cfg = dataclasses.replace(CFG, hidden_size=256, num_layers=2)
    packed = build_packed_model(cfg, jax.random.PRNGKey(2), g=64, r=16, dtype=jnp.float32)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, 8))
    refs["packed"] = llama_prefill(packed, jnp.asarray(prompt),
                                   init_kv_cache(cfg, 1, 16, dtype=jnp.float32), cfg)[0]
    cases.append(("packed", R.sp_prefill, dict(
        params=to_port(packed), cfg=dataclasses.replace(TCFG, num_layers=2), prompt=prompt,
        shape=(2, 2), names=("rep", "sp"))))

    for label, seed, s, b, steps, quantized in (("decode", 4, 7, 2, 3, False),
                                                ("int8", 5, 6, 1, 2, True)):
        params = init_params(CFG, jax.random.PRNGKey(seed), dtype=jnp.float32)
        rng = np.random.default_rng(seed)
        prompt = jnp.asarray(rng.integers(0, CFG.vocab_size, size=(b, s)))
        cache = init_kv_cache(CFG, b, 16, dtype=jnp.float32, quantized=quantized)
        _, cache = llama_prefill(params, prompt, cache, CFG)
        tok = rng.integers(0, CFG.vocab_size, size=(b, 1))
        refs[label] = _decode_ref(params, cache, jnp.asarray(tok), s, steps)
        cases.append((label, R.sp_decode, dict(
            params=dense_to_port(params), cfg=TCFG, cache=torch_tree(cache), tok=tok, pos0=s,
            steps=steps, shape=(2, 2), names=("rep", "sp"))))
    return refs, R.spawn_cases(4, cases)


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sp_prefill_matches_single_device(run, n_sp):
    refs, results = run
    ref_logits, ref_cache = refs["prefill"]
    for rank in range(4):
        res = R.result(results, f"prefill{n_sp}", rank)
        np.testing.assert_allclose(res["logits"], np.asarray(ref_logits), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(res[k], np.asarray(ref_cache[k])[:, :, :, :16], **TOL)


def test_sp_prefill_then_decode(run):
    refs, results = run
    res = R.result(results, "then_decode")
    np.testing.assert_allclose(res["prefill"], refs["then_decode"][0], **TOL)
    np.testing.assert_allclose(res["decode"], refs["then_decode"][1], **TOL)


def test_sp_prefill_gqa_and_packed(run):
    refs, results = run
    np.testing.assert_allclose(R.result(results, "packed")["logits"], np.asarray(refs["packed"]),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("label,tol", [("decode", 2e-4), ("int8", 5e-2)])
def test_sp_decode_sharded_cache_matches_single_device(run, label, tol):
    """Positions cross the shard boundary (8 slots a rank); the owner rank
    writes each new K/V."""
    refs, results = run
    ref_logits, ref_cache = refs[label]
    for rank in range(4):
        res = R.result(results, label, rank)
        np.testing.assert_allclose(res["logits"], ref_logits, rtol=tol, atol=tol)
        if label == "int8":  # as JAX's test: the logits (a code may round the other way)
            continue
        for k, ref in ref_cache.items():
            got = res[f"cache_{k}"]
            s, p = got.shape[3], res["coords"]["sp"]
            np.testing.assert_allclose(got, np.asarray(ref)[:, :, :, p * s: (p + 1) * s],
                                       rtol=tol, atol=tol)
