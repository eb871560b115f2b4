"""Tensor-parallel decode of the port (``qeft_tpu_torch.parallel.tp_forward``)
on real Gloo ranks on the CPU, in f32, against ``qeft_tpu``'s single-device
outputs on the same tree: the cases of tests/test_tp_forward.py (decode at
tp 2 and 4, biases and a linear without weak columns, the int8 cache,
greedy generation), plus the prefill window.  Logits and cache slots within
JAX's own 2e-3; greedy tokens equal.

Four ranks are spawned once for the module; tp 2 runs as a (dp 2, tp 2)
mesh, each dp row a replica."""

import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.generate import SampleConfig as JaxSampleConfig
from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import LLAMA_PRESETS, init_kv_cache
from qeft_tpu.models.llama import llama_decode_step, llama_prefill
from tests import torch_ranks as R
from tests.torch_parity import (to_port, torch_cfg, torch_tree, tp_packed_tiny_v2,
                                with_bias_no_outlier)

CFG = LLAMA_PRESETS["tiny-v2"]  # 4 heads / 4 kv heads / dh 128; f = 1024
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_tp_forward.py
MESHES = {2: (2, 2), 4: (1, 4)}  # tp -> (dp, tp) over the four ranks


@pytest.fixture(scope="module")
def run():
    packed = tp_packed_tiny_v2()
    biased = with_bias_no_outlier(packed)
    tcfg = torch_cfg("tiny-v2")
    refs, cases = {}, []
    prompt, tok = jnp.asarray([[1, 2, 3, 4]]), jnp.asarray([[5]])
    for label, tree, quantized in (("plain", packed, False), ("bias", biased, False),
                                   ("int8", packed, True)):
        cache = init_kv_cache(CFG, 1, 128 if quantized else 16, dtype=jnp.float32,
                              quantized=quantized)
        prefill_logits, cache = llama_prefill(tree, prompt, cache, CFG)
        ref_logits, ref_cache = llama_decode_step(tree, tok, cache, jnp.int32(4), CFG)
        refs[label] = (ref_logits, ref_cache)
        tree_t = to_port(tree)
        for tp in ((2, 4) if label == "plain" else (2,)):
            cases.append((f"{label}{tp}", R.tp_decode, dict(
                params=tree_t, cfg=tcfg, cache=torch_tree(cache), tok=np.array([[5]]), pos=4,
                shape=MESHES[tp])))
        if label == "plain":
            empty = init_kv_cache(CFG, 1, 16, dtype=jnp.float32)
            refs["window"] = llama_prefill(tree, prompt, empty, CFG)[0]
            for tp in (2, 4):
                cases.append((f"window{tp}", R.tp_window, dict(
                    params=tree_t, cfg=tcfg, cache=torch_tree(init_kv_cache(
                        CFG, 1, 16, dtype=jnp.float32)), tokens=np.array([[1, 2, 3, 4]]),
                    pos=0, shape=MESHES[tp])))
            gen_prompt = jnp.asarray([[1, 2, 3, 4, 5, 6]])
            refs["generate"], _ = jax_generate(tree, gen_prompt,
                                               init_kv_cache(CFG, 1, 32, dtype=jnp.float32),
                                               CFG, 8, JaxSampleConfig())
            for tp in (2, 4):
                cases.append((f"generate{tp}", R.tp_gen, dict(
                    params=tree_t, cfg=tcfg, prompt=np.array(gen_prompt), n=8, max_len=32,
                    shape=MESHES[tp])))
    return refs, R.spawn_cases(4, cases)


def _check_cache_slot(results, name, ref_cache, key, slot):
    """Every rank's kv heads of the new cache slot against the reference's."""
    ref = np.asarray(ref_cache[key])[:, :, :, slot]
    for rank in range(4):
        res = R.result(results, name, rank)
        got = res[f"cache_{key}"][:, :, :, slot]
        h, t = got.shape[2], res["coords"]["tp"]
        np.testing.assert_allclose(got, ref[:, :, t * h: (t + 1) * h], **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_matches_single_device(run, tp):
    refs, results = run
    ref_logits, ref_cache = refs["plain"]
    for rank in range(4):
        np.testing.assert_allclose(R.result(results, f"plain{tp}", rank)["logits"],
                                   np.asarray(ref_logits), **TOL)
    _check_cache_slot(results, f"plain{tp}", ref_cache, "k", 4)


def test_tp_decode_bias_and_no_outlier(run):
    refs, results = run
    np.testing.assert_allclose(R.result(results, "bias2")["logits"],
                               np.asarray(refs["bias"][0]), **TOL)


def test_tp_decode_int8_kv_matches_single_device(run):
    refs, results = run
    ref_logits, ref_cache = refs["int8"]
    np.testing.assert_allclose(R.result(results, "int82")["logits"], np.asarray(ref_logits),
                               **TOL)
    _check_cache_slot(results, "int82", ref_cache, "k_scale", 4)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefill_window_matches_single_device(run, tp):
    refs, results = run
    np.testing.assert_allclose(R.result(results, f"window{tp}")["logits"],
                               np.asarray(refs["window"]), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_generate_matches_single_device(run, tp):
    refs, results = run
    for rank in range(4):
        np.testing.assert_array_equal(R.result(results, f"generate{tp}", rank)["tokens"],
                                      np.asarray(refs["generate"]))
