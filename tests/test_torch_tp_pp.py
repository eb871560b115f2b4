"""Tensor x pipeline (x data) parallel decode of the port
(``qeft_tpu_torch.parallel.tp_pp``) on eight real Gloo ranks on the CPU, in
f32, against ``qeft_tpu``'s single-device decode on the same tree: the
cases of tests/test_tp_pp.py -- tiny-v2 at (pp 2, tp 2), Llama-2-70B's head
geometry (64 query over 8 kv heads, its 3.5x ffn, the upgate halves padded
by the JAX loader) at (pp 2, tp 4), the int8 cache, the full (dp 2, pp 2,
tp 2) composition and greedy ``tppp_generate``.  Logits and cache slots
within JAX's 2e-3; tokens equal.

The ranks are spawned once; a 4-rank mesh runs as two replicas of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.generate import SampleConfig as JaxSampleConfig
from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models.llama import (
    LLAMA_PRESETS,
    LlamaConfig,
    init_kv_cache,
    llama_decode_step,
    llama_prefill,
)
from qeft_tpu.testing import build_packed_model
from tests import torch_ranks as R
from tests.torch_parity import to_port, torch_tree

TOL = dict(rtol=2e-3, atol=2e-3)
# tests/test_tp_pp.py's 70B head geometry at reduced width and depth
CFG_70B_SHAPE = LlamaConfig(vocab_size=512, hidden_size=1024, intermediate_size=3584,
                            num_layers=4, num_heads=64, num_kv_heads=8, head_dim=16,
                            max_position_embeddings=128)
# case: (config, mesh shape, axis names, batch, int8 cache)
CASES = {
    "tiny_v2": (LLAMA_PRESETS["tiny-v2"], (2, 2, 2), ("rep", "pp", "tp"), 2, False),
    "shape_70b": (CFG_70B_SHAPE, (2, 4), ("pp", "tp"), 2, False),
    "int8": (LLAMA_PRESETS["tiny-v2"], (2, 2, 2), ("rep", "pp", "tp"), 2, True),
    "dp_pp_tp": (LLAMA_PRESETS["tiny-v2"], (2, 2, 2), ("dp", "pp", "tp"), 4, False),
}


def _torch_cfg(cfg):
    import dataclasses

    import torch

    from qeft_tpu_torch.models.llama import LlamaConfig as TorchConfig

    return TorchConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                          if f.name != "dtype"}, dtype=torch.float32)


@pytest.fixture(scope="module")
def run():
    refs, cases = {}, []
    for name, (cfg, shape, names, batch, quantized) in CASES.items():
        packed = build_packed_model(cfg, jax.random.PRNGKey(0), g=64, r=16, fuse_stages=True,
                                    dtype=jnp.float32)
        cache = init_kv_cache(cfg, batch, 32, dtype=jnp.float32, quantized=quantized)
        rng = np.random.default_rng(0)
        _, cache = llama_prefill(packed, jnp.asarray(rng.integers(0, cfg.vocab_size,
                                                                  size=(batch, 6))), cache, cfg)
        tok = rng.integers(0, cfg.vocab_size, size=(batch, 1))
        refs[name] = llama_decode_step(packed, jnp.asarray(tok), cache, jnp.int32(6), cfg)
        cases.append((name, R.tppp_step, dict(
            params=to_port(packed), cfg=_torch_cfg(cfg), cache=torch_tree(cache), tok=tok,
            pos=6, shape=shape, names=names)))

    cfg = LLAMA_PRESETS["tiny-v2"]
    packed = build_packed_model(cfg, jax.random.PRNGKey(1), g=64, r=16, fuse_stages=True,
                                dtype=jnp.float32)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 5))
    refs["generate"], _ = jax_generate(packed, jnp.asarray(prompt),
                                       init_kv_cache(cfg, 2, 32, dtype=jnp.float32), cfg, 6,
                                       JaxSampleConfig())
    cases.append(("generate", R.tppp_gen, dict(
        params=to_port(packed), cfg=_torch_cfg(cfg), prompt=prompt, n=6, max_len=32,
        shape=(2, 2, 2), names=("rep", "pp", "tp"))))
    return refs, R.spawn_cases(8, cases)


@pytest.mark.parametrize("name", list(CASES))
def test_tppp_decode_matches_single_device(run, name):
    """Logits on every rank; each rank's (layer span, rows, kv heads) of
    the new cache slot."""
    refs, results = run
    ref_logits, ref_cache = refs[name]
    key = "k_scale" if CASES[name][4] else "k"
    ref = np.asarray(ref_cache[key])[:, :, :, 6]
    for rank in range(8):
        res = R.result(results, name, rank)
        np.testing.assert_allclose(res["logits"], np.asarray(ref_logits), **TOL)
        got = res[f"cache_{key}"][:, :, :, 6]
        (nl, nb, nh), c = got.shape[:3], res["coords"]
        p, d, t = c["pp"], c.get("dp", 0), c["tp"]
        np.testing.assert_allclose(
            got, ref[p * nl: (p + 1) * nl, d * nb: (d + 1) * nb, t * nh: (t + 1) * nh], **TOL)


def test_tppp_generate_matches_single_device(run):
    refs, results = run
    for rank in range(8):
        np.testing.assert_array_equal(R.result(results, "generate", rank)["tokens"],
                                      np.asarray(refs["generate"]))
