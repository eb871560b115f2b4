"""The OPT, Phi, Bloom and Falcon decoders of the port against the JAX
package's, on the CPU in f32.

Tiny models that the JAX package quantizes and packs (tests/torch_parity.py
``FAMILY_MODELS``: OPT pre- and post-LN with the narrow embedding, Phi,
Bloom, Falcon-7b and the Falcon-40b ``dual_ln`` lineage; some with the
global reorder's ``o_reorder``, the rest with per-linear ``reorder_ids``)
run through the port's plain versions: forward, prefill + decode and window
logits within 1e-4 of the logit scale (`assert_close_to_scale`: both sides
f32, summed in another order), greedy tokens identical.  Also: the dense
models of each family's ``init_params``, the stage fusion (nothing fused
outside the llama topology), checkpoints read and written bit for bit both
ways, and the CLIs on a family checkpoint.
"""

import contextlib
import dataclasses
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.checkpoint import _flatten, load_model as jax_load_model, save_packed as jax_save
from qeft_tpu.generate import SampleConfig, generate as jax_generate
from qeft_tpu.models.api import get_model_api as jax_api
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.ops.packing import QLinearParams as JaxQLinear
from qeft_tpu.pipeline import fuse_packed_stages as jax_fuse
from qeft_tpu_torch import main as torch_main
from qeft_tpu_torch import run_benchmark
from qeft_tpu_torch.checkpoint import from_flat, load_packed, save_packed, to_flat
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.pipeline import fuse_packed_stages
from tests.torch_parity import (
    FAMILY_MODELS,
    assert_close_to_scale,
    f32,
    family_presets,
    quantized_family,
    random_tokens,
)

NAMES = sorted(FAMILY_MODELS)


@pytest.fixture(scope="module")
def models():
    return {name: quantized_family(name) for name in NAMES}


def _apis(family):
    return jax_api(family), get_model_api(family)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match(models, name):
    jparams, tparams, jcfg, tcfg, family = models[name]
    ja, ta = _apis(family)
    toks = random_tokens(jcfg.vocab_size, (2, 11), 1)
    ref = ja.forward(jparams, jnp.asarray(toks), jcfg)
    assert_close_to_scale(ta.forward(tparams, torch.as_tensor(toks), tcfg), ref)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_and_window_match(models, name):
    """Prefill 5, three single-token steps, then a 3-token window at 8, each
    through both caches."""
    jparams, tparams, jcfg, tcfg, family = models[name]
    ja, ta = _apis(family)
    decode = jax.jit(ja.decode_step, static_argnums=4)  # one trace for every position
    toks = random_tokens(jcfg.vocab_size, (1, 11), 2)
    jc = ja.init_cache(jcfg, 1, 16, dtype=jnp.float32)
    tc = ta.init_cache(tcfg, 1, 16, dtype=torch.float32)
    ref, jc = ja.prefill(jparams, jnp.asarray(toks[:, :5]), jc, jcfg)
    got, tc = ta.prefill(tparams, torch.as_tensor(toks[:, :5]), tc, tcfg)
    assert_close_to_scale(got, ref)
    for i in range(5, 8):
        ref, jc = decode(jparams, jnp.asarray(toks[:, i: i + 1]), jc, jnp.int32(i), jcfg)
        got, tc = ta.decode_step(tparams, torch.as_tensor(toks[:, i: i + 1]), tc, i, tcfg)
        assert got.shape == (1, tcfg.vocab_size)
        assert_close_to_scale(got, ref)
    ref, jc = ja.forward_window(jparams, jnp.asarray(toks[:, 8:]), jc, jnp.int32(8), jcfg)
    got, tc = ta.forward_window(tparams, torch.as_tensor(toks[:, 8:]), tc, 8, tcfg)
    assert_close_to_scale(got, ref)
    np.testing.assert_allclose(f32(tc["k"]), np.asarray(jc["k"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_generate_gives_the_same_greedy_tokens(models, name):
    jparams, tparams, jcfg, tcfg, family = models[name]
    ja, ta = _apis(family)
    prompt = random_tokens(jcfg.vocab_size, (2, 5), 3)
    jcache = ja.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    ref, _ = jax_generate(jparams, jnp.asarray(prompt), jcache, jcfg, 8, SampleConfig(), api=ja)
    got, _ = generate(tparams, torch.as_tensor(prompt), ta.init_cache(tcfg, 2, 16,
                                                                      dtype=torch.float32),
                      tcfg, 8, api=ta, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", NAMES)
def test_dense_init_params_match_jax(name):
    """The port's ``init_params`` builds the JAX tree's leaves with their
    shapes and dtypes, and the JAX dense model carried over gives JAX's
    logits through the port's dense path."""
    family, _ = FAMILY_MODELS[name]
    jmod, jpresets, tpresets = family_presets(family)
    jcfg = jpresets[name]
    tcfg = tpresets[name]
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tmod = importlib.import_module(f"qeft_tpu_torch.models.{family}")
    tparams = tmod.init_params(tcfg, seed=0, dtype=torch.float32, device="cpu")
    jflat, tflat = _flatten(jparams), to_flat(tparams)
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        assert tflat[k].shape == v.shape and tflat[k].dtype == v.dtype, k
    carried = from_flat(jflat)
    toks = random_tokens(jcfg.vocab_size, (1, 9), 4)
    ref = jax_api(family).forward(jparams, jnp.asarray(toks), jcfg)
    got = get_model_api(family).forward(carried, torch.as_tensor(toks),
                                        dataclasses.replace(tcfg, dtype=torch.float32))
    assert_close_to_scale(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_stage_fusion_leaves_family_linears_as_jax_does(models, name):
    jparams, _, _, _, family = models[name]
    meta = get_model_meta(family)
    unfused = from_flat(_flatten(jparams))
    fused = fuse_packed_stages(unfused, meta)
    jfused = jax_fuse(jparams, jax_meta(family))
    names = {k for k, v in fused["layers"].items() if isinstance(v, QLinearParams)}
    jnames = {k for k, v in jfused["layers"].items() if isinstance(v, JaxQLinear)}
    assert names == jnames == set(meta.all_linears)
    assert fused["layers"].keys() == unfused["layers"].keys()


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


def _bits(flat):
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_cross_load_bit_exact(models, name, tmp_path):
    """JAX's save_packed read by the port, and the port's read by JAX: the
    same keys, bytes (bf16 leaves included) and config."""
    jparams, _, jcfg, _, family = models[name]
    _, _, tpresets = family_presets(family)
    jtree = _bf16(jparams)
    path = str(tmp_path / "jax_written")
    jax_save(path, jtree, jcfg, family=family)
    tparams, tcfg, tfamily = load_packed(path, device="cpu")
    assert tfamily == family and tcfg == tpresets[name]
    want = _bits(_flatten(jtree))
    got = to_flat(tparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = str(tmp_path / "port_written")
    save_packed(back, tparams, tcfg, family=family)
    jback, jcfg2, jfamily = jax_load_model(back)
    assert jfamily == family and jcfg2 == jcfg
    again = _bits(_flatten(jback))
    assert set(again) == set(want)
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


def test_family_clis_on_a_jax_written_checkpoint(models, tmp_path):
    """``main --load`` and ``run_benchmark --method qeft --load`` dispatch by
    the checkpoint's family; the engine method stays llama-only."""
    jparams, tparams, jcfg, tcfg, family = models["opt-tiny"]
    path = str(tmp_path / "opt_tiny_packed")
    jax_save(path, jparams, jcfg, family=family)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = torch_main.main(["--load", path, "--device", "cpu", "--eval", "--eval_windows",
                               "2", "--seqlen", "16", "--benchmark", "4"])
    assert "family opt" in out.getvalue()
    from qeft_tpu_torch.data import get_loaders

    test = get_loaders("synthetic", train=False, vocab_size=tcfg.vocab_size)
    want = eval_ppl(tparams, test, tcfg, seqlen=16, max_windows=2, family="opt", device="cpu")
    np.testing.assert_allclose(res["ppl_synthetic"], want, rtol=1e-4)
    assert res["decode_tokens_per_s"] > 0 and np.isfinite(res["streaming_ppl"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_benchmark.main(["--method", "qeft", "--load", path, "--device", "cpu",
                                  "--context", "8", "--gen", "4", "--reps", "1"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res and res["tokens_per_s"] > 0
    with pytest.raises(NotImplementedError, match="llama"):
        run_benchmark.main(["--method", "engine", "--load", path, "--device", "cpu"])


@pytest.mark.parametrize("n_heads", [4, 6, 12, 32, 40, 71])
def test_alibi_slopes_match_jax(n_heads):
    """Bloom's ALiBi slopes, head counts that are not a power of two too."""
    from qeft_tpu.models.bloom import alibi_slopes as jax_slopes
    from qeft_tpu_torch.models.bloom import alibi_slopes

    np.testing.assert_allclose(alibi_slopes(n_heads).numpy(), jax_slopes(n_heads), rtol=1e-7)


@pytest.mark.parametrize("fan_in", [False, True])
def test_random_family_weights_keep_the_bf16_oracle_conditioned(fan_in, monkeypatch):
    """Why `build_packed_model` draws family linears with ``fan_in``: a
    32-layer OPT at width 512, its packed path against its dense model, both
    in bf16 and plain PyTorch (no kernel), as the dense-model oracle on the
    card compares them.  With the llama test distribution (every column's
    weights of positive mean) the two differ by more than the oracle's bound
    of 0.1 of the logit scale; with fan-in scaled, centered weights they
    agree well inside it."""
    from qeft_tpu_torch import testing
    from qeft_tpu_torch.models.opt import OPT_PRESETS

    if not fan_in:  # the llama distribution, whatever the family builder asks for
        draw = testing.random_packed_linear
        monkeypatch.setattr(testing, "random_packed_linear",
                            lambda *a, **k: draw(*a, **{**k, "fan_in": False}))
    cfg = dataclasses.replace(OPT_PRESETS["opt-tiny"], hidden_size=512, ffn_dim=2048,
                              num_layers=32, num_heads=8)
    params = testing.build_packed_model(cfg, seed=0, g=128, r=128, device="cpu", family="opt")
    toks = torch.as_tensor(random_tokens(cfg.vocab_size, (1, 16), 0))
    api = get_model_api("opt")
    packed = api.forward(params, toks, cfg).float()
    dense = api.forward(testing.dense_model(params), toks, cfg).float()
    ratio = ((packed - dense).abs().max() / dense.abs().max()).item()
    assert torch.isfinite(packed).all()
    assert (ratio < 0.1) if fan_in else (ratio > 0.1), ratio
