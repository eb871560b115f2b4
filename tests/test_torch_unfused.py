"""Unfused llama trees (``q``/``k``/``v``/``o``/``up``/``gate``/``down`` by their
own names) and per-linear ``reorder_ids`` against ``qeft_tpu`` on the CPU, in
f32 activations.  Three trees:

- ``default``: JAX's default packed tree (``testing.build_packed_model``,
  ``fuse_stages=False``; identity ``o_reorder``);
- ``reorder``: tiny quantized by GPTQ-OWQ with the global reorder and packed
  with ``pack_model(fuse_stages=False)`` (the real OGR ``o_reorder``);
- ``no-reorder``: the same without the reorder: every linear carries its
  own ``reorder_ids``, which ``qlinear_apply`` gathers first.

Each runs unfused in the port as in JAX: logits within 1e-4 of their scale
(tests/test_torch_llama.py's bound), the decode step through the per-layer
linear (K5's wrapper seven times a layer and token), greedy tokens of
``generate`` and of the ``Engine`` equal, ``eval_ppl`` within 1e-4
relative, the weak-column gradients within `GRAD_RTOL`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.checkpoint import _flatten
from qeft_tpu.data.loaders import get_loaders
from qeft_tpu.eval import eval_ppl as jax_eval_ppl
from qeft_tpu.finetune import split_wct as jax_split_wct
from qeft_tpu.finetune import wct_loss as jax_wct_loss
from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import llama as jl
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.serving import Engine as JaxEngine
from qeft_tpu.serving import Request as JaxRequest
from qeft_tpu_torch.checkpoint import from_flat
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.finetune import split_wct, wct_loss
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.serving import Engine, Request
from tests.torch_parity import f32, random_packed, random_tokens, torch_cfg
from tests.torch_parity import assert_close_to_scale as _close

NAMES = ("default", "reorder", "no-reorder")
# relative Frobenius error of a slab's gradient against JAX's.  The GPTQ
# trees agree within 2e-6; on the random default tree JAX's own f32
# gradients lie up to 7.6e-4 from the float64 evaluation of the same loss
# (the port's f32 ones 1.2e-4): its positive-mean weights give the residual
# stream a common mode that f32 sums cancel (qeft_tpu_torch/testing.py)
GRAD_RTOL = {"default": 1e-3, "reorder": 2e-4, "no-reorder": 2e-4}


def _quantized_tiny(reorder):
    """tiny quantized (4 bits, g = 64, rank 8, 2 x 16 calibration tokens) and
    packed unfused in f32 by the JAX package."""
    from qeft_tpu.pipeline import QuantizeArgs, extract_global_outidx, pack_model, quantize_model
    from qeft_tpu.quant.quantizer import QuantSpec

    cfg, meta = jl.LLAMA_PRESETS["tiny"], jax_meta("llama")
    params = jl.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    args = QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=False, group_size=64),
                        target_rank=8, no_frob_norm=True, nsamples=2, reorder=reorder)
    outidx = extract_global_outidx(params, calib, cfg, meta, args)[0] if reorder else None
    qparams, quantizers = quantize_model(params, calib, cfg, meta, args, outidx)
    return pack_model(qparams, quantizers, cfg, meta, dtype=jnp.float32, fuse_stages=False)


@pytest.fixture(scope="module")
def models():
    built = {"default": random_packed("tiny"), "reorder": _quantized_tiny(True),
             "no-reorder": _quantized_tiny(False)}
    cfg = jl.LLAMA_PRESETS["tiny"]
    return {name: (jp, from_flat(_flatten(jp)), cfg, torch_cfg("tiny"))
            for name, jp in built.items()}


def test_the_trees_are_unfused_as_described(models):
    for name, (_, tparams, _, _) in models.items():
        layers = tparams["layers"]
        assert {"q", "k", "v", "up", "gate"} <= set(layers) and "qkv" not in layers
        with_ids = [n for n in ("q", "k", "v", "o", "up", "gate", "down")
                    if layers[n].reorder_ids is not None]
        assert with_ids == ([] if name != "no-reorder" else
                            ["q", "k", "v", "o", "up", "gate", "down"])
        assert ("o_reorder" in layers) == (name != "no-reorder")


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    toks = random_tokens(jcfg.vocab_size, (2, 12), 0)
    ref = jl.llama_forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = tl.llama_forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, f32(ref))


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_through_the_per_layer_linear(models, name, monkeypatch):
    """Prefill and three decode steps: logits and cache within the bound;
    every decode step runs K5's wrapper on each of the seven linears of every
    layer (the per-layer path of JAX's scan) and no stacked matvec."""
    from qeft_tpu_torch.ops import qlinear

    jparams, tparams, jcfg, tcfg = models[name]
    calls = []
    for kernel in ("qgemv", "qgemv_stacked", "qgemv_stacked_fused"):
        real = getattr(qlinear, kernel)
        monkeypatch.setattr(qlinear, kernel, lambda *a, _k=kernel, _f=real, **kw:
                            calls.append(_k) or _f(*a, **kw))
    toks = random_tokens(jcfg.vocab_size, (2, 9), 1)
    jcache = jl.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = tl.init_kv_cache(tcfg, 2, 16, dtype=torch.float32)
    _, jcache = jl.llama_prefill(jparams, jnp.asarray(toks[:, :6]), jcache, jcfg)
    with torch.no_grad():
        _, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks[:, :6]), tcache, tcfg)
        for pos in range(6, 9):
            tok = toks[:, pos: pos + 1]
            ref, jcache = jl.llama_decode_step(jparams, jnp.asarray(tok), jcache,
                                               jnp.int32(pos), jcfg)
            calls.clear()
            got, tcache = tl.llama_decode_step(tparams, torch.from_numpy(tok), tcache, pos, tcfg)
            assert calls == ["qgemv"] * 7 * tcfg.num_layers
            _close(got, f32(ref))
    _close(tcache["k"], f32(jcache["k"]))


@pytest.mark.parametrize("name", NAMES)
def test_generate_gives_the_same_greedy_tokens(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    prompt = random_tokens(jcfg.vocab_size, (2, 8), 2)
    n = 10
    ref, _ = jax_generate(jparams, jnp.asarray(prompt),
                          jl.init_kv_cache(jcfg, 2, 8 + n, dtype=jnp.float32), jcfg, n)
    got, _ = generate(tparams, torch.from_numpy(prompt),
                      tl.init_kv_cache(tcfg, 2, 8 + n, dtype=torch.float32), tcfg, n,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", NAMES)
def test_engine_gives_the_jax_engines_tokens(models, name):
    jparams, tparams, jcfg, tcfg = models[name]

    def serve(engine, request_cls):
        rng = np.random.default_rng(5)
        for i, (s, n) in enumerate(zip((4, 7, 3), (5, 3, 6))):
            engine.submit(request_cls(request_id=i, prompt=rng.integers(0, 256, size=s),
                                      max_new_tokens=n))
        return {r.request_id: list(r.output) for r in engine.run()}

    ref = serve(JaxEngine(jparams, jcfg, max_batch=2, max_len=16, cache_dtype=jnp.float32),
                JaxRequest)
    got = serve(Engine(tparams, tcfg, max_batch=2, max_len=16, cache_dtype=torch.float32,
                       device="cpu"), Request)
    assert got == ref and sorted(got) == [0, 1, 2]


@pytest.mark.parametrize("name", NAMES)
def test_eval_ppl_matches(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    test = get_loaders("synthetic", train=False, vocab_size=jcfg.vocab_size)
    ref = jax_eval_ppl(jparams, test, jcfg, seqlen=32, max_windows=2)
    got = eval_ppl(tparams, test, tcfg, seqlen=32, max_windows=2, device="cpu")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_wct_slab_gradients_match(models, name):
    """The loss and every linear's weak-column gradient of the unfused tree
    (the ``reorder_ids`` gather differentiated) against
    ``jax.value_and_grad(wct_loss)``: loss rtol 1e-4, each slab's gradient
    within `GRAD_RTOL` relative (Frobenius norm)."""
    jparams, tparams, jcfg, tcfg = models[name]
    ids = random_tokens(jcfg.vocab_size, (2, 16), 3)
    jow, jfrozen = jax_split_wct(jparams, jax_meta("llama"))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda ow: jax_wct_loss(ow, jfrozen, jnp.asarray(ids), jnp.asarray(ids), jcfg,
                                remat=False))(jow)
    ow, frozen = split_wct(tparams)
    assert sorted(ow) == sorted(ref_grads)
    loss = wct_loss(ow, frozen, torch.from_numpy(ids), torch.from_numpy(ids), tcfg, remat=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for lin, g in ref_grads.items():
        g = np.asarray(g)
        got = torch.stack([t.grad for t in ow[lin]]).numpy()
        err = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert err <= GRAD_RTOL[name], (lin, err)


def test_checkpoints_of_unfused_trees_load_train_and_serve(models, tmp_path):
    """A tree packed without the reorder written by JAX: ``load_packed``
    serves it with JAX's tokens, ``run_finetune`` trains it unfused and its
    WCT checkpoint loads back; ``main --load`` refuses it with a
    ``ValueError``, as JAX's stage fusion asserts."""
    from qeft_tpu.checkpoint import save_packed as jax_save_packed
    from qeft_tpu.pipeline import fuse_packed_stages as jax_fuse
    from qeft_tpu_torch import main as torch_main
    from qeft_tpu_torch import run_finetune
    from qeft_tpu_torch.checkpoint import load_packed, load_wct

    jparams, _, jcfg, _ = models["no-reorder"]
    path = str(tmp_path / "noreorder_packed")
    jax_save_packed(path, jparams, jcfg)
    params, cfg, family = load_packed(path, device="cpu")
    assert family == "llama" and "qkv" not in params["layers"]
    prompt = random_tokens(jcfg.vocab_size, (1, 6), 4)
    ref, _ = jax_generate(jparams, jnp.asarray(prompt),
                          jl.init_kv_cache(jcfg, 1, 14, dtype=jnp.bfloat16), jcfg, 8)
    got, _ = generate(params, torch.from_numpy(prompt),
                      tl.init_kv_cache(cfg, 1, 14, dtype=torch.bfloat16), cfg, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    out = tmp_path / "wct"
    run_finetune.main(["--load", path, "--output_dir", str(out), "--device", "cpu",
                       "--max_steps", "2", "--batch_size", "1", "--source_max_len", "16",
                       "--nsamples", "4"])
    tuned, _, _ = load_wct(str(out / "wct_final"), device="cpu")
    assert "qkv" not in tuned["layers"] and tuned["layers"]["q"].reorder_ids is not None
    with pytest.raises(AssertionError, match="statically reordered"):
        jax_fuse(jparams, jax_meta("llama"))
    with pytest.raises(ValueError, match="statically reordered"):
        torch_main.main(["--load", path, "--device", "cpu", "--eval", "--seqlen", "16"])


def test_build_packed_model_unfused():
    """``fuse_stages=False`` cuts the fused tree into its members (the same
    logits); ``reorder=False`` gives every linear its own ``reorder_ids``
    and needs the unfused tree."""
    from qeft_tpu_torch.testing import build_packed_model, dense_model

    cfg = torch_cfg("tiny")
    kw = dict(g=64, r=8, dtype=torch.float32, device="cpu")
    fused = build_packed_model(cfg, **kw)
    unfused = build_packed_model(cfg, fuse_stages=False, **kw)
    own = build_packed_model(cfg, fuse_stages=False, reorder=False, **kw)
    toks = torch.from_numpy(random_tokens(cfg.vocab_size, (2, 10), 6))
    with torch.no_grad():
        torch.testing.assert_close(tl.llama_forward(unfused, toks, cfg),
                                   tl.llama_forward(fused, toks, cfg), rtol=0, atol=0)
        want = tl.llama_forward(dense_model(own, torch.float32), toks, cfg)
        _close(tl.llama_forward(own, toks, cfg), want.numpy())
    assert all(own["layers"][n].reorder_ids is not None for n in ("q", "o", "down"))
    with pytest.raises(ValueError, match="fuse_stages=False"):
        build_packed_model(cfg, reorder=False, **kw)
