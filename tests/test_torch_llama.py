"""The port's Llama path against ``qeft_tpu.models.llama`` on the same weights,
carried across with ``from_flat``, in f32 on the CPU.

Models: ``tiny`` from the packed_tiny recipe (real GPTQ, real OGR o_reorder,
g = 64, r = 8) and ``tiny-gemma`` from ``qeft_tpu.testing.build_packed_model``
(gemma norm offset, embedding scale, tanh GELU).  The JAX side runs its
default CPU path; the port runs its plain versions (CPU tensors).

Tolerance: logits within 1e-4 of the logit scale (max |logit|), 1e-4
relative for PPL.  Both sides are f32 through the same operations; what
differs is summation order (XLA's fused stages and scans against PyTorch's
matmuls), which stays orders of magnitude below that.  Greedy tokens must
be identical.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.checkpoint import save_packed
from qeft_tpu.eval import eval_ppl as jax_eval_ppl
from qeft_tpu.generate import generate as jax_generate
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models import llama as jl
from qeft_tpu_torch import main as torch_main
from qeft_tpu_torch.data import get_loaders
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.generate import generate
from qeft_tpu_torch.models import llama as tl
from tests.torch_parity import f32, gptq_packed_tiny, random_packed_tiny_gemma, to_port, torch_cfg

MODELS = {
    "tiny": ("llama", gptq_packed_tiny),
    "tiny-gemma": ("gemma", random_packed_tiny_gemma),
}


@pytest.fixture(scope="module")
def models():
    built = {}
    for name, (family, build) in MODELS.items():
        jparams = build()
        built[name] = (jparams, to_port(jparams, family), LLAMA_PRESETS[name], torch_cfg(name))
    return built


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(f32(got), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_logits_match(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    toks = _tokens(jcfg.vocab_size, (2, 20), 0)
    ref = f32(jl.llama_forward(jparams, jnp.asarray(toks), jcfg))
    got = tl.llama_forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_steps_match(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    b, s, steps, max_len = 1, 12, 8, 24
    toks = _tokens(jcfg.vocab_size, (b, s + steps), 1)
    jcache = jl.init_kv_cache(jcfg, b, max_len, dtype=jnp.float32)
    tcache = tl.init_kv_cache(tcfg, b, max_len, dtype=torch.float32, device="cpu")

    ref, jcache = jl.llama_prefill(jparams, jnp.asarray(toks[:, :s]), jcache, jcfg)
    got, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks[:, :s]), tcache, tcfg)
    _close(got, f32(ref))
    _close(tcache["k"], f32(jcache["k"]))
    _close(tcache["v"], f32(jcache["v"]))

    for i in range(steps):
        pos = s + i
        tok = toks[:, pos: pos + 1]
        ref, jcache = jl.llama_decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(pos), jcfg)
        got, tcache = tl.llama_decode_step(tparams, torch.from_numpy(tok), tcache, pos, tcfg)
        _close(got, f32(ref))
    _close(tcache["k"], f32(jcache["k"]))


def test_generate_gives_the_same_greedy_tokens(models):
    jparams, tparams, jcfg, tcfg = models["tiny"]
    prompt = _tokens(jcfg.vocab_size, (1, 10), 2)
    n = 12
    jcache = jl.init_kv_cache(jcfg, 1, 10 + n, dtype=jnp.float32)
    ref, _ = jax_generate(jparams, jnp.asarray(prompt), jcache, jcfg, n)
    tcache = tl.init_kv_cache(tcfg, 1, 10 + n, dtype=torch.float32, device="cpu")
    got, _ = generate(tparams, torch.from_numpy(prompt), tcache, tcfg, n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_ppl_matches(models, name):
    jparams, tparams, jcfg, tcfg = models[name]
    test = get_loaders("synthetic", train=False, vocab_size=jcfg.vocab_size)
    ref = jax_eval_ppl(jparams, test, jcfg, seqlen=32, max_windows=2)
    got = eval_ppl(tparams, test, tcfg, seqlen=32, max_windows=2,
                   family=MODELS[name][0], device="cpu")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_synthetic_data_matches_jax():
    from qeft_tpu.data.loaders import get_loaders as jax_get_loaders

    np.testing.assert_array_equal(get_loaders("synthetic", train=False, vocab_size=300),
                                  jax_get_loaders("synthetic", train=False, vocab_size=300))
    np.testing.assert_array_equal(
        get_loaders("synthetic", nsamples=2, seed=3, seqlen=16, vocab_size=300),
        jax_get_loaders("synthetic", nsamples=2, seed=3, seqlen=16, vocab_size=300))


def test_main_on_a_jax_written_checkpoint(models, tmp_path):
    jparams, _, jcfg, _ = models["tiny"]
    path = str(tmp_path / "tiny_packed")
    save_packed(path, jparams, jcfg, family="llama")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = torch_main.main(["--load", path, "--device", "cpu", "--eval", "--eval_windows",
                               "2", "--seqlen", "32", "--benchmark", "8"])
    text = out.getvalue()
    assert "synthetic ppl:" in text and "tokens/s" in text and "per-token" in text
    ref = jax_eval_ppl(jparams, get_loaders("synthetic", train=False, vocab_size=256), jcfg,
                       seqlen=32, max_windows=2)
    np.testing.assert_allclose(res["ppl_synthetic"], ref, rtol=1e-4)
    assert res["decode_tokens_per_s"] > 0 and np.isfinite(res["streaming_ppl"])
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_simple_gives_jax_tokens(models, name):
    """``generate_simple`` allocates the cache itself: greedy tokens equal
    to ``qeft_tpu.generate.generate_simple``'s."""
    from qeft_tpu.generate import generate_simple as jax_generate_simple
    from qeft_tpu_torch.generate import generate_simple
    from qeft_tpu_torch.models.api import get_model_api

    jparams, tparams, jcfg, tcfg = models[name]
    prompt = _tokens(jcfg.vocab_size, (2, 9), 5)
    ref = jax_generate_simple(jparams, jnp.asarray(prompt), jcfg, 10, cache_dtype=jnp.float32)
    got = generate_simple(tparams, torch.from_numpy(prompt), tcfg, 10, cache_dtype=torch.float32,
                          api=get_model_api(MODELS[name][0]), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_main_eval_datasets_and_logfile_match_jax(models, tmp_path, monkeypatch):
    """``main --load <ckpt> --eval --eval_datasets synthetic,<.npy>
    --logfile``: the port's line holds every key of JAX's line, with the
    same argument values and each set's PPL within 1e-4 relative (JAX rounds
    it to 4 decimals); the port adds its ``device`` flag and result."""
    import json

    from qeft_tpu import main as jax_main

    jparams, _, jcfg, _ = models["tiny"]
    path = str(tmp_path / "tiny_packed")
    save_packed(path, jparams, jcfg, family="llama")
    npy = str(tmp_path / "tokens.npy")
    np.save(npy, _tokens(jcfg.vocab_size, (512,), 6))
    flags = ["--load", path, "--eval", "--seqlen", "32", "--eval_windows", "2",
             "--eval_datasets", f"synthetic,{npy}"]
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    monkeypatch.setattr("sys.argv", ["main", "tiny", "synthetic", *flags, "--logfile", jlog])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_main.main()
        torch_main.main(["--model", "tiny", "--dataset", "synthetic", "--device", "cpu", *flags,
                         "--logfile", tlog])
    (want,), (got,) = ([json.loads(line) for line in open(p)] for p in (jlog, tlog))
    assert set(want) - {"trust_remote_code"} <= set(got), set(want) - set(got)
    assert set(got) - set(want) == {"device"}
    for key, value in want.items():
        if key.startswith("ppl_"):
            np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
        elif key not in ("logfile", "trust_remote_code"):
            assert got[key] == value, key
    assert got["logfile"] == tlog and {"ppl_synthetic", f"ppl_{npy}"} <= set(got)
