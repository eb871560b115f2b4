"""The port's window forwards and continuous-batching engine against
``qeft_tpu`` on the CPU, in f32 activations.

- `llama_forward_window`, the ragged window forward and the ragged decode
  step (bf16-layout f32 and int8 caches, one window clamped at the cache's
  end as ``dynamic_update_slice`` clamps it), on the tiny and tiny-gemma
  packed models: logits within 1e-4 of the logit scale (as
  tests/test_torch_llama.py), caches within the same bound.
- `Engine` against the JAX `Engine` on the tiny packed model with bf16 and
  int8 caches, burst 1 and 16, EOS and chunked prefill: identical tokens for
  every request.
- `measure_engine_throughput` and ``run_benchmark --method engine`` on the
  CPU.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.models import llama as jl
from qeft_tpu.serving import Engine as JaxEngine
from qeft_tpu.serving import Request as JaxRequest
from qeft_tpu_torch import run_benchmark
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.serving import Engine, Request, measure_engine_throughput
from tests.torch_parity import RANDOM_MODELS, f32, random_models, random_tokens
from tests.torch_parity import assert_close_to_scale as _close


@pytest.fixture(scope="module")
def models():
    # random packed models (GPTQ and the real OGR gather: tests/test_torch_llama.py)
    return random_models()


def _prefilled(jparams, tparams, jcfg, tcfg, b, s, max_len, quantized, seed):
    toks = random_tokens(jcfg.vocab_size, (b, s), seed)
    jcache = jl.init_kv_cache(jcfg, b, max_len, dtype=jnp.float32, quantized=quantized)
    tcache = tl.init_kv_cache(tcfg, b, max_len, dtype=torch.float32, quantized=quantized)
    _, jcache = jl.llama_prefill(jparams, jnp.asarray(toks), jcache, jcfg)
    _, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks), tcache, tcfg)
    return jcache, tcache


@pytest.mark.parametrize("name", list(RANDOM_MODELS))
def test_forward_window_matches(models, name):
    jparams, tparams, jcfg, tcfg, _ = models[name]
    jcache, tcache = _prefilled(jparams, tparams, jcfg, tcfg, 2, 6, 32, False, 0)
    window = random_tokens(jcfg.vocab_size, (2, 3), 1)
    ref, jcache = jl.llama_forward_window(jparams, jnp.asarray(window), jcache, jnp.int32(6),
                                          jcfg)
    got, tcache = tl.llama_forward_window(tparams, torch.from_numpy(window), tcache, 6, tcfg)
    _close(got, f32(ref))
    _close(tcache["k"], f32(jcache["k"]))


@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", list(RANDOM_MODELS))
def test_ragged_window_matches(models, name, quantized, w):
    """Per-sequence offsets; the last row's window runs past the cache's end
    and its write is clamped (the JAX cache rounds int8 slot counts to 128,
    so the int8 case uses 128 slots on both sides)."""
    jparams, tparams, jcfg, tcfg, _ = models[name]
    s_max = 128 if quantized else 32
    jcache, tcache = _prefilled(jparams, tparams, jcfg, tcfg, 3, 10, s_max, quantized, 2)
    window = random_tokens(jcfg.vocab_size, (3, w), 3)
    pos = np.array([10, 4, s_max - 2], np.int32)
    if w == 1:
        ref, jcache = jl.llama_decode_step_ragged(jparams, jnp.asarray(window), jcache,
                                                  jnp.asarray(pos), jcfg)
        got, tcache = tl.llama_decode_step_ragged(tparams, torch.from_numpy(window), tcache,
                                                  torch.from_numpy(pos), tcfg)
    else:
        ref, jcache = jl.llama_forward_window_ragged(jparams, jnp.asarray(window), jcache,
                                                     jnp.asarray(pos), jcfg)
        got, tcache = tl.llama_forward_window_ragged(tparams, torch.from_numpy(window), tcache,
                                                     torch.from_numpy(pos), tcfg)
    _close(got, f32(ref))
    for key in tcache:
        if key in ("k", "v") and quantized:  # codes: one rounding step apart at most
            diff = np.abs(tcache[key].numpy().astype(np.int32) - np.asarray(jcache[key]))
            assert diff.max() <= 1
        else:
            _close(tcache[key], f32(jcache[key]))


PROMPT_LENS, NEW = (4, 6, 3, 5, 9), (5, 3, 7, 4, 6)


def _serve(engine, request_cls):
    rng = np.random.default_rng(5)
    for i, (s, n) in enumerate(zip(PROMPT_LENS, NEW)):
        engine.submit(request_cls(request_id=i, prompt=rng.integers(0, 256, size=s),
                                  max_new_tokens=n))
    return {r.request_id: list(r.output) for r in engine.run()}


@pytest.fixture(scope="module")
def engine_pair(models):
    """Both engines on the tiny model, built the same way from keyword args."""
    jparams, tparams, jcfg, tcfg, _ = models["tiny"]

    def serve(cache, **kw):
        jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                    "f32": (jnp.float32, torch.float32)}[cache]
        ref = _serve(JaxEngine(jparams, jcfg, max_batch=2, max_len=32, cache_dtype=jdt, **kw),
                     JaxRequest)
        got = _serve(Engine(tparams, tcfg, max_batch=2, max_len=32, cache_dtype=tdt,
                            device="cpu", **kw), Request)
        return ref, got

    return serve


@pytest.mark.parametrize("burst", [1, 16])
def test_engine_matches_jax_engine(engine_pair, burst):
    ref, got = engine_pair("bf16", burst=burst)
    assert sorted(got) == list(range(len(NEW)))
    assert got == ref
    assert all(len(got[i]) == n for i, n in enumerate(NEW))


def test_engine_int8_cache_matches_jax_engine(engine_pair, monkeypatch):
    monkeypatch.setenv("QEFT_KV_DTYPE", "int8")
    ref, got = engine_pair("f32", burst=4)
    assert got == ref


@pytest.mark.parametrize("burst", [1, 16])
def test_engine_eos_matches_jax_engine(engine_pair, burst):
    plain, _ = engine_pair("f32")
    eos = plain[0][1]  # request 0's second token: it retires early
    ref, got = engine_pair("f32", burst=burst, eos_id=eos)
    assert got == ref
    assert got[0][-1] == eos and len(got[0]) == 2


def test_engine_chunked_prefill_matches_jax_engine(engine_pair):
    ref, got = engine_pair("f32", prefill_chunk=4)
    assert got == ref
    plain, _ = engine_pair("f32")
    assert got == plain


def test_engine_caps_at_cache_capacity(models):
    _, tparams, _, tcfg, _ = models["tiny"]
    eng = Engine(tparams, tcfg, max_batch=1, max_len=8, cache_dtype=torch.float32, device="cpu")
    eng.submit(Request(request_id=0, prompt=np.arange(4), max_new_tokens=100))
    done = eng.run(max_ticks=50)
    assert len(done) == 1 and len(done[0].output) <= 8 - 4 + 1


def test_engine_refuses_a_mesh(models):
    """``Engine(mesh=...)`` runs on its mesh's device (tests/test_torch_serving_tp.py):
    it refuses a model that lives elsewhere; ``SpecEngine`` refuses any mesh,
    as the JAX package's does."""
    from qeft_tpu_torch.parallel.mesh import Mesh
    from qeft_tpu_torch.serving import SpecEngine

    _, tparams, _, tcfg, _ = models["tiny"]
    with pytest.raises(ValueError, match="expected cuda"):
        Engine(tparams, tcfg, mesh=Mesh({"dp": 1, "tp": 2}, device=torch.device("cuda")))
    with pytest.raises(NotImplementedError, match="TP mesh"):
        SpecEngine(tparams, tcfg, tparams, tcfg, mesh=Mesh({"dp": 1, "tp": 2}), device="cpu")


def test_measure_engine_throughput_serves_everything(models):
    _, tparams, _, tcfg, _ = models["tiny"]
    tps = measure_engine_throughput(tparams, tcfg, slots=2, burst=2, requests=3, ctx=6, gen=4,
                                    reps=1, device="cpu")
    assert tps > 0 and np.isfinite(tps)


def test_run_benchmark_engine_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_benchmark.main(["--method", "engine", "--model", "tiny", "--device", "cpu",
                                  "--context", "8", "--gen", "6", "--batch", "2", "--burst",
                                  "4", "--reps", "1"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line == res and res["requests"] == 4 and res["served_tokens_per_s"] > 0
    res = run_benchmark.main(["--method", "qeft-x", "--model", "tiny", "--device", "cpu",
                              "--context", "8", "--gen", "4", "--reps", "1"])
    assert res["method"] == "qeft-x" and res["tokens_per_s"] > 0  # QEFT_PALLAS=0's model
    with pytest.raises(SystemExit):  # --tp serves qeft and engine only, as in JAX
        run_benchmark.main(["--method", "spec", "--tp", "2", "--model", "tiny", "--device", "cpu"])


def test_generate_eos_matches_jax(models):
    """The EOS variant of `generate`: stops once every sequence has emitted
    EOS and pads finished ones with it, token for token as the JAX loop."""
    from qeft_tpu.generate import generate as jax_generate
    from qeft_tpu_torch.generate import generate

    jparams, tparams, jcfg, tcfg, _ = models["tiny"]
    prompt = random_tokens(jcfg.vocab_size, (2, 5), 7)
    plain, _ = generate(tparams, torch.from_numpy(prompt),
                        tl.init_kv_cache(tcfg, 2, 20, dtype=torch.float32), tcfg, 12, device="cpu")
    eos = int(plain[0, 3])  # sequence 0 stops at its fourth token
    ref, _ = jax_generate(jparams, jnp.asarray(prompt),
                          jl.init_kv_cache(jcfg, 2, 20, dtype=jnp.float32), jcfg, 12, eos_id=eos)
    got, _ = generate(tparams, torch.from_numpy(prompt),
                      tl.init_kv_cache(tcfg, 2, 20, dtype=torch.float32), tcfg, 12, eos_id=eos,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0, 3:] == eos).all()
