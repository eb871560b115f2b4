"""The port's sampling and speculative decoding against ``qeft_tpu`` on the
CPU, in f32.

- `warp_logits`: exactly equal to the JAX warper (temperature, top-k, top-p).
- The accept / resample rule, batched generation and `generate`'s sampling
  draw from a ``torch.Generator`` whose stream differs from JAX's keys, so
  they are held to their distributions: the emitted token's law equals the
  target's (total variation below bounds sized for the sample counts).
- Greedy speculative decoding (batched, B = 1, the `SpecEngine`) on the tiny
  packed model: tokens equal to the target's own greedy decode and to the
  JAX package's tokens.  A full-depth self-draft accepts gamma of gamma in
  f32 on the CPU.
- The draft's vocabulary must be the target's; ``run_benchmark --method
  spec-batch`` on the CPU.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.generate import SampleConfig as JaxSampleConfig
from qeft_tpu.generate import warp_logits as jax_warp_logits
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models import llama as jl
from qeft_tpu.serving import Engine as JaxEngine
from qeft_tpu.serving import Request as JaxRequest
from qeft_tpu.serving import SpecEngine as JaxSpecEngine
from qeft_tpu.speculative import layer_sliced_draft as jax_sliced_draft
from qeft_tpu.speculative import speculative_generate_batched as jax_spec_batched
from qeft_tpu_torch import run_benchmark
from qeft_tpu_torch.generate import SampleConfig, generate, warp_logits
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.serving import Request, SpecEngine
from qeft_tpu_torch.speculative import (
    layer_sliced_draft,
    speculative_accept,
    speculative_generate,
    speculative_generate_batched,
    speculative_generate_sampled,
)
from tests.torch_parity import random_packed_tiny, to_port, torch_cfg


@pytest.fixture(scope="module")
def tiny():
    jparams = random_packed_tiny()
    return jparams, to_port(jparams), LLAMA_PRESETS["tiny"], torch_cfg("tiny")


@pytest.mark.parametrize("warp", [dict(), dict(temperature=0.7), dict(top_k=5),
                                  dict(top_p=0.8), dict(top_k=20, top_p=0.5, temperature=1.3)])
def test_warp_logits_equals_jax(warp):
    logits = (np.random.default_rng(0).normal(size=(4, 64)) * 3).astype(np.float32)
    ref = np.asarray(jax_warp_logits(jnp.asarray(logits), JaxSampleConfig(greedy=False, **warp)))
    got = warp_logits(torch.from_numpy(logits), SampleConfig(greedy=False, **warp))
    np.testing.assert_array_equal(got.numpy(), ref)


def _tv(a, b, vocab):
    return 0.5 * np.abs(np.bincount(a, minlength=vocab) / len(a)
                        - np.bincount(b, minlength=vocab) / len(b)).sum()


def test_accept_rule_emits_the_target_distribution():
    """cand ~ p_d through the accept / resample rule gives p_t at position 0,
    however different p_d is (TV of a 16-bin law over 20000 trials
    concentrates well below 0.03); always keeping the draft token fails."""
    vocab, gamma, n = 16, 3, 20000
    rng = np.random.default_rng(7)
    pd = torch.from_numpy(rng.dirichlet(np.ones(vocab) * 0.7, size=gamma).astype(np.float32))
    pt = torch.from_numpy(rng.dirichlet(np.ones(vocab) * 0.7, size=gamma + 1).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    cand = torch.multinomial(pd, n, replacement=True, generator=gen).t()  # [n, gamma]
    n_accept, corrected = speculative_accept(cand, pd.expand(n, -1, -1), pt.expand(n, -1, -1),
                                             gen)
    emitted = torch.where(n_accept >= 1, cand[:, 0], corrected).numpy()
    target = np.random.default_rng(1).choice(vocab, size=n, p=pt[0].double().numpy()
                                             / pt[0].double().sum().item())
    assert _tv(emitted, target, vocab) < 0.03
    assert _tv(cand[:, 0].numpy(), target, vocab) > 0.1


def _small_cfg():
    return dataclasses.replace(torch_cfg("tiny"), vocab_size=32, hidden_size=64,
                               intermediate_size=128, num_heads=2, num_kv_heads=2, head_dim=32)


def test_sampled_spec_matches_target_sampling():
    """Per-position marginals of sampled batched speculative decoding equal
    those of sampling the target alone: 2000 rows of one prompt are 2000
    independent trials (TV bound 0.1 for a 32-token law, about twice the
    noise at that count)."""
    cfg = _small_cfg()
    target = tl.init_params(cfg, seed=0, device="cpu")
    draft = tl.init_params(cfg, seed=1, device="cpu")
    n, new = 2000, 4
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 32, size=(1, 6))).expand(n, 6)
    sc = SampleConfig(greedy=False, top_p=0.9)
    spec, tel = speculative_generate_batched(
        target, draft, prompt, tl.init_kv_cache(cfg, n, 16, device="cpu"),
        tl.init_kv_cache(cfg, n, 16, device="cpu"), cfg, cfg, new,
        torch.Generator().manual_seed(3), gamma=2, sc=sc, device="cpu")
    plain, _ = generate(target, prompt, tl.init_kv_cache(cfg, n, 16, device="cpu"), cfg, new, sc,
                        torch.Generator().manual_seed(4), device="cpu")
    assert 0 < float(tel["mean_accept_length"]) <= 2
    for p in range(new):
        assert _tv(spec[:, p].numpy(), plain[:, p].numpy(), 32) < 0.1, p
    one, tel1 = speculative_generate_sampled(
        target, draft, prompt[:1], tl.init_kv_cache(cfg, 1, 16, device="cpu"),
        tl.init_kv_cache(cfg, 1, 16, device="cpu"), cfg, cfg, new, gamma=2, sc=sc, device="cpu")
    assert one.shape == (1, new) and int(tel1["rounds"]) >= 1


def test_batched_greedy_spec_equals_target_and_jax(tiny):
    jparams, tparams, jcfg, tcfg = tiny
    b, s, n, gamma = 3, 5, 10, 4
    slots = s + n + gamma + 1
    prompt = np.random.default_rng(0).integers(0, 256, size=(b, s))
    jdraft, jdcfg = jax_sliced_draft(jparams, jcfg, 1)
    tdraft, tdcfg = layer_sliced_draft(tparams, tcfg, 1)
    assert tdcfg.num_layers == 1 and tdraft["layers"]["qkv"].qweight.shape[0] == 1
    ref, _ = jax_spec_batched(jparams, jdraft, jnp.asarray(prompt),
                              jl.init_kv_cache(jcfg, b, slots, dtype=jnp.float32),
                              jl.init_kv_cache(jdcfg, b, slots, dtype=jnp.float32), jcfg, jdcfg,
                              n, jax.random.PRNGKey(2), gamma=gamma, greedy=True)
    got, tel = speculative_generate_batched(
        tparams, tdraft, torch.from_numpy(prompt),
        tl.init_kv_cache(tcfg, b, slots, dtype=torch.float32),
        tl.init_kv_cache(tdcfg, b, slots, dtype=torch.float32), tcfg, tdcfg, n, gamma=gamma,
        greedy=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    want, _ = generate(tparams, torch.from_numpy(prompt),
                       tl.init_kv_cache(tcfg, b, slots, dtype=torch.float32), tcfg, n,
                       device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(tel["rounds"]) <= n


def test_full_self_draft_accepts_gamma(tiny):
    """Draft = target at full depth: in f32 with the plain versions the W = 1
    draft steps and the W = gamma + 1 verify agree, so every round accepts
    all gamma candidates."""
    _, tparams, _, tcfg = tiny
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, 256, size=(1, 8)))
    full, fcfg = layer_sliced_draft(tparams, tcfg, tcfg.num_layers)
    out, tel = speculative_generate(
        tparams, full, prompt, tl.init_kv_cache(tcfg, 1, 32, dtype=torch.float32),
        tl.init_kv_cache(fcfg, 1, 32, dtype=torch.float32), tcfg, fcfg, 11, gamma=4,
        device="cpu")
    assert float(tel["mean_accept_length"]) == 4.0 and int(tel["rounds"]) == 2
    want, _ = generate(tparams, prompt, tl.init_kv_cache(tcfg, 1, 32, dtype=torch.float32),
                       tcfg, 11, device="cpu")
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_spec_engine_matches_jax(tiny, int8, monkeypatch):
    """SpecEngine's greedy outputs equal the JAX SpecEngine's and the plain
    JAX Engine's, request for request."""
    if int8:
        monkeypatch.setenv("QEFT_KV_DTYPE", "int8")
    jparams, tparams, jcfg, tcfg = tiny
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=(int(rng.integers(3, 7)),)) for _ in range(5)]
    jdraft, jdcfg = jax_sliced_draft(jparams, jcfg, 1)
    tdraft, tdcfg = layer_sliced_draft(tparams, tcfg, 1)

    def serve(engine, request_cls):
        for i, p in enumerate(prompts):
            engine.submit(request_cls(i, p, 8))
        return {r.request_id: list(r.output) for r in engine.run()}

    kw = dict(max_batch=2, max_len=40)
    plain = serve(JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw), JaxRequest)
    ref = serve(JaxSpecEngine(jparams, jcfg, jdraft, jdcfg, gamma=3, cache_dtype=jnp.float32,
                              **kw), JaxRequest)
    eng = SpecEngine(tparams, tcfg, tdraft, tdcfg, gamma=3, cache_dtype=torch.float32,
                     device="cpu", **kw)
    got = serve(eng, Request)
    assert got == ref == plain
    assert eng.rounds_total > 0 and tl.cache_quantized(eng.cache) == int8


def test_draft_vocabulary_must_match(tiny):
    _, tparams, _, tcfg = tiny
    dcfg = torch_cfg("tiny-v2")
    draft = tl.init_params(dcfg, device="cpu", dtype=torch.float32)
    prompt = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(tparams, draft, prompt, tl.init_kv_cache(tcfg, 1, 16),
                             tl.init_kv_cache(dcfg, 1, 16), tcfg, dcfg, 4, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpecEngine(tparams, tcfg, draft, dcfg, device="cpu")


def test_run_benchmark_spec_batch_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_benchmark.main(["--method", "spec-batch", "--model", "tiny", "--device", "cpu",
                                  "--draft_layers", "1", "--context", "8", "--gen", "6",
                                  "--batch", "2", "--reps", "1"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line == res and res["batch"] == 2 and res["draft"] == "self:1-layers"
    assert res["rounds"] >= 1 and res["tokens_per_s"] > 0
    with pytest.raises(ValueError, match="vocabulary"):  # the default draft, tiny-v2
        run_benchmark.main(["--method", "spec", "--model", "tiny", "--device", "cpu",
                            "--gen", "4", "--reps", "1"])
