"""The kernel ablations of ``qeft_tpu`` (``env.py``) against JAX under the same
environment variable, on the CPU:

- ``QEFT_PALLAS=0``: the dequantize-then-matmul linears (JAX's
  ``qlinear_xla``) in the decode loop and in training, no kernel wrapper
  reached; ``run_benchmark --method qeft-x`` is that model's benchmark;
- ``QEFT_FLASH_ATTN=0``: window attention the plain masked softmax, q.k
  rounded to the activation dtype as XLA's attention rounds it;
- ``QEFT_PALLAS_ATTN=0``: decode attention the plain path over the cache;
- ``QEFT_GEMV_F32W=0``: the decode matvecs' bf16w arithmetic (each weight
  code x scale rounded to bf16 first) against JAX's Pallas kernels in
  interpret mode under the same variable, bf16 activations.

Logits within 1e-4 of their scale (f32, tests/test_torch_llama.py's bound);
the bf16 cases within 1e-2 of the scale (bf16 roundings at other places:
JAX rounds the zero-point group sums and the slab product too)."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.finetune import split_wct as jax_split_wct
from qeft_tpu.finetune import wct_loss as jax_wct_loss
from qeft_tpu.models import llama as jl
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.ops.packing import QLinearParams as JaxQLinear, pack_codes
from qeft_tpu_torch import env, run_benchmark
from qeft_tpu_torch.device import resolve_device
from qeft_tpu_torch.finetune import split_wct, wct_loss
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.ops import qlinear, qmm
from qeft_tpu_torch.ops.packing import QLinearParams
from tests.torch_parity import f32, gptq_packed_tiny, random_tokens, to_port, torch_cfg
from tests.torch_parity import assert_close_to_scale as _close


@pytest.fixture(scope="module")
def model():
    jparams = gptq_packed_tiny()  # real GPTQ and OGR, fused stages in the port
    return jparams, to_port(jparams), jl.LLAMA_PRESETS["tiny"], torch_cfg("tiny")


@pytest.fixture
def ablate(monkeypatch):
    """Set an ablation variable for both packages (JAX reads it at trace
    time, the port at its next entry point); the flags come back after."""
    def set_(name, value="0"):
        monkeypatch.setenv(name, value)
        resolve_device("cpu")

    yield set_
    monkeypatch.undo()
    resolve_device("cpu")


@pytest.fixture
def wrappers(monkeypatch):
    """Names of the kernel wrappers reached, through the names the model
    modules imported."""
    calls = []
    for mod, names in ((qlinear, ("qgemm", "qgemm_t", "qgemv", "qgemv_stacked",
                                  "qgemv_stacked_fused")),
                       (tl, ("flash_window_attention", "decode_attention",
                             "decode_attention_stacked"))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _k=name, _f=real, **kw:
                                calls.append(_k) or _f(*a, **kw))
    return calls


def _decode(jparams, tparams, jcfg, tcfg, steps=3):
    """Prefill 6 tokens and ``steps`` decode steps on both sides: each pair
    of logits."""
    toks = random_tokens(jcfg.vocab_size, (2, 6 + steps), 7)
    jcache = jl.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = tl.init_kv_cache(tcfg, 2, 16, dtype=torch.float32)
    ref, jcache = jl.llama_prefill(jparams, jnp.asarray(toks[:, :6]), jcache, jcfg)
    with torch.no_grad():
        got, tcache = tl.llama_prefill(tparams, torch.from_numpy(toks[:, :6]), tcache, tcfg)
        out = [(got, ref)]
        for pos in range(6, 6 + steps):
            tok = toks[:, pos: pos + 1]
            ref, jcache = jl.llama_decode_step(jparams, jnp.asarray(tok), jcache,
                                               jnp.int32(pos), jcfg)
            got, tcache = tl.llama_decode_step(tparams, torch.from_numpy(tok), tcache, pos, tcfg)
            out.append((got, ref))
    return out


def test_pallas_off_runs_the_dequantize_then_matmul_linears(model, ablate, wrappers, capsys):
    jparams, tparams, jcfg, tcfg = model
    ablate("QEFT_PALLAS")
    for got, ref in _decode(jparams, tparams, jcfg, tcfg):
        _close(got, f32(ref))
    assert not [c for c in wrappers if c.startswith("qg")], wrappers
    assert "QEFT_PALLAS" in capsys.readouterr().out


def test_pallas_off_trains_through_autograd_of_that_path(model, ablate, wrappers):
    """The loss and slab gradients under QEFT_PALLAS=0 against JAX's under
    the same variable: loss rtol 1e-4, gradients 2e-4 of their scale (the
    fused stages' gradients cut into JAX's members); no K2 or K7 wrapper."""
    from tests.torch_parity import oweights_from_port

    jparams, tparams, jcfg, tcfg = model
    ablate("QEFT_PALLAS")
    ids = random_tokens(jcfg.vocab_size, (2, 16), 8)
    jow, jfrozen = jax_split_wct(jparams, jax_meta("llama"))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda ow: jax_wct_loss(ow, jfrozen, jnp.asarray(ids), jnp.asarray(ids), jcfg,
                                remat=False))(jow)
    ow, frozen = split_wct(tparams)
    loss = wct_loss(ow, frozen, torch.from_numpy(ids), torch.from_numpy(ids), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    got = oweights_from_port({k: [t.grad for t in v] for k, v in ow.items()}, tcfg)
    for name, g in ref_grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[name], g, rtol=0, atol=2e-4 * np.abs(g).max(),
                                   err_msg=name)
    assert not [c for c in wrappers if c.startswith("qg")], wrappers


def test_flash_attn_off_runs_the_plain_window_attention(model, ablate, wrappers):
    jparams, tparams, jcfg, tcfg = model
    ablate("QEFT_FLASH_ATTN")
    toks = random_tokens(jcfg.vocab_size, (2, 12), 9)
    with torch.no_grad():
        got = tl.llama_forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, f32(jl.llama_forward(jparams, jnp.asarray(toks), jcfg)))
    assert "flash_window_attention" not in wrappers


def test_plain_window_attention_rounds_scores_as_xla_does():
    """bf16 q, k, v: the plain masked softmax against JAX's ``_attention``
    (q.k in bf16, then f32 softmax, probabilities in bf16), GQA 4 / 2."""
    from qeft_tpu.models.llama import _attention, _causal_mask
    from qeft_tpu_torch.ops.flash import flash_window_attention_plain

    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 8, 4, 64), (2, 2, 8, 64), (2, 2, 8, 64)))
    ref = _attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), _causal_mask(8), 2,
                     jnp.bfloat16)
    got = flash_window_attention_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                         for a in (q, k, v)), 0)
    want = f32(ref)
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_pallas_attn_off_runs_the_plain_decode_attention(model, ablate, wrappers):
    jparams, tparams, jcfg, tcfg = model
    ablate("QEFT_PALLAS_ATTN")
    for got, ref in _decode(jparams, tparams, jcfg, tcfg):
        _close(got, f32(ref))
    assert "decode_attention" not in wrappers


L, K, N, G, R = 2, 256, 256, 64, 16


def _linear(rng, k=K, n=N):
    codes = rng.integers(0, 16, size=(L, k, n)).astype(np.int32)
    f = dict(qweight=np.stack([np.array(pack_codes(jnp.asarray(c), G)) for c in codes]),
             scales=(rng.random((L, k // G, n)) * 0.02 + 0.01).astype(np.float32),
             scaled_zeros=(-rng.random((L, k // G, n)) * 0.1).astype(np.float32),
             oweight=(rng.normal(size=(L, R, n)) * 0.02).astype(np.float32))
    jp = JaxQLinear(**{k_: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
                       for k_, v in f.items()}, group_size=G)
    tp = QLinearParams(**{k_: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
                          else torch.from_numpy(v) for k_, v in f.items()}, group_size=G)
    return jp, tp


@pytest.mark.parametrize("kernel", ["K6", "K1", "K5"])
def test_gemv_f32w_off_plain_matches_jax_interpret(ablate, kernel):
    """K6 (``qgemv_stacked``), K1 (``qgemv_stacked_fused`` with the norm)
    and K5 (``qgemv``): the port's bf16w plain version against JAX's
    kernel in interpret mode with ``QEFT_PALLAS=1 QEFT_GEMV_F32W=0``, bf16
    activations, 1 and 8 rows, within 1e-2 of the scale.  That bound is
    ordinary bf16 noise, which the weights' rounding also is, so it is
    checked apart: with the zero points and the slab at zero (where JAX
    rounds its group sums and slab product besides), the mean |diff| from
    JAX's bf16w output is under a quarter of JAX's default (F32W=1)
    output's."""
    from qeft_tpu.ops.pallas_qmm import qgemv as jax_qgemv
    from qeft_tpu.ops.pallas_qmm import qgemv_stacked as jax_k6
    from qeft_tpu.ops.pallas_qmm import qgemv_stacked_fused as jax_k1

    rng = np.random.default_rng({"K6": 1, "K1": 2, "K5": 3}[kernel])
    jp, tp = _linear(rng)
    jz = JaxQLinear(jp.qweight, jp.scales, jnp.zeros_like(jp.scaled_zeros),
                    oweight=jnp.zeros_like(jp.oweight), group_size=G)
    tz = QLinearParams(tp.qweight, tp.scales, torch.zeros_like(tp.scaled_zeros),
                       oweight=torch.zeros_like(tp.oweight), group_size=G)
    lnw = (rng.normal(size=(K,)) * 0.1 + 1.0).astype(np.float32)
    jl_, tl_ = jnp.asarray(lnw, jnp.bfloat16), torch.from_numpy(lnw).to(torch.bfloat16)
    ablate("QEFT_PALLAS", "1")
    ablate("QEFT_GEMV_F32W")

    def jax_fn(jx, jp):
        if kernel == "K6":
            return f32(jax_k6(jx, jp, jnp.int32(1)))
        if kernel == "K1":
            return f32(jax_k1(jx, jp, jnp.int32(1), lnw=jl_))
        return f32(jax_qgemv(jx, JaxQLinear(jp.qweight[1], jp.scales[1], jp.scaled_zeros[1],
                                            oweight=jp.oweight[1], group_size=G)))

    def port(tx, tp):
        if kernel == "K6":
            return qmm.qgemv_stacked(tx, tp, 1)
        if kernel == "K1":
            return qmm.qgemv_stacked_fused(tx, tp, 1, lnw=tl_)
        return qmm.qgemv(tx, tp.layer(1))

    for m in (1, 8):
        x = rng.normal(size=(m, K)).astype(np.float32)
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
        got, want = port(tx, tp), jax_fn(jx, jp)
        np.testing.assert_allclose(f32(got), want, rtol=0, atol=1e-2 * np.abs(want).max())
        want0 = jax_fn(jx, jz)
        ablate("QEFT_GEMV_F32W", "1")
        default0 = jax_fn(jx, jz)
        ablate("QEFT_GEMV_F32W")
        err, gap = np.abs(f32(port(tx, tz)) - want0).mean(), np.abs(default0 - want0).mean()
        assert err < 0.25 * gap, (err, gap)
    if kernel != "K1":
        assert not torch.equal(got, qmm.qgemm_plain(tx, tp.layer(1)))


def test_run_benchmark_qeft_x_on_the_cpu(capsys):
    """``--method qeft-x``: the qeft model under QEFT_PALLAS=0 (announced),
    one JSON line; the environment as it was afterwards."""
    before = os.environ.get("QEFT_PALLAS")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_benchmark.main(["--method", "qeft-x", "--model", "tiny", "--device", "cpu",
                                  "--context", "8", "--gen", "4", "--reps", "1"])
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == res and res["method"] == "qeft-x" and res["tokens_per_s"] > 0
    assert os.environ.get("QEFT_PALLAS") == before and env.PALLAS


def test_each_ablation_announces_itself_once(monkeypatch, capsys):
    monkeypatch.setattr(env, "_announced", set())
    monkeypatch.setenv("QEFT_PALLAS_ATTN", "0")
    for _ in range(3):
        env.announce("QEFT_PALLAS_ATTN")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and "K4" in lines[0] and "QEFT_PALLAS_ATTN='0'" in lines[0]
