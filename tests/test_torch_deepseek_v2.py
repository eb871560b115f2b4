"""DeepSeek-V2 on the port (``qeft_tpu_torch/models/deepseek_v2.py``,
``ops/moe.py``) on the CPU at tiny sizes: the expert layer against a loop
over each token's chosen experts, the absorbed decode against the
uncompressed attention over the same latents, prefill then decode through
the latent cache against the benchmark's plain f32 reference
(``portbench/reference/deepseek_v2.py``), and YaRN's frequencies and
softmax scale against the published formulas.  ``qeft_tpu`` has no such
family, so the reference is the benchmark's."""

import dataclasses
import math

import pytest
import torch

from qeft_tpu_torch.models import deepseek_v2 as ds
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.ops import moe
from qeft_tpu_torch.testing import random_packed_linear

TINY = ds.DEEPSEEK_V2_PRESETS["deepseek-v2-tiny"]


def _experts(gen, e, d, f):
    """One layer's experts ([E, ...]) and a shared SwiGLU, packed at g = 32."""
    def lin(n_layers, k, n):
        return random_packed_linear(gen, n_layers, k, n, 32, 8, fan_in=True)

    return lin(e, d, 2 * f), lin(e, f, d), lin(1, d, 2 * f).layer(0), lin(1, f, d).layer(0)


def _loop(x, router, gate_up, down, shared_gu, shared_down, k):
    """Each token through each of its chosen experts, one at a time."""
    weights, chosen = moe.route(x, router, k)
    out = []
    for t in range(x.shape[0]):
        y = torch.zeros(x.shape[-1])
        for j in range(k):
            e = int(chosen[t, j])
            y += weights[t, j] * moe.mlp(x[t:t + 1], gate_up.layer(e), down.layer(e))[0].float()
        out.append(y.to(x.dtype) + moe.mlp(x[t:t + 1], shared_gu, shared_down)[0])
    return torch.stack(out)


@pytest.mark.parametrize("routing", ["random", "one expert first", "empty experts"])
def test_expert_layer_against_a_loop_over_tokens(routing):
    """The expert layer's grouped path (the plain grouped matvec on the
    CPU) equals a loop over each token's chosen experts: the same products
    summed in another order, so within 2**-7 of the output's scale (two
    roundings of bf16 rows apart); every token on one expert first, and
    half the experts never chosen, leave nothing out."""
    gen = torch.Generator().manual_seed(0)
    e, d, f, k, t = 8, 64, 32, 2, 12
    x = torch.randn(t, d, generator=gen).to(torch.bfloat16)
    router = torch.randn(d, e, generator=gen) * d ** -0.5
    if routing == "one expert first":
        router[:, 3] = x.float().mean(0) * 50  # every token's largest score
    elif routing == "empty experts":
        router[:, ::2] = -x.float().mean(0)[:, None] * 50
    router = router.to(torch.bfloat16)
    layers = _experts(gen, e, d, f)
    got = moe.moe_layer(x, router, *layers, k, grouped=True).float()
    want = _loop(x, router, *layers, k).float()
    assert (got - want).abs().max() <= 2 ** -7 * want.abs().max()
    _, chosen = moe.route(x, router, k)
    counts, offsets, rows = moe.dispatch(chosen, e)
    if routing == "one expert first":
        assert int(counts[3]) == t
    if routing == "empty experts":
        assert int(counts[::2].sum()) == 0
    assert sorted(rows.tolist()) == list(range(t * k))  # each (token, choice) one row
    assert torch.equal(offsets, torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    flat = chosen.reshape(-1)
    for i, r in enumerate(rows.tolist()):  # rows of an expert in its range, in token order
        ex = int(flat[i])
        assert offsets[ex] <= r < offsets[ex] + counts[ex]
    assert torch.equal(got, moe.moe_layer(x, router, *layers, k, grouped=False).float())


@pytest.fixture(scope="module")
def f32_model():
    cfg = dataclasses.replace(TINY, dtype=torch.float32)
    return cfg, ds.build_packed(cfg, seed=1, g=32, r=8, dtype=torch.float32, device="cpu")


def test_absorbed_decode_equals_the_uncompressed_attention(f32_model):
    """In f32 the absorbed decode step (q_nope . W_UK over the cached
    latents, W_UV . o_lat) gives the uncompressed forward's logits over the
    same latents to 1e-4 of their scale (the algebra is exact; f32 sums
    in another order), at host and device-tensor positions; so does a
    window of 4 tokens after the cached 8 (the uncompressed form over the
    cache's latents, masked)."""
    cfg, params = f32_model
    api = get_model_api("deepseek_v2")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(2))
    full = api.forward(params, tokens, cfg)
    scale = full.abs().max()
    cache = api.init_cache(cfg, 2, 16, device="cpu")
    api.prefill(params, tokens[:, :8], cache, cfg)
    for i in range(8, 12):
        pos = i if i % 2 else torch.tensor(i)
        step, _ = api.decode_step(params, tokens[:, i:i + 1], cache, pos, cfg)
        assert (step - full[:, i]).abs().max() <= 1e-4 * scale, i
    window, _ = api.forward_window(params, tokens[:, 8:], cache, 8, cfg)
    assert (window - full[:, 8:]).abs().max() <= 1e-4 * scale


def _small_config():
    from portbench import run

    c = run.load_json(run.find("configs", "deepseek-v2-lite"))
    c.update(hidden_size=64, num_attention_heads=4, num_hidden_layers=2, vocab_size=256,
             kv_lora_rank=64, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1)
    c["qeft"] = dict(c["qeft"], group_size=32, n_outlier=8)
    return c


def _reference_logits(dims, raw, tokens, ar):
    from portbench.reference import deepseek_v2 as ref

    x = ref.embed(raw, dims, tokens)
    for l in range(dims.layers):
        x = ref.block(ref.layer_params(raw, dims, l), x, dims, ar)
    return ref.logits(raw, dims, x, ar)


def test_prefill_then_decode_against_the_reference():
    """Two layers, one dense and one of experts, on the benchmark's own
    weights: the port's prefill of 8 tokens and its decode steps through
    the latent cache give the f32 reference's full-forward logits within
    6 % of their scale (bf16 activations and one bf16 rounding of each
    absorbed weight through two layers), and the reference computed in
    float8 lies at least twice as far."""
    from portbench import program, shapes, weights
    from portbench.reference import common

    dims = shapes.dims(_small_config())
    raw = weights.make(dims, 3, torch.device("cpu"))
    params, cfg, api = program.tree(dims, raw), program.config(dims), program.api(dims)
    tokens = torch.randint(0, dims.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    ref = _reference_logits(dims, raw, tokens, common.F32)
    scale = ref.abs().max()
    cache = api.init_cache(cfg, 2, 16, device="cpu")
    pre, _ = api.prefill(params, tokens[:, :8], cache, cfg)
    port = [pre.float()]
    for i in range(8, 12):
        step, _ = api.decode_step(params, tokens[:, i:i + 1], cache, i, cfg)
        port.append(step.float()[:, None])
    err = (torch.cat(port, dim=1) - ref).abs().max() / scale
    assert err < 0.06, err
    low = _reference_logits(dims, raw, tokens, common.FP8)
    assert (low - ref).abs().max() / scale > 2 * err


def test_yarn_frequencies_and_softmax_scale():
    """DeepSeek-V2-Lite's rotary tables and softmax scale from the
    published formulas, written out: the correction range of beta_fast 32
    and beta_slow 1 over the 4096 original positions is dims 10..23; below
    it the original frequencies, above them divided by the factor 40, a
    linear ramp between; cos/sin unscaled (mscale = mscale_all_dim); the
    scale 192**-0.5 * (0.1 * 0.707 * ln 40 + 1)**2."""
    cfg = ds.DEEPSEEK_V2_PRESETS["deepseek-v2-lite"]

    def dim_of(rotations):
        return 64 * math.log(4096 / (rotations * 2 * math.pi)) / (2 * math.log(10000))

    assert (math.floor(dim_of(32)), math.ceil(dim_of(1))) == (10, 23)
    assert ds.yarn_correction_range(cfg) == (10, 23)
    want = []
    for i in range(32):
        original = 10000.0 ** (-2 * i / 64)
        ramp = min(max((i - 10) / (23 - 10), 0.0), 1.0)
        want.append(original / 40 * ramp + original * (1 - ramp))
    got = ds.yarn_inv_freq(cfg, "cpu")
    assert torch.allclose(got, torch.tensor(want), rtol=1e-6, atol=0)
    cos, sin = ds.rope_tables(cfg, torch.tensor([0, 1, 1000]))
    assert torch.allclose(cos[2, :32], torch.cos(1000 * torch.tensor(want)), atol=1e-4)
    assert torch.equal(cos[:, :32], cos[:, 32:]) and torch.equal(sin[0], torch.zeros(64))
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2,
                                              rel=1e-12)
    assert cfg.softmax_scale == pytest.approx(0.114721, abs=1e-6)


def test_the_latent_cache_and_the_entry_points():
    """One row a token and layer (the latent and the roped key), and
    nothing else in the cache; the family's functions behind
    ``get_model_api``; without ``device`` the entry points want the card."""
    cache = ds.init_kv_cache(TINY, 3, 10, device="cpu")
    assert cache["k"].shape == (2, 3, 1, 10, TINY.kv_lora_rank + TINY.qk_rope_head_dim)
    assert list(cache) == ["k"]
    api = get_model_api("deepseek_v2")
    assert api.decode_step is ds.decode_step and api.config_cls is ds.DeepseekV2Config
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ds.build_packed(TINY)
