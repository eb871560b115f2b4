"""DeepSeek-V2-Lite's part of the yardstick (``families/deepseek_v2.py``):
its sizes at published widths, its leaves with the experts' leading axis,
a decode step's operations and bytes at batch 64 (the experts expected
under uniform routing, n (1 - (1 - k/n)^B) = 63.88 of 64), the calls a
traced request must hold, and a plain reference that loads nothing of the
port and no JAX."""

import math
import types

import pytest
import torch

from portbench import costs, expect, run, shapes, weights
from portbench.families import deepseek_v2 as fam
from portbench.tests.test_portbench_families import python

H100 = costs.peaks("NVIDIA H100 80GB HBM3")


def full():
    return shapes.dims(run.load_json(run.find("configs", "deepseek-v2-lite")))


def small_config():
    """The configuration file at CPU sizes: every width cut, two layers (one
    dense, one of 8 experts, top 2), g = 32 with 8 weak rows."""
    c = run.load_json(run.find("configs", "deepseek-v2-lite"))
    c.update(hidden_size=64, num_attention_heads=4, num_hidden_layers=2, vocab_size=256,
             kv_lora_rank=64, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1)
    c["qeft"] = dict(c["qeft"], group_size=32, n_outlier=8)
    return c


def test_dims_at_published_widths():
    d = full()
    assert (d.layers, d.hidden, d.heads, d.vocab, d.group, d.n_outlier) == (
        27, 2048, 16, 102400, 128, 128)
    assert (d.experts, d.top_k, d.shared, d.dense_layers, d.routed_scale) == (64, 6, 2, 1, 1.0)
    assert (d.rank, d.nope, d.rope, d.v, d.row, d.ffn, d.expert_ffn) == (
        512, 128, 64, 128, 576, 10944, 1408)
    assert dict((n, (k, m)) for n, k, m in d.linears) == {
        "q": (2048, 3072), "kv_a": (2048, 576), "kv_b": (512, 4096), "o": (2048, 2048),
        "gate_up": (2048, 21888), "down": (10944, 2048), "shared_gate_up": (2048, 5632),
        "shared_down": (2816, 2048), "experts_gate_up": (2048, 2816),
        "experts_down": (1408, 2048)}
    assert d.group_of("down") == 64 and d.group_of("experts_down") == 128  # 10944 % 128
    assert dict(d.rope_scaling) == {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 40.0,
                                    "mscale": 0.707, "mscale_all_dim": 0.707,
                                    "original_max_position_embeddings": 4096.0}
    packed = sum(math.prod(d.stack(n)) * costs.weight_bytes(k, m, d.group_of(n), 128, False)
                 for n, k, m in d.linears)
    assert packed == 10316984320  # 10.3 GB packed, 0.84 GB more in the embedding and head


def test_leaves_hold_the_experts_on_a_leading_axis():
    d = shapes.dims(small_config())
    raw = weights.make(d, 3, torch.device("cpu"))
    lay = raw["layers"]
    k, n = d.linear("experts_gate_up")
    assert lay["experts_gate_up"]["qweight"].shape == (d.moe_layers, d.experts, k // 8, n)
    assert lay["experts_gate_up"]["oweight"].shape == (d.moe_layers, d.experts, d.n_outlier, n)
    assert lay["shared_down"]["scales"].shape[0] == d.moe_layers
    assert lay["gate_up"]["qweight"].shape[0] == d.dense_layers
    assert lay["q"]["qweight"].shape[0] == d.layers
    assert lay["router"].shape == (d.moe_layers, d.hidden, d.experts)
    assert lay["kv_a_ln"].shape == (d.layers, d.rank)
    assert raw["lm_head"].shape == (d.hidden, d.vocab)  # untied
    assert torch.equal(weights.make(d, 3, torch.device("cpu"))["layers"]["router"], lay["router"])


@pytest.mark.parametrize("batch,keys,want", [
    (1, 1, (5194422272, 1990044032.0)),
    (64, 1, (332443025408, 10782230183.591806)),
    (64, 700, (374496296960, 12173698727.591806)),
    (64, 1280, (409390284800, 13328279207.591806)),
])
def test_decode_step_counts_the_experts_uniform_routing_touches(batch, keys, want):
    d = full()
    assert fam.expected_experts(d, 64) == pytest.approx(63.8825, abs=1e-4)
    assert fam.expected_experts(d, 1) == 6
    assert costs.decode_step(d, batch, keys) == want


def test_expected_calls_of_a_traced_request():
    d = full()
    r = types.SimpleNamespace(dims=d, traced={"requests": [(512, 200, 64)]},
                              mix=run.load_json(run.find("traffic", "batch64")))
    e = expect.decode(r)
    assert e["qgemv"] == []  # 64 rows: every dense linear on K2
    assert len(e["moe"]) == 2 * 26 * 199 and len(e["latent"]) == 27 * 199
    assert len(e["steps"]) == 199 and e["steps"][0] == (64, 513)
    # prefill: 7 dense linears on their layers and kv_b; decode: the same 7 a step
    per_step = 27 * 3 + 1 * 2 + 26 * 2
    assert len(e["qgemm"]) == per_step + 27 + 199 * per_step
    moe = sum(costs.least_time(*fam.moe_call(d, t, n), H100) for t, n in e["moe"])
    lat = sum(costs.least_time(*fam.latent_call(d, b, k), H100) for b, k in e["latent"])
    assert moe == pytest.approx(26 * 199 * (245511889.55 + 134008884.89) / 3.35e12, rel=1e-6)
    assert 0 < lat < moe


def test_the_reference_loads_nothing_of_the_port():
    code = """
import sys, torch
from portbench import run, shapes, weights
from portbench.reference import common, deepseek_v2 as ref
from portbench.tests.test_portbench_deepseek import small_config
d = shapes.dims(small_config())
raw = weights.make(d, 3, torch.device("cpu"))
x = ref.embed(raw, d, torch.zeros((1, 6), dtype=torch.long))
for l in range(d.layers):
    x = ref.block(ref.layer_params(raw, d, l), x, d, common.F32)
ref.logits(raw, d, x, common.F32)
print(sorted({m.split(".")[0] for m in sys.modules} & {"qeft_tpu_torch", "qeft_tpu", "jax"}))
"""
    assert python(code).split("\n")[-2] == "[]"


def test_a_small_cell_runs_and_is_correct():
    from portbench.tests import small

    cell = "deepseek-v2-lite.batch64"
    files = dict(small.files(cell), config=small_config())
    res = run.execute(small.BENCH, cell, 2**31 + 41, 0.3, False, torch.device("cpu"), files=files)
    assert res["correct"] is True and res["attempted"] > 0
