"""Tensor-parallel weak-column tuning (``qeft_tpu_torch/parallel/tp_train.py``)
against the JAX package's single-device training on Gloo ranks on the CPU,
with tests/test_tp_train.py's model and bounds: tiny-v2 in f32, g = 64,
r = 16, stage-fused, its ``o_reorder`` an OGR compaction drawn with numpy
(the r weak channels moved to the tail) so that the gather of the context
really crosses ranks.

- at tp 2 and at dp 2 x tp 2, the loss within rtol 2e-3 of
  ``jax.value_and_grad(wct_loss)`` and every slab gradient, its column
  shards put back in order, within 5e-4 of its scale;
- the planted own-slice backward of the gather fails that gradient check;
- one clipped AdamW step at tp 2 equals the port's single-device step;
- the loss falls over three steps at dp 2 x tp 2 (JAX's ``_run_step``).

JAX's sharded program is not run (its compile crashed XLA:CPU before)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.finetune import split_wct as jax_split_wct
from qeft_tpu.finetune import wct_loss as jax_wct_loss
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.testing import build_packed_model as jax_build_packed_model
from qeft_tpu_torch.finetune import TrainConfig, make_optimizer, make_train_step, split_wct
from qeft_tpu_torch.parallel.tp_forward import _interleave_perm
from tests import torch_ranks as R
from tests.torch_parity import to_port, torch_cfg

R_WEAK = 16


def _compaction(rng, n_layers, k, r):
    rows = []
    for _ in range(n_layers):
        out = np.sort(rng.choice(k, r, replace=False))
        rows.append(np.concatenate([np.setdiff1d(np.arange(k), out), out]))
    return np.stack(rows).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = LLAMA_PRESETS["tiny-v2"]
    jparams = jax_build_packed_model(cfg, jax.random.PRNGKey(3), g=64, r=R_WEAK,
                                     fuse_stages=True, dtype=jnp.float32)
    layers = {k: v for k, v in jparams["layers"].items() if k not in ("o_band", "o_tail")}
    rng = np.random.default_rng(3)
    layers["o_reorder"] = jnp.asarray(_compaction(rng, cfg.num_layers,
                                                  cfg.num_heads * cfg.head_dim, R_WEAK))
    jparams = {**jparams, "layers": layers}
    ids = rng.integers(0, cfg.vocab_size, size=(4, 16))
    ow0, frozen0 = jax_split_wct(jparams, None)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda ow: jax_wct_loss(ow, frozen0, jnp.asarray(ids), jnp.asarray(ids), cfg,
                                remat=False))(ow0)
    return dict(params=to_port(jparams), cfg=torch_cfg("tiny-v2"), ids=ids,
                loss=float(ref_loss), grads={k: np.asarray(v) for k, v in ref_grads.items()})


_STEP = dict(learning_rate=1e-3, total_steps=4, lr_schedule="constant", weight_decay=0.0)
_CLIP = 1e-6  # far under the gradients' norm: every update is clipped


@pytest.fixture(scope="module")
def tp2(model):
    args = (model["params"], model["cfg"], model["ids"], (1, 2))
    return R.spawn_cases(2, [
        ("grads", R.tp_train_grads, dict(zip(("params", "cfg", "ids", "shape"), args))),
        ("planted", R.tp_train_grads, dict(zip(("params", "cfg", "ids", "shape"), args),
                                           planted=True, remat=True)),
        ("clipped", R.tp_train_steps, dict(zip(("params", "cfg", "ids", "shape"), args),
                                           steps=2, max_grad_norm=_CLIP, **_STEP)),
    ])


@pytest.fixture(scope="module")
def dp2tp2(model):
    kw = dict(params=model["params"], cfg=model["cfg"], ids=model["ids"], shape=(2, 2))
    return R.spawn_cases(4, [
        ("grads", R.tp_train_grads, dict(kw, remat=True)),
        ("steps", R.tp_train_steps, dict(kw, steps=3, learning_rate=1e-3, total_steps=4)),
    ])


def _perms(cfg, tp):
    hq, hkv, dh, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    return {"qkv": _interleave_perm([hq * dh, hkv * dh, hkv * dh], tp),
            "upgate": _interleave_perm([f, f], tp)}


def _assemble(ranks, key, field, cfg, shape):
    """The global [L, r, N] tensors from the ranks' shards: the column
    stages' tp shards concatenated and put back in order; the replicated
    row stages equal on every rank."""
    tp = shape[1]
    perms = _perms(cfg, tp)
    first = ranks[0][key][field]
    out = {}
    for name in first:
        if name in perms:
            cat = np.concatenate([ranks[t][key][field][name] for t in range(tp)], axis=-1)
            out[name] = cat[..., np.argsort(perms[name])]
        else:
            for r in ranks:
                np.testing.assert_array_equal(r[key][field][name], first[name], err_msg=name)
            out[name] = first[name]
    return out


def _grad_errors(got, ref):
    return {name: np.abs(got[name] - g).max() / max(np.abs(g).max(), 1e-6)
            for name, g in ref.items()}


def _check_against_jax(ranks, model, shape):
    for r in range(len(ranks)):
        res = R.result(ranks, "grads", r)
        np.testing.assert_allclose(res["loss"], model["loss"], rtol=2e-3)
    got = _assemble(ranks, "grads", "grads", model["cfg"], shape)
    # 5e-4 of the scale: the shards contract K in partial sums, so rounding
    # differs from the single-device reference by a few ulp on
    # near-cancelling sums (tests/test_tp_train.py's bound)
    for name, err in _grad_errors(got, model["grads"]).items():
        assert err <= 5e-4, (name, err)


def test_tp2_loss_and_slab_gradients_match_jax(tp2, model):
    _check_against_jax(tp2, model, (1, 2))


def test_dp2_tp2_loss_and_slab_gradients_match_jax(dp2tp2, model):
    """The batch's rows split over dp (each rank feeds its own), the loss's
    mean global, the slab gradients summed over dp; with remat."""
    for r in range(4):
        assert R.result(dp2tp2, "grads", r)["coords"] == {"dp": r // 2, "tp": r % 2}
    _check_against_jax(dp2tp2, model, (2, 2))


def test_own_slice_gather_backward_fails_the_gradient_check(tp2, model):
    """The Megatron shortcut for the gather's backward drops the cotangent
    that the o_reorder gather sent to the other rank's K rows: the loss is
    unchanged (the forward is), the qkv slab gradients miss the bound by
    far."""
    for r in range(2):
        np.testing.assert_allclose(R.result(tp2, "planted", r)["loss"], model["loss"],
                                   rtol=2e-3)
    errs = _grad_errors(_assemble(tp2, "planted", "grads", model["cfg"], (1, 2)),
                        model["grads"])
    assert errs["qkv"] > 100 * 5e-4, errs


def test_clipped_tp_step_equals_the_single_device_step(tp2, model):
    """Two AdamW steps (the first at lr 0: the schedule's warmup) with
    max_grad_norm far under the gradient's norm, so the update scales with
    the clipping factor: at tp 2 the slabs equal the port's single-device
    step's within 1e-5 relative.  A per-rank norm would clip each rank's
    shard by another factor."""
    cfg = model["cfg"]
    ow, frozen = split_wct(model["params"])
    opt = make_optimizer(TrainConfig(max_grad_norm=_CLIP, **_STEP), ow)
    step = make_train_step(cfg, opt, remat=True)
    ids = torch.as_tensor(model["ids"])
    losses = [float(step(ow, frozen, ids, ids)) for _ in range(2)]
    want = {k: torch.stack([t.detach() for t in v]).numpy() for k, v in ow.items()}
    for r in range(2):
        np.testing.assert_allclose(R.result(tp2, "clipped", r)["losses"], losses, rtol=2e-3)
    got = _assemble(tp2, "clipped", "slabs", cfg, (1, 2))
    start = {k: torch.stack(v).detach().numpy() for k, v in split_wct(model["params"])[0].items()}
    for name, w in want.items():
        moved = np.abs(w - start[name]).max()
        assert moved > 1e-5 * np.abs(start[name]).max(), name  # the step did update
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_tp_train_loss_falls_at_dp2_tp2(dp2tp2):
    """JAX's ``_run_step``: three steps on one batch (the first at lr 0),
    the losses finite, the third below the first, equal on every rank."""
    losses = R.result(dp2tp2, "steps", 0)["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for r in range(1, 4):
        assert R.result(dp2tp2, "steps", r)["losses"] == losses


def test_tp_train_specs_match_jax(model):
    """The spec table names the same axes as JAX's ``tp_train_specs``."""
    from qeft_tpu.parallel.tp_train import tp_train_specs as jax_specs
    from qeft_tpu_torch.parallel.tp_train import tp_train_specs

    jparams = jax_build_packed_model(LLAMA_PRESETS["tiny-v2"], jax.random.PRNGKey(3), g=64,
                                     r=R_WEAK, fuse_stages=True, dtype=jnp.float32)
    jow, jfrozen = jax_split_wct(jparams, None)
    j_ow, j_fr = jax_specs(jow, jfrozen)
    ow, frozen = split_wct(model["params"])
    t_ow, t_fr = tp_train_specs(ow, frozen)
    for name, spec in j_ow.items():  # JAX's per stacked leaf, ours per layer's leaf
        assert tuple(spec)[1:] == t_ow[name], name
    for name in ("qkv", "o", "upgate", "down"):
        for field in ("qweight", "scales", "scaled_zeros"):
            assert tuple(getattr(j_fr["layers"][name], field)) == \
                getattr(t_fr["layers"][name], field), (name, field)
    assert tuple(j_fr["lm_head"]) == t_fr["lm_head"]
