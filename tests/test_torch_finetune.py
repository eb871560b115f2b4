"""WCT training in the port against ``qeft_tpu.finetune`` on the same weights
and batches, in f32 on the CPU.

Models: ``tiny`` from the packed_tiny recipe (real GPTQ + OGR, g = 64,
r = 8) and random ``tiny-gemma`` (embedding scale, ``(1 + w)`` norms, tanh
GELU).  The JAX side trains its unfused q/k/v, up/gate linears; the port
trains the fused stages, carried across with `oweights_to_port` and back
with `oweights_from_port`.

Tolerances, each with its reason:
- loss, schedule and data: the same f32 arithmetic in another summation
  order (XLA's fused scans against PyTorch's matmuls): loss within 1e-5
  relative, data bit-identical; lr within 1e-6 of itself and of the peak
  (optax evaluates its schedule in f32, where ``1 + cos(pi t / T)`` cancels
  near the end of the decay, the port in f64).
- SGD parameters after 8 steps within 1e-5 of the slab scale: SGD adds
  lr * gradient, so the parameter error is the gradient's summation-order
  error and does not grow.
- AdamW is held by its losses only (1e-4 relative): ``m / (sqrt(v) + eps)``
  is of order 1 even where a gradient is near 0, so the summation-order
  noise of near-zero gradients becomes order-lr parameter differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qeft_tpu import finetune as jft
from qeft_tpu.data import sft as jsft
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu_torch import finetune as tft
from qeft_tpu_torch.data import sft as tsft
from tests.torch_parity import (
    gptq_packed_tiny,
    oweights_from_port,
    oweights_to_port,
    random_packed_tiny_gemma,
    to_port,
    torch_cfg,
)

MODELS = {
    "tiny": ("llama", gptq_packed_tiny),
    "tiny-gemma": ("gemma", random_packed_tiny_gemma),
}
STEPS = 8


@pytest.fixture(scope="module")
def models():
    built = {}
    for name, (family, build) in MODELS.items():
        jparams = build()
        built[name] = (family, jparams, to_port(jparams, family), LLAMA_PRESETS[name],
                       torch_cfg(name))
    return built


def _batch(vocab, seed, b=2, s=16):
    """ids [b, s] and labels with the first 3 positions of each row masked."""
    ids = np.random.default_rng(seed).integers(0, vocab, size=(b, s))
    labels = ids.copy()
    labels[:, :3] = jft.IGNORE_INDEX
    return ids, labels


def _jax_run(family, jparams, jcfg, opt, batches):
    ow, frozen = jft.split_wct(jparams, jax_meta(family))
    state = opt.init(ow)
    step = jft.make_train_step(jcfg, opt, remat=True, family=family)
    losses = []
    for ids, labels in batches:
        ow, state, loss = step(ow, state, frozen, jnp.asarray(ids), jnp.asarray(labels))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in ow.items()}


def _port_run(family, tparams, tcfg, make_opt, batches):
    ow, frozen = tft.split_wct(tparams)
    step = tft.make_train_step(tcfg, make_opt(ow), remat=True, family=family)
    losses = [float(step(ow, frozen, torch.from_numpy(ids), torch.from_numpy(labels)))
              for ids, labels in batches]
    return losses, ow


def _sgd(lr):
    return lambda ow: tft.WCTOptimizer(torch.optim.SGD(tft.leaves(ow), lr=lr))


def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 9, 32)).astype(np.float32)
    labels = rng.integers(0, 32, size=(2, 9))
    labels[0, :4] = jft.IGNORE_INDEX
    labels[1, 7] = jft.IGNORE_INDEX
    ref = float(jft.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tft.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    none = np.full_like(labels, jft.IGNORE_INDEX)
    assert float(tft.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("total,warmup", [(7, 0.03), (40, 0.2), (100, 0.03)])
def test_lr_schedule_matches_optax(schedule, total, warmup):
    """The lr of each applied update, read from the torch optimizer, against
    the schedule ``qeft_tpu.finetune.make_optimizer`` builds."""
    lr = 2e-4
    w = int(total * warmup) + 1
    if schedule == "cosine":
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, w, total)
    else:
        ref = optax.join_schedules([optax.linear_schedule(0.0, lr, w),
                                    optax.constant_schedule(lr)], [w])
    tc = tft.TrainConfig(learning_rate=lr, warmup_ratio=warmup, total_steps=total,
                         lr_schedule=schedule)
    p = torch.zeros(1, requires_grad=True)
    opt = tft.WCTOptimizer(torch.optim.SGD([p], lr=lr), tft.lr_factor(tc))
    got = []
    for _ in range(total + 3):
        got.append(opt.optimizer.param_groups[0]["lr"])
        p.grad = torch.zeros(1)
        opt.step()
    want = [float(ref(c)) for c in range(total + 3)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * lr)


def test_cosine_schedule_without_decay_steps_raises_like_optax():
    tc = jft.TrainConfig(total_steps=1)
    with pytest.raises(ValueError):
        jft.make_optimizer(tc)
    with pytest.raises(ValueError):
        tft.lr_factor(tft.TrainConfig(total_steps=1))


@pytest.mark.parametrize("name", list(MODELS))
def test_split_wct_carries_the_jax_oweights_both_ways(models, name):
    family, jparams, tparams, _, tcfg = models[name]
    ref, _ = jft.split_wct(jparams, jax_meta(family))
    ow, frozen = tft.split_wct(tparams)
    carried = oweights_to_port(ref, family)
    assert set(carried) == set(ow) == {"qkv", "o", "upgate", "down"}
    for k in ow:
        assert len(ow[k]) == tcfg.num_layers
        for a, b in zip(ow[k], carried[k]):
            assert a.dtype == torch.float32 and a.requires_grad
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert frozen["layers"][k].oweight is None
    back = oweights_from_port(ow, tcfg, family)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


@pytest.mark.parametrize("name", list(MODELS))
def test_sgd_steps_match_jax(models, name):
    family, jparams, tparams, jcfg, tcfg = models[name]
    batches = [_batch(jcfg.vocab_size, i) for i in range(STEPS)]
    ref_losses, ref_ow = _jax_run(family, jparams, jcfg, optax.sgd(1e-2), batches)
    losses, ow = _port_run(family, tparams, tcfg, _sgd(1e-2), batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = oweights_from_port(ow, tcfg, family)
    assert set(got) == set(ref_ow)
    for k, v in ref_ow.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("name,accum", [("tiny", 1), ("tiny", 2), ("tiny-gemma", 1)])
def test_adamw_losses_match_jax(models, name, accum):
    """make_optimizer on both sides: clip 0.3, AdamW, warmup-cosine, and
    MultiSteps(2) against the port's accumulation."""
    family, jparams, tparams, jcfg, tcfg = models[name]
    tc = dict(learning_rate=5e-3, total_steps=STEPS, max_grad_norm=0.3, grad_accum=accum)
    batches = [_batch(jcfg.vocab_size, 10 + i) for i in range(STEPS)]
    ref_losses, _ = _jax_run(family, jparams, jcfg, jft.make_optimizer(jft.TrainConfig(**tc)),
                             batches)
    losses, _ = _port_run(family, tparams, tcfg,
                          lambda ow: tft.make_optimizer(tft.TrainConfig(**tc), ow), batches)
    assert len(set(np.round(losses, 4))) > 2  # the parameters really moved
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_grad_accum_two_halves_equal_the_full_batch(models):
    """SGD with grad_accum=2 over two half batches == one full-batch step
    (each half's loss is a mean over its own equal count of targets)."""
    family, _, tparams, jcfg, tcfg = models["tiny"]
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(4, 16))
    t = torch.from_numpy(ids)
    ow_full, frozen = tft.split_wct(tparams)
    tft.make_train_step(tcfg, _sgd(1e-2)(ow_full), remat=False)(ow_full, frozen, t, t)

    ow_acc, _ = tft.split_wct(tparams)
    before = oweights_from_port(ow_acc, tcfg)
    opt = tft.WCTOptimizer(torch.optim.SGD(tft.leaves(ow_acc), lr=1e-2), grad_accum=2)
    step = tft.make_train_step(tcfg, opt, remat=False)
    step(ow_acc, frozen, t[:2], t[:2])
    for k, v in oweights_from_port(ow_acc, tcfg).items():
        np.testing.assert_array_equal(v, before[k])  # the first half applies nothing
    step(ow_acc, frozen, t[2:], t[2:])
    got, want = oweights_from_port(ow_acc, tcfg), oweights_from_port(ow_full, tcfg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)


def test_training_moves_only_the_oweights(models):
    family, _, tparams, jcfg, tcfg = models["tiny-gemma"]
    frozen_before = {}
    ow, frozen = tft.split_wct(tparams)
    for name, leaf in frozen["layers"].items():
        fields = dataclasses.asdict(leaf) if dataclasses.is_dataclass(leaf) else {"": leaf}
        for f, t in fields.items():
            if isinstance(t, torch.Tensor):
                frozen_before[name, f] = t.clone()
    start = oweights_from_port(ow, tcfg, family)
    tc = tft.TrainConfig(learning_rate=5e-3, total_steps=10)
    step = tft.make_train_step(tcfg, tft.make_optimizer(tc, ow), family=family)
    for i in range(3):
        ids, labels = _batch(jcfg.vocab_size, 20 + i)
        step(ow, frozen, torch.from_numpy(ids), torch.from_numpy(labels))
    for (name, f), t in frozen_before.items():
        leaf = frozen["layers"][name]
        now = getattr(leaf, f) if f else leaf
        assert torch.equal(now, t), (name, f)
    for name, lin in tparams["layers"].items():  # split_wct trained copies
        if hasattr(lin, "oweight"):
            assert lin.oweight.requires_grad is False
    moved = oweights_from_port(ow, tcfg, family)
    assert all(np.abs(moved[k] - start[k]).max() > 0 for k in start)


def test_remat_on_and_off_give_equal_gradients(models):
    family, _, tparams, jcfg, tcfg = models["tiny"]
    ids, labels = _batch(jcfg.vocab_size, 5)
    grads = []
    for remat in (True, False):
        ow, frozen = tft.split_wct(tparams)
        tft.wct_loss(ow, frozen, torch.from_numpy(ids), torch.from_numpy(labels), tcfg,
                     remat=remat).backward()
        grads.append([t.grad.clone() for t in tft.leaves(ow)])
    for a, b in zip(*grads):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_sft_data_is_identical_to_jax():
    assert tsft.alpaca_prompt("do x", "with y") == jsft.alpaca_prompt("do x", "with y")
    assert tsft.alpaca_prompt("do x") == jsft.alpaca_prompt("do x")
    ref = jsft.synthetic_sft_examples(10, 300, seed=3)
    got = tsft.synthetic_sft_examples(10, 300, seed=3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.prompt_ids, b.prompt_ids)
        np.testing.assert_array_equal(a.response_ids, b.response_ids)
    for train_on_prompt in (False, True):
        for x, y in zip(tsft.mask_and_pad(got, 40, 0, train_on_prompt),
                        jsft.mask_and_pad(ref, 40, 0, train_on_prompt)):
            np.testing.assert_array_equal(x, y)
    ex_t = tsft.load_sft_examples("synthetic", None, 12, 300, seed=1)
    ex_j = jsft.load_sft_examples("synthetic", None, 12, 300, seed=1)
    bt = list(tsft.batches(ex_t, 4, 48, seed=7, epochs=2))
    bj = list(jsft.batches(ex_j, 4, 48, seed=7, epochs=2))
    assert len(bt) == len(bj) == 6
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("dataset", ["platypus", "alpaca", "oasst1", "wikitext2"])
def test_sft_sets_that_need_files_raise_and_name_them(dataset):
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        tsft.load_sft_examples(dataset, None, 4, 300)
