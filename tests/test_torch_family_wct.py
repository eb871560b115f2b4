"""Weak-column tuning of OPT, Phi, Bloom and Falcon: the port's training
step (``qeft_tpu_torch.finetune``, the families' forwards under autograd
through ``qlinear_apply``) against ``qeft_tpu.finetune.make_train_step(
family=...)``, in f32 on the CPU, on tiny models quantized and packed by
the JAX package: ``opt-tiny`` packed without the global reorder (every
linear carries ``reorder_ids``, whose gather is differentiated), and
``phi-tiny``, ``bloom-tiny`` and ``falcon-tiny`` with it.

Six steps of AdamW under the cosine schedule and global-norm clipping,
``remat`` on in both packages (JAX checkpoints the whole forward, the port
each block: the same loss and gradients).  Tolerances: each step's loss
within 1e-4 relative, the slabs after the last step within 2e-4; every
frozen leaf stays bit for bit what it was.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu import finetune as jft
from qeft_tpu.checkpoint import save_packed as jax_save_packed
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu_torch import finetune as tft
from qeft_tpu_torch.checkpoint import to_flat
from tests.torch_parity import oweights_from_port, quantized_family

MODELS = {"opt-tiny": False, "phi-tiny": True, "bloom-tiny": True, "falcon-tiny": True}
STEPS, BATCH, SEQ = 6, 2, 12


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, size=(BATCH, SEQ))
        labels = ids.copy()
        labels[:, :3] = -100  # a masked prompt, as the SFT collators mask it
        out.append((ids, labels))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_six_wct_steps_match_jax(name):
    jparams, tparams, cfg, tcfg, family = quantized_family(name, reorder=MODELS[name])
    assert (("o_reorder" in tparams["layers"]) == MODELS[name]
            and (tparams["layers"]["q" if family in ("opt", "phi") else "qkv"].reorder_ids
                 is None) == MODELS[name])
    tc = dict(total_steps=STEPS, learning_rate=1e-3)
    jo, jfrozen = jft.split_wct(jparams, jax_meta(family))
    opt = jft.make_optimizer(jft.TrainConfig(**tc))
    state = opt.init(jo)
    step = jft.make_train_step(cfg, opt, remat=True, family=family)
    to, tfrozen = tft.split_wct(tparams)
    frozen_before = to_flat(tfrozen)
    tstep = tft.make_train_step(tcfg, tft.make_optimizer(tft.TrainConfig(**tc), to),
                                remat=True, family=family)
    for ids, labels in _batches(cfg.vocab_size):
        jo, state, jloss = step(jo, state, jfrozen, jnp.asarray(ids), jnp.asarray(labels))
        tloss = tstep(to, tfrozen, torch.as_tensor(ids), torch.as_tensor(labels))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    got = oweights_from_port(to, tcfg, family)
    assert sorted(got) == sorted(jo)
    for key, want in jo.items():
        np.testing.assert_allclose(got[key], np.asarray(want), rtol=2e-4, atol=2e-4, err_msg=key)
        assert not np.array_equal(got[key], tparams["layers"][key].oweight.numpy())
    after = to_flat(tfrozen)
    assert sorted(after) == sorted(frozen_before)
    for key, v in frozen_before.items():
        np.testing.assert_array_equal(after[key], v, err_msg=key)


def test_run_finetune_tunes_a_family_checkpoint_on_the_cpu(tmp_path):
    """``run_finetune`` on a JAX-written OPT checkpoint packed without the
    reorder, then ``main --load wct_final --eval``; JAX reads the WCT file
    and gets the slabs the port trained."""
    from qeft_tpu.checkpoint import load_wct as jax_load_wct
    from qeft_tpu_torch import main as tmain
    from qeft_tpu_torch import run_finetune

    jparams, _, cfg, tcfg, family = quantized_family("opt-tiny", reorder=False)
    base = str(tmp_path / "opt_packed")
    jax_save_packed(base, jparams, cfg, family=family)
    out = str(tmp_path / "wct")
    metrics = run_finetune.main(["--load", base, "--output_dir", out, "--device", "cpu",
                                 "--max_steps", "2", "--batch_size", "2", "--source_max_len",
                                 "16", "--nsamples", "8", "--log_steps", "1"])
    assert [m["step"] for m in metrics] == [1, 2] and all(np.isfinite(m["loss"]) for m in metrics)
    loaded, _, jfam = jax_load_wct(out + "/wct_final")
    assert jfam == family
    res = tmain.main(["--load", out + "/wct_final", "--device", "cpu", "--eval", "--eval_windows",
                      "1", "--seqlen", "16"])
    assert np.isfinite(res["ppl_synthetic"])
    moved = [not np.array_equal(np.asarray(loaded["layers"][k].oweight, np.float32),
                                np.asarray(jparams["layers"][k].oweight, np.float32))
             for k in ("q", "fc2")]
    assert all(moved)
