"""WCT checkpoints cross-load between the port and ``qeft_tpu`` bit for bit,
and the port's ``run_finetune`` runs on the CPU: save, resume, evaluate, and
serve the tuned model through ``main``.

Base checkpoints are written by the JAX package's ``save_packed``, unfused
(q/k/v, up/gate) and fused (qkv, upgate), or by the port's own
``save_packed``.  Every checkpoint comparison is exact (array_equal); the
accuracy of the synthetic multiple-choice eval is compared as counts, and
the resumed run's slabs equal the uninterrupted run's to 1e-6 of their scale
(the same f32 steps; the optimizer state goes through a file)."""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu import checkpoint as jckpt
from qeft_tpu.eval_mc import (
    evaluate_mc as jax_evaluate_mc,
    score_example as jax_score_example,
    synthetic_mc_examples as jax_mc,
)
from qeft_tpu.finetune import split_wct as jax_split_wct
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.pipeline import fuse_packed_stages as jax_fuse
from qeft_tpu_torch import checkpoint as tckpt
from qeft_tpu_torch import eval_mc as tmc
from qeft_tpu_torch import main as torch_main
from qeft_tpu_torch import run_finetune
from qeft_tpu_torch.finetune import split_wct
from qeft_tpu_torch.models.llama import LLAMA_PRESETS as TORCH_PRESETS
from tests.torch_parity import gptq_packed_tiny, oweights_from_port

CFG = LLAMA_PRESETS["tiny"]
TCFG = TORCH_PRESETS["tiny"]


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """JAX-written base checkpoints of packed_tiny: unfused and fused."""
    root = tmp_path_factory.mktemp("bases")
    jparams = gptq_packed_tiny()
    out = {}
    for kind, tree in (("unfused", jparams), ("fused", jax_fuse(jparams, jax_meta("llama")))):
        path = str(root / f"tiny_{kind}")
        jckpt.save_packed(path, tree, CFG, family="llama")
        out[kind] = (path, tree)
    return out


def _noisy(arrays, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.normal(size=v.shape) * 0.01).astype(np.float32)
            for k, v in arrays.items()}


@pytest.mark.parametrize("kind", ["unfused", "fused"])
def test_jax_wct_loads_into_the_port(bases, tmp_path, kind):
    base, tree = bases[kind]
    jow = _noisy(jax_split_wct(tree, jax_meta("llama"))[0], 1)
    path = str(tmp_path / "wct")
    jckpt.save_wct(path, {k: jnp.asarray(v) for k, v in jow.items()}, base)
    params, cfg, family = tckpt.load_wct(path, device="cpu")
    ref, _, _ = jckpt.load_wct(path)
    assert family == "llama" and cfg.hidden_size == CFG.hidden_size
    members = {"qkv": ("q", "k", "v"), "o": ("o",), "upgate": ("up", "gate"), "down": ("down",)}
    for name, names in members.items():
        names = names if kind == "unfused" else (name,)
        want = np.concatenate([np.asarray(ref["layers"][n].oweight) for n in names], axis=-1)
        np.testing.assert_array_equal(params["layers"][name].oweight.numpy(), want)
    slabs, base_path = tckpt.read_wct(path)
    assert base_path == os.path.abspath(base) and set(slabs) == set(jow)
    for k, v in jow.items():
        np.testing.assert_array_equal(slabs[k].numpy(), v)


@pytest.mark.parametrize("kind", ["unfused", "fused"])
def test_port_wct_loads_into_jax(bases, tmp_path, kind):
    base, tree = bases[kind]
    params, _, _ = tckpt.load_wct(_port_base_wct(base, tmp_path), device="cpu")
    ow, _ = split_wct(params)
    with torch.no_grad():
        for i, leaf in enumerate(t for v in ow.values() for t in v):
            leaf.add_(torch.from_numpy(np.random.default_rng(i).normal(
                size=tuple(leaf.shape)).astype(np.float32)) * 0.01)
    path = str(tmp_path / "wct_port")
    tckpt.save_wct(path, ow, base)
    ref, _, _ = jckpt.load_wct(path)
    names = set(jax_split_wct(tree, jax_meta("llama"))[0])
    with np.load(path + ".npz") as z:
        assert {k.split("::")[1] for k in z.files} == names
    if kind == "unfused":
        want = oweights_from_port(ow, TCFG)
    else:
        want = {k: torch.stack([t.detach() for t in v]).numpy() for k, v in ow.items()}
    for name in names:
        np.testing.assert_array_equal(np.asarray(ref["layers"][name].oweight), want[name])


def _port_base_wct(base, tmp_path):
    """A WCT checkpoint holding the base's own slabs (identity overlay)."""
    path = str(tmp_path / "identity")
    params, _, _ = tckpt.load_packed(base, device="cpu")
    ow = {k: v.oweight for k, v in params["layers"].items() if hasattr(v, "oweight")}
    tckpt.save_wct(path, ow, base)
    return path


def test_port_save_packed_round_trips_through_both_packages(bases, tmp_path):
    base, tree = bases["fused"]
    params, cfg, family = tckpt.load_packed(base, device="cpu")
    path = str(tmp_path / "port_packed")
    tckpt.save_packed(path, params, cfg, family)
    again, cfg2, _ = tckpt.load_packed(path, device="cpu")
    jtree, jcfg, _ = jckpt.load_packed(path)
    assert cfg2 == cfg and jcfg.hidden_size == cfg.hidden_size
    for name, leaf in params["layers"].items():
        if hasattr(leaf, "qweight"):
            for f in ("qweight", "scales", "scaled_zeros", "oweight"):
                np.testing.assert_array_equal(getattr(again["layers"][name], f).numpy(),
                                              getattr(leaf, f).numpy())
                np.testing.assert_array_equal(np.asarray(getattr(jtree["layers"][name], f)),
                                              getattr(leaf, f).numpy())
            assert jtree["layers"][name].group_size == leaf.group_size
        else:
            np.testing.assert_array_equal(again["layers"][name].numpy(), leaf.numpy())


def test_load_model_dispatches_on_the_format(bases, tmp_path):
    base, _ = bases["unfused"]
    packed, _, _ = tckpt.load_model(base, device="cpu")
    assert "q" in packed["layers"]  # a packed checkpoint loads as written
    wct, _, _ = tckpt.load_model(_port_base_wct(base, tmp_path), device="cpu")
    assert "qkv" in wct["layers"] and "q" not in wct["layers"]
    q = packed["layers"]["q"].oweight
    np.testing.assert_array_equal(wct["layers"]["qkv"].oweight[..., : q.shape[-1]].numpy(),
                                  q.numpy())
    fake = str(tmp_path / "fake")
    with open(fake + ".json", "w") as f:
        f.write('{"format": "fake"}')
    with pytest.raises(NotImplementedError):
        tckpt.load_model(fake, device="cpu")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = run_finetune.main(argv)
    return metrics, out.getvalue()


def test_run_finetune_resume_eval_and_serve(bases, tmp_path):
    base, _ = bases["unfused"]
    common = ["--load", base, "--device", "cpu", "--batch_size", "2", "--source_max_len",
              "32", "--nsamples", "24", "--lr_schedule", "constant", "--learning_rate",
              "5e-3", "--log_steps", "1", "--seed", "3"]
    straight = str(tmp_path / "straight")
    _run(common + ["--output_dir", straight, "--max_steps", "4", "--save_steps", "10"])
    for name in ("wct_final.npz", "wct_final.json", "metrics.json", "completed"):
        assert os.path.exists(os.path.join(straight, name)), name
    assert _run(common + ["--output_dir", straight, "--max_steps", "4"])[0] is None

    split = str(tmp_path / "split")
    _run(common + ["--output_dir", split, "--max_steps", "2", "--save_steps", "2"])
    assert os.path.exists(os.path.join(split, "opt_step2.pt"))
    os.remove(os.path.join(split, "completed"))  # as if the run had been cut after step 2
    metrics, text = _run(common + ["--output_dir", split, "--max_steps", "4"])
    assert "resuming from" in text and "restored optimizer state" in text
    assert [m["step"] for m in metrics if "loss" in m] == [1, 2, 3, 4]
    a, _ = tckpt.read_wct(os.path.join(straight, "wct_final"))
    b, _ = tckpt.read_wct(os.path.join(split, "wct_final"))
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6 * a[k].abs().max().item())

    res = torch_main.main(["--load", os.path.join(split, "wct_final"), "--device", "cpu",
                           "--eval", "--eval_windows", "1", "--seqlen", "32", "--benchmark", "4"])
    assert np.isfinite(res["ppl_synthetic"]) and res["decode_tokens_per_s"] > 0


def test_run_finetune_eval_and_mc_match_jax(bases, tmp_path):
    base, _ = bases["unfused"]
    out = str(tmp_path / "evals")
    metrics, text = _run(["--load", base, "--device", "cpu", "--output_dir", out,
                          "--batch_size", "2", "--source_max_len", "32", "--nsamples", "24",
                          "--max_steps", "3", "--eval_steps", "2", "--eval_nsamples", "4",
                          "--do_mmlu_eval", "--mmlu_n", "6", "--mmlu_eval_steps", "2"])
    assert [m["step"] for m in metrics if "eval_loss" in m] == [2, 3]
    assert [m["step"] for m in metrics if "mmlu_accuracy" in m] == [2, 3]
    assert all(np.isfinite(m["eval_loss"]) for m in metrics if "eval_loss" in m)

    final = os.path.join(out, "wct_final")
    jparams, jcfg, family = jckpt.load_wct(final)
    tparams, tcfg, _ = tckpt.load_wct(final, device="cpu")
    ex_j, ex_t = jax_mc(12, CFG.vocab_size, 5), tmc.synthetic_mc_examples(12, CFG.vocab_size, 5)
    for a, b in zip(ex_j, ex_t):
        assert a.label == b.label
        np.testing.assert_array_equal(a.context_ids, b.context_ids)
    picks_j = [jax_score_example(jparams, e, jcfg) for e in ex_j]
    picks_t = [tmc.score_example(tparams, e, tcfg, device="cpu") for e in ex_t]
    assert picks_t == picks_j
    assert tmc.evaluate_mc(tparams, ex_t, tcfg, device="cpu") == jax_evaluate_mc(
        jparams, ex_j, jcfg)
    assert [m for m in metrics if "mmlu_accuracy" in m][-1]["mmlu_accuracy"] == tmc.evaluate_mc(
        tparams, tmc.synthetic_mc_examples(6, CFG.vocab_size, 42), tcfg,
        device="cpu")["accuracy"]


def test_mmlu_loader_needs_files():
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        tmc.load_mmlu_examples("tok")
