"""Models larger than the device, on the CPU: the port's streaming branch
(a tree held in host memory, each block moved to the device the caller
names) of ``extract_global_outidx``, ``quantize_model`` and ``pack_model``
against its resident branch, ``reorder_model_host`` against ``qeft_tpu``'s,
and ``eval_ppl_streamed`` against ``qeft_tpu``'s and the port's
``eval_ppl``, on ``tiny`` (llama) and ``tiny-gemma`` in f32.  The branch is
reached with ``device="cpu"`` and the tree on the host (host and device the
same); the same dense weights are carried from ``qeft_tpu`` with
``from_flat``, and each model is quantized once per module in each branch.

Tolerances:
- streamed against resident (extraction, the fake tree and every quantizer
  state, the packed tree): bit for bit -- the same operations on the same
  values, only the tensors' home differs;
- ``reorder_model_host`` against JAX's on the same tree and states: bit for
  bit (a permutation);
- ``eval_ppl_streamed``: within 1e-4 relative of JAX's ``eval_ppl_streamed``
  (summation order), and of the port's ``eval_ppl`` (the same windows
  through the same block function, layer-major instead of window-major).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu import eval as jeval
from qeft_tpu import pipeline as jpipe
from qeft_tpu.checkpoint import _flatten
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models import llama as jl
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu_torch import checkpoint as tckpt
from qeft_tpu_torch import pipeline as tpipe
from qeft_tpu_torch.checkpoint import from_flat
from qeft_tpu_torch.data import get_loaders
from qeft_tpu_torch.eval import eval_ppl, eval_ppl_streamed
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.quant.quantizer import QuantSpec as TSpec
from tests.torch_parity import torch_cfg

PRESETS = {"tiny": "llama", "tiny-gemma": "gemma"}
NSAMPLES, SEQLEN = 4, 32
SPEC = dict(bits=4, sym=False, mse=False, group_size=64)


def _targs(**kw):
    return tpipe.QuantizeArgs(spec=TSpec(**SPEC), target_rank=8, nsamples=NSAMPLES, **kw)


def _assert_same_tree(got, want):
    g, w = tckpt.to_flat(got), tckpt.to_flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _assert_same_states(got, want):
    assert sorted(got) == sorted(want)
    for key, st in want.items():
        for field in ("scale_group", "zero_group", "out_ids"):
            assert getattr(got[key], field).device.type == "cpu"
            assert torch.equal(getattr(got[key], field), getattr(st, field)), (key, field)


@pytest.fixture(scope="module")
def runs():
    """preset -> the resident and the streamed run of extraction,
    quantization (the global reorder) and packing of one model."""
    out = {}
    for name, family in PRESETS.items():
        cfg, tcfg, meta = LLAMA_PRESETS[name], torch_cfg(name), get_model_meta(family)
        dense = jl.init_params(cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
        tdense = from_flat(_flatten(dense))
        calib = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(NSAMPLES, SEQLEN))
        run = {}
        for label, device in (("resident", None), ("streamed", "cpu")):
            outidx, per_layer = tpipe.extract_global_outidx(
                tdense, calib, tcfg, meta, _targs(no_frob_norm=True), device=device)
            fake, states = tpipe.quantize_model(tdense, calib, tcfg, meta, _targs(), outidx,
                                                device=device)
            packed = tpipe.pack_model(fake, states, tcfg, meta, fuse_stages=True,
                                      device=device)
            run[label] = dict(outidx=outidx, per_layer=per_layer, fake=fake, states=states,
                              packed=packed)
        out[name] = dict(cfg=cfg, tcfg=tcfg, meta=meta, dense=dense, tdense=tdense, **run)
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_streamed_extraction_is_bit_exact_with_the_resident_one(runs, name):
    r, s = runs[name]["resident"], runs[name]["streamed"]
    np.testing.assert_array_equal(s["outidx"], r["outidx"])
    assert sorted(s["per_layer"]) == sorted(r["per_layer"])
    for key, ids in r["per_layer"].items():
        np.testing.assert_array_equal(s["per_layer"][key], ids)


@pytest.mark.parametrize("name", list(PRESETS))
def test_streamed_quantization_is_bit_exact_with_the_resident_one(runs, name):
    r, s = runs[name]["resident"], runs[name]["streamed"]
    _assert_same_tree(s["fake"], r["fake"])
    _assert_same_states(s["states"], r["states"])
    assert "o_reorder" in s["fake"]["layers"]


@pytest.mark.parametrize("name", list(PRESETS))
def test_streamed_packing_is_bit_exact_with_the_resident_one(runs, name):
    _assert_same_tree(runs[name]["streamed"]["packed"], runs[name]["resident"]["packed"])


def test_streaming_refuses_a_tree_on_another_device(runs):
    r = runs["tiny"]
    with pytest.raises(ValueError, match="streams only from the host"):
        tpipe._placement({"embed": torch.empty(1, device="meta")}, "cpu")
    assert tpipe._placement(r["tdense"], None) == (torch.device("cpu"), False)
    assert tpipe._placement(r["tdense"], "cpu") == (torch.device("cpu"), True)


def _states_to_jax(states):
    return {k: jpipe.QuantizerState(
        scale_group=np.array(st.scale_group), zero_group=np.array(st.zero_group),
        out_ids=np.array(st.out_ids), sym=st.sym, bits=st.bits, group_size=st.group_size)
        for k, st in states.items()}


@pytest.mark.parametrize("name", list(PRESETS))
def test_reorder_model_host_matches_jax(runs, name):
    """The un-reordered fake tree and quantizer states of the port's
    quantizer, permuted by both packages' host passes around a random
    global weak set: trees, ``o_reorder`` and the states' rows identical."""
    r = runs[name]
    cfg, tcfg, meta = r["cfg"], r["tcfg"], r["meta"]
    calib = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(NSAMPLES, SEQLEN))
    fake, states = tpipe.quantize_model(r["tdense"], calib, tcfg, meta,
                                        _targs(reorder=False))
    global_out = np.sort(np.random.default_rng(7).choice(cfg.hidden_size, 8, replace=False))
    jstates = _states_to_jax(states)
    want = jpipe.reorder_model_host(
        {**{k: v.numpy() for k, v in fake.items() if k != "layers"},
         "layers": {k: v.numpy().copy() for k, v in fake["layers"].items()}},
        jstates, global_out.astype(np.int32), cfg, jax_meta(PRESETS[name]))
    got = tpipe.reorder_model_host(fake, states, global_out, tcfg, meta)
    jflat, tflat = _flatten(want), tckpt.to_flat(got)
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        np.testing.assert_array_equal(tflat[key], np.asarray(jflat[key]), err_msg=key)
    for key, st in jstates.items():
        np.testing.assert_array_equal(states[key].scale_group.numpy(), st.scale_group,
                                      err_msg=str(key))
        np.testing.assert_array_equal(states[key].zero_group.numpy(), st.zero_group,
                                      err_msg=str(key))


@pytest.mark.parametrize("tree", ["dense", "fake"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_eval_ppl_streamed_matches_jax_and_eval_ppl(runs, name, tree):
    r = runs[name]
    cfg, tcfg, meta = r["cfg"], r["tcfg"], r["meta"]
    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    tparams = r["tdense"] if tree == "dense" else r["resident"]["fake"]
    jparams = r["dense"] if tree == "dense" else jax.tree.map(
        jnp.asarray, {**{k: v.numpy() for k, v in tparams.items() if k != "layers"},
                      "layers": {k: v.numpy() for k, v in tparams["layers"].items()}})
    ref = jeval.eval_ppl_streamed(jparams, test, cfg, jax_meta(PRESETS[name]), seqlen=SEQLEN,
                                  max_windows=3)
    got = eval_ppl_streamed(tparams, test, tcfg, meta, seqlen=SEQLEN, max_windows=3,
                            device="cpu")
    whole = eval_ppl(tpipe.fuse_dense_stages(tparams, meta), test, tcfg, seqlen=SEQLEN,
                     max_windows=3, family=PRESETS[name], device="cpu")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    np.testing.assert_allclose(got, whole, rtol=1e-4)


def test_eval_ppl_streamed_covers_the_llama_family_only(runs):
    with pytest.raises(ValueError, match="llama family"):
        eval_ppl_streamed(runs["tiny"]["tdense"], np.zeros(64, np.int64), runs["tiny"]["tcfg"],
                          get_model_meta("opt"), seqlen=SEQLEN, device="cpu")


def test_eval_ppl_streamed_of_a_packed_tree_matches_eval_ppl(runs):
    """The packed tree held on the host: each block's packed linears move to
    the device and run their kernels' plain versions."""
    r = runs["tiny"]
    packed = r["streamed"]["packed"]
    test = get_loaders("synthetic", train=False, vocab_size=r["cfg"].vocab_size)
    got = eval_ppl_streamed(packed, test, r["tcfg"], r["meta"], seqlen=SEQLEN, max_windows=2,
                            device="cpu")
    whole = eval_ppl(packed, test, r["tcfg"], seqlen=SEQLEN, max_windows=2, device="cpu")
    np.testing.assert_allclose(got, whole, rtol=1e-4)
