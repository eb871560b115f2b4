"""The port's quantization pipeline (``qeft_tpu_torch.pipeline``,
``checkpoint`` fake format, the CLIs) against ``qeft_tpu``'s on the same
dense weights, carried across with ``from_flat``, in f32 on the CPU, on
``tiny`` (llama) and ``tiny-gemma`` (gemma norm offset, embedding scale,
tanh GELU).  Each model is quantized once per module by each package:
extraction with and without the Frobenius weighting, then GPTQ-OWQ (w4,
g = 64, MSE grid, r = 8) with the global reorder.

Tolerances:
- ``outidx`` and every per-layer weak set: identical;
- GPTQ codes of the whole model: at most 0.5 % differ, each by at most one
  level (a flipped rounding propagates along its row, and the Hessians
  differ in summation order), and the fake weights' reconstruction error
  ``tr((W - Q) H (W - Q)^T)`` within 1 % of JAX's;
- `pack_model`, `reorder_model`, `rtn_pack_linear` and the checkpoints on
  the same inputs: bit-exact;
- the port's packed model against its own fake model: logits within
  ``rtol = atol = 5e-3`` (JAX's own bound, ``tests/test_pipeline.py``);
- the calibration capture against JAX's ``llama_block(capture=True)``:
  within 1e-5 of each tensor's scale.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu import checkpoint as jckpt
from qeft_tpu import pipeline as jpipe
from qeft_tpu.checkpoint import _flatten
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.models import llama as jl
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.quant.quantizer import QuantSpec as JSpec
from qeft_tpu_torch import checkpoint as tckpt
from qeft_tpu_torch import pipeline as tpipe
from qeft_tpu_torch.checkpoint import from_flat
from qeft_tpu_torch.models import llama as tl
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.quant.quantizer import QuantSpec as TSpec
from tests.torch_parity import f32, torch_cfg

PRESETS = {"tiny": "llama", "tiny-gemma": "gemma"}
NSAMPLES, SEQLEN = 4, 32
ARGS = dict(target_rank=8, nsamples=NSAMPLES)
SPEC = dict(bits=4, sym=False, mse=False, group_size=64)


def _calib(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, size=(NSAMPLES, SEQLEN))


def _jargs(**kw):
    return jpipe.QuantizeArgs(spec=JSpec(**SPEC), **{**ARGS, **kw})


def _targs(**kw):
    return tpipe.QuantizeArgs(spec=TSpec(**SPEC), **{**ARGS, **kw})


def to_torch(tree):
    return from_flat(_flatten(tree))


def _states_to_jax(states):
    return {k: jpipe.QuantizerState(
        scale_group=jnp.asarray(st.scale_group.numpy()), zero_group=jnp.asarray(
            st.zero_group.numpy()), out_ids=jnp.asarray(st.out_ids.numpy()), sym=st.sym,
        bits=st.bits, group_size=st.group_size) for k, st in states.items()}


def _states_to_torch(states):
    return {k: tpipe.QuantizerState(
        scale_group=torch.from_numpy(np.array(st.scale_group)),
        zero_group=torch.from_numpy(np.array(st.zero_group)),
        out_ids=torch.from_numpy(np.array(st.out_ids)), sym=st.sym, bits=st.bits,
        group_size=st.group_size) for k, st in states.items()}


@pytest.fixture(scope="module")
def runs():
    """preset -> both packages' extraction and quantization of one model."""
    out = {}
    for name, family in PRESETS.items():
        cfg, tcfg = LLAMA_PRESETS[name], torch_cfg(name)
        jmeta, tmeta = jax_meta(family), get_model_meta(family)
        dense = jl.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
        tdense = to_torch(dense)
        calib = _calib(cfg)
        j_out, j_per = jpipe.extract_global_outidx(dense, calib, cfg, jmeta,
                                                   _jargs(no_frob_norm=True))
        t_out, t_per = tpipe.extract_global_outidx(tdense, calib, tcfg, tmeta,
                                                   _targs(no_frob_norm=True))
        jq, jstates = jpipe.quantize_model(dense, calib, cfg, jmeta, _jargs(), j_out)
        tq, tstates = tpipe.quantize_model(tdense, calib, tcfg, tmeta, _targs(), t_out)
        out[name] = dict(cfg=cfg, tcfg=tcfg, jmeta=jmeta, tmeta=tmeta, dense=dense,
                         tdense=tdense, calib=calib, extract=((j_out, j_per), (t_out, t_per)),
                         jax=(jq, jstates), port=(tq, tstates), family=family)
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_extracted_outidx_is_identical(runs, name):
    (j_out, j_per), (t_out, t_per) = runs[name]["extract"]
    np.testing.assert_array_equal(t_out, j_out)
    assert t_out.dtype == np.int32 and sorted(t_per) == sorted(j_per)
    for key in j_per:
        np.testing.assert_array_equal(t_per[key], np.asarray(j_per[key]))


@pytest.mark.parametrize("name", list(PRESETS))
def test_extraction_with_the_frobenius_weighting_is_identical(runs, name):
    r = runs[name]
    j_out, j_per = jpipe.extract_global_outidx(r["dense"], r["calib"], r["cfg"], r["jmeta"],
                                               _jargs())
    t_out, t_per = tpipe.extract_global_outidx(r["tdense"], r["calib"], r["tcfg"], r["tmeta"],
                                               _targs())
    np.testing.assert_array_equal(t_out, j_out)
    for key in j_per:
        np.testing.assert_array_equal(t_per[key], np.asarray(j_per[key]))


def _levels(w_kn, st, g):
    """The signed quantization level (code - zero) of every weight of a
    fake weight [K, N] under its state."""
    scale = np.repeat(np.asarray(st.scale_group, np.float64).T, g, axis=0)
    return np.round(np.asarray(w_kn, np.float64) / scale)


@pytest.mark.parametrize("name", list(PRESETS))
def test_block0_codes_match_jax(runs, name):
    """Block 0 sees the same calibration input in both packages (up to
    summation order): at most 0.5 % of its codes differ.  From block 1 on
    each package calibrates on its own quantized block 0's outputs, which
    differ by those codes, so the models are compared there by what they
    compute (`test_fake_models_are_as_close_to_the_dense_model`)."""
    r = runs[name]
    jq, jstates = r["jax"]
    tq, tstates = r["port"]
    assert sorted(jstates) == sorted(tstates)
    differ = total = 0
    for (i, lin), jst in jstates.items():
        tst = tstates[(i, lin)]
        assert tst.out_ids.shape == jst.out_ids.shape
        if i:
            continue
        np.testing.assert_array_equal(tst.out_ids.numpy(), np.asarray(jst.out_ids))
        n_out = int(jst.out_ids.shape[0])
        jw = np.asarray(jq["layers"][lin][0])
        tw = f32(tq["layers"][lin][0])
        k = jw.shape[0]
        d = _levels(jw, jst, 64)[: k - n_out] != _levels(tw, tst, 64)[: k - n_out]
        differ += int(d.sum())
        total += d.size
        # the weak rows keep their compensated full-precision values (in the
        # output columns whose codes all agree)
        same = ~d.any(axis=0)
        np.testing.assert_allclose(tw[k - n_out:, same], jw[k - n_out:, same], rtol=1e-4,
                                   atol=1e-5)
    assert differ <= 0.005 * total, (differ, total)
    np.testing.assert_array_equal(tq["layers"]["o_reorder"][0].numpy(),
                                  np.asarray(jq["layers"]["o_reorder"][0]))
    for leaf in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(f32(tq[leaf]), np.asarray(jq[leaf]))


@pytest.mark.parametrize("name", list(PRESETS))
def test_fake_models_are_as_close_to_the_dense_model(runs, name):
    """Whole models: the port's fake model's logits are as far from the
    dense model's as JAX's fake model's are (mean squared error within 10
    %), and the two fake models are closer to each other than either is to
    the dense model."""
    r = runs[name]
    tokens = r["calib"][:2]
    dense = np.asarray(jl.llama_forward(r["dense"], jnp.asarray(tokens), r["cfg"]))
    jfake = np.asarray(jl.llama_forward(r["jax"][0], jnp.asarray(tokens), r["cfg"]))
    with torch.no_grad():
        tfake = tl.llama_forward(tpipe.fuse_dense_stages(r["port"][0], r["tmeta"]),
                                 torch.as_tensor(tokens), r["tcfg"]).numpy()
    e_j = float(np.mean((jfake - dense) ** 2))
    e_t = float(np.mean((tfake - dense) ** 2))
    np.testing.assert_allclose(e_t, e_j, rtol=0.1)
    assert float(np.mean((tfake - jfake) ** 2)) < min(e_j, e_t)


OPTION_CASES = {  # QuantizeArgs options beyond the module's run: (kwargs, reorder)
    "true_sequential-target_bit": (dict(true_sequential=True, target_bit=4.25,
                                        target_rank=None), True),
    "act_order-per_layer": (dict(act_order=True), False),
    "rtn-owq_layers": (dict(rtn=True, owq_layers=("q", "down")), True),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_quantize_options_match_jax(runs, case):
    """``true_sequential`` with a ``target_bit`` budget, ``act_order``
    without the reorder (per-linear permutations), and nearest rounding with
    weak columns in some linears only: the same weak sets and permutations
    as JAX, block 0's codes within 0.5 %, the packed trees' layouts alike."""
    r = runs["tiny"]
    kw, reorder = OPTION_CASES[case]
    outidx = r["extract"][0][0] if reorder else None
    jq, jstates = jpipe.quantize_model(r["dense"], r["calib"], r["cfg"], r["jmeta"],
                                       _jargs(reorder=reorder, **kw), outidx)
    tq, tstates = tpipe.quantize_model(r["tdense"], r["calib"], r["tcfg"], r["tmeta"],
                                       _targs(reorder=reorder, **kw), outidx)
    differ = total = 0
    for (i, lin), jst in jstates.items():
        tst = tstates[(i, lin)]
        assert tst.out_ids.shape == jst.out_ids.shape and (jst.perm_ids is None) == (
            tst.perm_ids is None)
        if i == 0:  # the same calibration input: the same weak sets
            np.testing.assert_array_equal(tst.out_ids.numpy(), np.asarray(jst.out_ids),
                                          err_msg=lin)
            if jst.perm_ids is not None:
                np.testing.assert_array_equal(tst.perm_ids.numpy(), np.asarray(jst.perm_ids))
            # levels in the quantization order (act-order permutes within the
            # reordered layout, so compare there)
            order = (np.asarray(jst.perm_ids) if jst.perm_ids is not None
                     else np.arange(jq["layers"][lin].shape[1]))
            jw = np.asarray(jq["layers"][lin][0])[order]
            tw = f32(tq["layers"][lin][0])[order]
            n_out = int(jst.out_ids.shape[0])
            k = jw.shape[0]
            if not reorder and jst.perm_ids is None and n_out:
                ids = np.asarray(jpipe.sparse_to_dense_ids(jst.out_ids, k))
                jw, tw = jw[ids], tw[ids]
            d = _levels(jw, jst, 64)[: k - n_out] != _levels(tw, tst, 64)[: k - n_out]
            differ += int(d.sum())
            total += d.size
    assert differ <= 0.005 * total, (case, differ, total)
    if not kw.get("act_order"):
        jpacked = jpipe.pack_model(jq, jstates, r["cfg"], r["jmeta"], dtype=jnp.float32)
        tpacked = tpipe.pack_model(tq, tstates, r["tcfg"], r["tmeta"], dtype=torch.float32)
        jflat, tflat = _flatten(jpacked), tckpt.to_flat(tpacked)
        assert sorted(jflat) == sorted(tflat)
        for key in jflat:
            assert tflat[key].shape == np.asarray(jflat[key]).shape, key


@pytest.mark.parametrize("name", list(PRESETS))
def test_reconstruction_error_matches_jax(runs, name):
    """tr((W - Q) H (W - Q)^T) of every linear of block 0, with the Hessian
    of the block's own calibration input, each package's fake weight
    against the original dense weight, both brought to the same
    (unreordered) column order."""
    r = runs[name]
    cfg, meta = r["cfg"], r["jmeta"]
    blk = jax.tree.map(lambda a: a[0], r["dense"]["layers"])
    x = jpipe._plain_embed(r["dense"], jnp.asarray(r["calib"]), cfg)
    _, h_sums = jpipe.block_hessians(blk, x, cfg)
    jq, jstates = r["jax"]
    tq, _ = r["port"]
    for lin in ("q", "k", "v", "up", "gate"):  # residual-stream inputs: one permutation
        h = np.asarray(h_sums[jpipe._stage_of(meta, lin)]) * (2.0 / NSAMPLES)
        ids = np.asarray(jpipe.sparse_to_dense_ids(jnp.asarray(r["extract"][0][0]),
                                                   cfg.hidden_size))
        w = np.asarray(blk[lin])[ids]
        hp = h[ids][:, ids]
        errs = []
        for fake in (np.asarray(jq["layers"][lin][0]), f32(tq["layers"][lin][0])):
            if lin in ("up", "gate"):  # ffn1 outputs permuted by down's ids
                f_ids = np.asarray(jpipe.sparse_to_dense_ids(
                    jstates[(0, "down")].out_ids, cfg.intermediate_size))
                fake = fake[:, np.argsort(f_ids)]
            d = (w - fake).astype(np.float64)
            errs.append(float(np.trace(d.T @ hp @ d)))
        np.testing.assert_allclose(errs[1], errs[0], rtol=1e-2)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", list(PRESETS))
def test_pack_model_is_bit_exact_with_jax(runs, name, fuse):
    """JAX's fake tree and states packed by both packages."""
    r = runs[name]
    jq, jstates = r["jax"]
    jpacked = jpipe.pack_model(jq, jstates, r["cfg"], r["jmeta"], dtype=jnp.float32,
                               fuse_stages=fuse)
    tpacked = tpipe.pack_model(to_torch(jq), _states_to_torch(jstates), r["tcfg"], r["tmeta"],
                               dtype=torch.float32, fuse_stages=fuse)
    want = _flatten(jpacked)
    got = tckpt.to_flat(tpacked)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_pack_model_without_the_reorder_is_bit_exact_with_jax(runs):
    """Per-linear layouts and ``reorder_ids`` (no global reorder)."""
    r = runs["tiny"]
    jq, jstates = jpipe.quantize_model(r["dense"], r["calib"], r["cfg"], r["jmeta"],
                                       _jargs(reorder=False, no_frob_norm=True))
    jpacked = jpipe.pack_model(jq, jstates, r["cfg"], r["jmeta"], dtype=jnp.float32)
    tpacked = tpipe.pack_model(to_torch(jq), _states_to_torch(jstates), r["tcfg"], r["tmeta"],
                               dtype=torch.float32)
    want, got = _flatten(jpacked), tckpt.to_flat(tpacked)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    with pytest.raises(ValueError, match="reordered"):
        tpipe.pack_model(to_torch(jq), _states_to_torch(jstates), r["tcfg"], r["tmeta"],
                         fuse_stages=True)


def test_reorder_model_matches_jax(runs):
    """A dense tree and JAX's quantizer states permuted by both packages
    around a random global weak set: the trees, ``o_reorder`` and the
    states' rows identical."""
    r = runs["tiny"]
    cfg = r["cfg"]
    jstates = dict(r["jax"][1])
    rng = np.random.default_rng(4)
    global_out = np.sort(rng.choice(cfg.hidden_size, 8, replace=False)).astype(np.int32)
    tstates = _states_to_torch(jstates)
    want = jpipe.reorder_model(r["dense"], jstates, jnp.asarray(global_out), cfg, r["jmeta"])
    got = tpipe.reorder_model(to_torch(r["dense"]), tstates, torch.from_numpy(global_out),
                              r["tcfg"], r["tmeta"])
    jflat, tflat = _flatten(want), tckpt.to_flat(got)
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        np.testing.assert_array_equal(tflat[key], np.asarray(jflat[key]), err_msg=key)
    for key, st in jstates.items():
        np.testing.assert_array_equal(tstates[key].scale_group.numpy(),
                                      np.asarray(st.scale_group), err_msg=str(key))


@pytest.mark.parametrize("name", list(PRESETS))
def test_fake_checkpoints_cross_load_both_ways(runs, name, tmp_path):
    r = runs[name]
    jq, jstates = r["jax"]
    tq, tstates = r["port"]
    jpath, tpath = str(tmp_path / "jax_fake"), str(tmp_path / "port_fake")
    jckpt.save_fake(jpath, jq, jstates, r["cfg"], family=r["family"])
    tckpt.save_fake(tpath, tq, tstates, r["tcfg"], family=r["family"])
    with np.load(jpath + ".npz") as zj, np.load(tpath + ".npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
    # JAX's file through the port
    params, states, cfg, family = tckpt.load_fake(jpath, device="cpu")
    assert family == r["family"] and cfg.hidden_size == r["cfg"].hidden_size
    want = _flatten(jq)
    got = tckpt.to_flat(params)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key, st in jstates.items():
        for field in ("scale_group", "zero_group", "out_ids"):
            np.testing.assert_array_equal(getattr(states[key], field).numpy(),
                                          np.asarray(getattr(st, field)))
        assert (states[key].sym, states[key].bits, states[key].group_size) == (
            st.sym, st.bits, st.group_size)
    # the port's file through JAX
    jparams, jst2, jcfg, jfam = jckpt.load_fake(tpath)
    assert jfam == r["family"] and jcfg == dataclasses.replace(r["cfg"], dtype=jnp.float32)
    flat = tckpt.to_flat(tq)
    for key, v in _flatten(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), flat[key], err_msg=key)
    for key, st in tstates.items():
        np.testing.assert_array_equal(np.asarray(jst2[key].scale_group), st.scale_group.numpy())
        np.testing.assert_array_equal(np.asarray(jst2[key].out_ids), st.out_ids.numpy())
    loaded, cfg3, fam3 = tckpt.load_model(tpath, device="cpu")
    assert fam3 == r["family"] and "q" in loaded["layers"]


@pytest.mark.parametrize("name", list(PRESETS))
def test_packed_logits_match_the_fake_model(runs, name):
    """The reference's oracle on the port alone: its packed model against
    its fake-quantized model, f32 throughout."""
    r = runs[name]
    tq, tstates = r["port"]
    cfg, meta = r["tcfg"], r["tmeta"]
    packed = tpipe.fuse_packed_stages(
        tpipe.pack_model(tq, tstates, cfg, meta, dtype=torch.float32), meta)
    fake = tpipe.fuse_dense_stages(tq, meta)
    tokens = torch.as_tensor(r["calib"][:2])
    with torch.no_grad():
        want = tl.llama_forward(fake, tokens, cfg).numpy()
        got = tl.llama_forward(packed, tokens, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_calibration_capture_matches_jax(runs):
    r = runs["tiny-gemma"]
    cfg, tcfg = r["cfg"], r["tcfg"]
    blk = jax.tree.map(lambda a: a[1], r["dense"]["layers"])
    x = np.random.default_rng(5).normal(size=(1, SEQLEN, cfg.hidden_size)).astype(np.float32)
    cos, sin = jl.rope_tables(cfg, jnp.arange(SEQLEN)[None])
    out, _, cap = jl.llama_block(blk, jnp.asarray(x), cfg, cos, sin, jl._causal_mask(SEQLEN),
                                 capture=True)
    tblk = {k: v[1] for k, v in tpipe._member_layers(r["tdense"], tcfg, r["tmeta"]).items()}
    layers = tpipe._block_layers(tblk, r["tmeta"])
    tcos, tsin = tl.rope_tables(tcfg, torch.arange(SEQLEN)[None])
    tcap = {}
    tout = tl.llama_block(layers, 0, torch.from_numpy(x), tcfg, tcos, tsin, capture=tcap)
    for key, ref in [("out", out), *cap.items()]:
        ref = np.asarray(ref)
        got = f32(tout if key == "out" else tcap[key])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=key)


def test_quantizing_another_family_raises_naming_a6b():
    """The other families quantize now (their parity with JAX is
    tests/test_torch_family_quant.py).  A llama tree packed without the
    global reorder is served unfused (tests/test_torch_unfused.py); fusing
    its q/k/v, which carry their own ``reorder_ids``, raises a ValueError
    that says why, as JAX's stage fusion asserts.  (The name is kept from
    when this named A6b.)"""
    from qeft_tpu_torch.models.opt import OPT_PRESETS, init_params
    from tests.torch_parity import random_packed_linear

    cfg = OPT_PRESETS["opt-tiny"]
    params = init_params(cfg, dtype=torch.float32, device="cpu")
    meta = get_model_meta("opt")
    calib = np.zeros((1, 8), np.int64)
    outidx, _ = tpipe.extract_global_outidx(params, calib, cfg, meta, _targs(nsamples=1))
    fake, states = tpipe.quantize_model(params, calib, cfg, meta, _targs(nsamples=1), outidx)
    assert outidx.shape == (8,) and "o_reorder" in fake["layers"] and len(states) == 12
    lins = {}
    for i, name in enumerate(("q", "k", "v")):
        lins[name] = random_packed_linear(i, 2, 64, 64, 32, 8)
        lins[name].reorder_ids = torch.stack([torch.randperm(64)] * 2).to(torch.int32)
    with pytest.raises(ValueError, match="statically reordered.*reorder_ids"):
        tpipe.fuse_packed_stages({"layers": lins}, get_model_meta("llama"))


def test_rtn_pack_linear_is_bit_exact_with_jax():
    w = np.random.default_rng(6).normal(size=(256, 96)).astype(np.float32) * 0.05
    for g, dtype in ((128, (jnp.bfloat16, torch.bfloat16)), (64, (jnp.float32, torch.float32))):
        want = _flatten({"h": jpipe.rtn_pack_linear(jnp.asarray(w), group_size=g,
                                                    dtype=dtype[0])})
        got = tckpt.to_flat({"h": tpipe.rtn_pack_linear(torch.from_numpy(w), group_size=g,
                                                        dtype=dtype[1])})
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def _cli(module, argv):
    import importlib

    return importlib.import_module(f"qeft_tpu_torch.{module}").main(argv)


def test_clis_quantize_convert_and_serve_on_the_cpu(tmp_path):
    """extract_outidx -> main (quantize, --fake --packing --save, the
    fake-vs-packed oracle) -> convert -> main --load, all with ``--device
    cpu`` on ``tiny``: the converted checkpoint equals the one main packed,
    JAX reads both, and the packed PPL stays within 1 % of the fake one's."""
    common = ["--model", "tiny", "--device", "cpu", "--wbits", "4", "--target_rank", "8",
              "--groupsize", "64", "--no_frob_norm", "--nsamples", "2", "--seqlen", "32"]
    res = _cli("extract_outidx", common + ["--output_dir", str(tmp_path / "oidx")])
    outidx = os.path.join(res["dir"], "outidx.npy")
    assert os.path.exists(os.path.join(res["dir"], "layer1.gate.npy"))
    save = str(tmp_path / "ckpt" / "tiny")
    res = _cli("main", common + ["--reorder", "--outidx_file", outidx, "--fake", "--packing",
                                 "--save", save, "--eval", "--eval_windows", "2"])
    assert res["quantize_time_s"] > 0
    assert res["fake_vs_packed_delta"] < 1e-2, res
    _cli("convert", [save + "_fake", str(tmp_path / "conv"), "--device", "cpu"])
    with np.load(save + "_packed.npz") as a, np.load(str(tmp_path / "conv.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    jckpt.load_packed(str(tmp_path / "conv"))
    jckpt.load_fake(save + "_fake")
    res2 = _cli("main", ["--load", str(tmp_path / "conv"), "--device", "cpu", "--eval",
                         "--eval_windows", "2", "--seqlen", "32"])
    np.testing.assert_allclose(res2["ppl_synthetic"], res["ppl_synthetic_packed"], rtol=1e-4)
