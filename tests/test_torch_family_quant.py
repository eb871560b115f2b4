"""QEFT's quantizer on OPT, Phi, Bloom and Falcon: the port's pipeline
(``qeft_tpu_torch.pipeline``, the ``checkpoint`` formats, the CLIs) against
``qeft_tpu``'s on the same dense weights, carried across as numpy arrays,
in f32 on the CPU, over ``opt-tiny``, ``phi-tiny``, ``bloom-tiny``,
``falcon-tiny`` and ``falcon-tiny-40b`` (``dual_ln``, GQA).  Each model is
extracted and quantized once per module by each package (w4, g = 32,
min-max grid, r = 8, 2 x 16 calibration tokens, with the global reorder).

Tolerances:
- the global weak set and every per-layer weak set of block 0: identical;
- block 0's codes: at most 0.5 % differ, each by at most one level (the
  Hessians differ in summation order, and a flipped rounding propagates
  along its row; tests/test_torch_pipeline.py);
- `reorder_model` of an unquantized model: bit-exact with JAX's, and an
  isomorphism: logits within 1e-5 of their scale;
- `pack_model` of the same fake tree and both checkpoint formats:
  bit-exact, and each package reads the other's files;
- the port's packed model against its fake model: logits within
  ``rtol = atol = 2e-2`` (tests/test_families.py's bound).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu import checkpoint as jckpt
from qeft_tpu import pipeline as jpipe
from qeft_tpu.checkpoint import _flatten
from qeft_tpu.models.api import get_model_api as jax_api
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.quant.quantizer import QuantSpec as JSpec
from qeft_tpu_torch import checkpoint as tckpt
from qeft_tpu_torch import pipeline as tpipe
from qeft_tpu_torch.checkpoint import from_flat
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.quant.quantizer import QuantSpec as TSpec
from tests.torch_parity import f32, family_presets, states_to_port

PRESETS = {"opt-tiny": "opt", "phi-tiny": "phi", "bloom-tiny": "bloom",
           "falcon-tiny": "falcon", "falcon-tiny-40b": "falcon"}
NSAMPLES, SEQLEN, G = 2, 16, 32
SPEC = dict(bits=4, sym=False, mse=False, group_size=G)
ARGS = dict(target_rank=8, nsamples=NSAMPLES, no_frob_norm=True)


def _configs(name):
    family = PRESETS.get(name, "opt")
    jmod, jpresets, tpresets = family_presets(family)
    return jmod, jpresets[name], dataclasses.replace(tpresets[name], dtype=torch.float32), family


def _calib(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, size=(NSAMPLES, SEQLEN))


def _jargs(**kw):
    return jpipe.QuantizeArgs(spec=JSpec(**SPEC), **{**ARGS, **kw})


def _targs(**kw):
    return tpipe.QuantizeArgs(spec=TSpec(**SPEC), **{**ARGS, **kw})


@pytest.fixture(scope="module")
def runs():
    """preset -> both packages' extraction and quantization of one model."""
    out = {}
    for name in PRESETS:
        jmod, cfg, tcfg, family = _configs(name)
        jmeta, tmeta = jax_meta(family), get_model_meta(family)
        dense = jmod.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
        tdense = from_flat(_flatten(dense))
        calib = _calib(cfg)
        j_out, j_per = jpipe.extract_global_outidx(dense, calib, cfg, jmeta, _jargs())
        t_out, t_per = tpipe.extract_global_outidx(tdense, calib, tcfg, tmeta, _targs())
        jq, jstates = jpipe.quantize_model(dense, calib, cfg, jmeta, _jargs(reorder=True), j_out)
        tq, tstates = tpipe.quantize_model(tdense, calib, tcfg, tmeta, _targs(reorder=True),
                                           t_out)
        out[name] = dict(cfg=cfg, tcfg=tcfg, jmeta=jmeta, tmeta=tmeta, dense=dense,
                         tdense=tdense, calib=calib, family=family, jmod=jmod,
                         extract=((j_out, j_per), (t_out, t_per)), jax=(jq, jstates),
                         port=(tq, tstates))
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_global_outidx_is_identical(runs, name):
    (j_out, j_per), (t_out, t_per) = runs[name]["extract"]
    np.testing.assert_array_equal(t_out, j_out)
    assert t_out.dtype == np.int32 and sorted(t_per) == sorted(j_per)
    for key in j_per:
        np.testing.assert_array_equal(t_per[key], np.asarray(j_per[key]), err_msg=str(key))


def _levels(w_kn, st):
    scale = np.repeat(np.asarray(st.scale_group, np.float64).T, G, axis=0)
    return np.round(np.asarray(w_kn, np.float64) / scale)


@pytest.mark.parametrize("name", list(PRESETS))
def test_block0_codes_match_jax(runs, name):
    """Block 0 calibrates on the same input in both packages; from block 1
    on each calibrates on its own quantized block 0 (compared by what the
    models compute in `test_packed_logits_match_the_fake_model`)."""
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
        np.testing.assert_array_equal(tst.out_ids.numpy(), np.asarray(jst.out_ids), err_msg=lin)
        n_out = int(jst.out_ids.shape[0])
        jw, tw = np.asarray(jq["layers"][lin][0]), f32(tq["layers"][lin][0])
        k = jw.shape[0]
        d = np.abs(_levels(jw, jst)[: k - n_out] - _levels(tw, tst)[: k - n_out])
        # a flipped rounding moves the later groups' re-fit (their min and
        # max): only where a group's parameters agree is a level comparable
        js, ts = np.asarray(jst.scale_group), tst.scale_group.numpy()
        same = np.repeat((np.abs(js - ts) <= 1e-6 * np.abs(js)).T, G, axis=0)[: k - n_out]
        assert d[same].max() <= 1, (lin, d[same].max())
        differ += int((d > 0).sum())
        total += d.size
    assert differ <= 0.005 * total, (differ, total)
    np.testing.assert_array_equal(tq["layers"]["o_reorder"][0].numpy(),
                                  np.asarray(jq["layers"]["o_reorder"][0]))
    # what the reorder permutes outside the linears (block 0's), bit for bit
    tflat = tckpt.to_flat(tq)
    for key, want in _flatten(jq).items():
        if key.split("::")[-1] in r["tmeta"].all_linears:
            continue
        got, want = tflat[key], np.asarray(want)
        if key.startswith("layers::"):
            got, want = got[:1], want[:1]
        np.testing.assert_array_equal(got, want, err_msg=key)


def _dummy_states(dense, cfg, meta, rng):
    states = {}
    for i in range(cfg.num_layers):
        for lin in meta.all_linears:
            k, n = dense["layers"][lin].shape[1:]
            states[(i, lin)] = jpipe.QuantizerState(
                scale_group=jnp.asarray(rng.random((n, k // G)).astype(np.float32)),
                zero_group=jnp.zeros((n, k // G)),
                out_ids=jnp.asarray(np.sort(rng.choice(k, size=4, replace=False))),
                sym=False, bits=4, group_size=G)
    return states


@pytest.mark.parametrize("name", list(PRESETS))
def test_reorder_model_is_an_exact_isomorphism(runs, name):
    """An unquantized model (with random biases and norms, so that every
    permuted leaf matters) permuted by both packages around a random global
    weak set: the trees and the states bit-exact, and the port's reordered
    model computes the logits of the original."""
    r = runs[name]
    cfg, meta, tmeta = r["cfg"], r["jmeta"], r["tmeta"]
    rng = np.random.default_rng(2)

    def noisy(a):
        return jnp.asarray(np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1)

    dense = {k: v if k in ("embed", "lm_head", "layers") else noisy(v)
             for k, v in r["dense"].items()}
    dense["layers"] = {k: v if k in meta.all_linears else noisy(v)
                       for k, v in r["dense"]["layers"].items()}
    states = _dummy_states(dense, cfg, meta, rng)
    global_out = np.sort(rng.choice(cfg.hidden_size, 8, replace=False)).astype(np.int32)
    tstates = states_to_port(states)
    want = jpipe.reorder_model(dense, dict(states), jnp.asarray(global_out), cfg, meta)
    got = tpipe.reorder_model(from_flat(_flatten(dense)), tstates, torch.from_numpy(global_out),
                              r["tcfg"], tmeta)
    jflat, tflat = _flatten(want), tckpt.to_flat(got)
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        np.testing.assert_array_equal(tflat[key], np.asarray(jflat[key]), err_msg=key)
    jst = dict(states)
    jpipe.reorder_model(dense, jst, jnp.asarray(global_out), cfg, meta)
    for key, st in jst.items():
        np.testing.assert_array_equal(tstates[key].scale_group.numpy(),
                                      np.asarray(st.scale_group), err_msg=str(key))
    api = get_model_api(r["family"])
    tokens = torch.as_tensor(r["calib"])
    with torch.no_grad():
        before = api.forward(from_flat(_flatten(dense)), tokens, r["tcfg"]).numpy()
        after = api.forward(got, tokens, r["tcfg"]).numpy()
    np.testing.assert_allclose(after, before, rtol=0, atol=1e-5 * np.abs(before).max())


@pytest.mark.parametrize("name", list(PRESETS))
def test_pack_model_is_bit_exact_with_jax(runs, name):
    """JAX's fake tree and states packed by both packages."""
    r = runs[name]
    jq, jstates = r["jax"]
    jpacked = jpipe.pack_model(jq, jstates, r["cfg"], r["jmeta"], dtype=jnp.float32)
    tpacked = tpipe.pack_model(from_flat(_flatten(jq)), states_to_port(jstates), r["tcfg"],
                               r["tmeta"], dtype=torch.float32)
    want, got = _flatten(jpacked), tckpt.to_flat(tpacked)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    with pytest.raises(ValueError, match="no fusable stages"):
        tpipe.pack_model(from_flat(_flatten(jq)), states_to_port(jstates), r["tcfg"],
                         r["tmeta"], fuse_stages=True)
    with pytest.raises(ValueError, match="no fusable stages"):
        jpipe.pack_model(jq, jstates, r["cfg"], r["jmeta"], fuse_stages=True)


def _same_files(a, b):
    """Two checkpoints (stems): the same arrays under the same keys, bit for
    bit, and the same manifest."""
    with np.load(a + ".npz") as za, np.load(b + ".npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    with open(a + ".json") as fa, open(b + ".json") as fb:
        assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("name", list(PRESETS))
def test_fake_and_packed_checkpoints_cross_load_both_ways(runs, name, tmp_path):
    """JAX's fake tree written by each package: the same file; each package
    loads the other's.  The same for the packed tree of it."""
    r = runs[name]
    jq, jstates = r["jax"]
    cfg, family = r["cfg"], r["family"]
    tcfg = dataclasses.replace(r["tcfg"], dtype=torch.bfloat16)  # the preset, as JAX's
    tq, tstates = from_flat(_flatten(jq)), states_to_port(jstates)
    p = {k: str(tmp_path / k) for k in ("jf", "tf", "jp", "tp")}
    jckpt.save_fake(p["jf"], jq, jstates, cfg, family=family)
    tckpt.save_fake(p["tf"], tq, tstates, tcfg, family=family)
    _same_files(p["jf"], p["tf"])
    params, states, lcfg, fam = tckpt.load_fake(p["jf"], device="cpu")
    assert fam == family and lcfg == tcfg
    want = _flatten(jq)
    for key, v in tckpt.to_flat(params).items():
        np.testing.assert_array_equal(v, np.asarray(want[key]), err_msg=key)
    for key, st in jstates.items():
        for field in ("scale_group", "zero_group", "out_ids"):
            np.testing.assert_array_equal(getattr(states[key], field).numpy(),
                                          np.asarray(getattr(st, field)))
    jparams, _, jcfg, jfam = jckpt.load_fake(p["tf"])
    assert jfam == family and jcfg == cfg
    for key, v in _flatten(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[key]), err_msg=key)

    jpacked = jpipe.pack_model(jq, jstates, cfg, r["jmeta"], dtype=jnp.float32)
    tpacked = tpipe.pack_model(tq, tstates, tcfg, r["tmeta"], dtype=torch.float32)
    jckpt.save_packed(p["jp"], jpacked, cfg, family=family)
    tckpt.save_packed(p["tp"], tpacked, tcfg, family=family)
    _same_files(p["jp"], p["tp"])
    loaded, lcfg, fam = tckpt.load_model(p["jp"], device="cpu")
    assert fam == family and lcfg == tcfg
    flat = _flatten(jpacked)
    for key, v in tckpt.to_flat(loaded).items():
        np.testing.assert_array_equal(v, np.asarray(flat[key]), err_msg=key)
    jloaded, jcfg, jfam = jckpt.load_model(p["tp"])
    assert jfam == family and jcfg == cfg
    for key, v in _flatten(jloaded).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat[key]), err_msg=key)


@pytest.mark.parametrize("name", list(PRESETS))
def test_packed_logits_match_the_fake_model(runs, name):
    """The reference's oracle on the port alone: its packed model against
    its fake-quantized model, f32; and the port's fake model is as close to
    the dense model as JAX's (mean squared error within 25 %)."""
    r = runs[name]
    tq, tstates = r["port"]
    cfg, meta = r["tcfg"], r["tmeta"]
    packed = tpipe.fuse_packed_stages(
        tpipe.pack_model(tq, tstates, cfg, meta, dtype=torch.float32), meta)
    api = get_model_api(r["family"])
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, 12))
    with torch.no_grad():
        want = api.forward(tq, torch.as_tensor(tokens), cfg).numpy()
        got = api.forward(packed, torch.as_tensor(tokens), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    jfwd = jax_api(r["family"]).forward
    dense = np.asarray(jfwd(r["dense"], jnp.asarray(tokens), r["cfg"]))
    jfake = np.asarray(jfwd(r["jax"][0], jnp.asarray(tokens), r["cfg"]))
    e_j, e_t = (float(np.mean((f - dense) ** 2)) for f in (jfake, want))
    np.testing.assert_allclose(e_t, e_j, rtol=0.25)


def test_opt_350m_reorder_raises_and_packs_without_it():
    """``project_in`` (opt-350m): the global reorder raises JAX's
    ValueError in both packages; without it every linear packs with its own
    ``reorder_ids``, bit for bit as JAX packs it, and serves."""
    name = "opt-tiny-350m"
    jmod, cfg, tcfg, family = _configs(name)
    jmeta, tmeta = jax_meta(family), get_model_meta(family)
    dense = jmod.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tdense = from_flat(_flatten(dense))
    calib = _calib(cfg)
    outidx = tpipe.extract_global_outidx(tdense, calib, tcfg, tmeta, _targs())[0]
    with pytest.raises(ValueError, match="project_in") as got:
        tpipe.quantize_model(tdense, calib, tcfg, tmeta, _targs(reorder=True), outidx)
    with pytest.raises(ValueError, match="project_in") as want:
        jpipe.quantize_model(dense, calib, cfg, jmeta, _jargs(reorder=True), outidx)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    jq, jstates = jpipe.quantize_model(dense, calib, cfg, jmeta, _jargs(reorder=False))
    tq, tstates = tpipe.quantize_model(tdense, calib, tcfg, tmeta, _targs(reorder=False))
    jpacked = jpipe.pack_model(jq, jstates, cfg, jmeta, dtype=jnp.float32)
    tpacked = tpipe.pack_model(from_flat(_flatten(jq)), states_to_port(jstates), tcfg, tmeta,
                               dtype=torch.float32)
    want_flat, got_flat = _flatten(jpacked), tckpt.to_flat(tpacked)
    assert sorted(got_flat) == sorted(want_flat) and "layers::q::reorder_ids" in got_flat
    for key in want_flat:
        np.testing.assert_array_equal(got_flat[key], np.asarray(want_flat[key]), err_msg=key)
    own = tpipe.pack_model(tq, tstates, tcfg, tmeta, dtype=torch.float32)
    tokens = torch.as_tensor(calib[:1, :12])
    api = get_model_api(family)
    with torch.no_grad():
        np.testing.assert_allclose(api.forward(own, tokens, tcfg).numpy(),
                                   api.forward(tq, tokens, tcfg).numpy(), rtol=2e-2, atol=2e-2)


def _cli(module, argv):
    import importlib

    return importlib.import_module(f"qeft_tpu_torch.{module}").main(argv)


@pytest.mark.parametrize("name", ["opt-tiny", "phi-tiny", "bloom-tiny", "falcon-tiny"])
def test_clis_quantize_every_family_on_the_cpu(name, tmp_path, monkeypatch):
    """extract_outidx -> main (quantize with the reorder, --fake --packing
    --save, the fake-vs-packed oracle) -> convert -> main --load, with
    ``--device cpu`` on each family's tiny preset: the converted checkpoint
    equals the one main packed, JAX reads both, the packed PPL stays within
    1 % of the fake one's; Falcon is quantized at percdamp 1.0."""
    common = ["--model", name, "--device", "cpu", "--wbits", "4", "--target_rank", "8",
              "--groupsize", "32", "--no_frob_norm", "--nsamples", "2", "--seqlen", "16"]
    res = _cli("extract_outidx", common + ["--output_dir", str(tmp_path / "oidx")])
    outidx = os.path.join(res["dir"], "outidx.npy")
    save = str(tmp_path / "ckpt" / "m")
    res = _cli("main", common + ["--reorder", "--outidx_file", outidx, "--fake", "--packing",
                                 "--save", save, "--eval", "--eval_windows", "2"])
    assert res["fake_vs_packed_delta"] < 1e-2, res
    _cli("convert", [save + "_fake", str(tmp_path / "conv"), "--device", "cpu"])
    _same_files(save + "_packed", str(tmp_path / "conv"))
    _, _, jcfg, family = jckpt.load_fake(save + "_fake")
    assert family == PRESETS[name] and jckpt.load_packed(str(tmp_path / "conv"))[2] == family
    res2 = _cli("main", ["--load", str(tmp_path / "conv"), "--device", "cpu", "--eval",
                         "--eval_windows", "2", "--seqlen", "16"])
    np.testing.assert_allclose(res2["ppl_synthetic"], res["ppl_synthetic_packed"], rtol=1e-4)
    # the percdamp main hands the quantizer: 1.0 for Falcon, as the reference
    seen = []

    class Seen(Exception):
        pass

    def record(params, calib, cfg, meta, qargs, outidx, **placement):
        seen.append(qargs.percdamp)
        raise Seen

    monkeypatch.setattr("qeft_tpu_torch.main.quantize_model", record)
    with pytest.raises(Seen):
        _cli("main", common + ["--percdamp", "0.01"])
    assert seen == [1.0 if family == "falcon" else 0.01]
