"""The port's quantizer, weak-column selection, OGR index math, packing
writers and calibration data against ``qeft_tpu``'s on the same
numpy-seeded inputs, f32 on the CPU.

Tolerances: quantizer parameters within 1e-6 relative (zero points
identical); fake-quantized values and codes identical; the Frobenius
errors within 1e-5 relative; permutations, weak sets, packed words,
scales and token arrays identical (bit-exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.data import loaders as jload
from qeft_tpu.ops import packing as jpack
from qeft_tpu.quant import outliers as jo
from qeft_tpu.quant import quantizer as jq
from qeft_tpu.quant import reorder as jr
from qeft_tpu_torch.data import loaders as tload
from qeft_tpu_torch.ops import packing as tpack
from qeft_tpu_torch.quant import outliers as to
from qeft_tpu_torch.quant import quantizer as tq
from qeft_tpu_torch.quant import reorder as tr

torch.set_num_threads(1)


def _w(seed, shape=(48, 128), shift=0.0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) + np.float32(shift)
    w[0] = 0.0  # a degenerate row
    return w


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("num", [1, 40, 100])
@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("sym", [False, True])
def test_find_params_matches_jax(sym, mse, num, bits):
    for seed, shift in ((0, 0.0), (1, 0.7)):
        w = _w(seed, shift=shift)
        pj = jq.find_params(jnp.asarray(w), jq.QuantSpec(bits=bits, sym=sym, mse=mse), num)
        pt = tq.find_params(torch.from_numpy(w), tq.QuantSpec(bits=bits, sym=sym, mse=mse), num)
        np.testing.assert_allclose(pt.scale.numpy(), np.asarray(pj.scale), rtol=1e-6)
        np.testing.assert_array_equal(pt.zero.numpy(), np.asarray(pj.zero))


def test_mse_grid_chunks_agree_with_one_pass(monkeypatch):
    """A grid split into chunks (a whole-row search of a wide linear)
    chooses what one pass chooses."""
    w = torch.from_numpy(_w(2, shape=(32, 256)))
    spec = tq.QuantSpec(bits=4, sym=False, mse=True)
    one = tq.find_params(w, spec, 40)
    monkeypatch.setattr(tq, "GRID_ELEMENTS", 3 * w.numel())
    chunked = tq.find_params(w, spec, 40)
    np.testing.assert_array_equal(chunked.scale.numpy(), one.scale.numpy())
    np.testing.assert_array_equal(chunked.zero.numpy(), one.zero.numpy())


@pytest.mark.parametrize("sym", [False, True])
def test_quantize_and_codes_match_jax(sym):
    w = _w(3)
    js, ts = jq.QuantSpec(sym=sym, mse=True), tq.QuantSpec(sym=sym, mse=True)
    p = jq.find_params(jnp.asarray(w), js, 40)
    s, z = np.array(p.scale)[:, None], np.array(p.zero)[:, None]
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(z), ts).numpy(),
        np.asarray(jq.quantize(jnp.asarray(w), jnp.asarray(s), jnp.asarray(z), js)))
    np.testing.assert_array_equal(
        tq.quantize_int(torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(z),
                        ts).numpy(),
        np.asarray(jq.quantize_int(jnp.asarray(w), jnp.asarray(s), jnp.asarray(z), js)))
    np.testing.assert_allclose(tq.fake_quantize(torch.from_numpy(w), ts, 40).numpy(),
                               np.asarray(jq.fake_quantize(jnp.asarray(w), js, 40)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mse", [False, True])
def test_frob_norm_error_matches_jax(mse):
    w = _w(4, shape=(64, 96))
    spec_j, spec_t = jq.QuantSpec(mse=mse), tq.QuantSpec(mse=mse)
    np.testing.assert_allclose(to.frob_norm_error(torch.from_numpy(w), spec_t, 30).numpy(),
                               np.asarray(jo.frob_norm_error(jnp.asarray(w), spec_j, 30)),
                               rtol=1e-5)


def _diag(seed, ic=96):
    d = np.random.default_rng(seed).random(ic).astype(np.float32)
    d[5] = d[17] = d[40]  # ties resolve to the lower index in both
    return d


@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("mode", ["top", "fixed", "frob", "none"])
def test_hessian_sort_ids_match_jax(mode, actorder):
    d = _diag(5)
    frob = np.random.default_rng(6).random(d.shape[0]).astype(np.float32)
    fixed = np.sort(np.random.default_rng(7).choice(d.shape[0], 8, replace=False)).astype(np.int32)
    n_out = 0 if mode == "none" else 8
    kw_j = dict(frob_norm=jnp.asarray(frob) if mode == "frob" else None,
                outidx=jnp.asarray(fixed) if mode == "fixed" else None, actorder=actorder)
    kw_t = dict(frob_norm=torch.from_numpy(frob) if mode == "frob" else None,
                outidx=torch.from_numpy(fixed) if mode == "fixed" else None, actorder=actorder)
    ids_j, out_j = jo.hessian_sort_ids(jnp.asarray(d), n_out, **kw_j)
    ids_t, out_t = to.hessian_sort_ids(torch.from_numpy(d), n_out, **kw_t)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert out_t.dtype == torch.int32


def test_global_selection_and_reorder_ids_match_jax():
    s = _diag(8, ic=256)
    np.testing.assert_array_equal(to.select_global_outliers(torch.from_numpy(s), 16).numpy(),
                                  np.asarray(jo.select_global_outliers(jnp.asarray(s), 16)))
    np.testing.assert_allclose(to.normalized_sensitivity(torch.from_numpy(s)).numpy(),
                               np.asarray(jo.normalized_sensitivity(jnp.asarray(s))), rtol=1e-6)
    sparse = np.array([200, 3, 77, 9], np.int32)  # the given order is kept
    ids = tr.sparse_to_dense_ids(torch.from_numpy(sparse), 256)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jr.sparse_to_dense_ids(jnp.asarray(sparse), 256)))
    np.testing.assert_array_equal(tr.inverse_permutation(ids).numpy(),
                                  np.asarray(jr.inverse_permutation(jnp.asarray(ids.numpy()))))


@pytest.mark.parametrize("g", [64, 128, -1])
def test_pack_codes_match_jax(g):
    codes = np.random.default_rng(9).integers(0, 16, size=(256, 40)).astype(np.int32)
    want = np.asarray(jpack.pack_codes(jnp.asarray(codes), g))
    np.testing.assert_array_equal(tpack.pack_codes(torch.from_numpy(codes), g).numpy(), want)
    np.testing.assert_array_equal(tpack.pack_codes_np(codes, g), jpack.pack_codes_np(codes, g))
    np.testing.assert_array_equal(
        tpack.unpack_codes(tpack.pack_codes(torch.from_numpy(codes), g), g).numpy(), codes)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sym,n_outlier,g", [(False, 0, 64), (False, 16, 64), (True, 16, 128),
                                             (False, 8, -1)])
def test_pack_layer_is_bit_exact_with_jax(sym, n_outlier, g, dtype):
    rng = np.random.default_rng(10)
    k, n = 256, 48
    gg = g if g > 0 else k
    spec = jq.QuantSpec(bits=4, sym=sym, mse=False, group_size=g)
    w = rng.normal(size=(n, k)).astype(np.float32)
    rows = w.reshape(n, k // gg, gg).reshape(-1, gg)
    p = jq.find_params(jnp.asarray(rows), spec)
    scale = np.asarray(p.scale).reshape(n, k // gg)
    zero = np.asarray(p.zero).reshape(n, k // gg)
    s_kn = np.repeat(scale.T, gg, axis=0)
    z_kn = np.repeat(zero.T, gg, axis=0)
    q = np.clip(np.round(w.T / s_kn) + z_kn, spec.minq, spec.maxq)
    fake = (s_kn * (q - z_kn)).astype(np.float32)
    fake[k - n_outlier:] = w.T[k - n_outlier:]  # the weak rows stay full precision
    bias = rng.normal(size=n).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jpack.pack_layer(jnp.asarray(fake), jnp.asarray(scale), jnp.asarray(zero), n_outlier,
                            gg, sym=sym, bias=jnp.asarray(bias), dtype=jdt)
    got = tpack.pack_layer(torch.from_numpy(fake), torch.from_numpy(scale),
                           torch.from_numpy(zero), n_outlier, gg, sym=sym,
                           bias=torch.from_numpy(bias), dtype=tdt)
    for field in ("qweight", "scales", "scaled_zeros", "oweight", "bias"):
        a, b = getattr(want, field), getattr(got, field)
        assert (a is None) == (b is None), field
        if a is not None:
            a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
            np.testing.assert_array_equal(b.to(torch.float32).numpy() if b.is_floating_point()
                                          else b.numpy(), a, err_msg=field)
    assert got.group_size == want.group_size


@pytest.mark.parametrize("source", ["synthetic", "npy"])
def test_calibration_tokens_match_jax(source, tmp_path):
    name = "synthetic"
    if source == "npy":
        name = str(tmp_path / "tokens.npy")
        np.save(name, np.random.default_rng(11).integers(0, 500, size=5000))
    for kw in (dict(nsamples=4, seed=0, seqlen=32), dict(nsamples=3, seed=5, seqlen=100)):
        np.testing.assert_array_equal(
            tload.get_calibration_tokens(name, vocab_size=500, **kw),
            jload.get_calibration_tokens(name, vocab_size=500, **kw))
        np.testing.assert_array_equal(tload.get_loaders(name, vocab_size=500, **kw),
                                      jload.get_loaders(name, vocab_size=500, **kw))
    np.testing.assert_array_equal(tload.get_loaders(name, train=False, vocab_size=500),
                                  jload.get_loaders(name, train=False, vocab_size=500))


def test_document_crops_match_jax():
    rng = np.random.default_rng(12)
    docs = [rng.integers(0, 100, size=int(n)) for n in rng.integers(5, 80, size=40)]
    for seqlen in (8, 40):
        np.testing.assert_array_equal(
            tload._sample_doc_crops(lambda i: docs[i], len(docs), 6, seqlen, 3),
            jload._sample_doc_crops(lambda i: docs[i], len(docs), 6, seqlen, 3))


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4"])
def test_hugging_face_sources_raise_naming_a7b(name):
    with pytest.raises(NotImplementedError, match="A7b"):
        tload.get_calibration_tokens(name, 2, 0, 16)
    with pytest.raises(NotImplementedError, match="A7b"):
        tload.get_loaders(name, train=False)
