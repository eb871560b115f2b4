"""The port's GPTQ-OWQ (``qeft_tpu_torch.quant.gptq``) against
``qeft_tpu.quant.gptq`` on the same numpy-seeded weights and calibration
activations, f32 on the CPU.  Each package builds its own Hessian from the
same activations.

Tolerances:
- Hessians within 1e-6 of their scale (summation order);
- the damped factor U of both packages within 1e-4 of each other, and
  U^T U H within 1e-4 of the identity;
- GPTQ codes: at most 0.5 % differ, each by at most one level, and the
  reconstruction error tr((W - Q) H (W - Q)^T) within 1 % of JAX's (a
  flipped rounding propagates along its row, so exact equality cannot be
  asked); group parameters within 1e-4 relative where the codes agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.quant import gptq as jg
from qeft_tpu.quant import outliers as jo
from qeft_tpu.quant.quantizer import QuantSpec as JSpec
from qeft_tpu_torch.quant import gptq as tg
from qeft_tpu_torch.quant import outliers as to
from qeft_tpu_torch.quant.quantizer import QuantSpec as TSpec

torch.set_num_threads(1)


def _inputs(seed, ic=256, oc=96, tokens=512, dead=0):
    """Weights [oc, ic] and activations [2, tokens/2, ic] with a spread of
    column scales (some columns far more sensitive), ``dead`` columns zero."""
    rng = np.random.default_rng(seed)
    col = np.exp(rng.normal(size=ic)).astype(np.float32)
    x = (rng.normal(size=(2, tokens // 2, ic)) * col).astype(np.float32)
    if dead:
        x[..., rng.choice(ic, dead, replace=False)] = 0.0
    w = (rng.normal(size=(oc, ic)) * ic ** -0.5).astype(np.float32)
    return w, x


def _hessians(x):
    return (np.asarray(jg.hessian_from_inputs(jnp.asarray(x))),
            tg.hessian_from_inputs(torch.from_numpy(x)).numpy())


def test_hessians_match_jax():
    _, x = _inputs(0)
    hj, ht = _hessians(x)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-6 * np.abs(hj).max())
    hj2, n = jg.hessian_accumulate(jnp.asarray(hj), jnp.asarray(x[0]), 2, 1)
    ht2, n2 = tg.hessian_accumulate(torch.from_numpy(ht), torch.from_numpy(x[0]), 2, 1)
    assert n == n2 == 3
    np.testing.assert_allclose(ht2.numpy(), np.asarray(hj2), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(hj2)).max())


def test_hessian_precision_high_is_bf16x3(monkeypatch):
    """``QEFT_HESSIAN_PRECISION=high``: hi.hi + hi.lo + lo.hi of the bf16
    split, within bf16x3's error of the f32 Hessian and not the plain bf16
    product."""
    _, x = _inputs(1)
    flat = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    exact = (flat.double().t() @ flat.double()).float()
    monkeypatch.setenv("QEFT_HESSIAN_PRECISION", "high")
    assert tg.hessian_precision() == "high"
    high = tg.gram(flat)
    bf16 = (flat.bfloat16().float().t() @ flat.bfloat16().float())
    scale = exact.abs().max().item()
    assert (high - exact).abs().max().item() < 1e-4 * scale
    assert (bf16 - exact).abs().max().item() > 10 * (high - exact).abs().max().item()
    monkeypatch.setenv("QEFT_HESSIAN_PRECISION", "highest")
    assert tg.hessian_precision() == "highest"


def test_full_f32_restores_the_setting():
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    with tg.full_f32():
        assert matmul.fp32_precision == "ieee"
    assert matmul.fp32_precision == before


@pytest.mark.parametrize("dead", [0, 5])
def test_cholesky_inv_upper_matches_jax(dead):
    _, x = _inputs(2, dead=dead)
    hj, ht = _hessians(x)
    uj = np.asarray(jg._cholesky_inv_upper(jnp.asarray(hj), 0.01))
    ut = tg._cholesky_inv_upper(torch.from_numpy(ht), 0.01).numpy()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-4)
    assert np.allclose(np.triu(ut), ut)
    h = ht.astype(np.float64).copy()
    d = np.diag(h).copy()
    d[d == 0] = 1.0
    np.fill_diagonal(h, d + 0.01 * d.mean())
    eye = ut.astype(np.float64).T @ ut.astype(np.float64) @ h
    np.testing.assert_allclose(eye, np.eye(h.shape[0]), rtol=0, atol=1e-4)


def _levels(w_fake, scale_group, g):
    """The signed quantization level of every weight, [OC, IC] (permuted
    order): round(w / scale) = code - zero."""
    s = np.repeat(np.asarray(scale_group, np.float64), g, axis=1)
    return np.round(np.asarray(w_fake, np.float64) / s)


CASES = {  # name: (spec kwargs, n_out, gptq kwargs, dead columns)
    "w4-g64-mse": (dict(bits=4, sym=False, mse=True, group_size=64), 16, {}, 0),
    "w4-g64-minmax-dead": (dict(bits=4, sym=False, mse=False, group_size=64), 16, {}, 5),
    "w3-g128-sym-mse": (dict(bits=3, sym=True, mse=True, group_size=128), 8, {}, 0),
    "w4-row-minmax": (dict(bits=4, sym=False, mse=False, group_size=-1), 16, dict(num=100), 0),
    "w4-g64-rtn": (dict(bits=4, sym=False, mse=True, group_size=64), 16, dict(rtn=True, num=1),
                   0),
    "w4-g64-actorder": (dict(bits=4, sym=False, mse=False, group_size=64), 16,
                        dict(actorder=True), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gptq_matches_jax(case):
    spec_kw, n_out, kw, dead = CASES[case]
    kw = dict(kw)
    actorder = kw.pop("actorder", False)
    w, x = _inputs(3, dead=dead)
    hj, ht = _hessians(x)
    ids_j, out_j = jo.hessian_sort_ids(jnp.diagonal(jnp.asarray(hj)), n_out, actorder=actorder)
    ids_t, out_t = to.hessian_sort_ids(torch.diagonal(torch.from_numpy(ht)), n_out,
                                       actorder=actorder)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    rj = jg.gptq_quantize(jnp.asarray(w), jnp.asarray(hj), JSpec(**spec_kw), ids_j, out_j, **kw)
    rt = tg.gptq_quantize(torch.from_numpy(w), torch.from_numpy(ht), TSpec(**spec_kw), ids_t,
                          out_t, **kw)
    ids = np.asarray(ids_j)
    ic = w.shape[1]
    g = spec_kw["group_size"] if spec_kw["group_size"] > 0 else ic
    n_dense = ic - n_out
    lj = _levels(np.asarray(rj.w_fake)[:, ids], rj.scale_group, g)[:, :n_dense]
    lt = _levels(rt.w_fake.numpy()[:, ids], rt.scale_group.numpy(), g)[:, :n_dense]
    diff = np.abs(lj - lt)
    assert diff.max() <= 1, case
    assert (diff > 0).mean() <= 0.005, (case, (diff > 0).mean())
    agree = np.all(diff == 0, axis=1)
    np.testing.assert_allclose(rt.scale_group.numpy()[agree], np.asarray(rj.scale_group)[agree],
                               rtol=1e-4)
    np.testing.assert_array_equal(rt.zero_group.numpy()[agree], np.asarray(rj.zero_group)[agree])
    errs = []
    for fake in (np.asarray(rj.w_fake), rt.w_fake.numpy()):
        d = (w - fake).astype(np.float64)
        errs.append(float(np.trace(d @ hj.astype(np.float64) @ d.T)))
    np.testing.assert_allclose(errs[1], errs[0], rtol=1e-2)
    # the weak columns keep their (error-compensated) full-precision values
    out = np.asarray(out_j)
    np.testing.assert_allclose(rt.w_fake.numpy()[:, out], np.asarray(rj.w_fake)[:, out],
                               rtol=1e-4, atol=1e-5)
