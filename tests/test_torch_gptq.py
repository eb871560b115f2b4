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


def _per_column_gptq(w_perm, h_perm, spec, n_nonout, percdamp=0.01, num=40, rtn=False):
    """The column loop as it ran before it became a static block program:
    each block sliced at its offset, the trailing update over the columns
    right of the block only (``w[:, i2:] -= err_blk @ u[i1:i2, i2:]``)."""
    from qeft_tpu_torch.quant.quantizer import find_params, quantize

    oc, ic = w_perm.shape
    g = spec.group_size if spec.group_size > 0 else ic
    n_blocks = -(-n_nonout // g)
    w = w_perm.clone()
    w[:, h_perm.diagonal() == 0] = 0.0
    u = None if rtn else tg._cholesky_inv_upper(h_perm, percdamp)
    scales, zeros = [], []
    for b in range(n_blocks):
        i1, i2 = b * g, (b + 1) * g
        active = min(g, n_nonout - i1)
        w_blk = w[:, i1:i2].clone()
        w_params = w_blk.clone()
        w_params[:, active:] = 0.0
        p = find_params(w_params, spec, num)
        if rtn:
            q_blk = w_blk.clone()
            q_blk[:, :active] = quantize(w_blk[:, :active], p.scale[:, None], p.zero[:, None],
                                         spec)
        else:
            q_blk, err_blk = tg._quantize_block(w_blk, p.scale, p.zero, u[i1:i2, i1:i2],
                                                active, spec)
            w[:, i2:] -= err_blk @ u[i1:i2, i2:]
        w[:, i1:i2] = q_blk
        scales.append(p.scale)
        zeros.append(p.zero)
    return w, torch.stack(scales, dim=1), torch.stack(zeros, dim=1)


@pytest.mark.parametrize("case", [c for c in CASES if "actorder" not in c])
@pytest.mark.parametrize("n_out", [16, 40])
def test_block_program_equals_the_per_column_loop(case, n_out):
    """The block program (`ColumnLoop`: columns gathered at a device
    offset, the trailing update over the whole width with the factor's rows
    zeroed left of the block) against the sliced per-column loop, on the
    CPU: bit for bit, fake weights, scales and zeros, also where the last
    dense block is partial (n_out 40 of g 64 or 128) and where one
    `ColumnLoop` serves two linears of a shape in turn."""
    spec_kw, _, kw, dead = CASES[case]
    spec = TSpec(**spec_kw)
    w, x = _inputs(4, dead=dead)
    h = tg.hessian_from_inputs(torch.from_numpy(x))
    ids, _ = to.hessian_sort_ids(torch.diagonal(h), n_out)
    w_perm = torch.from_numpy(w)[:, ids]
    h_perm = h[ids][:, ids]
    n_nonout = w.shape[1] - n_out
    num, rtn = kw.get("num", 40), kw.get("rtn", False)
    want = _per_column_gptq(w_perm, h_perm, spec, n_nonout, num=num, rtn=rtn)
    loops = tg.ColumnLoops()
    for weight in (w_perm, w_perm.flip(0)):
        got = tg.gptq_quantize_permuted(weight, h_perm, spec, n_nonout, num=num, rtn=rtn,
                                        loops=loops)
        ref = want if weight is w_perm else _per_column_gptq(weight, h_perm, spec, n_nonout,
                                                             num=num, rtn=rtn)
        g = spec.group_size if spec.group_size > 0 else w.shape[1]
        n_blocks = -(-n_nonout // g)
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1][:, :n_blocks], ref[1])
        assert torch.equal(got[2][:, :n_blocks], ref[2])
    assert len(loops) == 1
