"""The port's training linear against the JAX package's custom vjp, on the CPU
in f32.

K7: `qmm.qgemm_t_plain` against ``pallas_qmm.qgemm_t`` run in interpret mode
(automatic off the TPU), at the (k, n, g) cases of
tests/test_qlinear_vjp.py::test_qgemm_t_matches_dense_transpose and at row
counts that are not a multiple of its 128-row tile.

The autograd linear (`qlinear.QLinearFunction`): its output, ``dx`` and
``dow`` (and, with a per-linear ``reorder_ids`` gather and a bias, ``dbias``)
against ``qeft_tpu.ops.qlinear.qlinear_apply`` with QEFT_PALLAS=1
(interpret: K2 forward, K7 backward) and QEFT_PALLAS=0 (the XLA dequant
path), in the shapes of tests/test_qlinear_vjp.py, and against plain
PyTorch autograd through `qmm.qgemm_plain`.

Tolerances are the JAX tests' own: 2e-4 for gradients and 2e-5 for outputs
(abs and rel).  Both sides are f32; the Pallas kernels sum per nibble plane
and per tile, in another order than one dense matmul.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.ops.packing import QLinearParams as JaxQLinear, dequantize_weight, pack_codes
from qeft_tpu.ops.pallas_qmm import qgemm_t as jax_qgemm_t
from qeft_tpu.ops.qlinear import qlinear_apply as jax_qlinear_apply
from qeft_tpu_torch.ops import qmm
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.qlinear import qlinear_apply

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)


def _linear(rng, k=64, n=128, g=16, r=8):
    codes = rng.integers(0, 16, size=(k, n)).astype(np.int32)
    scales = (rng.random((k // g, n)) * 0.02 + 0.01).astype(np.float32)
    zeros = rng.integers(0, 16, size=(k // g, n)).astype(np.float32)
    fields = dict(
        qweight=np.array(pack_codes(jnp.asarray(codes), g)),
        scales=scales,
        scaled_zeros=(-zeros * scales).astype(np.float32),
        oweight=(rng.normal(size=(r, n)) * 0.05).astype(np.float32) if r else None,
    )
    jp = JaxQLinear(**{f: None if v is None else jnp.asarray(v) for f, v in fields.items()},
                    group_size=g)
    tp = QLinearParams(**{f: None if v is None else torch.from_numpy(v)
                          for f, v in fields.items()}, group_size=g)
    return jp, tp


@pytest.mark.parametrize("k,n,g", [(64, 128, 16), (128, 256, 64), (256, 128, 256)])
@pytest.mark.parametrize("m", [9, 200])
def test_qgemm_t_plain_matches_pallas(k, n, g, m):
    rng = np.random.default_rng(4)
    jp, tp = _linear(rng, k, n, g, r=0)
    gcot = rng.normal(size=(m, n)).astype(np.float32)
    ref = np.asarray(jax_qgemm_t(jnp.asarray(gcot), jp, dtype=jnp.float32))
    got = qmm.qgemm_t(torch.from_numpy(gcot), tp)  # CPU tensor: the plain version
    np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL)
    dense = np.asarray(dequantize_weight(jp, jnp.float32))
    np.testing.assert_allclose(got.numpy(), gcot @ dense.T, **GRAD_TOL)


def test_qgemm_t_tail_lands_on_the_last_r_columns():
    rng = np.random.default_rng(5)
    _, tp = _linear(rng, 128, 64, 32, r=0)
    g = torch.from_numpy(rng.normal(size=(3, 7, 64)).astype(np.float32))
    tail = torch.from_numpy(rng.normal(size=(3, 7, 16)).astype(np.float32))
    base = qmm.qgemm_t(g, tp)
    got = qmm.qgemm_t(g, tp, tail)
    assert got.shape == (3, 7, 128)
    np.testing.assert_array_equal(got[..., :112].numpy(), base[..., :112].numpy())
    np.testing.assert_allclose(got[..., 112:].numpy(), (base[..., 112:] + tail).numpy(),
                               rtol=1e-6, atol=1e-6)


def _port_grads(tp, x, ow):
    xt = torch.from_numpy(x).requires_grad_()
    owt = None if ow is None else torch.from_numpy(ow).requires_grad_()
    y = qlinear_apply(xt, dataclasses.replace(tp, oweight=owt))
    (y ** 2).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), None if owt is None else owt.grad.numpy()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("r", [8, 0])
@pytest.mark.parametrize("shape", [(3, 5, 64), (1, 64)])
def test_function_matches_jax_custom_vjp(monkeypatch, use_pallas, r, shape):
    """(3, 5, 64) runs K2's plain version forward, (1, 64) K5's."""
    monkeypatch.setenv("QEFT_PALLAS", "1" if use_pallas else "0")
    rng = np.random.default_rng(0)
    jp, tp = _linear(rng, r=r)
    x = rng.normal(size=shape).astype(np.float32)
    ow = None if r == 0 else np.array(jp.oweight)

    def f(x, ow):
        return jax_qlinear_apply(x, dataclasses.replace(jp, oweight=ow), dtype=jnp.float32)

    y_ref = f(jnp.asarray(x), None if ow is None else jnp.asarray(ow))
    if r:
        dx_ref, dow_ref = jax.grad(lambda x, o: jnp.sum(f(x, o) ** 2), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(ow))
    else:
        dx_ref = jax.grad(lambda x: jnp.sum(f(x, None) ** 2))(jnp.asarray(x))
    y, dx, dow = _port_grads(tp, x, ow)
    np.testing.assert_allclose(y, np.asarray(y_ref), **OUT_TOL)
    np.testing.assert_allclose(dx, np.asarray(dx_ref), **GRAD_TOL)
    if r:
        np.testing.assert_allclose(dow, np.asarray(dow_ref), **GRAD_TOL)


@pytest.mark.parametrize("m", [2, 40])
def test_function_matches_autograd_of_the_plain_version(m):
    rng = np.random.default_rng(1)
    _, tp = _linear(rng, k=128, n=96, g=32, r=16)
    x = rng.normal(size=(m, 128)).astype(np.float32)
    ow = np.asarray(tp.oweight)
    y, dx, dow = _port_grads(tp, x, ow)

    xt = torch.from_numpy(x).requires_grad_()
    owt = torch.from_numpy(ow).clone().requires_grad_()
    yr = qmm.qgemm_plain(xt, dataclasses.replace(tp, oweight=owt))
    (yr ** 2).sum().backward()
    np.testing.assert_allclose(y, yr.detach().numpy(), **OUT_TOL)
    np.testing.assert_allclose(dx, xt.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dow, owt.grad.numpy(), **GRAD_TOL)


def test_backward_skips_dx_when_the_input_needs_no_gradient(monkeypatch):
    calls = []
    monkeypatch.setattr("qeft_tpu_torch.ops.qlinear.qgemm_t",
                        lambda *a: calls.append(1) or qmm.qgemm_t(*a))
    rng = np.random.default_rng(2)
    _, tp = _linear(rng)
    owt = tp.oweight.clone().requires_grad_()
    x = torch.from_numpy(rng.normal(size=(12, 64)).astype(np.float32))
    qlinear_apply(x, dataclasses.replace(tp, oweight=owt)).sum().backward()
    assert calls == [] and owt.grad is not None
    xg = x.clone().requires_grad_()
    qlinear_apply(xg, dataclasses.replace(tp, oweight=owt)).sum().backward()
    assert calls == [1] and xg.grad is not None


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 64), (1, 3, 64)])
def test_reorder_ids_and_bias_match_jax_custom_vjp(monkeypatch, use_pallas, shape):
    """A linear packed without the global reorder: the input gathered by its
    ``reorder_ids`` before the function, a bias inside it; output and the
    gradients of x, oweight and bias.  (1, 3, 64) runs K5's plain version,
    (3, 5, 64) K2's."""
    monkeypatch.setenv("QEFT_PALLAS", "1" if use_pallas else "0")
    rng = np.random.default_rng(6)
    jp, tp = _linear(rng)
    ids = rng.permutation(64).astype(np.int32)
    bias = (rng.normal(size=(128,)) * 0.5).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    ow = np.array(jp.oweight)

    def f(x, o, b):
        p = dataclasses.replace(jp, oweight=o, bias=b, reorder_ids=jnp.asarray(ids))
        return jnp.sum(jax_qlinear_apply(x, p, dtype=jnp.float32) ** 2)

    args = (jnp.asarray(x), jnp.asarray(ow), jnp.asarray(bias))
    y_ref = jax_qlinear_apply(args[0], dataclasses.replace(
        jp, bias=args[2], reorder_ids=jnp.asarray(ids)), dtype=jnp.float32)
    dx_ref, dow_ref, db_ref = jax.grad(f, argnums=(0, 1, 2))(*args)

    xt, owt, bt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, ow, bias))
    y = qlinear_apply(xt, dataclasses.replace(tp, oweight=owt, bias=bt,
                                              reorder_ids=torch.from_numpy(ids)))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **OUT_TOL)
    for got, ref in ((xt.grad, dx_ref), (owt.grad, dow_ref), (bt.grad, db_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
