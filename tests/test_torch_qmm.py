"""The plain versions of the packed-linear kernels against the JAX Pallas
kernels run in interpret mode on the CPU, in f32.

K1: the port's `qgemv_stacked_fused` (plain on CPU tensors) against
``pallas_qmm.qgemv_stacked_fused`` -- norm prologue (one_offset on and off),
residual epilogue, with and without the weak-column slab -- as
tests/test_pallas_qmm.py::test_qgemv_stacked_fused_matches_composed does.
K2: the port's `qgemm` against ``pallas_qmm.qgemm``.  K6: the port's
`qgemv_stacked` (no norm, no residual, the weak-column slab inside) against
``pallas_qmm.qgemv_stacked`` (its slab product outside the kernel), and
`qlinear_apply_stacked` on both sides of the row threshold.  K5: the port's
`qgemv` (one unstacked linear, slab and bias inside) against
``pallas_qmm.qgemv`` (slab and bias outside) at 1..7 rows.

Tolerance 1e-4 (abs and rel), the JAX test's own: both sides are f32, and the
Pallas kernels sum per nibble plane and fold the zero points through group
sums, a different order than one dense matmul.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.ops.packing import QLinearParams as JaxQLinear, pack_codes
from qeft_tpu.ops.pallas_qmm import qgemm as jax_qgemm, qgemv_stacked_fused as jax_fused
from qeft_tpu.ops.pallas_qmm import qgemv as jax_qgemv, qgemv_stacked as jax_qgemv_stacked
from qeft_tpu_torch.ops import qlinear, qmm
from qeft_tpu_torch.ops.packing import QLinearParams

TOL = dict(rtol=1e-4, atol=1e-4)
L, K, N, G, R = 3, 256, 256, 64, 16
EPS = 1e-5


def _layers(rng, k=K, n=N, g=G, r=R):
    out = []
    for _ in range(L):
        codes = rng.integers(0, 16, size=(k, n)).astype(np.int32)
        out.append(dict(
            qweight=np.array(pack_codes(jnp.asarray(codes), g)),
            scales=(rng.random((k // g, n)) * 0.02 + 0.01).astype(np.float32),
            scaled_zeros=(-rng.random((k // g, n)) * 0.1).astype(np.float32),
            oweight=(rng.normal(size=(r, n)) * 0.02).astype(np.float32),
        ))
    return out


def _stack(layers, with_ow, g=G):
    fields = ("qweight", "scales", "scaled_zeros") + (("oweight",) if with_ow else ())
    st = {f: np.stack([lay[f] for lay in layers]) for f in fields}
    jp = JaxQLinear(**{f: jnp.asarray(v) for f, v in st.items()}, group_size=g)
    tp = QLinearParams(**{f: torch.from_numpy(v) for f, v in st.items()}, group_size=g)
    return jp, tp


@pytest.mark.parametrize("with_ow", [True, False])
@pytest.mark.parametrize("one_offset", [False, True])
def test_fused_decode_stage_matches_pallas(one_offset, with_ow):
    rng = np.random.default_rng(11)
    jp, tp = _stack(_layers(rng), with_ow)
    x = rng.normal(size=(2, K)).astype(np.float32)
    lnw = (rng.normal(size=(K,)) * 0.1 + 1.0).astype(np.float32)
    res = rng.normal(size=(2, N)).astype(np.float32)
    for l in range(L):
        ref = np.asarray(jax_fused(jnp.asarray(x), jp, jnp.int32(l), lnw=jnp.asarray(lnw),
                                   eps=EPS, one_offset=one_offset, dtype=jnp.float32))
        got = qmm.qgemv_stacked_fused(torch.from_numpy(x), tp, l, lnw=torch.from_numpy(lnw),
                                      eps=EPS, one_offset=one_offset)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)

        ref2 = np.asarray(jax_fused(jnp.asarray(x), jp, jnp.int32(l), residual=jnp.asarray(res),
                                    dtype=jnp.float32))
        got2 = qmm.qgemv_stacked_fused(torch.from_numpy(x), tp, l, residual=torch.from_numpy(res))
        np.testing.assert_allclose(got2.numpy(), ref2, **TOL)


def test_fused_decode_stage_at_86_groups():
    """K = 11008 at g = 128 (the 7B down projection's 86 groups), narrow N."""
    rng = np.random.default_rng(3)
    k, n, g, r = 11008, 128, 128, 128
    layers = _layers(rng, k, n, g, r)
    jp, tp = _stack(layers, True, g)
    x = rng.normal(size=(1, k)).astype(np.float32)
    res = rng.normal(size=(1, n)).astype(np.float32)
    ref = np.asarray(jax_fused(jnp.asarray(x), jp, jnp.int32(2), residual=jnp.asarray(res),
                               dtype=jnp.float32))
    got = qmm.qgemv_stacked_fused(torch.from_numpy(x), tp, 2, residual=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 40, K), (72, K)])
def test_qgemm_matches_pallas(shape):
    rng = np.random.default_rng(1)
    lay = _layers(rng)[0]
    jp = JaxQLinear(**{f: jnp.asarray(v) for f, v in lay.items()}, group_size=G)
    tp = QLinearParams(**{f: torch.from_numpy(v) for f, v in lay.items()}, group_size=G)
    x = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_qgemm(jnp.asarray(x), jp, dtype=jnp.float32))
    got = qmm.qgemm(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("m", [1, 4, 7])
@pytest.mark.parametrize("with_ow", [True, False])
def test_plain_decode_matvec_matches_pallas(m, with_ow):
    rng = np.random.default_rng(7)
    jp, tp = _stack(_layers(rng), with_ow)
    x = rng.normal(size=(m, K)).astype(np.float32)
    for l in range(L):
        ref = np.asarray(jax_qgemv_stacked(jnp.asarray(x), jp, jnp.int32(l), dtype=jnp.float32))
        got = qmm.qgemv_stacked(torch.from_numpy(x), tp, l)
        assert got.shape == (m, N)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_ow", [True, False])
def test_unstacked_decode_matvec_matches_pallas(with_ow, with_bias):
    rng = np.random.default_rng(9)
    lay = _layers(rng)[0]
    if not with_ow:
        del lay["oweight"]
    if with_bias:
        lay["bias"] = (rng.normal(size=(N,)) * 0.5).astype(np.float32)
    jp = JaxQLinear(**{f: jnp.asarray(v) for f, v in lay.items()}, group_size=G)
    tp = QLinearParams(**{f: torch.from_numpy(v) for f, v in lay.items()}, group_size=G)
    for m in range(1, 8):
        x = rng.normal(size=(m, K)).astype(np.float32)
        ref = np.asarray(jax_qgemv(jnp.asarray(x), jp, dtype=jnp.float32))
        got = qmm.qgemv(torch.from_numpy(x), tp)
        assert got.shape == (m, N)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("tokens", [1, 8, 9, 64])
def test_stacked_apply_is_one_function(tokens):
    """Both sides of the row threshold give x @ W_deq[l] + x[:, -r:] @ ow[l]."""
    rng = np.random.default_rng(8)
    _, tp = _stack(_layers(rng), True)
    x = torch.from_numpy(rng.normal(size=(1, tokens, K)).astype(np.float32))
    got = qlinear.qlinear_apply_stacked(x, tp, 2)
    torch.testing.assert_close(got, qmm.qgemm_plain(x, tp.layer(2)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tokens", [1, 8, 9, 64])
def test_stage_dispatch_is_one_function(tokens):
    """Both sides of the token threshold give norm -> matmul -> residual."""
    rng = np.random.default_rng(5)
    _, tp = _stack(_layers(rng), True)
    x = torch.from_numpy(rng.normal(size=(1, tokens, K)).astype(np.float32))
    lnw = torch.from_numpy((rng.normal(size=(K,)) * 0.1 + 1.0).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=(1, tokens, N)).astype(np.float32))
    got = qlinear.qlinear_fused_stage(x, tp, 1, lnw=lnw, residual=res, eps=EPS)
    want = res + qmm.qgemm_plain(qmm.rms_norm(x, lnw, EPS), tp.layer(1))
    assert got.shape == (1, tokens, N)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_jax():
    from qeft_tpu.models.llama import rms_norm as jax_rms_norm

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 64)).astype(np.float32) * 5
    w = rng.normal(size=(64,)).astype(np.float32)
    for one_offset in (False, True):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            ref = np.asarray(jax_rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                                          1e-5, one_offset).astype(jnp.float32))
            got = qmm.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), 1e-5,
                               one_offset).to(torch.float32).numpy()
            # bf16: one rounding step of the normalised value may differ
            tol = 1e-6 if tdt is torch.float32 else 2 ** -7 * np.abs(ref).max()
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("m,n,n_groups", [(64, 12288, 32), (64, 4096, 32), (64, 4096, 86),
                                          (64, 22016, 32), (512, 4096, 86), (9, 96, 4),
                                          (130, 200, 12), (1, 64, 1), (2048, 12288, 32),
                                          (2047, 4096, 86), (257, 22016, 32)])
def test_gemm_split_k_covers_every_group_once(m, n, n_groups):
    """The GEMM's block rows (one 64-row warpgroup tile up to 64 rows, two
    above) and split-K factor: no split empty, the card filled (about two
    blocks per SM of 132) where the groups allow it, no split at M = 2048."""
    bm, splits = qmm.gemm_plan(m, n, n_groups, sms=132)
    assert bm == qmm.gemm_rows(m) == (64 if m <= 64 else 128)
    per = -(-n_groups // splits)  # groups per split, as csrc/qmm.cu cuts them
    assert 1 <= splits <= n_groups and (splits - 1) * per < n_groups <= splits * per
    tiles = -(-m // bm) * -(-n // qmm.GEMM_BN)
    assert tiles * splits >= min(2 * 132, tiles * n_groups) or splits == n_groups
    if m >= 2047:
        assert splits == 1
