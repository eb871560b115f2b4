"""The host library of the port (``qeft_tpu_torch/ops/native.py`` over its copy
of ``native/qeft_host.cpp``, built at first use with g++) against the JAX
package: packing and unpacking bit-exact with ``qeft_tpu.ops.packing``,
quantization bit-exact with the formula of tests/test_native.py; a build
that fails raises with the compiler's words."""

import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.ops.packing import pack_codes, unpack_codes
from qeft_tpu_torch.ops import native
from qeft_tpu_torch.ops.packing import pack_codes_np


@pytest.mark.parametrize("k,n,g", [(256, 128, 64), (512, 96, 128), (128, 40, 0)])
def test_pack_and_unpack_are_bit_exact_with_jax(k, n, g):
    assert native.available()
    codes = np.random.default_rng(k + n).integers(0, 16, size=(k, n)).astype(np.int32)
    packed = native.pack_codes(codes, g)
    np.testing.assert_array_equal(packed, np.asarray(pack_codes(jnp.asarray(codes), g)))
    np.testing.assert_array_equal(packed, pack_codes_np(codes, g if g else k))
    np.testing.assert_array_equal(native.unpack_codes(packed, k, g), codes)
    np.testing.assert_array_equal(native.unpack_codes(packed, k, g),
                                  np.asarray(unpack_codes(jnp.asarray(packed), g)))


def test_quantize_codes_matches_the_formula():
    """tests/test_native.py's case: weights made from known codes come back
    as those codes, the outlier rows as their zero points."""
    rng = np.random.default_rng(1)
    k, n, g, r = 256, 64, 64, 8
    scales = (rng.random((k // g, n)) * 0.05 + 0.01).astype(np.float32)
    zeros = rng.integers(0, 16, size=(k // g, n)).astype(np.float32)
    codes_true = rng.integers(0, 16, size=(k, n)).astype(np.int32)
    s_full, z_full = np.repeat(scales, g, axis=0), np.repeat(zeros, g, axis=0)
    w = ((codes_true - z_full) * s_full).astype(np.float32)
    out = native.quantize_codes(w, scales, zeros, g, r)
    expected = codes_true.copy()
    expected[k - r:] = np.clip(np.round(z_full[k - r:]), 0, 15).astype(np.int32)
    np.testing.assert_array_equal(out, expected)
    # off-grid weights: round(w / s + z) clipped, as the JAX fallback computes it
    w2 = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    want = np.clip(np.round(w2 / s_full + z_full), 0, 15).astype(np.int32)
    want[k - r:] = expected[k - r:]
    got = native.quantize_codes(w2, scales, zeros, g, r)
    assert (got != want).mean() < 1e-3  # ties: away from zero here, to even in NumPy
    np.testing.assert_array_equal(np.abs(got - want) <= 1, True)


def test_shapes_are_checked_before_the_call():
    with pytest.raises(ValueError, match="group size"):
        native.pack_codes(np.zeros((100, 8), np.int32), 64)
    with pytest.raises(ValueError, match="expected"):
        native.quantize_codes(np.zeros((128, 8), np.float32), np.ones((1, 8), np.float32),
                              np.zeros((1, 8), np.float32), 64, 0)


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    src = tmp_path / "pkg" / "csrc" / "qeft_host.cpp"
    src.parent.mkdir(parents=True)
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the host library failed"):
        native.pack_codes(np.zeros((64, 8), np.int32), 64)
    assert not native.library_path().exists()
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.pack_codes(np.zeros((64, 8), np.int32), 64)
