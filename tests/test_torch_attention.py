"""The plain versions of the attention kernels against the JAX Pallas kernels
run in interpret mode on the CPU, in f32.

K3: `flash_window_attention` (plain on CPU tensors) against
``pallas_flash.flash_window_attention`` with GQA, pos > 0, S not a multiple
of the query block, and per-sequence [B] positions.  K4: `decode_attention`
against ``pallas_attention.decode_attention`` at several positions, also at
the query groups of the kernel's grouped-head path (71 over 1, 16 over 1).

Tolerance 2e-5 (abs and rel), the JAX flash test's own: both sides are f32
softmaxes, blockwise-online on the Pallas side and one masked softmax here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.ops.pallas_attention import decode_attention as jax_decode
from qeft_tpu.ops.pallas_flash import flash_window_attention as jax_flash
from qeft_tpu_torch.ops.attention import decode_attention
from qeft_tpu_torch.ops.flash import flash_window_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, b, s, h, hkv, d, s_k):
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s_k, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s_k, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "b,s,h,hkv,d,s_k,pos,blkq,blkk",
    [
        (1, 16, 4, 2, 64, 64, 0, 8, 16),    # GQA prefill into a larger cache
        (2, 16, 4, 4, 64, 64, 13, 8, 16),   # window at an offset
        (1, 64, 4, 1, 64, 64, 0, 16, 64),   # MQA, keys = the window itself
        (1, 10, 2, 2, 64, 64, 3, 8, 16),    # S not a multiple of the query block
        (1, 24, 8, 2, 128, 40, 0, 8, 8),    # GQA 4:1 at head_dim 128
    ],
)
def test_flash_matches_pallas(b, s, h, hkv, d, s_k, pos, blkq, blkk):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b, s, h, hkv, d, s_k)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                               blk_q=blkq, blk_k=blkk))
    got = flash_window_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    assert got.shape == (b, s, h * d)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_flash_per_sequence_positions():
    rng = np.random.default_rng(1)
    b, s, h, hkv, d, s_k = 3, 6, 4, 2, 64, 48
    q, k, v = _qkv(rng, b, s, h, hkv, d, s_k)
    pos = np.array([0, 17, 41], np.int32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                               blk_q=8, blk_k=16))
    got = flash_window_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_flash_rows_do_not_depend_on_window_width():
    """A row's result is the same through a 1-row and a 9-row window."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 9, 4, 2, 64, 32))
    wide = flash_window_attention(q, k, v, 5)
    for i in range(9):
        narrow = flash_window_attention(q[:, i: i + 1], k, v, 5 + i)
        torch.testing.assert_close(narrow[:, 0], wide[:, i], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos", [0, 5, 15, 37, 63])
@pytest.mark.parametrize("h,hkv,d", [(8, 4, 128), (4, 4, 64), (71, 1, 64), (16, 1, 64)])
def test_decode_attention_matches_pallas(pos, h, hkv, d):
    rng = np.random.default_rng(pos)
    b, s = 2, 64
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, blk=16))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
