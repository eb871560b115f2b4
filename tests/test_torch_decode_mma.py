"""The tensor-core decode matvec of K5/K6 (``csrc/qmm.cu::qgemv_mma_kernel``)
emulated in numpy, one warp's ``mma.sync.m16n8k16`` steps at a time, against
the plain version: no GPU needed.

The emulation builds every register as the kernel does -- which word a lane
loads (word row jj0 + t of its 4 columns), which mask-or pair of it goes
into which A register (pairs 2s, 2s + 1 of k16 step s; columns 2j, 2j + 1
of tile j as A rows gid, gid + 8), which staged activation pair goes into
which B register (chunk words 2s, 2s + 1), where the accumulator fragment
lands (column 4 gid + 2j + i/2, token 2t + i%2) -- multiplies the fragments
as the MMA defines them, folds each group with its scale and zero point
(s * part + (z - 128 s) * sum(x)) and adds the weak-column steps.  A fault in
that layout moves outputs by their own scale; the emulation agrees with the
plain version to f32 rounding.  Tolerance 1e-5 of the output's scale: the
products are exact (bf16 operands), and the f32 sums of x * (128 + code)
over a group carry about 2**-24 of 128 x the group's |x| sum, which the fold
scales by s (at most 0.03).
"""

import numpy as np
import pytest
import torch

from qeft_tpu_torch.ops import qmm
from tests.torch_parity import random_packed_linear

MAGIC = np.uint32(0x43004300)  # the bf16 pair (128, 128)


def _halves(u):
    """bf16 pairs (uint32) -> (low, high) halves as float32."""
    u = np.asarray(u, dtype=np.uint32)
    return (u << 16).view(np.float32), (u & np.uint32(0xFFFF0000)).view(np.float32)


def _pair(lo, hi):
    """Two exact bf16 values (float32) -> their bf16 pair (lo first)."""
    bits = lambda v: np.asarray(v, dtype=np.float32).view(np.uint32) >> 16
    return bits(lo) | (bits(hi) << 16)


def _code_pair(w, q):
    return ((w >> np.uint32(4 * q)) & np.uint32(0x000F000F)) | MAGIC


def _a_tile(a0, a1, a2, a3):
    """A [16, 16] from the four registers of each lane [gid 8, t 4]: a0 row
    gid, K (2t, 2t+1); a1 row gid + 8; a2 / a3 K (2t + 8, 2t + 9)."""
    a = np.zeros((16, 16), np.float32)
    t2 = 2 * np.arange(4)
    for reg, r0, k0 in ((a0, 0, 0), (a1, 8, 0), (a2, 0, 8), (a3, 8, 8)):
        lo, hi = _halves(reg)
        a[r0:r0 + 8][:, k0 + t2] = lo
        a[r0:r0 + 8][:, k0 + t2 + 1] = hi
    return a


def _b_tile(b0, b1):
    """B [16 K, 8 tokens] from each lane's b0 (K 2t, 2t+1) and b1 (2t + 8,
    2t + 9), lane (gid = token, t)."""
    b = np.zeros((16, 8), np.float32)
    t2 = 2 * np.arange(4)
    for reg, k0 in ((b0, 0), (b1, 8)):
        lo, hi = _halves(reg)  # [8 tokens, 4 t]
        b[k0 + t2] = lo.T
        b[k0 + t2 + 1] = hi.T
    return b


def _scatter(y, d, n4, j, m_count):
    """Accumulator fragment D [16, 8] of tile j into y [M, N]: row gid is
    column n4[gid] + 2j, row gid + 8 column n4[gid] + 2j + 1."""
    for gid in range(8):
        for half in range(2):
            n = n4[gid] + 2 * j + half
            if n < y.shape[1]:
                y[:, n] += d[8 * half + gid, :m_count]


def emulate(x, p, layer):
    """K6 on numpy: x [M, K] bf16 values (f32), layer ``layer`` of the
    stacked packed linear ``p`` (bf16 values in f32) -> y [M, N] f32."""
    m_count, k = x.shape
    qw = p.qweight[layer].numpy().view(np.uint32)
    sc, sz = p.scales[layer].numpy(), p.scaled_zeros[layer].numpy()
    g = p.group_size
    hh, n_groups, n = g // 8, k // g, qw.shape[1]
    xs = np.zeros((8, k), np.float32)
    xs[:m_count] = x
    y = np.zeros((m_count, n), np.float32)
    gid, t = np.arange(8)[:, None], np.arange(4)[None, :]  # lane (gid, t): [8, 4]
    for n0 in range(0, n, 32):  # one warp's 32 columns
        n4 = n0 + 4 * np.arange(8)
        col = lambda c: np.minimum(n4[:, None] + c, n - 1)  # [8, 1]
        ok = (n4[:, None] + np.zeros((1, 4), int)) < n
        acc = [np.zeros((16, 8), np.float32) for _ in range(2)]
        for gi in range(n_groups):
            part = [np.zeros((16, 8), np.float32) for _ in range(2)]
            sx = np.zeros(8, np.float32)
            for u in range(hh // 4):
                # the lane's words: word row 4u + t of its group, columns n4 + c
                w = [np.where(ok, qw[(4 * u + t) * n_groups + gi, col(c)], 0).astype(np.uint32)
                     for c in range(4)]
                # the staged chunk of lane (gid = token, t): element e is K row
                # mma_k_row(hh, 4u, t, e) of the group; chunk word q = (2q, 2q+1)
                rows = np.array([[[gi * g + qmm.mma_k_row(hh, 4 * u, tt, e) for e in range(8)]
                                  for tt in range(4)]])  # [1, 4, 8]
                chunk = xs[np.arange(8)[:, None, None], rows]  # [8 tokens, 4, 8]
                words = [_pair(chunk[..., 2 * q], chunk[..., 2 * q + 1]) for q in range(4)]
                sx += chunk.reshape(8, -1).sum(1, dtype=np.float32)
                for s in range(2):
                    b = _b_tile(words[2 * s], words[2 * s + 1])
                    for j in range(2):
                        e, o = w[2 * j], w[2 * j + 1]
                        a = _a_tile(_code_pair(e, 2 * s), _code_pair(o, 2 * s),
                                    _code_pair(e, 2 * s + 1), _code_pair(o, 2 * s + 1))
                        part[j] += a @ b
            for j in range(2):
                cols = np.concatenate([col(2 * j)[:, 0], col(2 * j + 1)[:, 0]])  # D rows
                s_g, z_g = sc[gi, cols][:, None], sz[gi, cols][:, None]
                acc[j] += s_g * part[j] + (z_g - 128 * s_g) * sx[None, :]
        r = p.n_outlier
        for st in range((r + 15) // 16):  # weak columns: oweight rows as A
            ow = p.oweight[layer].numpy()
            orow = lambda i, c: np.where(ok & (i < r), ow[np.minimum(i, r - 1), col(c)], 0)
            xt = lambda i: np.where((gid < m_count) & (i < r),
                                    xs[np.minimum(gid, 7), k - r + np.minimum(i, r - 1)], 0)
            i0 = 16 * st + 2 * t
            b = _b_tile(_pair(xt(i0), xt(i0 + 1)), _pair(xt(i0 + 8), xt(i0 + 9)))
            for j in range(2):
                regs = [_pair(orow(i, c), orow(i + 1, c)) for i in (i0, i0 + 8)
                        for c in (2 * j, 2 * j + 1)]
                acc[j] += _a_tile(regs[0], regs[1], regs[2], regs[3]) @ b
        for j in range(2):
            _scatter(y, acc[j], n4, j, m_count)
    return y


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("g", [64, 128])
def test_contraction_order_is_a_permutation_of_each_group(g):
    """Over a group's units and both k16 steps, kappa 0..15 of every step
    names each of the g K rows once, and each A register pairs nibbles
    (q, q + 4) of one word."""
    hh = g // 8
    seen = []
    for u in range(hh // 4):
        for s in range(2):
            for kappa in range(16):
                t, e, q = (kappa % 8) // 2, kappa % 2, 2 * s + kappa // 8
                seen.append(qmm.mma_k_row(hh, 4 * u, t, 2 * q + e))
    assert sorted(seen) == list(range(g))
    for t in range(4):
        for q in range(4):
            assert qmm.mma_k_row(hh, 4, t, 2 * q) == q * hh + 4 + t
            assert qmm.mma_k_row(hh, 4, t, 2 * q + 1) == (q + 4) * hh + 4 + t


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("g,k,n,r", [
    (128, 512, 200, 16),  # ragged N: the last warp tile is part empty
    (64, 512, 96, 16),
    (64, 256, 64, 0),     # no weak columns
    (128, 256, 72, 24),   # weak rows not a multiple of 16 (zero-padded step)
])
def test_warp_emulation_matches_plain(m, g, k, n, r):
    p = random_packed_linear(3, 2, k, n, g, r).map(
        lambda t: _bf16(t) if t.is_floating_point() else t)
    x = _bf16(torch.from_numpy(np.random.default_rng(m).normal(size=(m, k)).astype(np.float32)))
    want = qmm.qgemv_stacked_plain(x, p, 1).numpy()
    got = emulate(x.numpy(), p, 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
