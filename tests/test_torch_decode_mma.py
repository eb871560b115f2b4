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

K1 (``qgemv_stacked_fused``) runs on the same kernel with a norm prologue
and a residual epilogue; its emulation adds them in the kernel's order:
each block's rstd from its own thread mapping (every split of a cluster
computes it, and the splits must agree bit for bit), the normalised values
rounded as ``rms_norm`` rounds them and staged in ``mma_k_row`` order in
chunks of 64 units, the zero-point fold over the normalised sums, the
normalised weak-column tail, the splits' partial tiles summed in rank
order and the residual added before the one rounding.  P4's bf16 variants
(``csrc/probes.cu``, ``gemv_ablation``) are emulated the same way: the
weight pairs the CUDA cores build, the activations staged in the kernel's
MMA order, the splits summed in rank order.
"""

import re
from pathlib import Path

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


THREADS, WARPS, SMS = 256, 8, 132  # a block of the kernel; the H100's SMs
CHUNK_UNITS = 64  # units of 32 K rows staged at once


def gemv_splits(tiles, units, most=16):
    """P4's split count: the largest power of two, at most ``most`` and
    ``units``, that keeps two blocks an SM (the decode matvecs' own rule is
    ``qmm.gemv_splits``)."""
    s = 1
    while 2 * s <= most and 2 * s <= units and tiles * 2 * s <= 2 * SMS:
        s *= 2
    return s


def _round_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def block_rstd(x, eps):
    """K1's rstd of each token row as one block computes it: thread tid sums
    the squares of the 8-value chunks tid, tid + 256, ... in order (one f32
    fma each), a butterfly sum over each warp's lanes, the 8 warps' sums in
    order, then 1 / sqrt(sum / K + eps)."""
    m_count, k = x.shape
    out = np.zeros(m_count, np.float32)
    for m in range(m_count):
        chunks = (x[m].astype(np.float64) ** 2).reshape(-1, 8)  # exact squares of bf16 values
        per = np.zeros(THREADS, np.float32)
        for c0 in range(0, len(chunks), THREADS):
            blk = chunks[c0:c0 + THREADS]
            for e in range(8):
                per[:len(blk)] = (per[:len(blk)] + blk[:, e]).astype(np.float32)
        lanes = per.reshape(WARPS, 32)
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
        total = np.float32(0)
        for w in range(WARPS):
            total = np.float32(total + lanes[w, 0])
        out[m] = np.float32(1) / np.sqrt(np.float32(total / np.float32(k) + np.float32(eps)))
    return out


def normed(x, lnw, rs, one_offset):
    """The normalised activations as the kernel stages them: x * rstd
    rounded to bf16, times lnw (bf16(1 + lnw) for gemma), rounded again."""
    w = _round_bf16(1 + lnw) if one_offset else lnw
    return _round_bf16(_round_bf16(x * rs[:, None]) * w)


def emulate(x, p, layer, lnw=None, res=None, eps=1e-5, one_offset=False):
    """K6 on numpy: x [M, K] bf16 values (f32), layer ``layer`` of the
    stacked packed linear ``p`` (bf16 values in f32) -> y [M, N] f32, the
    sum before the one rounding.  With ``lnw`` and ``res``, K1: the norm
    prologue and the residual epilogue.  The groups are split over the
    cluster as the kernel splits them."""
    m_count, k = x.shape
    qw = p.qweight[layer].numpy().view(np.uint32)
    sc, sz = p.scales[layer].numpy(), p.scaled_zeros[layer].numpy()
    g = p.group_size
    hh, n_groups, n = g // 8, k // g, qw.shape[1]
    upg = hh // 4  # units of a group
    splits = qmm.gemv_splits(-(-n // 256), n_groups, SMS)
    h = x
    if lnw is not None:
        rs = [block_rstd(x, eps) for _ in range(splits)]  # every block of a cluster
        assert all(np.array_equal(r, rs[0]) for r in rs)
        h = normed(x, lnw, rs[0], one_offset)
    xs = np.zeros((8, k), np.float32)
    xs[:m_count] = h  # the normalised values replace the raw ones everywhere
    y = np.zeros((m_count, n), np.float32)
    gid, t = np.arange(8)[:, None], np.arange(4)[None, :]  # lane (gid, t): [8, 4]
    r = p.n_outlier
    weak_steps = (r + 15) // 16
    for n0 in range(0, n, 32):  # one warp's 32 columns
        n4 = n0 + 4 * np.arange(8)
        col = lambda c: np.minimum(n4[:, None] + c, n - 1)  # [8, 1]
        ok = (n4[:, None] + np.zeros((1, 4), int)) < n
        tiles = []
        for rank in range(splits):
            gb0, gb1 = rank * n_groups // splits, (rank + 1) * n_groups // splits
            acc = [np.zeros((16, 8), np.float32) for _ in range(2)]
            for c0 in range(gb0, gb1, CHUNK_UNITS // upg):
                c1 = min(gb1, c0 + CHUNK_UNITS // upg)
                # the chunk's staging: for each (group, unit), the chunk of
                # lane (gid = token, t), element e at K row mma_k_row(hh, 4u,
                # t, e) of the group, and its (unit, token) sum
                staged = {}
                for gi in range(c0, c1):
                    for u in range(upg):
                        rows = np.array([[[gi * g + qmm.mma_k_row(hh, 4 * u, tt, e)
                                           for e in range(8)] for tt in range(4)]])
                        chunk = xs[np.arange(8)[:, None, None], rows]  # [8 tokens, 4, 8]
                        staged[gi, u] = chunk, chunk.reshape(8, -1).sum(1, dtype=np.float32)
                if c0 == gb0:
                    for st in range(rank, weak_steps, splits):  # weak columns: oweight rows as A
                        ow = p.oweight[layer].numpy()
                        orow = lambda i, c: np.where(ok & (i < r),
                                                     ow[np.minimum(i, r - 1), col(c)], 0)
                        xt = lambda i: np.where((gid < m_count) & (i < r),
                                                xs[np.minimum(gid, 7), k - r + np.minimum(i, r - 1)],
                                                0)
                        i0 = 16 * st + 2 * t
                        b = _b_tile(_pair(xt(i0), xt(i0 + 1)), _pair(xt(i0 + 8), xt(i0 + 9)))
                        for j in range(2):
                            regs = [_pair(orow(i, c), orow(i + 1, c)) for i in (i0, i0 + 8)
                                    for c in (2 * j, 2 * j + 1)]
                            acc[j] += _a_tile(regs[0], regs[1], regs[2], regs[3]) @ b
                for gi in range(c0, c1):
                    part = [np.zeros((16, 8), np.float32) for _ in range(2)]
                    sx = np.zeros(8, np.float32)
                    for u in range(upg):
                        # the lane's words: word row 4u + t of its group, columns n4 + c
                        w = [np.where(ok, qw[(4 * u + t) * n_groups + gi, col(c)], 0)
                             .astype(np.uint32) for c in range(4)]
                        chunk, psum = staged[gi, u]
                        words = [_pair(chunk[..., 2 * q], chunk[..., 2 * q + 1]) for q in range(4)]
                        sx += psum
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
            tiles.append(acc)
        for j in range(2):  # the splits' tiles in rank order
            total = np.zeros((16, 8), np.float32)
            for acc in tiles:
                total = (total + acc[j]).astype(np.float32)
            _scatter(y, total, n4, j, m_count)
    if res is not None:
        y = (y + res).astype(np.float32)  # before the one rounding to bf16
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


@pytest.mark.parametrize("tiles,units,want", [
    (16, 32, 8),    # OPT-6.7B q/k/v/o: 128 blocks, one an SM
    (16, 128, 8),   # OPT-6.7B fc2
    (64, 32, 2),    # OPT-6.7B fc1: 128 blocks one an SM, not 256 two an SM
    (19, 71, 8),    # Falcon-7b qkv (g = 64): 76 at one an SM would idle 56 SMs
    (18, 71, 8),    # Falcon-7b o
    (71, 71, 2),    # Falcon-7b fc1: 71 SMs at one an SM, 142 blocks at two
    (18, 284, 8),   # Falcon-7b fc2
    (11 * 64, 16, 1),  # DeepSeek-V2-Lite's experts' gate/up, tiles x experts
    (197, 32, 1),   # a 50,272-wide head: more tiles than SMs
    (1, 4, 4),      # a split a group
])
def test_decode_matvec_splits(tiles, units, want):
    """The decode matvecs' splits (``qmm.gemv_splits``, twin of
    ``csrc/qmm.cu:gemv_splits``) at the cells' shapes on the H100's 132 SMs:
    one block an SM wherever that fills 7/8 of them, else two; never more
    than a group a split or a cluster of 8."""
    s = qmm.gemv_splits(tiles, units, SMS)
    assert s == want
    assert s <= min(units, qmm.GEMV_MAX_SPLITS) and s & (s - 1) == 0
    assert tiles * s <= 2 * SMS or s == 1


@pytest.mark.parametrize("q", range(4))
def test_code_pair_is_one_lop3_of_the_mask_or(q):
    """K1/K5/K6 build each A register with one LOP3 on (w >> 4q), the nibble
    mask and the bf16 pair (128, 128), the constants in registers: its truth
    table, read from csrc/qmm.cu, evaluated bit by bit is the mask-or pair
    that the emulation below builds, for every word."""
    src = (Path(qmm.__file__).resolve().parent.parent / "csrc" / "qmm.cu").read_text()
    luts = re.findall(r"lop3\.b32 %0, %1, %2, %3, (0x[0-9A-Fa-f]+)", src)
    assert luts, "no lop3 in csrc/qmm.cu"
    w = np.random.default_rng(q).integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    a = w >> np.uint32(4 * q)
    mask, magic = np.uint32(0x000F000F), MAGIC
    for lut in {int(v, 16) for v in luts}:
        got = np.zeros_like(a)
        for bit in range(32):
            i = (((a >> bit) & 1) << 2) | (((mask >> bit) & 1) << 1) | ((magic >> bit) & 1)
            got |= ((np.uint32(lut) >> i) & np.uint32(1)) << np.uint32(bit)
        np.testing.assert_array_equal(got, _code_pair(w, q))


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


def _k1_inputs(m, k, n, g, r, seed):
    p = random_packed_linear(seed, 2, k, n, g, r).map(
        lambda t: _bf16(t) if t.is_floating_point() else t)
    rng = np.random.default_rng(seed)
    x = _bf16(torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32) * 3))
    lnw = _bf16(torch.from_numpy(rng.normal(size=k).astype(np.float32) * 0.1 + 1))
    res = _bf16(torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32) * 4))
    return p, x, lnw, res


@pytest.mark.parametrize("one_offset", [False, True])
def test_k1_rstd_and_rounding_are_rms_norms(one_offset):
    """The emulated block's rstd is the plain f32 statistic to f32 rounding,
    and with the plain statistic the emulated normalisation is
    ``rms_norm`` in bf16 bit for bit."""
    _, x, lnw, _ = _k1_inputs(8, 1024, 8, 128, 0, seed=11)
    rs = block_rstd(x.numpy(), 1e-5)
    want = torch.rsqrt((x * x).mean(-1) + 1e-5).numpy()
    np.testing.assert_allclose(rs, want, rtol=2e-6, atol=0)
    got = normed(x.numpy(), lnw.numpy(), want, one_offset)
    ref = qmm.rms_norm(x.to(torch.bfloat16), lnw.to(torch.bfloat16), 1e-5, one_offset)
    np.testing.assert_array_equal(got, ref.float().numpy())


K1_CASES = [(m, k, n, r) for m in (1, 3, 8) for k, n, r in (
    (512, 40, 16),  # ragged N: the second warp tile is part empty
    (512, 40, 0),   # no weak columns
)] + [(m, 18432, 32, 24) for m in (1, 8)]  # a split of two 64-unit chunks; a part weak step


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("one_offset", [False, True])
@pytest.mark.parametrize("m,k,n,r", K1_CASES)
def test_k1_emulation_matches_plain(m, g, one_offset, k, n, r):
    """K1's order of operations on numpy against the plain fused stage in
    f32 after the kernel's normalisation (the emulated rstd, the
    ``rms_norm`` rounding): the normalised staging, sums and weak-column
    tail, the rank-order sum of the splits and the residual before the
    rounding."""
    p, x, lnw, res = _k1_inputs(m, k, n, g, r, seed=m + g + k)
    h = normed(x.numpy(), lnw.numpy(), block_rstd(x.numpy(), 1e-5), one_offset)
    want = qmm.qgemv_stacked_fused_plain(torch.from_numpy(h), p, 1, residual=res).numpy()
    got = emulate(x.numpy(), p, 1, lnw=lnw.numpy(), res=res.numpy(), one_offset=one_offset)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# P4's bf16 variants


def _p4_weight_pair(variant, w, sc, i, planes):
    """The bf16 pair the kernel builds for pair ``i`` of a word: planes
    (i, i + planes/2), each (plane as f32) * scale rounded to bf16 (v1: the
    plane; v5: the low nibble for every plane)."""
    def deq(p):
        code = ((w if variant == "v5_noshift" else w >> np.uint32(4 * p)) & np.uint32(0xF))
        f = code.astype(np.float32)
        return f if variant == "v1_noscale" else _round_bf16(f * sc)

    return _pair(deq(i), deq(i + planes // 2))


def emulate_p4(variant, x, qw, s):
    """P4's tensor-core variants on numpy: x [8, K] (bf16 values in f32, plane
    order), qw [K/8, N] uint32, s [G, N] f32 -> [8, N] f32.  The activations
    are staged as the kernel stages them ([unit][vector][token][lane t] of
    bf16 pairs, lane t's pairs in its order); lane (gid, t) owns columns
    4 gid .. 4 gid + 3 and word rows 8u + t, 8u + 4 + t of each unit."""
    from qeft_tpu_torch.probes import gemv_ablation as p4

    planes = {"v2_4plane": 4, "v3_2plane": 2}.get(variant, 8)
    half, cp = planes // 2, 4 if planes >= 4 else 2
    k8, n = qw.shape
    units, g_rows = k8 // 8, s.shape[0]
    assert variant in p4.VARIANTS and k8 % 8 == 0
    xs = np.zeros((units, planes // cp, 8, 4, cp), np.uint32)
    for u in range(units):
        for m in range(8):
            for q in range(half):
                lo = x[m, q * k8 + 8 * u: q * k8 + 8 * u + 8]
                hi = x[m, (q + half) * k8 + 8 * u: (q + half) * k8 + 8 * u + 8]
                for r in range(8):
                    i = q if r < 4 else half + q
                    xs[u, i // cp, m, r & 3, i % cp] = _pair(lo[r], hi[r])
    splits = gemv_splits(-(-n // 256), units)
    y = np.zeros((8, n), np.float32)
    t = np.arange(4)[None, :]
    for n0 in range(0, n, 32):
        n4 = n0 + 4 * np.arange(8)
        ok = (n4[:, None] + np.zeros((1, 4), int)) < n
        col = lambda c: np.minimum(n4[:, None] + c, n - 1)
        tiles = []
        for rank in range(splits):
            acc = [np.zeros((16, 8), np.float32) for _ in range(2)]
            for u in range(rank * units // splits, (rank + 1) * units // splits):
                b = [xs[u, i // cp, :, :, i % cp] for i in range(planes)]  # [8 tokens, 4 t]

                def a(c, i):  # A register of column c, lane pair i: [8 gid, 4 t]
                    hw = 0 if i < half else 1
                    row = 8 * u + 4 * hw + t
                    w = np.where(ok, qw[row, col(c)], 0).astype(np.uint32)
                    return _p4_weight_pair(variant, w, s[row % g_rows, col(c)], i - hw * half,
                                           planes)

                for st in range(half):
                    bt = _b_tile(b[2 * st], b[2 * st + 1])
                    for j in range(2):
                        acc[j] += _a_tile(a(2 * j, 2 * st), a(2 * j + 1, 2 * st),
                                          a(2 * j, 2 * st + 1), a(2 * j + 1, 2 * st + 1)) @ bt
            tiles.append(acc)
        for j in range(2):
            total = np.zeros((16, 8), np.float32)
            for acc in tiles:
                total = (total + acc[j]).astype(np.float32)
            _scatter(y, total, n4, j, 8)
    return y


@pytest.mark.parametrize("variant", ["v0_full", "v1_noscale", "v2_4plane", "v3_2plane",
                                     "v5_noshift"])
def test_p4_mma_emulation_matches_plain(variant):
    """The fragments of P4's tensor-core variants against
    ``gemv_ablation_plain``, whose output is bf16: within the module's
    tolerance (1e-2 of the output's scale); a wrong pair, plane or lane
    moves outputs by their own scale."""
    from qeft_tpu_torch.probes import gemv_ablation as p4

    x, qw, s = p4.random_inputs(1024, 40, 128, seed=7, device="cpu")
    want = p4.gemv_ablation_plain(variant, x, qw, s, 8).float().numpy()
    got = emulate_p4(variant, x.float().numpy(), qw.numpy().view(np.uint32), s.numpy())
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=p4.TOL * scale)
