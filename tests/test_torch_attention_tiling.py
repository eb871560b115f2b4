"""The order of operations of the decode-attention template (K4, K4q, K8:
``csrc/decode_attention.cu``) and of the tensor-core window attention (K3:
``csrc/flash.cu``), emulated in numpy and checked against the JAX Pallas
kernels in interpret mode on the CPU: no GPU needed.

Decode template: one (sequence, kv head)'s valid keys are cut into
``attention.SPLITS`` chunks of ``attention.split_chunk(len)`` keys from key
0 (a block a chunk, empty where the keys run out, as at K8's position 0);
a block walks its chunk in tiles of 16 KB of K rows with an f32 online
softmax (K scale after D^-0.5, the running sum of unscaled p, the V scale
on p only for P.V), and the blocks' (max, sum, accumulator) are combined in
rank order, seeded with K8's new-token term.  Tolerance 2e-5, the JAX
attention tests' own: f32 softmaxes, blockwise online on both sides in
another order.

K4's grouped-head path (H / Hkv >= 16): the splits that cover the card's
SMs, chunks of ``split_chunk(len, splits)`` keys, each walked in tiles and
softmax steps of its head size with base-2 exponentials and P in bf16 for
P.V, the splits combined in rank order; against the JAX kernel as K3 below.

K3: rows in tiles of 16, key chunks of 64 from key 0 up to the last key the
tile's rows may see, scores prescaled by D^-0.5 log2 e and exponentiated in
base 2, alpha exactly 1 while a row's max holds, and P rounded to bf16 for
the P.V product.  With P kept in f32 the emulation meets the JAX kernel at
2e-5; with P in bf16 (the kernel) each weight moves by at most 2**-8 of
itself, so the output by at most 2**-8 of max |v| (the row sum takes the
unrounded p).  A row's result is bit-identical between a 1-row and a 9-row
window whose chunks cross a 64-key boundary, chunk boundaries being fixed
and masked chunks exact no-ops.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.ops.pallas_attention import decode_attention as jax_decode
from qeft_tpu.ops.pallas_attention import decode_attention_stacked as jax_stacked
from qeft_tpu.ops.pallas_flash import flash_window_attention as jax_flash
from qeft_tpu_torch.ops import attention, flash

TOL = dict(rtol=2e-5, atol=2e-5)
CSRC = Path(attention.__file__).resolve().parent.parent / "csrc"
F32 = np.float32


def _bf16(a):
    """``a`` rounded to bf16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------- decode


def _chunks(length):
    c = attention.split_chunk(length)
    return [(min(r * c, length), min(r * c + c, length)) for r in range(attention.SPLITS)]


def emulate_decode(q, k, v, length, ks=None, vs=None, k_new=None, v_new=None):
    """The decode template over slots [0, length) of one layer's cache:
    q [B, H, D], k / v [B, Hkv, S, D] (int8 codes when ks / vs [B, Hkv, S]
    are given), k_new / v_new [B, Hkv, D] (K8).  Returns [B, H, D] f32."""
    b_, h_, d = q.shape
    hkv = k.shape[1]
    # keys a tile: 16 KB of K rows, bf16 or int8 codes
    rep, kt, scale = h_ // hkv, (16384 if ks is not None else 8192) // d, F32(d ** -0.5)
    out = np.zeros((b_, h_, d), F32)
    for b in range(b_):
        for hk in range(hkv):
            qh = q[b, hk * rep:(hk + 1) * rep].astype(F32)  # the block's query heads
            parts = []
            for k0, k1 in _chunks(length):
                m = np.full(rep, -np.inf, F32)
                l = np.zeros(rep, F32)
                acc = np.zeros((rep, d), F32)
                for j0 in range(k0, k1, kt):
                    j1 = min(j0 + kt, k1)
                    s = (qh @ k[b, hk, j0:j1].astype(F32).T) * scale
                    if ks is not None:
                        s = s * ks[b, hk, j0:j1]
                    mn = np.maximum(m, s.max(axis=1))
                    al = np.where(m == -np.inf, F32(0), np.exp(m - mn)).astype(F32)
                    p = np.exp(s - mn[:, None]).astype(F32)
                    pv = p * vs[b, hk, j0:j1] if vs is not None else p
                    l = l * al + p.sum(axis=1)
                    acc = acc * al[:, None] + pv @ v[b, hk, j0:j1].astype(F32)
                    m = mn
                parts.append((m, l, acc))
            mx = np.full(rep, -np.inf, F32)
            l = np.zeros(rep, F32)
            o = np.zeros((rep, d), F32)
            if k_new is not None:
                s_new = (qh @ k_new[b, hk].astype(F32)) * scale
                mx = s_new
            for m_r, _, _ in parts:
                mx = np.maximum(mx, m_r)
            if k_new is not None:
                w = np.exp(s_new - mx).astype(F32)
                l = w
                o = w[:, None] * v_new[b, hk].astype(F32)[None]
            for m_r, l_r, acc_r in parts:  # rank order; an empty chunk adds nothing
                ok = m_r != -np.inf
                w = np.where(ok, np.exp(np.where(ok, m_r - mx, 0)), 0).astype(F32)
                l = l + l_r * w
                o = o + acc_r * w[:, None]
            out[b, hk * rep:(hk + 1) * rep] = np.where(l[:, None] > 0, o / np.where(
                l > 0, l, 1)[:, None], 0)
    return out


def test_split_constants_are_the_kernels():
    src = (CSRC / "decode_attention.cu").read_text()
    assert re.search(rf"constexpr int kC = {attention.SPLITS};", src)
    assert re.search(r"constexpr int kAlign = 16;", src)
    assert re.search(rf"constexpr int kF_KEYS = {flash.CHUNK};", (CSRC / "flash.cu").read_text())


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 100, 112, 113, 127, 128, 129, 255, 256,
                                    257, 319, 511, 512, 513, 1000, 4095, 4096])
def test_split_chunks_tile_the_valid_keys(length):
    """Chunks from key 0 at multiples of 16 keys cover [0, length) once, in
    rank order, and depend on the length only; the blocks past the last
    chunk are empty (all of them at length 0, K8's position 0)."""
    c = attention.split_chunk(length)
    assert c % 16 == 0 and c * attention.SPLITS >= length
    assert c < 16 + -(-length // attention.SPLITS)
    covered = []
    for k0, k1 in _chunks(length):
        assert k0 % 16 == 0 or k0 == length
        covered.extend(range(k0, k1))
    assert covered == list(range(length))
    empty = sum(k0 == k1 for k0, k1 in _chunks(length))
    assert empty == attention.SPLITS - (-(-length // c) if length else 0)


def _int8(rng, *shape):
    codes = rng.integers(-127, 128, size=shape).astype(np.int8)
    return codes, (rng.random(shape[:-1]) * 0.03 + 0.005).astype(F32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 16, 127, 128, 129, 255])
@pytest.mark.parametrize("h,hkv,d", [(8, 4, 128), (4, 4, 64), (2, 1, 256)])
def test_decode_template_matches_pallas(quantized, pos, h, hkv, d):
    """K4 and K4q: slots 0..pos of a 256-slot cache, B = 2, GQA and MHA."""
    rng = np.random.default_rng(pos + 7 * d)
    b, s = 2, 256
    q = rng.normal(size=(b, h, d)).astype(F32)
    if quantized:
        (k, ks), (v, vs) = _int8(rng, b, hkv, s, d), _int8(rng, b, hkv, s, d)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (rng.normal(size=(b, hkv, s, d)).astype(F32) for _ in range(2))
        ks = vs = None
        scales = {}
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, blk=64,
                                **{n: jnp.asarray(t) for n, t in scales.items()}))
    got = emulate_decode(q, k, v, pos + 1, ks, vs)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pos", [0, 1, 17, 127, 128, 130, 255])
def test_stacked_template_matches_pallas(quantized, pos):
    """K8: slots < pos of layer 1 of a stacked cache (slots >= pos poisoned)
    plus the new token, which seeds the rank-order combination."""
    rng = np.random.default_rng(pos)
    n_layers, b, h, hkv, d, s, layer = 2, 2, 8, 4, 128, 256, 1
    q = rng.normal(size=(b, h, d)).astype(F32)
    kn, vn = (rng.normal(size=(b, hkv, d)).astype(F32) for _ in range(2))
    shape = (n_layers, b, hkv, s, d)
    if quantized:
        (kc, ks), (vc, vs) = _int8(rng, *shape), _int8(rng, *shape)
        for c, sc in ((kc, ks), (vc, vs)):
            c[:, :, :, pos:] = 127
            sc[:, :, :, pos:] = 1e3
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = (rng.normal(size=shape).astype(F32) for _ in range(2))
        kc[:, :, :, pos:] = 1e4
        vc[:, :, :, pos:] = 1e4
        scales = {}
    ref = np.asarray(jax_stacked(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.int32(layer), jnp.int32(pos), jnp.asarray(kn),
                                 jnp.asarray(vn), blk=128,
                                 **{n: jnp.asarray(t) for n, t in scales.items()}))
    got = emulate_decode(q, kc[layer], vc[layer], pos,
                         scales["k_scale"][layer] if quantized else None,
                         scales["v_scale"][layer] if quantized else None, kn, vn)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_stacked_at_position_zero_is_the_new_token():
    """Every block of the cluster is empty at K8's position 0: the output is
    v_new, exactly (weight exp(0) = 1, sum 1)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 64)).astype(F32)
    kc, vc = (rng.normal(size=(1, 2, 32, 64)).astype(F32) for _ in range(2))
    kn, vn = (rng.normal(size=(1, 2, 64)).astype(F32) for _ in range(2))
    got = emulate_decode(q, kc, vc, 0, k_new=kn, v_new=vn)
    assert np.array_equal(got, np.repeat(vn, 2, axis=1))



# ---------------------------------------------------------------- K4's group path

SMS = 132  # the H100's SMs, from which launch_group sizes its splits


def _group_sizes(d):
    """(keys a tile, keys a softmax step) of the group path at head size d
    (csrc GroupSmem's KT, KB)."""
    return (32 if d == 256 else 64), {64: 64, 128: 32, 256: 16}[d]


def emulate_group(q, k, v, length, bf16_p=True):
    """K4's grouped-head path over slots [0, length): q [B, H, D], k / v
    [B, Hkv, S, D].  The splits of `attention.group_grid`, chunks of
    `split_chunk` keys, tiles and softmax steps as the kernel walks them,
    exp2 of scores prescaled by D^-0.5 log2 e, alpha exactly 1 while a row's
    max holds, P in bf16 for P.V, the splits combined in rank order.
    Returns [B, H, D] f32."""
    b_, h_, d = q.shape
    hkv = k.shape[1]
    rep = h_ // hkv
    splits = attention.group_grid(b_, h_, hkv, d, SMS)[0]
    kt, kb = _group_sizes(d)
    chunk = attention.split_chunk(length, splits)
    sl2 = F32(d ** -0.5) * F32(1.4426950408889634)
    out = np.zeros((b_, h_, d), F32)
    for b in range(b_):
        for hk in range(hkv):
            qh = q[b, hk * rep:(hk + 1) * rep].astype(F32)
            parts = []
            for r in range(splits):
                k0, k1 = min(r * chunk, length), min(r * chunk + chunk, length)
                m = np.full(rep, -np.inf, F32)
                l = np.zeros(rep, F32)
                acc = np.zeros((rep, d), F32)
                for t0 in range(k0, k1, kt):
                    for j0 in range(t0, min(t0 + kt, k1), kb):
                        j1 = min(j0 + kb, k1)
                        s = (qh @ k[b, hk, j0:j1].astype(F32).T) * sl2
                        mn = np.maximum(m, s.max(axis=1))
                        al = np.where(m == mn, F32(1), np.exp2(m - mn)).astype(F32)
                        p = np.exp2(s - mn[:, None]).astype(F32)
                        l = l * al + p.sum(axis=1)
                        acc = acc * al[:, None] + (_bf16(p) if bf16_p else p) @ v[b, hk, j0:j1]
                        m = mn
                parts.append((m, l, acc))
            mx = np.max([m_r for m_r, _, _ in parts], axis=0)
            l = np.zeros(rep, F32)
            o = np.zeros((rep, d), F32)
            for m_r, l_r, acc_r in parts:  # rank order; an empty chunk adds nothing
                ok = m_r != -np.inf
                w = np.where(ok, np.exp2(np.where(ok, m_r - mx, 0)), 0).astype(F32)
                l = l + l_r * w
                o = o + acc_r * w[:, None]
            out[b, hk * rep:(hk + 1) * rep] = o / l[:, None]
    return out


def test_group_constants_are_the_kernels():
    src = (CSRC / "decode_attention.cu").read_text()
    assert re.search(rf"constexpr int kGroupMin = {attention.GROUP_MIN};", src)
    assert re.search(rf"constexpr int kGroupSplits = {attention.GROUP_SPLITS};", src)
    assert re.search(r"KT = D == 256 \? 32 : 64;", src)
    assert re.search(r"KB = D == 64 \? 64 : \(D == 128 \? 32 : 16\);", src)


@pytest.mark.parametrize("b,h,hkv,d,want", [
    (8, 71, 1, 64, (16, 5, 1)),    # Falcon-7b's batch of 8: 128 blocks of five row tiles
    (1, 71, 1, 64, (16, 5, 1)),
    (8, 128, 8, 64, (2, 1, 1)),    # Falcon-40b: 16 over 8, one row tile
    (1, 16, 1, 256, (16, 1, 1)),
    (1, 160, 1, 64, (16, 8, 2)),   # past 128 rows: a second block along z
    (4, 96, 1, 256, (16, 4, 2)),   # 64 rows a block at D = 256
    (64, 64, 4, 128, (1, 1, 1)),   # more groups than SMs: one split
])
def test_group_grid(b, h, hkv, d, want):
    assert attention.group_grid(b, h, hkv, d, SMS) == want


@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("length", [1, 15, 16, 17, 255, 256, 257, 700, 2048])
def test_group_split_chunks_tile_the_valid_keys(splits, length):
    """The group path's chunks, from key 0 at multiples of 16, cover [0,
    length) once in rank order for any number of splits."""
    c = attention.split_chunk(length, splits)
    assert c % 16 == 0 and c * splits >= length
    covered = []
    for r in range(splits):
        covered.extend(range(min(r * c, length), min(r * c + c, length)))
    assert covered == list(range(length))


@pytest.mark.parametrize("pos", [0, 15, 16, 100, 255])
@pytest.mark.parametrize("h,hkv,d", [(71, 1, 64), (16, 1, 64), (32, 2, 128), (16, 1, 256)])
def test_group_path_matches_pallas(pos, h, hkv, d):
    """With P kept in f32 the group path's order of operations meets the
    JAX kernel at 2e-5; with P in bf16 (the kernel) each weight moves by at
    most 2**-8 of itself, so the output by at most 2**-8 of max |v|."""
    rng = np.random.default_rng(pos + d)
    b, s = 2, 256
    q = rng.normal(size=(b, h, d)).astype(F32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(F32) for _ in range(2))
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, blk=64))
    np.testing.assert_allclose(emulate_group(q, k, v, pos + 1, bf16_p=False), ref, **TOL)
    got = emulate_group(q, k, v, pos + 1)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(v).max()


# ---------------------------------------------------------------- K3

ROWS = 16


def emulate_flash(q, k, v, pos, bf16_p=True):
    """K3 over q [B, S, H, D], k / v [B, Hkv, Sk, D], per-sequence positions
    pos [B]; row by row, as the kernel's tensor-core tile computes each row
    from its own q row and the keys.  Returns [B, S, H*D] f32."""
    b_, s_, h_, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep, chunk = h_ // hkv, flash.CHUNK
    sl2 = F32(d ** -0.5) * F32(1.4426950408889634)
    out = np.zeros((b_, s_, h_, d), F32)
    for b in range(b_):
        for h in range(h_):
            kb, vb = k[b, h // rep].astype(F32), v[b, h // rep].astype(F32)
            for i0 in range(0, s_, ROWS):
                last = min(i0 + ROWS, s_) - 1
                kend = min(int(pos[b]) + last, sk - 1)
                for i in range(i0, last + 1):
                    lim = min(int(pos[b]) + i, sk - 1)
                    m, l = F32(-np.inf), F32(0)
                    o = np.zeros(d, F32)
                    for c0 in range(0, kend + 1, chunk):
                        j = np.arange(c0, c0 + chunk)
                        loaded = j <= kend  # keys past the tile's last are zero-filled
                        kt = np.where(loaded[:, None], kb[np.minimum(j, sk - 1)], 0)
                        vt = np.where(loaded[:, None], vb[np.minimum(j, sk - 1)], 0)
                        s = np.where(j <= lim, (kt @ q[b, i, h].astype(F32)) * sl2, -np.inf)
                        mn = max(m, F32(s.max()))
                        mu = F32(0) if mn == -np.inf else mn
                        al = F32(1) if m == mn else F32(np.exp2(m - mu))
                        p = np.exp2(s - mu).astype(F32)
                        l = l * al + F32(p.sum())
                        pp = _bf16(p) if bf16_p else p
                        o = o * al + pp @ vt
                        m = mn
                    out[b, i, h] = o / l if l > 0 else 0
    return out.reshape(b_, s_, h_ * d)


def _window(rng, b, s, h, hkv, d, sk):
    """bf16-representable f32 inputs: the kernel's operands are bf16."""
    q = _bf16(rng.normal(size=(b, s, h, d)))
    k, v = (_bf16(rng.normal(size=(b, hkv, sk, d))) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,s,h,hkv,d,sk,pos", [
    (1, 16, 4, 2, 64, 64, 0),     # GQA prefill, one tile, one chunk
    (2, 40, 4, 4, 64, 128, 13),   # window at an offset, a ragged tile, two chunks
    (1, 70, 2, 1, 128, 70, 0),    # MQA, keys = the window itself, ragged chunk
    (1, 9, 2, 2, 256, 96, 60),    # the window's rows straddle a 64-key boundary
])
def test_flash_tiling_matches_pallas(b, s, h, hkv, d, sk, pos):
    rng = np.random.default_rng(s + d)
    q, k, v = _window(rng, b, s, h, hkv, d, sk)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                               blk_q=8, blk_k=16))
    p = np.full(b, pos)
    np.testing.assert_allclose(emulate_flash(q, k, v, p, bf16_p=False), ref, **TOL)
    got = emulate_flash(q, k, v, p)
    bound = 2.0 ** -8 * np.abs(v).max() + 2e-5  # P in bf16; see the module docstring
    assert np.abs(got - ref).max() <= bound


def test_flash_tiling_engine_rows_match_pallas():
    """W = 1 at B = 8 with one position per sequence over a 200-slot cache,
    slots past each row's position poisoned (the engine's decode windows)."""
    rng = np.random.default_rng(5)
    b, h, hkv, d, sk = 8, 2, 2, 64, 200
    q, k, v = _window(rng, b, 1, h, hkv, d, sk)
    pos = np.linspace(64, 191, b).astype(np.int32)
    past = np.arange(sk)[None] > pos[:, None]
    k[past[:, None, :, None].repeat(hkv, 1).repeat(d, 3)] = 1e4
    v[past[:, None, :, None].repeat(hkv, 1).repeat(d, 3)] = 1e4
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                               blk_q=8, blk_k=8))
    np.testing.assert_allclose(emulate_flash(q, k, v, pos, bf16_p=False), ref, **TOL)
    got = emulate_flash(q, k, v, pos)
    live = np.abs(np.where(past[:, None, :, None], 0, v)).max()
    assert np.abs(got - ref).max() <= 2.0 ** -8 * live + 2e-5


def test_flash_tiling_row_is_the_same_at_every_width():
    """Rows of a 9-row window at positions 60..68 cross the 64-key chunk
    boundary; each equals the 1-row window at its position bit for bit."""
    rng = np.random.default_rng(9)
    q, k, v = _window(rng, 2, 9, 2, 1, 64, 80)
    pos = np.array([60, 55])
    wide = emulate_flash(q, k, v, pos)
    for i in range(9):
        narrow = emulate_flash(q[:, i: i + 1], k, v, pos + i)
        assert np.array_equal(narrow[:, 0], wide[:, i]), i


def test_flash_tiling_masked_chunk_is_a_no_op():
    """A chunk wholly past a row's frontier leaves its state bit-unchanged:
    the row's output through a tile that walks an extra chunk equals its
    output alone."""
    rng = np.random.default_rng(11)
    q, k, v = _window(rng, 1, 16, 1, 1, 128, 256)
    pos = np.array([50])  # row 0 sees keys <= 50 (chunk 0); row 15 reaches chunk 1
    tile = emulate_flash(q, k, v, pos)
    alone = emulate_flash(q[:, :1], k, v, pos)
    assert np.array_equal(tile[:, 0], alone[:, 0])
