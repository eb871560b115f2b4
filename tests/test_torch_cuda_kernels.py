"""The CUDA kernels of ``qeft_tpu_torch/csrc`` against their plain PyTorch
versions on the card, at small shapes that reach every branch: 1..8 decode
rows, 86 quantization groups, no weak columns, the gemma norm, GEMM rows past
one tile, GQA, window offsets and per-sequence positions, split decode
chunks; the GEMM (K2) at 9 to 2048 rows, both block heights, split-K and
ragged M and N, bit-identical from call to call; the transposed GEMM (K7)
at 1 to 2048 rows and 86 groups, with and without the weak-column addend,
and the autograd linear's gradients; the tensor-core decode matvec (K6) at
every M from 1 to 8; int8 decode attention (K4q) and the stacked-cache
decode attention (K8, bf16 and int8, slots >= pos poisoned), the three at
the lengths where a cluster's chunks are empty or step, one launch a call
and bit-identical calls; K3 on the engine's W = 1 rows and on an S = 512
window without a cache, and the rows of windows past 128 rows (four-warp
blocks) bit-identical to W = 1 windows; the unstacked
decode matvec (K5) at the OPT, Phi, Bloom and Falcon shapes, every M from 1
to 8, with and without a bias; K1 (norm and residual), K5 and K6 one launch
a call and bit-identical from call to call; the autograd linear's K5 / K2
dispatch with ``reorder_ids``; K1 and K6 at eight rows of K up to 28,672;
P4's variants bit-identical from call to call; P2's unpack_only and P3 on
their bulk-copy ring at ragged shapes and past the 16-bit lane limit, the
probes' workspace and tickets left zeroed; K3 over whole windows of
2048 and 4096 rows (the calibration length and llama2-7b's eval window,
and its f32 entry); K5 on the round-to-nearest packed llama2-7b head; GPTQ
of one 4096 x 4096 linear on the card against the CPU; K2 and K7 at the
OPT, Phi and Falcon training shapes (K = 4544 at g = 64, K = 16384), the
autograd linear with a bias and ``reorder_ids`` at 2048 rows, and a
Falcon-width block quantized on the card against the CPU; K1 and K6 at the
stage shapes one rank of a tensor-parallel deployment runs (Llama-2-7B at
tp 2, Llama-2-70B width at tp 4, K6 without a slab) and a two-rank tp
prefill and decode step on the card against the single device; K2 and K7
at the shard shapes of tp-2 training (512 rows), the bf16w variant of K1,
K6 and K5 (``QEFT_GEMV_F32W=0``) against its plain version, and a two-rank
tensor-parallel WCT loss and gradient on the card against the single
device; and the wrappers' refusals.  They need an NVIDIA GPU and ``nvcc``
and skip elsewhere:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Every kernel input is bf16.  The plain versions run in f32 on the same
values, and the tolerance is 1e-2 of the output's scale (max |plain|): the
kernels sum in f32 and round to bf16 only their output and, in K1/K2, the
normalised activations and dequantized weights (relative errors near 2**-9
each), while a wrong index or a lost term moves outputs by the scale itself.
"""

import pytest
import torch

import dataclasses

from qeft_tpu_torch.ops import attention, cuda_lib, flash, qmm
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.ops.qlinear import qlinear_apply

pytestmark = pytest.mark.cuda

RTOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _packed(gen, layers, k, n, g, r):
    words = torch.randint(-2**31, 2**31, (layers, k // 8, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
    groups = (layers, k // g, n)
    sc = (torch.rand(groups, generator=gen, device="cuda") * 0.02 + 0.01).to(torch.bfloat16)
    sz = (-torch.rand(groups, generator=gen, device="cuda") * 0.16).to(torch.bfloat16)
    ow = _randn(gen, layers, r, n, scale=0.02) if r else None
    return QLinearParams(words, sc, sz, oweight=ow, group_size=g)


def _f32(t):
    if isinstance(t, QLinearParams):
        return t.map(_f32)
    return t.float() if t is not None and t.is_floating_point() else t


def _close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n,g,r,norm,one_offset", [
    (512, 96, 128, 16, True, False),
    (512, 96, 64, 16, True, True),
    (11008, 64, 128, 128, False, False),  # 86 groups
    (1024, 200, 128, 0, True, False),     # no weak columns, ragged N
])
def test_fused_decode_matvec(gen, m, k, n, g, r, norm, one_offset):
    p = _packed(gen, 3, k, n, g, r)
    x = _randn(gen, m, k)
    lnw = (1.0 + _randn(gen, k, scale=0.1).float()).to(torch.bfloat16) if norm else None
    res = _randn(gen, m, n, scale=4.0)
    before = cuda_lib.launches["qgemv_stacked_fused"]
    got = qmm.qgemv_stacked_fused(x, p, 2, lnw=lnw, residual=res, eps=1e-5,
                                  one_offset=one_offset)
    want = qmm.qgemv_stacked_fused_plain(_f32(x), _f32(p), 2, lnw=_f32(lnw),
                                         residual=_f32(res), eps=1e-5, one_offset=one_offset)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemv_stacked_fused"] == before + 1
    _close(got, want)


@pytest.mark.parametrize("m", [9, 63, 64, 65, 128, 129, 130, 257, 2048])
@pytest.mark.parametrize("k,n,g,r,residual", [
    (512, 96, 128, 16, True),
    (768, 200, 64, 24, False),
    (1024, 128, 128, 0, True),
    (11008, 200, 128, 128, True),  # 86 groups, N not a multiple of the 128-column tile
    (1024, 4096, 64, 128, False),
])
def test_qgemm(gen, m, k, n, g, r, residual):
    """Both block heights (64 rows up to M = 64, 128 above), split-K and
    ragged M and N; one launch a call, and a second call on the same inputs
    bit-identical (the split-K partial tiles are summed in split order)."""
    p = _packed(gen, 1, k, n, g, r).layer(0)
    x = _randn(gen, m, k)
    res = _randn(gen, m, n, scale=4.0) if residual else None
    before = cuda_lib.launches["qgemm"]
    got = qmm.qgemm(x, p, residual=res)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemm"] == before + 1
    _close(got, qmm.qgemm_plain(_f32(x), _f32(p), residual=_f32(res)))
    assert torch.equal(qmm.qgemm(x, p, residual=res), got)


@pytest.mark.parametrize("b,s,h,hkv,d,s_k,pos", [
    (1, 64, 8, 8, 128, 320, 0),
    (2, 13, 8, 2, 128, 64, 21),
    (1, 40, 4, 1, 64, 40, 0),
    (1, 9, 2, 2, 256, 48, 30),
])
def test_flash_window_attention(gen, b, s, h, hkv, d, s_k, pos):
    q = _randn(gen, b, s, h, d)
    k, v = _randn(gen, b, hkv, s_k, d), _randn(gen, b, hkv, s_k, d)
    got = flash.flash_window_attention(q, k, v, pos)
    _close(got, flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), pos))


def test_flash_per_sequence_positions_and_width(gen):
    q = _randn(gen, 3, 9, 4, 128)
    k, v = _randn(gen, 3, 2, 64, 128), _randn(gen, 3, 2, 64, 128)
    pos = torch.tensor([0, 17, 50], device="cuda")
    wide = flash.flash_window_attention(q, k, v, pos)
    _close(wide, flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), pos))
    for i in range(9):  # a row's result does not depend on the window width
        narrow = flash.flash_window_attention(q[:, i: i + 1], k, v, pos + i)
        torch.testing.assert_close(narrow[:, 0], wide[:, i], rtol=0, atol=0)


@pytest.mark.parametrize("s,slots,pos", [(200, 256, [0, 40]), (512, 512, [0])])
@pytest.mark.parametrize("h,hkv,d", [(4, 4, 128), (4, 2, 64), (2, 1, 256)])
def test_flash_wide_window_rows_equal_narrow_ones(gen, s, slots, pos, h, hkv, d):
    """Windows wider than 128 rows run blocks of four warps, narrow ones
    blocks of one: every row of a W = 200 window at per-sequence positions,
    and of an S = 512 window without a cache, equals the W = 1 window at
    its position bit for bit."""
    b = len(pos)
    q = _randn(gen, b, s, h, d)
    k, v = _randn(gen, b, hkv, slots, d), _randn(gen, b, hkv, slots, d)
    pos = torch.tensor(pos, device="cuda")
    wide = flash.flash_window_attention(q, k, v, pos)
    _close(wide, flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), pos))
    for i in range(s):
        narrow = flash.flash_window_attention(q[:, i: i + 1], k, v, pos + i)
        torch.testing.assert_close(narrow[:, 0], wide[:, i], rtol=0, atol=0)


def _once_and_again(name, fn):
    """``fn()`` is one launch of ``name``, and a second call bit-identical."""
    before = cuda_lib.launches[name]
    got = fn()
    torch.cuda.synchronize()
    assert cuda_lib.launches[name] == before + 1
    assert torch.equal(fn(), got)
    return got


@pytest.mark.parametrize("h,hkv,d", [(32, 32, 128), (8, 2, 64), (4, 1, 256)])
def test_flash_engine_rows(gen, h, hkv, d):
    """W = 1 at B = 8 with one position per sequence (64..191) over 200
    slots, as the engine's decode windows; slots past each row's position
    poisoned."""
    b, slots = 8, 200
    pos = torch.linspace(64, 191, b, device="cuda").long()
    q = _randn(gen, b, 1, h, d)
    k, v = _randn(gen, b, hkv, slots, d), _randn(gen, b, hkv, slots, d)
    past = (torch.arange(slots, device="cuda") > pos[:, None])[:, None, :, None].expand_as(k)
    k[past] = 1e4
    v[past] = 1e4
    got = _once_and_again("flash_window_attention",
                          lambda: flash.flash_window_attention(q, k, v, pos))
    _close(got, flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), pos))


@pytest.mark.parametrize("h,hkv,d", [(32, 32, 128), (8, 2, 64), (4, 2, 256)])
def test_flash_full_window_without_a_cache(gen, h, hkv, d):
    """S = 512 against its own K/V at position 0 (``eval_ppl``'s windows):
    eight key chunks for the last rows."""
    q = _randn(gen, 1, 512, h, d)
    k, v = _randn(gen, 1, hkv, 512, d), _randn(gen, 1, hkv, 512, d)
    got = _once_and_again("flash_window_attention",
                          lambda: flash.flash_window_attention(q, k, v, 0))
    _close(got, flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), 0))


@pytest.mark.parametrize("kind", ["bf16", "int8", "stacked bf16", "stacked int8"])
@pytest.mark.parametrize("h,hkv,d", [(32, 8, 128), (8, 8, 64), (4, 2, 256)])
def test_decode_template_at_short_and_stepping_lengths(gen, kind, h, hkv, d):
    """K4, K4q and K8 at B = 2: positions 0..20, where a cluster's splits of
    16 keys outnumber the valid keys (blocks with empty chunks; K8 at 0 has
    only its new token), and where the chunk length steps (8 x 16 x n and
    one either side); K8's slots >= pos poisoned.  One launch a call, and a
    second call bit-identical.  523 slots: the int8 scale ranges are not all
    16-byte aligned, so some are read without the bulk copy."""
    b, s, layer = 2, 523, 1
    stacked, int8 = kind.startswith("stacked"), kind.endswith("int8")
    name = "decode_attention_stacked" if stacked else (
        "decode_attention_int8" if int8 else "decode_attention")
    shape = (2, b, hkv, s, d) if stacked else (b, hkv, s, d)
    q, kn, vn = _randn(gen, b, h, d), _randn(gen, b, hkv, d), _randn(gen, b, hkv, d)
    if int8:
        (kc, ks), (vc, vs) = _int8_cache(gen, *shape), _int8_cache(gen, *shape)
    else:
        kc, vc = _randn(gen, *shape), _randn(gen, *shape)
    for pos in list(range(21)) + [126, 127, 128, 254, 255, 256, 382, 383, 384, 510, 511, 512]:
        scales = dict(k_scale=ks.clone(), v_scale=vs.clone()) if int8 else {}
        if not stacked:
            got = _once_and_again(name, lambda: attention.decode_attention(q, kc, vc, pos, **scales))
            want = attention.decode_attention_plain(
                _f32(q), kc if int8 else _f32(kc), vc if int8 else _f32(vc), pos, **scales)
            _close(got, want)
            continue
        kp, vp = kc.clone(), vc.clone()
        kp[:, :, :, pos:] = 127 if int8 else 1e4
        vp[:, :, :, pos:] = 127 if int8 else 1e4
        for t in scales.values():
            t[:, :, :, pos:] = 1e3
        got = _once_and_again(name, lambda: attention.decode_attention_stacked(
            q, kp, vp, layer, pos, kn, vn, **scales))
        want = attention.decode_attention_stacked_plain(
            _f32(q), kp if int8 else _f32(kp), vp if int8 else _f32(vp), layer, pos, _f32(kn),
            _f32(vn), **scales)
        _close(got, want)


@pytest.mark.parametrize("pos", [0, 1, 255, 256, 700, 4095])
@pytest.mark.parametrize("h,hkv,d", [(8, 8, 128), (8, 2, 128), (4, 4, 64)])
def test_decode_attention(gen, pos, h, hkv, d):
    q = _randn(gen, 2, h, d)
    k, v = _randn(gen, 2, hkv, 4096, d), _randn(gen, 2, hkv, 4096, d)
    got = attention.decode_attention(q, k, v, pos)
    _close(got, attention.decode_attention_plain(_f32(q), _f32(k), _f32(v), pos))


@pytest.mark.parametrize("m", [1, 9, 64, 100, 129, 2048])
@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("r", [0, 8, 128])
@pytest.mark.parametrize("k", [1024, 11008])
def test_qgemm_t(gen, m, g, r, k):
    n = 200  # N not a multiple of the 64-column step; 11008 = 86 groups at g = 128
    p = _packed(gen, 1, k, n, g, 0).layer(0)
    gy = _randn(gen, m, n)
    tail = torch.randn(m, r, generator=gen, device="cuda") if r else None
    before = cuda_lib.launches["qgemm_t"]
    got = qmm.qgemm_t(gy, p, tail)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemm_t"] == before + 1
    _close(got, qmm.qgemm_t_plain(_f32(gy), _f32(p), tail))
    assert torch.equal(qmm.qgemm_t(gy, p, tail), got)


@pytest.mark.parametrize("m", [4, 300])
def test_autograd_linear_gradients(gen, m):
    """``dx`` (K7 plus the weak-column addend) and the f32 ``dow`` against
    autograd through the plain version in f32; m = 4 runs K5 forward."""
    p = _packed(gen, 1, 512, 96, 128, 16).layer(0)
    x = _randn(gen, m, 512)
    ow = (torch.randn(16, 96, generator=gen, device="cuda") * 0.02).requires_grad_()
    gy = _randn(gen, m, 96)
    xk = x.clone().requires_grad_()
    y = qlinear_apply(xk, dataclasses.replace(p, oweight=ow))
    y.backward(gy)
    x32 = x.float().requires_grad_()
    ow32 = ow.detach().clone().requires_grad_()
    y32 = qmm.qgemm_plain(x32, dataclasses.replace(_f32(p), oweight=ow32))
    y32.backward(gy.float())
    _close(y, y32.detach())
    _close(xk.grad, x32.grad)
    assert ow.grad.dtype == torch.float32
    err = (ow.grad - ow32.grad).abs().max().item()
    assert err <= RTOL * ow32.grad.abs().max().item(), err


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    p = _packed(gen, 2, 256, 64, 64, 8)
    with pytest.raises(ValueError):  # f32 activations: no silent fallback
        qmm.qgemv_stacked_fused(torch.zeros(1, 256, device="cuda"), p, 0)
    with pytest.raises(ValueError):
        qmm.qgemv_stacked_fused(_randn(gen, 9, 256), p, 0)
    with pytest.raises(RuntimeError):  # group size 8: the kernel takes 64 and 128
        qmm.qgemm_t(_randn(gen, 4, 64), _packed(gen, 1, 256, 64, 8, 0).layer(0))
    with pytest.raises(RuntimeError):  # group size 32 likewise, in K2 too
        qmm.qgemm(_randn(gen, 16, 256), _packed(gen, 1, 256, 64, 32, 0).layer(0))
    with pytest.raises(RuntimeError):  # and in K1, which shares K6's kernel
        qmm.qgemv_stacked_fused(_randn(gen, 1, 256), _packed(gen, 2, 256, 64, 32, 0), 0,
                                lnw=_randn(gen, 256), residual=_randn(gen, 1, 64))
    with pytest.raises(IndexError):
        attention.decode_attention(_randn(gen, 1, 4, 64), _randn(gen, 1, 4, 8, 64),
                                   _randn(gen, 1, 4, 8, 64), 8)


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("k,n,g,r", [(512, 96, 128, 16), (11008, 64, 128, 128),
                                     (1024, 200, 64, 0)])
def test_plain_decode_matvec(gen, m, k, n, g, r):
    p = _packed(gen, 3, k, n, g, r)
    x = _randn(gen, m, k)
    before = cuda_lib.launches["qgemv_stacked"]
    got = qmm.qgemv_stacked(x, p, 2)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemv_stacked"] == before + 1
    _close(got, qmm.qgemv_stacked_plain(_f32(x), _f32(p), 2))


def _int8_cache(gen, *shape):
    codes = torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
    scales = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.03 + 0.005
    return codes, scales


@pytest.mark.parametrize("pos", [0, 1, 255, 256, 700, 4095])
@pytest.mark.parametrize("h,hkv,d", [(8, 8, 128), (8, 2, 128), (4, 4, 64)])
def test_int8_decode_attention(gen, pos, h, hkv, d):
    q = _randn(gen, 2, h, d)
    (kc, ks), (vc, vs) = _int8_cache(gen, 2, hkv, 4096, d), _int8_cache(gen, 2, hkv, 4096, d)
    before = cuda_lib.launches["decode_attention_int8"]
    got = attention.decode_attention(q, kc, vc, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert cuda_lib.launches["decode_attention_int8"] == before + 1
    _close(got, attention.decode_attention_plain(_f32(q), kc, vc, pos, ks, vs))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layer,pos", [(0, 0), (1, 1), (2, 255), (3, 256), (1, 1000)])
@pytest.mark.parametrize("h,hkv,d", [(8, 2, 128), (4, 4, 64), (2, 1, 256)])
def test_stacked_decode_attention(gen, quantized, layer, pos, h, hkv, d):
    shape = (4, 2, hkv, 1024, d)
    q, kn, vn = _randn(gen, 2, h, d), _randn(gen, 2, hkv, d), _randn(gen, 2, hkv, d)
    if quantized:
        (kc, ks), (vc, vs) = _int8_cache(gen, *shape), _int8_cache(gen, *shape)
        for c, sc in ((kc, ks), (vc, vs)):  # poison the stale slot at pos and beyond
            c[:, :, :, pos:] = 127
            sc[:, :, :, pos:] = 1e3
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = _randn(gen, *shape), _randn(gen, *shape)
        kc[:, :, :, pos:] = 1e4
        vc[:, :, :, pos:] = 1e4
        scales = {}
    before = cuda_lib.launches["decode_attention_stacked"]
    got = attention.decode_attention_stacked(q, kc, vc, layer, pos, kn, vn, **scales)
    torch.cuda.synchronize()
    assert cuda_lib.launches["decode_attention_stacked"] == before + 1
    want = attention.decode_attention_stacked_plain(
        _f32(q), kc if quantized else _f32(kc), vc if quantized else _f32(vc), layer, pos,
        _f32(kn), _f32(vn), **scales)
    _close(got, want)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(gen):
    (kc, ks), (vc, vs) = _int8_cache(gen, 1, 4, 64, 64), _int8_cache(gen, 1, 4, 64, 64)
    q = _randn(gen, 1, 4, 64)
    with pytest.raises(IndexError):  # pos past the cache
        attention.decode_attention(q, kc, vc, 64, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError):  # one scale plane without the other
        attention.decode_attention(q, kc, vc, 3, k_scale=ks)
    with pytest.raises(ValueError):  # a non-contiguous cache
        attention.decode_attention(q, kc.transpose(2, 1), vc.transpose(2, 1), 3,
                                   k_scale=ks, v_scale=vs)
    raw = torch.empty(1 * 4 * 64 * 64 + 1, dtype=torch.int8, device="cuda")
    misaligned = raw[1:].view(1, 4, 64, 64)  # one byte off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        attention.decode_attention(q, misaligned, vc, 3, k_scale=ks, v_scale=vs)
    stacked = _randn(gen, 2, 1, 4, 64, 64)
    kn = _randn(gen, 1, 4, 64)
    with pytest.raises(IndexError):
        attention.decode_attention_stacked(q, stacked, stacked, 0, 64, kn, kn)
    with pytest.raises(IndexError):
        attention.decode_attention_stacked(q, stacked, stacked, 2, 3, kn, kn)
    with pytest.raises(ValueError):  # the stale-slot step takes its new K/V in bf16
        attention.decode_attention_stacked(q, stacked, stacked, 0, 3, kn.float(), kn)
    p = _packed(gen, 2, 256, 64, 64, 8)
    with pytest.raises(ValueError):
        qmm.qgemv_stacked(_randn(gen, 9, 256), p, 0)
    with pytest.raises(IndexError):
        qmm.qgemv_stacked(_randn(gen, 1, 256), p, 2)


@pytest.mark.parametrize("k", [13824, 16384, 18176, 28672])
def test_decode_matvecs_at_eight_rows_of_wide_k(gen, k):
    """K1 (norm and residual) and K6 at M = 8 where eight whole rows need
    more than the 227 KB of shared memory a block may have: both stage
    their split's K range in chunks of 64 units."""
    n = 96
    p = _packed(gen, 2, k, n, 128, 128)
    x = _randn(gen, 8, k)
    lnw = (1.0 + _randn(gen, k, scale=0.1).float()).to(torch.bfloat16)
    res = _randn(gen, 8, n, scale=4.0)
    got = qmm.qgemv_stacked_fused(x, p, 1, lnw=lnw, residual=res, eps=1e-5)
    want = qmm.qgemv_stacked_fused_plain(_f32(x), _f32(p), 1, lnw=_f32(lnw),
                                         residual=_f32(res), eps=1e-5)
    _close(got, want)
    _close(qmm.qgemv_stacked(x, p, 1), qmm.qgemv_stacked_plain(_f32(x), _f32(p), 1))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("k,n,g,r", [
    (4096, 4096, 128, 128),   # OPT-6.7B q/k/v/o
    (16384, 512, 128, 128),   # OPT-6.7B fc2's K (two bands at M = 8)
    (2560, 2560, 128, 128),   # Phi-2
    (4544, 4672, 64, 128),    # Falcon-7b qkv, g = 64
    (18176, 320, 64, 128),    # Falcon-7b fc2's K
    (1024, 200, 64, 0),       # no weak columns, ragged N
])
def test_unstacked_decode_matvec(gen, m, k, n, g, r, bias):
    p = _packed(gen, 1, k, n, g, r).layer(0)
    if bias:
        p = dataclasses.replace(p, bias=_randn(gen, n, scale=0.5))
    x = _randn(gen, m, k)
    before = cuda_lib.launches["qgemv"]
    got = qmm.qgemv(x, p)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemv"] == before + 1
    _close(got, qmm.qgemv_plain(_f32(x), _f32(p)))


@pytest.mark.parametrize("m,kernel", [(1, "qgemv"), (8, "qgemv"), (40, "qgemm")])
def test_autograd_linear_reorder_and_bias(gen, m, kernel):
    """``reorder_ids`` gathered before the linear, the bias inside K5 or
    after K2; values and the gradients of x, oweight and bias."""
    k, n = 512, 96
    p = _packed(gen, 1, k, n, 64, 16).layer(0)
    ids = torch.randperm(k, generator=gen, device="cuda").to(torch.int32)
    b = (torch.randn(n, generator=gen, device="cuda") * 0.5).to(torch.bfloat16).requires_grad_()
    ow = (torch.randn(16, n, generator=gen, device="cuda") * 0.02).requires_grad_()
    x = _randn(gen, m, k)
    gy = _randn(gen, m, n)
    xk = x.clone().requires_grad_()
    before = cuda_lib.launches[kernel]
    y = qlinear_apply(xk, dataclasses.replace(p, oweight=ow, bias=b, reorder_ids=ids))
    torch.cuda.synchronize()
    assert cuda_lib.launches[kernel] == before + 1
    y.backward(gy)
    x32 = x.float().requires_grad_()
    ow32, b32 = ow.detach().clone().requires_grad_(), b.detach().float().requires_grad_()
    y32 = qmm.qgemm_plain(x32.index_select(-1, ids.long()),
                          dataclasses.replace(_f32(p), oweight=ow32, bias=b32))
    y32.backward(gy.float())
    _close(y, y32.detach())
    _close(xk.grad, x32.grad)
    _close(b.grad, b32.grad)
    err = (ow.grad - ow32.grad).abs().max().item()
    assert err <= RTOL * ow32.grad.abs().max().item(), err


def test_unstacked_decode_matvec_refuses_what_it_does_not_take(gen):
    p = _packed(gen, 1, 256, 64, 64, 8).layer(0)
    x = _randn(gen, 2, 256)
    with pytest.raises(ValueError):  # nine rows: the GEMM's, not the matvec's
        qmm.qgemv(_randn(gen, 9, 256), p)
    with pytest.raises(ValueError):  # f32 activations
        qmm.qgemv(x.float(), p)
    with pytest.raises(ValueError):  # a stacked linear
        qmm.qgemv(x, _packed(gen, 2, 256, 64, 64, 8))
    with pytest.raises(ValueError):  # the gather belongs before the kernel
        qmm.qgemv(x, dataclasses.replace(p, reorder_ids=torch.arange(256, device="cuda")))
    with pytest.raises(ValueError):  # an f32 bias
        qmm.qgemv(x, dataclasses.replace(p, bias=torch.zeros(64, device="cuda")))
    with pytest.raises(ValueError):  # a bias of the wrong width
        qmm.qgemv(x, dataclasses.replace(p, bias=_randn(gen, 32)))
    with pytest.raises(ValueError):  # a non-contiguous bias
        qmm.qgemv(x, dataclasses.replace(p, bias=_randn(gen, 128)[::2]))
    with pytest.raises(ValueError):  # non-contiguous codes
        qmm.qgemv(x, dataclasses.replace(p, qweight=p.qweight.t().contiguous().t()))
    raw = torch.empty(p.scales.numel() + 1, dtype=torch.bfloat16, device="cuda")
    misaligned = raw[1:].view(p.scales.shape)  # two bytes off a 16-byte boundary
    misaligned.copy_(p.scales)
    with pytest.raises(ValueError, match="aligned"):
        qmm.qgemv(x, dataclasses.replace(p, scales=misaligned))
    with pytest.raises(ValueError):  # K1 and K6 take no bias
        qmm.qgemv_stacked(x, dataclasses.replace(_packed(gen, 2, 256, 64, 64, 8),
                                                 bias=_randn(gen, 2, 64)), 0)
    with pytest.raises(RuntimeError):  # group size 32: K5 and K6 take 64 and 128
        qmm.qgemv(x, _packed(gen, 1, 256, 64, 32, 0).layer(0))
    with pytest.raises(RuntimeError):  # N not a multiple of 4 (16-byte word loads)
        qmm.qgemv_stacked(x, _packed(gen, 2, 256, 66, 64, 0), 0)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n,g,r", [
    (4096, 4096, 128, 128),   # 32 column tiles: the groups split over a cluster of 8
    (11008, 4096, 128, 128),  # 86 groups over 8 splits
    (4096, 22016, 128, 128),  # 172 tiles: one split
    (4544, 4672, 64, 128),
])
def test_decode_matvecs_bit_identical_and_one_launch(gen, m, k, n, g, r):
    """K6, K5 (with a bias) and K1 (with the norm and the residual): each
    call one launch, and a second call on the same inputs bit-identical (the
    splits are summed in rank order, and every split takes the same rstd)."""
    p = _packed(gen, 2, k, n, g, r)
    x = _randn(gen, m, k)
    lin = dataclasses.replace(p.layer(1), bias=_randn(gen, n, scale=0.5))
    lnw = (1.0 + _randn(gen, k, scale=0.1).float()).to(torch.bfloat16)
    kw = dict(lnw=lnw, residual=_randn(gen, m, n, scale=4.0), eps=1e-5)
    fused = qmm.qgemv_stacked_fused(x, p, 1, **kw)
    _close(fused, qmm.qgemv_stacked_fused_plain(_f32(x), _f32(p), 1, lnw=_f32(lnw),
                                                residual=_f32(kw["residual"]), eps=1e-5))
    for name, call in (("qgemv_stacked", lambda: qmm.qgemv_stacked(x, p, 1)),
                       ("qgemv_stacked_fused", lambda: qmm.qgemv_stacked_fused(x, p, 1, **kw)),
                       ("qgemv", lambda: qmm.qgemv(x, lin))):
        before = cuda_lib.launches[name]
        first = call()
        torch.cuda.synchronize()
        assert cuda_lib.launches[name] == before + 1, name
        assert torch.equal(call(), first), name
    _close(first, qmm.qgemv_plain(_f32(x), _f32(lin)))


# ---------------------------------------------------------------------------
# the probe kernels (P1-P4) against their plain versions; the decode
# attention kernels at a position read on the device; the decode loop as a
# CUDA graph against the eager loop


def test_probe_add_one(gen):
    from qeft_tpu_torch.probes import entry_overhead

    x = torch.randn(8, 128, generator=gen, device="cuda")
    before = cuda_lib.launches["add_one"]
    got = entry_overhead.add_one(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["add_one"] == before + 1
    assert torch.equal(got, x + 1.0)


def _probe_words(gen, k8, n):
    return torch.randint(-2**31, 2**31, (k8, n), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)


def _probe_scratch_zeroed(n, tiles):
    """The probes' workspace of ``n`` words and ``tiles`` tickets, as the
    kernels leave them: zeroed."""
    from qeft_tpu_torch.probes import common

    torch.cuda.synchronize()
    assert not common.workspace(torch.device("cuda"), n, torch.int32).any()
    assert not common.tickets(torch.device("cuda"), tiles).any()


@pytest.mark.parametrize("k8,n", [(1, 8), (8, 128), (37, 260), (9, 4100), (1377, 4096),
                                  (1376, 4096)])
def test_probe_column_sums_exact(gen, k8, n):
    """P2 bit-exact, twice in a row and bit-identical (each launch leaves its
    workspace and tickets zeroed), one launch a call; the ring's unpack_only
    at the script's shape and at ragged ones (a column tile that is not 512
    wide, a partial last stage)."""
    from qeft_tpu_torch.probes import common, dma

    qw = _probe_words(gen, k8, n)
    for name in ("dma_only", "unpack_only"):
        want = getattr(dma, f"{name}_plain")(qw)
        first = None
        for _ in range(2):
            before = cuda_lib.launches[name]
            got = getattr(dma, name)(qw)
            torch.cuda.synchronize()
            assert cuda_lib.launches[name] == before + 1, name
            assert torch.equal(got, want), name
            assert first is None or torch.equal(got, first), name
            first = got
    plan = dma.unpack_plan(k8, n, cuda_lib.sm_count("cuda"))
    _probe_scratch_zeroed(n, plan.tiles)
    _probe_scratch_zeroed(n, -(-n // 128))


def test_probe_unpack_only_past_the_lane_limit(gen):
    """Blocks of 2,300 word rows (264 column tiles leave one split each):
    the 16-bit lanes are widened twice a block and the sums stay exact; all
    words -1 (every nibble 15) is the largest a lane can take."""
    from qeft_tpu_torch.probes import common, dma

    k8, n = 2300, 512 * 264
    plan = dma.unpack_plan(k8, n, cuda_lib.sm_count("cuda"))
    assert plan.rows_per_block > 2 * dma.LANE_ROWS
    for qw in (torch.full((k8, n), -1, dtype=torch.int32, device="cuda"), _probe_words(gen, k8, n)):
        assert torch.equal(dma.unpack_only(qw), dma.unpack_only_plain(qw))
    _probe_scratch_zeroed(n, plan.tiles)


@pytest.mark.parametrize("bn", [256, 512, 1024])
@pytest.mark.parametrize("k8,n", [(8, 2048), (9, 2048), (37, 2048), (1376, 2048), (1377, 4096),
                                  (1376, 4096)])
def test_probe_dma_tile_exact(gen, k8, n, bn):
    """P3 bit-exact at each bn, at the script's shape and at ragged row
    counts; two calls bit-identical, one launch each."""
    from qeft_tpu_torch.probes import dma2

    qw = _probe_words(gen, k8, n)
    s = torch.randn(8, n, generator=gen, device="cuda")
    want = dma2.dma_tile_plain(qw, s)
    for _ in range(2):
        before = cuda_lib.launches["dma_tile"]
        got = dma2.dma_tile(qw, s, bn)
        torch.cuda.synchronize()
        assert cuda_lib.launches["dma_tile"] == before + 1
        assert torch.equal(got, want)


def test_probe_ring_wrappers_refuse(gen):
    from qeft_tpu_torch.probes import dma2

    qw = _probe_words(gen, 64, 1024)
    s = torch.zeros(8, 1024, device="cuda")
    with pytest.raises(ValueError):  # bn does not divide N
        dma2.dma_tile(qw, s, 384)
    with pytest.raises(ValueError):  # fewer than 8 word rows
        dma2.dma_tile(qw[:7], s, 256)


@pytest.mark.parametrize("k,n,g,bn", [(1024, 384, 128, 128), (11008, 4096, 128, 512),
                                      (4096, 12288, 128, 512)])
def test_probe_gemv_ablation(gen, k, n, g, bn):
    """Every P4 variant within 1e-2 of its output's scale, twice in a row."""
    from qeft_tpu_torch.probes import gemv_ablation as p4

    x, qw, s = p4.random_inputs(k, n, g, seed=k, device="cuda")
    for v in p4.VARIANTS:
        want = p4.gemv_ablation_plain(v, x, qw, s, bn)
        for _ in range(2):
            got = p4.gemv_ablation(v, x, qw, s, bn)
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            err = (got.float() - want.float()).abs().max().item()
            assert torch.isfinite(got.float()).all()
            assert err <= RTOL * want.float().abs().max().item(), (v, err)


def test_probe_gemv_ablation_bit_identical(gen):
    """P4's splits are summed in rank order through the cluster: two calls
    of every variant on the same inputs at the down shape are equal bit for
    bit, and each is one launch."""
    from qeft_tpu_torch.probes import gemv_ablation as p4

    x, qw, s = p4.random_inputs(11008, 4096, 128, seed=1, device="cuda")
    for v in p4.VARIANTS:
        before = cuda_lib.launches["gemv_ablation"]
        first = p4.gemv_ablation(v, x, qw, s, 512)
        torch.cuda.synchronize()
        assert cuda_lib.launches["gemv_ablation"] == before + 1, v
        assert torch.equal(p4.gemv_ablation(v, x, qw, s, 512), first), v


@pytest.mark.parametrize("pos", [0, 255, 256, 4095])
def test_decode_attention_at_a_device_position_is_bit_identical(gen, pos):
    """K4, K4q and K8 (bf16 and int8) with the position read on the device,
    launched over the same grid as a host int, give the host-int launch's
    output bit for bit."""
    b, h, hkv, d, s = 2, 8, 2, 128, 4096
    q, kn, vn = _randn(gen, b, h, d), _randn(gen, b, hkv, d), _randn(gen, b, hkv, d)
    at = torch.tensor(pos, device="cuda")
    k, v = _randn(gen, b, hkv, s, d), _randn(gen, b, hkv, s, d)
    (kc, ks), (vc, vs) = _int8_cache(gen, b, hkv, s, d), _int8_cache(gen, b, hkv, s, d)
    for kw, kk, vv in (({}, k, v), ({"k_scale": ks, "v_scale": vs}, kc, vc)):
        assert torch.equal(attention.decode_attention(q, kk, vv, at, **kw),
                           attention.decode_attention(q, kk, vv, pos, **kw))
        stacked = {n: t[None].expand(2, *t.shape).contiguous() for n, t in kw.items()}
        sk, sv = (t[None].expand(2, *t.shape).contiguous() for t in (kk, vv))
        assert torch.equal(attention.decode_attention_stacked(q, sk, sv, 1, at, kn, vn, **stacked),
                           attention.decode_attention_stacked(q, sk, sv, 1, pos, kn, vn, **stacked))


def _graph_models():
    """(label, family, config, packed model on the card, QEFT_ATTN_STACKED,
    int8 cache): two layers each."""
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.models.opt import OPT_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    llama = dataclasses.replace(LLAMA_PRESETS["tiny-v2"], num_layers=2)
    opt = dataclasses.replace(OPT_PRESETS["opt-125m"], num_layers=2)
    lp = build_packed_model(llama, seed=0, g=128, r=16, device="cuda")
    op = build_packed_model(opt, seed=0, g=128, r=16, device="cuda", family="opt")
    return [("llama bf16", "llama", llama, lp, "0", False), ("llama int8", "llama", llama, lp, "0", True),
            ("llama stacked", "llama", llama, lp, "1", False),
            ("llama stacked int8", "llama", llama, lp, "1", True),
            ("opt-125m", "opt", opt, op, "0", False)]


def test_graph_generate_gives_the_eager_loop_tokens(gen, monkeypatch):
    """``generate`` on the card replays one captured step: greedy tokens
    equal to the eager loop's, and the launches counted as if each step had
    run eagerly."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api

    for label, family, cfg, params, stacked, int8 in _graph_models():
        monkeypatch.setenv("QEFT_ATTN_STACKED", stacked)
        api = get_model_api(family)
        prompt = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen, device="cuda")
        out = {}
        for graph in (True, False):
            cache = api.init_cache(cfg, 2, 40, dtype=torch.bfloat16, device="cuda", quantized=int8)
            cuda_lib.reset_launches()
            out[graph], _ = generate(params, prompt, cache, cfg, 30, api=api, graph=graph)
            torch.cuda.synchronize()
            out[graph, "launches"] = dict(cuda_lib.launches)
        assert torch.equal(out[True], out[False]), label
        assert out[True, "launches"] == out[False, "launches"], label


def test_graph_generate_samples_fresh_numbers_each_replay(gen):
    from qeft_tpu_torch.generate import SampleConfig, generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    cfg = dataclasses.replace(LLAMA_PRESETS["tiny-v2"], num_layers=2)
    params = build_packed_model(cfg, seed=0, g=128, r=16, device="cuda")
    api = get_model_api("llama")
    prompt = torch.randint(0, cfg.vocab_size, (1, 9), generator=gen, device="cuda")
    sc = SampleConfig(greedy=False, temperature=2.0)
    toks, _ = generate(params, prompt, api.init_cache(cfg, 1, 80, device="cuda"), cfg, 64,
                       sc=sc, api=api)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert len(set(toks[0, 2:].tolist())) > 8  # replays do not repeat one draw
    again, _ = generate(params, prompt, api.init_cache(cfg, 1, 80, device="cuda"), cfg, 64,
                        sc=sc, api=api)
    assert torch.equal(toks, again)  # seed 0 by default: the same draws from the same state


@pytest.mark.parametrize("s", [2048, 4096])
def test_flash_at_calibration_and_eval_lengths(gen, s):
    """K3 over a whole window of Llama-2-7B heads at the calibration length
    (2048) and the default eval window (4096); the f32 entry of the
    pipeline's calibration forwards rounds q/k/v to bf16 for the kernel and
    returns f32."""
    q = _randn(gen, 1, s, 32, 128)
    k, v = _randn(gen, 1, 32, s, 128), _randn(gen, 1, 32, s, 128)
    want = flash.flash_window_attention_plain(_f32(q), _f32(k), _f32(v), 0)
    _close(flash.flash_window_attention(q, k, v, 0), want)
    got = flash.flash_window_attention_any(_f32(q), _f32(k), _f32(v), 0)
    assert got.dtype == torch.float32
    _close(got.to(torch.bfloat16), want)


@pytest.mark.parametrize("m", [1, 8])
def test_packed_lm_head_decode_matvec(gen, m):
    """K5 on the round-to-nearest packed Llama-2-7B head (4096 -> 32000, g =
    128, no weak columns), through the serving linear: one launch a call."""
    from qeft_tpu_torch.pipeline import rtn_pack_linear

    head = rtn_pack_linear(torch.randn(4096, 32000, generator=gen, device="cuda") * 0.02)
    x = _randn(gen, m, 4096)
    cuda_lib.reset_launches()
    got = qlinear_apply(x, head)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launches) == {"qgemv": 1}
    _close(got, qmm.qgemv_plain(_f32(x), _f32(head)))


def test_gptq_on_the_card_matches_the_cpu(gen):
    """GPTQ-OWQ of one 4096 x 4096 linear (w4, g = 128, MSE grid, r = 128)
    on the card against the port's CPU run on the same weights and Hessian:
    at most 0.5 % of the levels (code - zero) differ, at most 0.05 % by more
    than one, and the reconstruction error tr((W - Q) H (W - Q)^T) within 1
    %.  The two devices sum in other orders, a flipped rounding propagates
    along its row through the error feedback and the group re-fits, and at
    4096 columns a few such cascades move a level by two or more."""
    from qeft_tpu_torch.quant import gptq, outliers
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    col = torch.exp(torch.randn(4096, generator=gen, device="cuda"))
    x = torch.randn(2048, 4096, generator=gen, device="cuda") * col
    w = torch.randn(4096, 4096, generator=gen, device="cuda") * 4096 ** -0.5
    h = gptq.hessian_from_inputs(x).cpu()
    spec = QuantSpec(bits=4, sym=False, mse=True, group_size=128)
    ids, out_ids = outliers.hessian_sort_ids(torch.diagonal(h), 128)
    runs = {dev: gptq.gptq_quantize(w.to(dev), h.to(dev), spec, ids.to(dev), out_ids.to(dev))
            for dev in ("cuda", "cpu")}
    perm = ids.long()

    def levels(r):
        s = r.scale_group.cpu().double().repeat_interleave(128, dim=1)
        return torch.round(r.w_fake.cpu().double()[:, perm] / s)[:, : 4096 - 128]

    diff = (levels(runs["cuda"]) - levels(runs["cpu"])).abs()
    assert (diff > 0).double().mean().item() <= 0.005
    assert (diff > 1).double().mean().item() <= 0.0005
    errs = []
    for r in runs.values():
        d = (w.cpu() - r.w_fake.cpu()).double()
        errs.append(torch.trace(d @ h.double() @ d.t()).item())
    assert abs(errs[0] - errs[1]) <= 1e-2 * errs[1], errs


# the family linears' (K, N, g) at the training and prefill shapes: Falcon-7b's
# qkv and fc1 (K = 4544, 71 groups of 64: 35.5 of K7's 128-column tiles), Phi-2's
# fc1, OPT-6.7B's fc2 (K = 16384)
FAMILY_SHAPES = [(4544, 4672, 64), (4544, 18176, 64), (2560, 10240, 128), (16384, 4096, 128)]


@pytest.mark.parametrize("m", [64, 2048])
@pytest.mark.parametrize("k,n,g", FAMILY_SHAPES)
def test_qgemm_and_qgemm_t_at_the_family_shapes(gen, m, k, n, g):
    """K2 (the forward, with the weak-column slab) and K7 (``dx``, with the
    weak-column addend) at the OPT, Phi and Falcon shapes WCT and the
    prefill run them, against the plain versions; one launch a call."""
    p = _packed(gen, 1, k, n, g, 128).layer(0)
    x = _randn(gen, m, k)
    before = dict(cuda_lib.launches)
    got = qmm.qgemm(x, p)
    gy = _randn(gen, m, n)
    tail = torch.randn(m, 128, generator=gen, device="cuda")
    got_t = qmm.qgemm_t(gy, dataclasses.replace(p, oweight=None), tail)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemm"] == before.get("qgemm", 0) + 1
    assert cuda_lib.launches["qgemm_t"] == before.get("qgemm_t", 0) + 1
    _close(got, qmm.qgemm_plain(_f32(x), _f32(p)))
    _close(got_t, qmm.qgemm_t_plain(_f32(gy), _f32(dataclasses.replace(p, oweight=None)), tail))


def test_autograd_linear_with_a_bias_and_reorder_ids_at_training_rows(gen):
    """The training linear of a family packed without the global reorder at
    2048 rows (4 x 512, run_finetune's batch): the ``reorder_ids`` gather
    before K2, the bias after it, K7 for ``dx``; values and the gradients of
    x, oweight and bias against autograd through the plain version in f32."""
    k, n, m = 4544, 4672, 2048
    p = _packed(gen, 1, k, n, 64, 128).layer(0)
    ids = torch.randperm(k, generator=gen, device="cuda").to(torch.int32)
    b = (torch.randn(n, generator=gen, device="cuda") * 0.5).to(torch.bfloat16).requires_grad_()
    ow = (torch.randn(128, n, generator=gen, device="cuda") * 0.02).requires_grad_()
    x = _randn(gen, m, k)
    gy = _randn(gen, m, n)
    xk = x.clone().requires_grad_()
    before = dict(cuda_lib.launches)
    y = qlinear_apply(xk, dataclasses.replace(p, oweight=ow, bias=b, reorder_ids=ids))
    y.backward(gy)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemm"] == before.get("qgemm", 0) + 1
    assert cuda_lib.launches["qgemm_t"] == before.get("qgemm_t", 0) + 1
    x32 = x.float().requires_grad_()
    ow32, b32 = ow.detach().clone().requires_grad_(), b.detach().float().requires_grad_()
    y32 = qmm.qgemm_plain(x32.index_select(-1, ids.long()),
                          dataclasses.replace(_f32(p), oweight=ow32, bias=b32))
    y32.backward(gy.float())
    _close(y, y32.detach())
    _close(xk.grad, x32.grad)
    _close(b.grad, b32.grad)
    err = (ow.grad - ow32.grad).abs().max().item()
    assert err <= RTOL * ow32.grad.abs().max().item(), err


def test_gptq_of_a_falcon_width_block_on_the_card_matches_the_cpu(gen):
    """One Falcon-7b block at full width (4544, 71 heads, multi-query; fc2
    18,176 columns) quantized by the pipeline on the card and on the CPU
    from the same weights and calibration tokens (GPTQ-OWQ w4, g = 64,
    min-max, r = 128, percdamp 1.0, per-linear weak columns): the same weak
    sets, at most 0.5 % of the levels differ (compared where a group's
    re-fit parameters agree: a flipped rounding moves the later groups'
    min and max), and each linear's fake weight as far from the dense one,
    in the Hessian's norm, within 1 %."""
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.models.falcon import FALCON_PRESETS, init_params
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    cfg = dataclasses.replace(FALCON_PRESETS["falcon-7b"], num_layers=1, dtype=torch.float32)
    meta = get_model_meta("falcon")
    dense = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    calib = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device="cuda").cpu().numpy()
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=False, group_size=64),
                           target_rank=128, nsamples=4, percdamp=1.0, reorder=False)
    runs = {}
    for dev in ("cuda", "cpu"):
        tree = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                    {n: t.to(dev) for n, t in v.items()}) for k, v in dense.items()}
        runs[dev] = pl.quantize_model(tree, calib, cfg, meta, args)
    x = pl._embed_tokens(dense, torch.as_tensor(calib, device="cuda"), cfg, meta)
    blk = {k: v[0] for k, v in dense["layers"].items()}
    _, hs = pl.block_hessians(blk, x, cfg, meta)
    differ = total = 0
    for name in meta.all_linears:
        (fc, sc), (ff, sf) = ((runs[d][0]["layers"][name][0].cpu().double(),
                               runs[d][1][(0, name)]) for d in ("cuda", "cpu"))
        assert torch.equal(sc.out_ids.cpu(), sf.out_ids)
        ids = pl.sparse_to_dense_ids(sf.out_ids, fc.shape[0]).long()
        keep = fc.shape[0] - sf.out_ids.shape[0]
        s_c, s_f = sc.scale_group.cpu().double(), sf.scale_group.double()
        rep = fc.shape[0] // s_c.shape[1]
        same = ((s_c - s_f).abs() <= 1e-6 * s_f.abs()).t().repeat_interleave(rep, 0)[:keep]
        d = (torch.round(fc[ids] / s_c.t().repeat_interleave(rep, 0))
             - torch.round(ff[ids] / s_f.t().repeat_interleave(rep, 0)))[:keep].abs()
        assert d[same].max().item() <= 1, name
        differ += int((d > 0).sum())
        total += d.numel()
        h = (hs[pl._stage_of(meta, name)] * (2.0 / 4)).cpu().double()
        w = blk[name].cpu().double()
        errs = [torch.trace((w - f).t() @ h @ (w - f)).item() for f in (fc, ff)]
        assert abs(errs[0] - errs[1]) <= 1e-2 * errs[1], (name, errs)
    assert differ <= 0.005 * total, (differ, total)


@pytest.mark.parametrize("ic", [4096, 11008])
def test_captured_gptq_equals_the_eager_run(gen, ic):
    """GPTQ-OWQ of a linear of 4096 or 11,008 columns (w4, g = 128, MSE
    grid, r = 128), its column blocks as replays of captured programs and
    eagerly (``graph=False``): fake weights, scales and zeros bit-identical
    (the same kernels in the same order); a second linear of the same
    shape replays the programs the first captured, also bit-identical."""
    from qeft_tpu_torch.quant import gptq, outliers
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    spec = QuantSpec(bits=4, sym=False, mse=True, group_size=128)
    col = torch.exp(torch.randn(ic, generator=gen, device="cuda"))
    h = gptq.hessian_from_inputs(torch.randn(1024, ic, generator=gen, device="cuda") * col)
    ids, out_ids = outliers.hessian_sort_ids(torch.diagonal(h), 128)
    loops = gptq.ColumnLoops()
    for _ in range(2):
        w = torch.randn(4096, ic, generator=gen, device="cuda") * ic ** -0.5
        graph = gptq.gptq_quantize(w, h, spec, ids, out_ids, loops=loops)
        eager = gptq.gptq_quantize(w, h, spec, ids, out_ids, graph=False)
        torch.cuda.synchronize()
        for field in ("w_fake", "scale_group", "zero_group"):
            assert torch.equal(getattr(graph, field), getattr(eager, field)), field
    (loop,) = loops.values()
    blocks = -(-(ic - 128) // 128)
    assert len(loop.graphs) == 1 and loop.replays == 2 * blocks - 1


def test_streamed_quantization_on_the_card_equals_the_resident_one(gen):
    """A 2-layer model of width 512 (tiny-v2) in f32, held on the host and
    streamed to the card block by block, against the same tree on the card:
    the weak set, the fake tree, every quantizer state and the packed tree
    bit-identical."""
    from qeft_tpu_torch import checkpoint as ckpt
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.extract_outidx import host_init_params
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    cfg = dataclasses.replace(llama.LLAMA_PRESETS["tiny-v2"], num_layers=2)
    meta = get_model_meta("llama")
    host = host_init_params(llama, cfg, 0, torch.float32)
    card = ckpt.tree_map(lambda t: t.cuda(), host)
    calib = torch.randint(0, cfg.vocab_size, (8, 256), generator=gen, device="cuda").cpu().numpy()
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=True, group_size=128),
                           target_rank=32, nsamples=8, no_frob_norm=True)
    runs = {}
    for label, tree, device in (("streamed", host, "cuda"), ("resident", card, None)):
        outidx, _ = pl.extract_global_outidx(tree, calib, cfg, meta, args, device=device)
        fake, states = pl.quantize_model(tree, calib, cfg, meta, args, outidx, device=device)
        packed = pl.pack_model(fake, states, cfg, meta, fuse_stages=True, device=device)
        runs[label] = (outidx, ckpt.to_flat(fake), states, ckpt.to_flat(packed))
    (o_s, f_s, s_s, p_s), (o_r, f_r, s_r, p_r) = runs["streamed"], runs["resident"]
    assert (o_s == o_r).all()
    for got, want in ((f_s, f_r), (p_s, p_r)):
        assert sorted(got) == sorted(want)
        assert all((got[k] == want[k]).all() for k in want)
    for key, st in s_r.items():
        for field in ("scale_group", "zero_group", "out_ids"):
            assert torch.equal(getattr(s_s[key], field), getattr(st, field).cpu()), key


def test_an_imported_reference_checkpoint_serves_on_the_card(gen):
    """A random packed 2-layer model of width 512 written in the reference's
    format, imported on the card: codes bit-exact, and ``generate`` through
    the graph (K1-K4) gives the source model's greedy tokens."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.import_reference import import_reference_packed
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.pipeline import fuse_packed_stages
    from qeft_tpu_torch.testing import build_packed_model, write_reference_packed

    cfg = dataclasses.replace(llama.LLAMA_PRESETS["tiny-v2"], num_layers=2)
    src = build_packed_model(cfg, seed=1, g=128, r=32, device="cuda")
    got, family = import_reference_packed("unused.pth", cfg,
                                          ckpt=write_reference_packed(src, cfg), device="cuda")
    got = fuse_packed_stages(got, get_model_meta(family))
    for name in ("qkv", "o", "upgate", "down"):
        assert torch.equal(got["layers"][name].qweight, src["layers"][name].qweight)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device="cuda")
    tokens = []
    for params in (src, got):
        cache = llama.init_kv_cache(cfg, 1, 48, device="cuda")
        tokens.append(generate(params, prompt, cache, cfg, 32, device="cuda")[0])
    assert torch.equal(tokens[0], tokens[1])


# the per-rank stage shapes of tensor-parallel serving: Llama-2-7B at tp 2
# and Llama-2-70B width at tp 4 (column-parallel qkv / upgate, K1 with its
# norm and an N-sharded slab; row-parallel o / down, K6 without a slab --
# 7B's down shard is 43 groups, an odd count)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 11008), (8192, 2560), (8192, 14336)])
def test_fused_decode_matvec_at_tp_shard_shapes(gen, m, k, n):
    p = _packed(gen, 2, k, n, 128, 128)
    x = _randn(gen, m, k)
    lnw = (1.0 + _randn(gen, k, scale=0.1).float()).to(torch.bfloat16)
    got = qmm.qgemv_stacked_fused(x, p, 1, lnw=lnw, eps=1e-5)
    _close(got, qmm.qgemv_stacked_fused_plain(_f32(x), _f32(p), 1, lnw=_f32(lnw), eps=1e-5))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(2048, 4096), (5504, 4096), (2048, 8192), (7168, 8192)])
def test_plain_decode_matvec_at_tp_shard_shapes_without_a_slab(gen, m, k, n):
    p = _packed(gen, 2, k, n, 128, 0)
    x = _randn(gen, m, k)
    got = qmm.qgemv_stacked(x, p, 1)
    _close(got, qmm.qgemv_stacked_plain(_f32(x), _f32(p), 1))


def test_tp_decode_step_of_two_ranks_on_the_card(gen):
    """Two ranks sharing the card (Gloo through host memory) run the tp
    prefill and decode step of a random packed 2-layer model of width 1024
    through K2/K3 and K1/K6/K4; the step's logits within 2e-2 of the logit
    scale of the single-device step's (bf16 partial sums are rounded before
    the psum)."""
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.parallel.multihost import launch_ranks
    from qeft_tpu_torch.testing import build_packed_model
    import torch_ranks  # tests/ is on the path (pytest's rootdir insertion), not a package

    cfg = dataclasses.replace(llama.LLAMA_PRESETS["llama2-7b"], hidden_size=1024,
                              intermediate_size=2816, num_layers=2, num_heads=8,
                              num_kv_heads=8, vocab_size=4096)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device="cuda")
    params = build_packed_model(cfg, seed=3, device="cuda")
    cache = llama.init_kv_cache(cfg, 1, 24, device="cuda")
    with torch.inference_mode():
        logits, cache = llama.llama_prefill(params, prompt, cache, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        want, _ = llama.llama_decode_step(params, tok, cache, 16, cfg)
    want = want.float().cpu()
    ranks = launch_ranks(torch_ranks.tp_decode_on_card, 2, "cuda", cfg, 3, prompt.cpu(), 2)
    for res in ranks:
        assert res["staged"]
        got = torch.from_numpy(res["logits"])
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
        assert res["prefill"]["qgemm"] == 4 * cfg.num_layers
        assert res["prefill"]["flash_window_attention"] == cfg.num_layers
        assert res["decode"] == {"qgemv_stacked_fused": 2 * cfg.num_layers,
                                 "qgemv_stacked": 2 * cfg.num_layers,
                                 "decode_attention": cfg.num_layers}


# the per-rank stage shapes of tensor-parallel WCT at Llama-2-7B, tp 2, 512
# rows a rank: qkv and upgate column-parallel with their N-sharded slabs,
# o and down row-parallel (the last rank's slab; down's 43 groups)
TP_TRAIN_SHAPES = [(4096, 6144, 128), (4096, 11008, 128), (2048, 4096, 0), (5504, 4096, 128)]


@pytest.mark.parametrize("k,n,r", TP_TRAIN_SHAPES)
def test_qgemm_and_qgemm_t_at_the_tp_train_shard_shapes(gen, k, n, r):
    from qeft_tpu_torch.ops.qlinear import matmul_f32

    p = _packed(gen, 2, k, n, 128, r).layer(1)
    x, gy = _randn(gen, 512, k), _randn(gen, 512, n)
    _close(qmm.qgemm(x, p), qmm.qgemm_plain(_f32(x), _f32(p)))
    tail = matmul_f32(gy, p.oweight.t()) if r else None
    _close(qmm.qgemm_t(gy, p, tail), qmm.qgemm_t_plain(_f32(gy), _f32(p), tail))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("kernel", ["K1", "K6", "K5"])
def test_bf16w_variant_matches_its_plain_version(gen, kernel, m):
    """``QEFT_GEMV_F32W=0``: K1, K6 and K5 launch their bf16w entry point
    (weights code x scale rounded to bf16 before the product), which agrees
    with its plain version on the same bf16 inputs, at a 7B stage shape;
    and, as the bound is ordinary bf16 noise, which the weights' rounding
    also is, its mean |diff| from the plain version is under a quarter of
    the default kernel's (what a kernel that ignored the flag would give)."""
    from qeft_tpu_torch import env

    k, n = (4096, 12288) if kernel == "K1" else (11008, 4096)
    p = _packed(gen, 2, k, n, 128, 128)
    x = _randn(gen, m, k)
    lnw = (1.0 + _randn(gen, k, scale=0.1).float()).to(torch.bfloat16)
    name = {"K1": "qgemv_stacked_fused", "K6": "qgemv_stacked", "K5": "qgemv"}[kernel]
    cpu = p.map(torch.Tensor.cpu)

    def run(x, p, lnw):  # the wrapper (CUDA tensors) or its plain version (CPU ones)
        if kernel == "K1":
            return qmm.qgemv_stacked_fused(x, p, 1, lnw=lnw, eps=1e-5)
        if kernel == "K6":
            return qmm.qgemv_stacked(x, p, 1)
        return qmm.qgemv(x, p.layer(1))

    with env.setting(QEFT_GEMV_F32W="0"):
        before = cuda_lib.launches[name + "_bf16w"]
        got = run(x, p, lnw)
        want = run(x.cpu(), cpu, lnw.cpu())  # bf16 inputs, the products in f32, one rounding
        torch.cuda.synchronize()
        assert cuda_lib.launches[name + "_bf16w"] == before + 1
    want = want.float().cuda()
    _close(got, want)
    default = run(x, p, lnw)  # the default keeps the codes exact
    assert not torch.equal(got, default)
    err = (got.float() - want).abs().mean().item()
    assert err < 0.25 * (default.float() - want).abs().mean().item(), err


def test_tp_train_step_of_two_ranks_on_the_card(gen):
    """Two ranks sharing the card run the tensor-parallel loss and slab
    gradients of a random packed 2-layer model of width 1024 (K2 forward and
    its recomputation, K7 for dx); against the single-device ``wct_loss``
    backward on the same weights: the loss within 1e-2 relative, each slab
    gradient within 0.1 of its scale (both bf16 kernel paths; the tp one
    rounds its partial sums to bf16 before each psum)."""
    import numpy as np

    from qeft_tpu_torch.finetune import split_wct, wct_loss
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.parallel.multihost import launch_ranks
    from qeft_tpu_torch.parallel.tp_forward import _interleave_perm
    from qeft_tpu_torch.testing import build_packed_model
    import torch_ranks

    cfg = dataclasses.replace(llama.LLAMA_PRESETS["llama2-7b"], hidden_size=1024,
                              intermediate_size=2816, num_layers=2, num_heads=8,
                              num_kv_heads=8, vocab_size=4096)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device="cuda")
    ow, frozen = split_wct(build_packed_model(cfg, seed=3, device="cuda"))
    loss = wct_loss(ow, frozen, ids, ids, cfg, remat=True)
    loss.backward()
    want = {k: torch.stack([t.grad for t in v]).float().cpu().numpy() for k, v in ow.items()}
    ranks = launch_ranks(torch_ranks.tp_train_on_card, 2, "cuda", cfg, 3, ids.cpu(), 2)
    perms = {"qkv": _interleave_perm([1024, 1024, 1024], 2),
             "upgate": _interleave_perm([2816, 2816], 2)}
    for res in ranks:
        assert abs(res["loss"] - loss.item()) <= 1e-2 * loss.item()
        assert res["launches"] == {"qgemm": 8 * cfg.num_layers, "qgemm_t": 4 * cfg.num_layers - 1}
    for name, w in want.items():
        if name in perms:
            got = np.concatenate([r["grads"][name] for r in ranks], -1)[..., np.argsort(perms[name])]
        else:
            got = ranks[0]["grads"][name]
        assert np.abs(got - w).max() <= 0.1 * np.abs(w).max(), name
