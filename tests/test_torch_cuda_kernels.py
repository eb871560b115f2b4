"""The CUDA kernels of ``qeft_tpu_torch/csrc`` against their plain PyTorch
versions on the card, at small shapes that reach every branch: 1..8 decode
rows, 86 quantization groups, no weak columns, the gemma norm, GEMM rows past
one tile, GQA, window offsets and per-sequence positions, split decode
chunks; the transposed GEMM (K7) at 1 to 2048 rows, with and without the
weak-column addend, and the autograd linear's gradients; the plain decode
matvec (K6) at 1..8 rows; int8 decode attention (K4q) and the stacked-cache
decode attention (K8, bf16 and int8, slots >= pos poisoned); the unstacked
decode matvec (K5) at the OPT, Phi, Bloom and Falcon shapes with and without
a bias, and the autograd linear's K5 / K2 dispatch with ``reorder_ids``; K1
and K6 at eight rows of K up to 28,672 (staged in bands); and the wrappers'
refusals.  They need an NVIDIA GPU and ``nvcc`` and skip elsewhere:

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


@pytest.mark.parametrize("m", [9, 64, 130])
@pytest.mark.parametrize("k,n,g,r,residual", [
    (512, 96, 128, 16, True),
    (768, 200, 64, 24, False),
    (1024, 128, 128, 0, True),
])
def test_qgemm(gen, m, k, n, g, r, residual):
    p = _packed(gen, 1, k, n, g, r).layer(0)
    x = _randn(gen, m, k)
    res = _randn(gen, m, n, scale=4.0) if residual else None
    got = qmm.qgemm(x, p, residual=res)
    _close(got, qmm.qgemm_plain(_f32(x), _f32(p), residual=_f32(res)))


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


@pytest.mark.parametrize("pos", [0, 1, 255, 256, 700, 4095])
@pytest.mark.parametrize("h,hkv,d", [(8, 8, 128), (8, 2, 128), (4, 4, 64)])
def test_decode_attention(gen, pos, h, hkv, d):
    q = _randn(gen, 2, h, d)
    k, v = _randn(gen, 2, hkv, 4096, d), _randn(gen, 2, hkv, 4096, d)
    got = attention.decode_attention(q, k, v, pos)
    _close(got, attention.decode_attention_plain(_f32(q), _f32(k), _f32(v), pos))


@pytest.mark.parametrize("m", [1, 9, 64, 100, 2048])
@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("r", [0, 8, 128])
def test_qgemm_t(gen, m, g, r):
    k, n = 1024, 200  # 16 or 8 groups; N not a multiple of the 64-column chunk
    p = _packed(gen, 1, k, n, g, 0).layer(0)
    gy = _randn(gen, m, n)
    tail = torch.randn(m, r, generator=gen, device="cuda") if r else None
    before = cuda_lib.launches["qgemm_t"]
    got = qmm.qgemm_t(gy, p, tail)
    torch.cuda.synchronize()
    assert cuda_lib.launches["qgemm_t"] == before + 1
    _close(got, qmm.qgemm_t_plain(_f32(gy), _f32(p), tail))


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
    with pytest.raises(RuntimeError):  # group size 8: the kernel takes multiples of 16
        qmm.qgemm_t(_randn(gen, 4, 64), _packed(gen, 1, 256, 64, 8, 0).layer(0))
    with pytest.raises(IndexError):
        attention.decode_attention(_randn(gen, 1, 4, 64), _randn(gen, 1, 4, 8, 64),
                                   _randn(gen, 1, 4, 8, 64), 8)


@pytest.mark.parametrize("m", [1, 4, 8])
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
    more than the 227 KB of shared memory a block may have: the row is
    staged in bands of groups."""
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
@pytest.mark.parametrize("m", [1, 3, 8])
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


@pytest.mark.parametrize("k8,n", [(8, 128), (37, 260), (1376, 4096)])
def test_probe_column_sums_exact(gen, k8, n):
    """P2 bit-exact, twice in a row (each launch leaves its workspace zeroed)."""
    from qeft_tpu_torch.probes import dma

    qw = torch.randint(-2**31, 2**31, (k8, n), generator=gen, device="cuda",
                       dtype=torch.int64).to(torch.int32)
    for name in ("dma_only", "unpack_only"):
        want = getattr(dma, f"{name}_plain")(qw)
        for _ in range(2):
            assert torch.equal(getattr(dma, name)(qw), want), name


@pytest.mark.parametrize("bn", [256, 512, 1024])
@pytest.mark.parametrize("k8", [8, 37, 1376])
def test_probe_dma_tile_exact(gen, k8, bn):
    from qeft_tpu_torch.probes import dma2

    qw = torch.randint(-2**31, 2**31, (k8, 2048), generator=gen, device="cuda",
                       dtype=torch.int64).to(torch.int32)
    s = torch.randn(8, 2048, generator=gen, device="cuda")
    before = cuda_lib.launches["dma_tile"]
    got = dma2.dma_tile(qw, s, bn)
    torch.cuda.synchronize()
    assert cuda_lib.launches["dma_tile"] == before + 1
    assert torch.equal(got, dma2.dma_tile_plain(qw, s))


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


@pytest.mark.parametrize("pos", [0, 255, 256, 4095])
def test_decode_attention_at_a_device_position_is_bit_identical(gen, pos):
    """K4, K4q and K8 (bf16 and int8) with the position read on the device,
    launched over the whole 4096-slot cache's splits, give the host-int
    launch's output bit for bit."""
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
