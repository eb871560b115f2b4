"""The bulk-copy ring of P2's `unpack_only` and P3 (`dma_tile`) on the CPU.

`stream_plan` is the grid and ring both kernels take (``probes/common.py``):
every word row of every column tile in exactly one block and one stage, a
block's shared memory within 227 KB, the bytes in flight an SM the same at
every bn, and a ValueError on what the kernels do not take.
`unpack_only_emulated` is the new kernel's arithmetic in its order (nibble
pairs summed as integers in 16-bit lanes, widened before they can overflow,
the blocks' totals added): exact against the plain version and against the
script's Pallas kernel in interpret mode, on random words (the top bit set
in about half), on all-ones words (every nibble 15, the most a lane takes),
and past the lane limit, where a widening left out loses the carries.  The
SASS reader that counts the hot loop's instructions a word runs on a
listing written here.  Tolerance: exact (integers).
"""

import numpy as np
import pytest
import torch

from qeft_tpu_torch.probes import common, dma, sass
from tests.test_torch_probes import PL_INTERPRET, _script_defs, _words
from tests.torch_parity import f32  # noqa: F401  (one torch thread per worker)

SMS = 132  # the H100's SMs


def _script_unpack(qw, bn):
    ns = _script_defs("dma_probe.py", {"unpack_kernel", "unpack_only"},
                      K=8 * qw.shape[0], N=qw.shape[1], BN=bn)
    ns["pl"] = PL_INTERPRET
    import jax.numpy as jnp

    return np.asarray(ns["unpack_only"](jnp.asarray(qw)))


@pytest.mark.parametrize("k8", [1, 7, 8, 1376])
def test_unpack_emulation_is_exact(k8):
    n = 512
    qw = _words(k8, n, seed=k8)
    assert (qw < 0).any() or k8 == 1
    want = dma.unpack_only_plain(torch.from_numpy(qw)).numpy()
    got = dma.unpack_only_emulated(qw, SMS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _script_unpack(qw, 128))


def test_unpack_emulation_on_all_ones():
    qw = np.full((37, 260), -1, dtype=np.int32)
    got = dma.unpack_only_emulated(qw, SMS)
    np.testing.assert_array_equal(got, np.full((8, 260), 37 * 8 * 15, dtype=np.float32))
    np.testing.assert_array_equal(got, _script_unpack(qw, 260))


@pytest.mark.parametrize("fill", [None, -1])
def test_unpack_emulation_past_the_lane_limit(monkeypatch, fill):
    """One SM: one block of all 4,500 word rows, its lanes widened four
    times; with the widening pushed past the block the all-ones sums lose
    their carries."""
    k8, n = 4500, 64
    plan = dma.unpack_plan(k8, n, 1)
    assert plan.rows_per_block > 2 * dma.LANE_ROWS
    qw = _words(k8, n, seed=3) if fill is None else np.full((k8, n), fill, dtype=np.int32)
    want = dma.unpack_only_plain(torch.from_numpy(qw)).numpy()
    np.testing.assert_array_equal(dma.unpack_only_emulated(qw, 1), want)
    np.testing.assert_array_equal(_script_unpack(qw, 64), want)
    if fill == -1:
        monkeypatch.setattr(dma, "LANE_ROWS", plan.rows_per_block)
        assert not np.array_equal(dma.unpack_only_emulated(qw, 1), want)


@pytest.mark.parametrize("n,bn", [(4096, 512), (4100, 164), (260, 260), (8, 8), (1024, 512)])
def test_unpack_bn(n, bn):
    assert dma.unpack_bn(n) == bn


@pytest.mark.parametrize("bn", [256, 512, 1024])
@pytest.mark.parametrize("k8", [8, 9, 1376, 1377])
@pytest.mark.parametrize("n", [1024, 4096])
def test_stream_plan_covers_every_row_once(k8, n, bn):
    plan = common.stream_plan(k8, n, bn, SMS)
    seen = np.zeros((k8, n // bn), dtype=np.int64)
    for c0, r0, r1 in plan.blocks():
        assert c0 % bn == 0 and 0 <= r0 < r1 <= k8 and r1 - r0 <= plan.rows_per_block
        stages = plan.stages_of(r0, r1)
        assert [r for r, _ in stages] == list(range(r0, r1, plan.stage_rows))
        for r, rows in stages:
            assert 1 <= rows <= plan.stage_rows
            seen[r:r + rows, c0 // bn] += 1
    assert (seen == 1).all()
    assert plan.tiles * plan.splits == len(list(plan.blocks()))
    assert plan.smem <= common.SMEM_LIMIT
    assert plan.stage_rows * plan.row_bytes <= common.STAGE_BYTES_LIMIT
    assert plan.tiles * plan.splits <= max(plan.tiles, plan.blocks_per_sm * SMS)
    if k8 >= 1376:  # Little's law: ~3 TB/s x 1 us over 132 SMs
        assert plan.in_flight_per_sm(SMS) >= 24 << 10


def test_stream_plan_in_flight_does_not_depend_on_bn():
    per_sm = {bn: common.stream_plan(1376, 4096, bn, SMS).in_flight_per_sm(SMS)
              for bn in (256, 512, 1024)}
    assert len(set(per_sm.values())) == 1, per_sm
    smem = {bn: common.stream_plan(1376, 4096, bn, SMS).smem for bn in (256, 512, 1024)}
    assert len(set(smem.values())) == 1, smem


@pytest.mark.parametrize("k8,n,bn", [(64, 1024, 384), (64, 1024, 6), (64, 1024, 0),
                                     (0, 1024, 256), (8, 1 << 16, 1 << 16)])
def test_stream_plan_refuses(k8, n, bn):
    with pytest.raises(ValueError):
        common.stream_plan(k8, n, bn, SMS)


LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115dma_tile_kernelEPKiPKfPfiiiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
        /*0010*/               @P0 BRA 0x0 ;                  /* 0x0000000000007947 */
		Function : _ZN12_GLOBAL__N_118unpack_ring_kernelEPKiPfPjS3_iiiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3], RZ ;
        /*0020*/              @!P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0030*/                   LDS.128 R4, [R2] ;
        /*0040*/                   LDS.128 R8, [R2+0x800] ;
        /*0050*/                   LOP3.LUT R12, R4, 0xf000f, RZ, 0xc0, !PT ;
        /*0060*/                   SHF.R.U32.HI R13, RZ, 0x4, R4 ;
        /*0070*/                   NOP ;
        /*0080*/                   IADD3 R14, R12, R13, R14 ;
        /*0090*/               @P1 BRA `(.L_x_2) ;
        /*00a0*/                   LDS.128 R4, [R2] ;
        /*00b0*/                   LOP3.LUT R12, R4, 0xf000f, RZ, 0xc0, !PT ;
        /*00c0*/              @!P2 BRA 0xa0 ;
        /*00d0*/               @P3 BRA 0x10 ;
        /*00e0*/                   EXIT ;
"""


def test_sass_hot_loop():
    """The innermost marked loop that loads the most words: 6 instructions
    (the NOP left out) for 2 x 4 words; the enclosing loop and the
    one-load remainder loop are not it."""
    insns = sass.parse_sass(LISTING, "unpack_ring_kernel")
    assert insns[2] == (0x20, "@!P0 BRA `(.L_x_1)", 0x10)
    loop = sass.hot_loop(insns, r"0xf000f")
    assert (loop["start"], loop["end"]) == (0x30, 0x90)
    assert loop["instructions"] == 6 and loop["words"] == 8 and loop["per_word"] == 0.75
    assert loop["int_per_word"] == 3 / 8  # LOP3, SHF, IADD3
    assert loop["opcodes"] == {"LDS": 2, "LOP3": 1, "SHF": 1, "IADD3": 1, "BRA": 1}
    with pytest.raises(RuntimeError):
        sass.parse_sass(LISTING, "no_such_kernel")
    with pytest.raises(RuntimeError):
        sass.hot_loop(insns, r"0xdeadbeef")


def test_issue_and_integer_bounds():
    # 12 instructions a word over [1376, 4096] words: 2.11 M warp-instructions
    # at 4 a clock on 132 SMs at 1.98 GHz; integer ops at 64 lanes a clock
    # take twice that
    ms = sass.issue_bound_ms(12, 1376 * 4096, 132, 1.98e9)
    assert ms == pytest.approx(12 * 1376 * 4096 / 32 / (4 * 132 * 1.98e9) * 1e3)
    assert 2.0e-3 < ms < 2.1e-3
    assert sass.int_bound_ms(12, 1376 * 4096, 132, 1.98e9) == pytest.approx(2 * ms)
