"""Operations and bytes of K5, K2, K7 and of the two steps, against counts
made by hand at the OPT-6.7B and Falcon-7b shapes."""

import pytest

from portbench import costs, run, shapes

OPT = shapes.dims(run.load_json(run.find("configs", "opt-6.7b")))
FALCON = shapes.dims(run.load_json(run.find("configs", "falcon-7b")))


def test_shapes_read_from_the_files():
    assert OPT.linears == (("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096),
                           ("o", 4096, 4096), ("fc1", 4096, 16384), ("fc2", 16384, 4096))
    assert FALCON.linears == (("qkv", 4544, 4672), ("dense", 4544, 4544),
                              ("fc1", 4544, 18176), ("fc2", 18176, 4544))
    assert (OPT.group, FALCON.group, OPT.n_outlier, FALCON.kv_heads, FALCON.head_dim) == \
        (128, 64, 128, 1, 64)


def test_k5_at_opt_q_and_falcon_qkv():
    # q, M = 1: 2 * 4096 * (4096 + 128) operations; codes 8 MiB, scales and
    # zeros 4 * 32 * 4096, slab 2 * 128 * 4096, bias, x and out 8 KiB each
    assert costs.qgemv_call(1, 4096, 4096, 128, 128, True) == (
        34_603_008, 8_388_608 + 524_288 + 1_048_576 + 8_192 + 8_192 + 8_192)
    # Falcon qkv, M = 8, g = 64, no bias
    assert costs.qgemv_call(8, 4544, 4672, 64, 128, False) == (
        349_241_344, 10_614_784 + 1_326_848 + 1_196_032 + 72_704 + 74_752)


def test_k2_and_k7_at_opt_fc2_in_training():
    assert costs.qgemm_call(2048, 16384, 4096, 128, 128) == (
        277_025_390_592, 33_554_432 + 2_097_152 + 1_048_576 + 67_108_864 + 16_777_216)
    assert costs.qgemm_t_call(2048, 16384, 4096, 128, 128) == (
        274_877_906_944, 33_554_432 + 2_097_152 + 16_777_216 + 67_108_864 + 1_048_576)


def test_opt_decode_step_at_1000_keys():
    ops, nbytes = costs.decode_step(OPT, 1, 1000)
    linears = 32 * 412_090_368
    attention = 4 * 32 * 128 * 1000 * 32
    head = 2 * 4096 * 50272
    assert ops == linears + attention + head == 14_123_008_000
    per_layer = 100_663_296 + 6_291_456 + 9_437_184 + 73_728
    assert nbytes == 32 * per_layer + 2 * 2 * 32 * 32 * 1000 * 128 + 2 * 4096 * 50272


def test_falcon_decode_step_reads_one_kv_head():
    _, b1 = costs.decode_step(FALCON, 8, 600)
    _, b0 = costs.decode_step(FALCON, 8, 0)
    assert b1 - b0 == 2 * 2 * 32 * 8 * 1 * 600 * 64


@pytest.mark.parametrize("dims,first_no_dx", [(OPT, 3 * 4096 * 4096),
                                              (FALCON, 4544 * 4672 + 4544 * 18176)])
def test_train_step_without_the_recomputed_forward(dims, first_no_dx):
    m, s, b = 2048, 512, 4
    fwd = sum(2 * m * (k + 128) * n for _, k, n in dims.linears)
    dx = sum(2 * m * k * n for _, k, n in dims.linears)
    slab = sum(4 * m * 128 * n for _, k, n in dims.linears)
    attn = 3 * 4 * b * dims.heads * dims.head_dim * s * (s + 1) // 2
    head = 4 * m * dims.hidden * dims.vocab
    want = 32 * (fwd + dx + slab + attn) - 2 * m * first_no_dx + head
    assert costs.train_step_ops(dims, b, s) == want


def test_least_time_is_the_larger_bound():
    pk = costs.peaks("NVIDIA H100 80GB HBM3")
    assert pk == {"flops": 989.4e12, "bytes": 3.35e12, "about": pk["about"]}
    assert costs.least_time(989.4e12, 1.0, pk) == 1.0
    assert costs.least_time(1.0, 6.7e12, pk) == 2.0
    assert costs.peaks("some other card") is None
