"""P2: the streaming rate of the packed words (``scripts/dma_probe.py``).

`dma_only` replaces ``dma_probe.py::dma_only``: the per-column sum of all
K/8 int32 words, in int32 as ``jnp.sum`` of int32 gives it (wrapping), cast
to f32 and broadcast over 8 rows.  `unpack_only` replaces ``::unpack_only``:
the per-column sum of the 8 nibble planes ``(qw >> 4p) & 0xF`` of every word
(an arithmetic shift as on int32; the mask makes it the logical one).  Both
results are integers, those of `unpack_only` below 2**24, so the kernels
(``csrc/probes.cu``) agree with the plain versions bit for bit.  `dma_only`
streams the words through registers; `unpack_only` takes them through P3's
bulk-copy ring (`common.stream_plan`) and forms nibble pairs as the decode
matvec does, summed as integers (`unpack_only_emulated` is its arithmetic
on the CPU).  The script's shape: the words of the 11008 -> 4096 down
projection, [1376, 4096].

    python -m qeft_tpu_torch.probes.dma [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common, sass

K8, N = 1376, 4096  # dma_probe.py: K = 11008, N = 4096
ROWS = 8  # output rows (the broadcast)


def dma_only_plain(qw: torch.Tensor) -> torch.Tensor:
    total = qw.sum(0, dtype=torch.int32)  # wraps, as int32 arithmetic does
    return total.to(torch.float32).expand(ROWS, -1).contiguous()


def unpack_only_plain(qw: torch.Tensor) -> torch.Tensor:
    total = sum(((qw >> (4 * p)) & 0xF).sum(0) for p in range(8))
    return total.to(torch.float32).expand(ROWS, -1).contiguous()


UNPACK_BN = 512  # the widest column tile of unpack_only: 128 column quads
LANE_ROWS = 1092  # word rows a 16-bit lane pair takes before it is widened (csrc kLaneRows)
# unpack_only's ring (`common.stream_plan`): one block of 8 consumer warps an
# SM, 16 KB stages in a 64 KB ring, the sweep's fastest plan cold
# (`probes/ring_sweep.py`, PERF.md §6)
UNPACK_PLAN = dict(blocks_per_sm=1, stage_bytes=16 << 10, ring_bytes=64 << 10)


def unpack_bn(n: int) -> int:
    """unpack_only's column tile: the widest multiple of 4 up to UNPACK_BN
    that divides N."""
    return next(bn for bn in range(UNPACK_BN, 3, -4) if n % bn == 0)


def unpack_plan(k8: int, n: int, sms: int) -> common.StreamPlan:
    """unpack_only's grid and ring on a card of ``sms`` SMs."""
    return common.stream_plan(k8, n, unpack_bn(n), sms, **UNPACK_PLAN)


def unpack_only_emulated(qw: np.ndarray, sms: int = 132) -> np.ndarray:
    """The kernel's order of operations on the CPU (int32 words [K8, N] ->
    f32 [8, N]): for each block of `common.stream_plan` and each of its
    stages, every word's 4 nibble pairs (planes q and q + 4 in the low and
    high 16-bit lane, ``(w >> 4q) & 0x000F000F``) added into a 32-bit lane
    accumulator per column and half (the even rows of a stage in one, the
    odd in the other: two consumer lanes a column), widened (low lane plus
    high lane) into a 32-bit total before a stage would take them past
    LANE_ROWS rows; the halves and the blocks' totals summed, then f32.  A
    lane that overflowed would carry into the next or out of the word, as in
    the kernel."""
    k8, n = qw.shape
    plan = unpack_plan(k8, n, sms)
    w = qw.astype(np.uint32)
    pairs = sum((w >> np.uint32(4 * q)) & np.uint32(0x000F000F) for q in range(4))
    total = np.zeros(n, np.uint32)

    def widen(lanes):
        return ((lanes & np.uint32(0xFFFF)) + (lanes >> np.uint32(16))).sum(0, dtype=np.uint32)

    for c0, r0, r1 in plan.blocks():
        cols = slice(c0, c0 + plan.bn)
        lanes, held = np.zeros((2, plan.bn), np.uint32), 0
        for r, rows in plan.stages_of(r0, r1):
            if held + rows > LANE_ROWS:
                total[cols] += widen(lanes)
                lanes, held = np.zeros((2, plan.bn), np.uint32), 0
            held += rows
            for i in range(rows):
                lanes[i % 2] += pairs[r + i, cols]
        total[cols] += widen(lanes)
    return np.broadcast_to(total.astype(np.float32), (ROWS, n)).copy()


def dma_only(qw: torch.Tensor) -> torch.Tensor:
    """qw int32 [K8, N] -> f32 [8, N]: every row the wrapped int32 column sums."""
    if not qw.is_cuda:
        return dma_only_plain(qw)
    common.check_int32_words(qw)
    k8, n = qw.shape
    out = torch.empty(ROWS, n, dtype=torch.float32, device=qw.device)
    tiles = -(-n // 128)
    rpb = common.row_split(k8, tiles, qw.device)
    cuda_lib.launch("dma_only", cuda_lib.ptr(qw), cuda_lib.ptr(out),
                    cuda_lib.ptr(common.workspace(qw.device, n, torch.int32)),
                    cuda_lib.ptr(common.tickets(qw.device, tiles)), k8, n, rpb)
    return out


def unpack_only(qw: torch.Tensor) -> torch.Tensor:
    """qw int32 [K8, N] -> f32 [8, N]: every row the column sums of all
    nibbles."""
    if not qw.is_cuda:
        return unpack_only_plain(qw)
    common.check_int32_words(qw)
    k8, n = qw.shape
    plan = unpack_plan(k8, n, cuda_lib.sm_count(qw.device))
    out = torch.empty(ROWS, n, dtype=torch.float32, device=qw.device)
    cuda_lib.launch("unpack_only", cuda_lib.ptr(qw), cuda_lib.ptr(out),
                    cuda_lib.ptr(common.workspace(qw.device, n, torch.int32)),
                    cuda_lib.ptr(common.tickets(qw.device, plan.tiles)), k8, n, plan.bn,
                    plan.rows_per_block, plan.stage_rows, plan.stages)
    return out


def random_words(k8: int, n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    words = rng.integers(-(2 ** 31), 2 ** 31, (k8, n), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(words).to(device)


def measure(device, k8: int = K8, n: int = N, seed: int = 0) -> dict:
    """Each kernel against its plain version (bit-exact), then timed hot and
    cold, beside the plain version, ``qw.sum(0)`` and the byte bound."""
    qw = random_words(k8, n, seed, device)
    nbytes = qw.numel() * 4 + ROWS * n * 4
    out = {"shape": [k8, n], "bytes": nbytes, "bound_ms": common.bound_ms(nbytes)[0]}
    copies = [qw] + [qw.clone() for _ in range(common.n_copies(qw.numel() * 4) - 1)]
    for name, fn, plain in (("dma_only", dma_only, dma_only_plain),
                            ("unpack_only", unpack_only, unpack_only_plain)):
        got, want = fn(qw), plain(qw)
        err = (got - want).abs().max().item()
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
        t = common.hot_cold(fn, copies)
        t["plain_ms"] = common.time_ms(lambda i: plain(copies[i % len(copies)]), 2, 3)
        t["max_abs_err"] = err
        t["hot_GBps"] = qw.numel() * 4 / (t["hot_ms"] * 1e-3) / 1e9
        t["cold_GBps"] = qw.numel() * 4 / (t["cold_ms"] * 1e-3) / 1e9
        out[name] = t
    out["dma_only"]["library_ms"] = common.time_ms(
        lambda i: copies[i % len(copies)].sum(0, dtype=torch.int32))
    sms = cuda_lib.sm_count(device)
    plan = unpack_plan(k8, n, sms)
    issue = sass.unpack_issue(qw.numel(), device)
    out["unpack_only"].update(plan=dataclasses.asdict(plan), smem=plan.smem,
                              in_flight_per_sm=plan.in_flight_per_sm(sms), issue=issue,
                              issue_bound_ms=issue["issue_bound_ms"])
    return out


def main(argv=None) -> dict:
    args, device = common.parse_device(argv, __doc__.splitlines()[0])
    if device.type != "cuda":
        qw = random_words(64, 256, 0, device)
        res = {"device": "cpu", "dma_only": dma_only(qw)[0, :4].tolist(),
               "unpack_only": unpack_only(qw)[0, :4].tolist(), "times": "not measured"}
        common.report(res)
        return res
    res = measure(device)
    for name in ("dma_only", "unpack_only"):
        t = res[name]
        print(f"{name} [{K8}, {N}] int32: hot {t['hot_ms'] * 1e3:.2f} us ({t['hot_GBps']:.0f} "
              f"GB/s), cold {t['cold_ms'] * 1e3:.2f} us ({t['cold_GBps']:.0f} GB/s); bound "
              f"{res['bound_ms'] * 1e3:.2f} us", flush=True)
    i = res["unpack_only"]["issue"]
    print(f"unpack_only hot loop: {i['instructions']} instructions for {i['words']:.0f} words "
          f"({i['per_word']:.2f} a word) -> issue bound {i['issue_bound_ms'] * 1e3:.2f} us at "
          f"{i['clock_hz'] / 1e6:.0f} MHz; integer bound {i['int_bound_ms'] * 1e3:.2f} us",
          flush=True)
    res["device"] = torch.cuda.get_device_name(device)
    common.report(res)
    return res


if __name__ == "__main__":
    main()
