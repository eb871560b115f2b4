"""P3: the streaming rate when the whole tile passes through on-chip memory
(``scripts/dma_probe2.py``).

`dma_tile` replaces ``dma_probe2.py::make(bn).f``: ``out = float(qw[:8, :]) +
s``, where the TPU's BlockSpec copies the whole [K/8, bn] block of words into
VMEM at every grid step although the kernel reads 8 rows.  The kernel
(``csrc/probes.cu``) likewise moves every byte of each [K/8, bn] tile
through shared memory (a ``cp.async`` ring), the tile's rows split over
blocks so that every ``bn`` fills the card.  Exact against the plain
version.  The script's sweep: bn in 256, 512, 1024 over [1376, 4096] words.

    python -m qeft_tpu_torch.probes.dma2 [--device cpu]
"""

from __future__ import annotations

import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common
from qeft_tpu_torch.probes.dma import K8, N, random_words

BNS = (256, 512, 1024)
STAGE_ROWS = 4  # rows per stage of the kernel's ring


def dma_tile_plain(qw: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return qw[:8].to(torch.float32) + s


def dma_tile(qw: torch.Tensor, s: torch.Tensor, bn: int = 512) -> torch.Tensor:
    """qw int32 [K8, N], s f32 [8, N] -> f32 [8, N], the words streamed in
    [K8, bn] tiles (``bn`` changes the time, not the result)."""
    if not qw.is_cuda:
        return dma_tile_plain(qw, s)
    common.check_int32_words(qw)
    k8, n = qw.shape
    if k8 < 8 or n % bn or bn % 4:
        raise ValueError(f"dma_tile takes K8 >= 8 and bn | N, 4 | bn; got {tuple(qw.shape)}, {bn}")
    if s.dtype != torch.float32 or tuple(s.shape) != (8, n) or not s.is_cuda:
        raise ValueError(f"s must be a float32 CUDA tensor of shape (8, {n})")
    s = s.contiguous()
    out = torch.empty(8, n, dtype=torch.float32, device=qw.device)
    rpb = common.row_split(k8, n // bn, qw.device, multiple=STAGE_ROWS)
    cuda_lib.launch("dma_tile", cuda_lib.ptr(qw), cuda_lib.ptr(s), cuda_lib.ptr(out), k8, n, bn,
                    rpb)
    return out


def measure(device, k8: int = K8, n: int = N, seed: int = 0) -> dict:
    """At each bn: the kernel against the plain version (bit-exact), timed
    hot and cold beside the plain version and the byte bound."""
    qw = random_words(k8, n, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s = torch.randn(8, n, generator=gen, device=device)
    nbytes = qw.numel() * 4 + 2 * 8 * n * 4
    out = {"shape": [k8, n], "bytes": nbytes, "bound_ms": common.bound_ms(nbytes)[0]}
    copies = [qw] + [qw.clone() for _ in range(common.n_copies(qw.numel() * 4) - 1)]
    want = dma_tile_plain(qw, s)
    for bn in BNS:
        err = (dma_tile(qw, s, bn) - want).abs().max().item()
        if err != 0:
            raise AssertionError(f"dma_tile bn={bn}: kernel differs from its plain version")
        t = common.hot_cold(lambda w: dma_tile(w, s, bn), copies)
        t["max_abs_err"] = err
        t["hot_GBps"] = qw.numel() * 4 / (t["hot_ms"] * 1e-3) / 1e9
        t["cold_GBps"] = qw.numel() * 4 / (t["cold_ms"] * 1e-3) / 1e9
        out[f"bn{bn}"] = t
    out["plain_ms"] = common.time_ms(lambda i: dma_tile_plain(copies[i % len(copies)], s))
    # one PyTorch call for the same function (int32 + f32 promotes to f32);
    # it reads the 8 rows the result depends on, the kernel streams all K8
    out["library_ms"] = common.time_ms(lambda i: torch.add(copies[i % len(copies)][:8], s))
    return out


def main(argv=None) -> dict:
    args, device = common.parse_device(argv, __doc__.splitlines()[0])
    if device.type != "cuda":
        qw = random_words(64, 256, 0, device)
        res = {"device": "cpu", "dma_tile": dma_tile(qw, torch.zeros(8, 256))[:, 0].tolist(),
               "times": "not measured"}
        common.report(res)
        return res
    res = measure(device)
    for bn in BNS:
        t = res[f"bn{bn}"]
        print(f"dma_tile bn={bn}: hot {t['hot_ms'] * 1e3:.2f} us ({t['hot_GBps']:.0f} GB/s), cold "
              f"{t['cold_ms'] * 1e3:.2f} us ({t['cold_GBps']:.0f} GB/s); bound "
              f"{res['bound_ms'] * 1e3:.2f} us", flush=True)
    res["device"] = torch.cuda.get_device_name(device)
    common.report(res)
    return res


if __name__ == "__main__":
    main()
