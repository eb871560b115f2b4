"""P2: the streaming rate of the packed words (``scripts/dma_probe.py``).

`dma_only` replaces ``dma_probe.py::dma_only``: the per-column sum of all
K/8 int32 words, in int32 as ``jnp.sum`` of int32 gives it (wrapping), cast
to f32 and broadcast over 8 rows.  `unpack_only` replaces ``::unpack_only``:
the per-column sum of the 8 nibble planes ``(qw >> 4p) & 0xF`` of every word
(an arithmetic shift as on int32; the mask makes it the logical one).  Both
results are integers, those of `unpack_only` below 2**24, so the kernels
(``csrc/probes.cu``) agree with the plain versions bit for bit.  The script's
shape: the words of the 11008 -> 4096 down projection, [1376, 4096].

    python -m qeft_tpu_torch.probes.dma [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common

K8, N = 1376, 4096  # dma_probe.py: K = 11008, N = 4096
ROWS = 8  # output rows (the broadcast)


def dma_only_plain(qw: torch.Tensor) -> torch.Tensor:
    total = qw.sum(0, dtype=torch.int32)  # wraps, as int32 arithmetic does
    return total.to(torch.float32).expand(ROWS, -1).contiguous()


def unpack_only_plain(qw: torch.Tensor) -> torch.Tensor:
    total = sum(((qw >> (4 * p)) & 0xF).sum(0) for p in range(8))
    return total.to(torch.float32).expand(ROWS, -1).contiguous()


def _launch(name: str, qw: torch.Tensor) -> torch.Tensor:
    common.check_int32_words(qw)
    k8, n = qw.shape
    out = torch.empty(ROWS, n, dtype=torch.float32, device=qw.device)
    ws = common.workspace(qw.device, n, torch.int32)
    rpb = common.row_split(k8, -(-n // 128), qw.device)
    cuda_lib.launch(name, cuda_lib.ptr(qw), cuda_lib.ptr(out), cuda_lib.ptr(ws),
                    cuda_lib.ptr(common.tickets(qw.device, n)), k8, n, rpb)
    return out


def dma_only(qw: torch.Tensor) -> torch.Tensor:
    """qw int32 [K8, N] -> f32 [8, N]: every row the wrapped int32 column sums."""
    if not qw.is_cuda:
        return dma_only_plain(qw)
    return _launch("dma_only", qw)


def unpack_only(qw: torch.Tensor) -> torch.Tensor:
    """qw int32 [K8, N] -> f32 [8, N]: every row the column sums of all nibbles."""
    if not qw.is_cuda:
        return unpack_only_plain(qw)
    return _launch("unpack_only", qw)


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
    res["device"] = torch.cuda.get_device_name(device)
    common.report(res)
    return res


if __name__ == "__main__":
    main()
