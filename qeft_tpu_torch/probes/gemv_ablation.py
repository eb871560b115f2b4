"""P4: is the decode matvec bound by its dequantization or by memory?
(``scripts/gemv_ablation_probe.py``)

`gemv_ablation` replaces ``gemv_ablation_probe.py::build`` (its kernel,
``make_kernel``): x bf16 [8, K] in plane order -- column ``p*K/8 + w`` meets
nibble plane ``p`` of word row ``w`` -- words int32 [K/8, N], scales f32
[K/g, N] and out bf16 [8, N].  The scales are tiled over the word rows as
``pltpu.repeat(s, h, 0)`` tiles them: word row ``w`` takes scale row
``w mod K/g`` (the probe's arithmetic, not the product's layout).  The
variants cut the dequantization at constant bytes; all but ``v0_full`` and
the telescoped ones compute the wrong product on purpose (timing only):

- ``v0_full``: (plane as f32 times scale) rounded to bf16, bf16 products
  summed in f32;
- ``v1_noscale``: the plane as bf16; ``v2_4plane`` / ``v3_2plane``: only
  the first 4 / 2 planes; ``v5_noshift``: ``qw & 0xF`` for every plane;
- ``v4_dma``: no dequantization, the f32 column sums of the words plus
  ``x[:, :bn]`` (the same first bn columns for every N tile);
- ``v6_f32dot``: f32 weights and activations;
- ``v7_tele16`` / ``v8_tele8``: 16- / 8-bit fields shifted down 4 bits a
  plane, against ``a_p = x_p - 16 x_{p-1}`` -- exact, the same product as
  ``v6_f32dot``.

The plain version repeats each variant's arithmetic in PyTorch; the kernel
(``csrc/probes.cu``) sums in another order, so the bf16 outputs agree within
1e-2 of their scale.  `measure` also times the port's own matvec K6
(``ops.qmm.qgemv_stacked``, M = 8) at the same shapes on its own layout.

    python -m qeft_tpu_torch.probes.gemv_ablation [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from qeft_tpu_torch.ops import cuda_lib
from qeft_tpu_torch.probes import common

VARIANTS = ("v0_full", "v1_noscale", "v2_4plane", "v3_2plane", "v4_dma", "v5_noshift",
            "v6_f32dot", "v7_tele16", "v8_tele8")
# the script's two shapes: (label, K, N, group size, bn)
SHAPES = (("down 11008->4096", 11008, 4096, 128, 512), ("qkv 4096->12288", 4096, 12288, 128, 512))
M = 8  # activation rows (the script's bm)
TOL = 1e-2  # of the output's scale: bf16 outputs of sums in another order
MAX_ROWS_PER_BLOCK = 192  # the kernel's staged activations stay under 48 KB


def _codes(variant: str, qw: torch.Tensor):
    """(plane p, its integer codes [K8, N]) in the order the variant sums."""
    if variant == "v7_tele16":
        fields = [(0, qw & 0xFFFF, 4), (4, (qw >> 16) & 0xFFFF, 4)]
    elif variant == "v8_tele8":
        fields = [(2 * i, (qw >> (8 * i)) & 0xFF, 2) for i in range(4)]
    else:
        planes = {"v2_4plane": 4, "v3_2plane": 2}.get(variant, 8)
        for p in range(planes):
            yield p, (qw & 0xF) if variant == "v5_noshift" else (qw >> (4 * p)) & 0xF
        return
    for base, field, levels in fields:
        for j in range(levels):
            yield base + j, field >> (4 * j)


def gemv_ablation_plain(variant: str, x: torch.Tensor, qw: torch.Tensor, s: torch.Tensor,
                        bn: int = 512) -> torch.Tensor:
    """The variant's arithmetic in PyTorch, f32 sums -> bf16 [M, N]."""
    m, k = x.shape
    k8, n = qw.shape
    if variant == "v4_dma":
        sums = qw.to(torch.float32).sum(0)
        return (sums + x[:, :bn].float().repeat(1, n // bn)).to(torch.bfloat16)
    s_exp = s.float().repeat(k8 // s.shape[0], 1)  # tiled: row w -> s[w mod K/g]
    xp = x.float().reshape(m, 8, k8)
    tele = variant in ("v7_tele16", "v8_tele8")
    acc = torch.zeros(m, n, dtype=torch.float32, device=x.device)
    for p, code in _codes(variant, qw):
        xa = xp[:, p]
        if tele and p % (4 if variant == "v7_tele16" else 2):
            xa = xa - 16.0 * xp[:, p - 1]
        w = code.to(torch.float32)
        if variant != "v1_noscale":
            w = w * s_exp
        if variant in ("v0_full", "v2_4plane", "v3_2plane", "v5_noshift"):
            w = w.to(torch.bfloat16).float()
        acc += xa @ w
    return acc.to(torch.bfloat16)


def dequantized(x_dtype, qw: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The [K, N] weight ``v0_full`` multiplies by (row ``p*K/8 + w``: plane
    p of word row w, its scale tiled) -- the operand of the library call."""
    k8, n = qw.shape
    s_exp = s.float().repeat(k8 // s.shape[0], 1)
    return torch.cat([(((qw >> (4 * p)) & 0xF).float() * s_exp).to(x_dtype) for p in range(8)])


def gemv_ablation(variant: str, x: torch.Tensor, qw: torch.Tensor, s: torch.Tensor,
                  bn: int = 512) -> torch.Tensor:
    """x bf16 [8, K], qw int32 [K/8, N], s f32 [G, N] with G | K/8 -> bf16
    [8, N] by variant ``variant``; ``bn`` is read by ``v4_dma`` only."""
    if not x.is_cuda:
        return gemv_ablation_plain(variant, x, qw, s, bn)
    common.check_int32_words(qw)
    k8, n = qw.shape
    g_rows = s.shape[0]
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (M, 8 * k8) or not x.is_cuda:
        raise ValueError(f"x must be a bfloat16 CUDA tensor of shape ({M}, {8 * k8})")
    if s.dtype != torch.float32 or s.shape[1] != n or k8 % g_rows or not s.is_cuda:
        raise ValueError(f"s must be float32 [G, {n}] with G dividing {k8}")
    if not 1 <= bn <= 8 * k8 or n % bn:
        raise ValueError(f"bn {bn} must divide N = {n} and be at most K")
    x, s = cuda_lib.aligned(x), cuda_lib.aligned(s)
    out = torch.empty(M, n, dtype=torch.bfloat16, device=x.device)
    ws = common.workspace(x.device, M * n, torch.float32)
    rpb = common.row_split(k8, -(-n // 128), x.device, most=MAX_ROWS_PER_BLOCK)
    cuda_lib.launch("gemv_ablation", cuda_lib.ptr(x), cuda_lib.ptr(qw), cuda_lib.ptr(s),
                    cuda_lib.ptr(out), cuda_lib.ptr(ws), cuda_lib.ptr(common.tickets(x.device, n)),
                    k8, n, g_rows, bn, rpb, VARIANTS.index(variant))
    return out


def random_inputs(k: int, n: int, g: int, seed: int, device):
    """x bf16 [8, K], qw int32 [K/8, N], s f32 [K/g, N] from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, k)).astype(np.float32) * 0.5)
    qw = rng.integers(-(2 ** 31), 2 ** 31, (k // 8, n), dtype=np.int64).astype(np.int32)
    s = rng.uniform(0.005, 0.02, (k // g, n)).astype(np.float32)
    return (x.to(torch.bfloat16).to(device), torch.from_numpy(qw).to(device),
            torch.from_numpy(s).to(device))


def check(got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not (torch.isfinite(got.float()).all() and err <= TOL * scale):
        raise AssertionError(f"max abs error {err} past {TOL} of the scale {scale}")
    return err


def measure(device, shapes=SHAPES, seed: int = 0) -> dict:
    """At each shape: every variant against its plain version, timed hot
    (one buffer, as the script runs it) and cold (rotating over copies);
    the plain version of ``v0_full`` and ``torch.matmul`` on its
    pre-dequantized weight; K6 at M = 8 on the port's layout, hot and cold
    (layers of one stacked linear)."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import random_packed_linear

    out = {}
    for label, k, n, g, bn in shapes:
        x, qw, s = random_inputs(k, n, g, seed, device)
        wbytes = qw.numel() * 4 + s.numel() * 4
        nbytes = wbytes + x.numel() * 2 + M * n * 2
        n_cp = common.n_copies(wbytes)
        copies = [(qw, s)] + [(qw.clone(), s.clone()) for _ in range(n_cp - 1)]
        res = {"K": k, "N": n, "g": g, "bn": bn, "bytes": nbytes, "copies": n_cp,
               "bound_ms": common.bound_ms(nbytes, 2 * M * k * n)[0]}
        for v in VARIANTS:
            err = check(gemv_ablation(v, x, qw, s, bn), gemv_ablation_plain(v, x, qw, s, bn))
            t = common.hot_cold(lambda c: gemv_ablation(v, x, c[0], c[1], bn), copies)
            t["max_abs_err"] = err
            t["cold_GBps"] = qw.numel() * 4 / (t["cold_ms"] * 1e-3) / 1e9
            res[v] = t
        res["plain_ms"] = common.time_ms(lambda i: gemv_ablation_plain("v0_full", x, *copies[
            i % n_cp], bn), 2, 3)
        w = dequantized(x.dtype, qw, s)
        res["library_ms"] = common.time_ms(lambda i: torch.matmul(x, w))
        del w
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        lin = random_packed_linear(gen, 1, k, n, g, 128)
        k6_bytes = sum(t.numel() * t.element_size()
                       for t in (lin.qweight, lin.scales, lin.scaled_zeros, lin.oweight))
        layers = common.n_copies(k6_bytes)
        lin = random_packed_linear(gen, layers, k, n, g, 128)
        t = {"hot_ms": common.time_ms(lambda i: qmm.qgemv_stacked(x, lin, 0)),
             "cold_ms": common.time_ms(lambda i: qmm.qgemv_stacked(x, lin, i % layers)),
             "bytes": k6_bytes + x.numel() * 2 + M * n * 2}
        t["bound_ms"] = common.bound_ms(t["bytes"], 2 * M * (k + 128) * n)[0]
        res["k6"] = t
        del lin, copies
        out[label] = res
    return out


def main(argv=None) -> dict:
    args, device = common.parse_device(argv, __doc__.splitlines()[0])
    if device.type != "cuda":
        x, qw, s = random_inputs(1024, 256, 128, 0, device)
        res = {"device": "cpu", "times": "not measured",
               **{v: gemv_ablation(v, x, qw, s, 128)[0, :2].float().tolist() for v in VARIANTS}}
        common.report(res)
        return res
    res = measure(device)
    for label, r in res.items():
        print(f"--- {label} (int4 {r['K'] * r['N'] // 2 / 1e6:.1f} MB; bound "
              f"{r['bound_ms'] * 1e3:.2f} us) ---", flush=True)
        for v in VARIANTS:
            t = r[v]
            print(f"{v:11s}: hot {t['hot_ms'] * 1e3:7.1f} us, cold {t['cold_ms'] * 1e3:7.1f} us "
                  f"({t['cold_GBps']:.0f} GB/s of words)", flush=True)
        print(f"K6 qgemv_stacked M=8: hot {r['k6']['hot_ms'] * 1e3:.1f} us, cold "
              f"{r['k6']['cold_ms'] * 1e3:.1f} us (bound {r['k6']['bound_ms'] * 1e3:.2f} us); "
              f"torch.matmul on the dequantized weight {r['library_ms'] * 1e3:.1f} us", flush=True)
    res = {"device": torch.cuda.get_device_name(device), "shapes": res}
    common.report(res)
    return res


if __name__ == "__main__":
    main()
