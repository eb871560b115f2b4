"""INT4 packed layout of the mixed-precision linear (PyTorch side).

Layout contract (identical to ``qeft_tpu/ops/packing.py``, which writes the
checkpoints this package reads):

- Integer codes live in ``[K, N]`` orientation (K = in-features, N =
  out-features), so activations multiply as ``y = x @ W``.
- Eight 4-bit codes pack into one signed int32 word along K with plane
  striding.  Within quantization group ``gi`` of ``g`` K-rows (plane height
  ``h = g/8``) word ``jj`` holds K-row ``gi*g + p*h + jj`` in nibble ``p``,
  and the word rows are group-interleaved::

      packed[jj*G + gi, n] = sum_p code[gi*g + p*h + jj, n] << 4p   (G = K/g)

  Nibble 7 holds the sign bit of the word, so it is read with a shift and a
  mask (``(w >> 28) & 0xF``), never by relying on the sign of the shift.
- ``scales`` / ``scaled_zeros`` are ``[G, N]`` and ``w = code * scale +
  scaled_zero``.
- The last ``r`` K-rows are the weak ("outlier") columns.  Their
  full-precision values live in ``oweight [r, N]``; the dense INT4 product
  still runs over all K rows, the last ``r`` included.

Stacked models carry every leaf with a leading layer axis (``qweight [L,
K/8, N]``); kernels take the layer as an integer index instead of a slice.

`pack_codes`, `pack_codes_np` and `pack_layer` write the layout, bit for bit
as ``qeft_tpu/ops/packing.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class QLinearParams:
    """Buffers of one packed linear (or of all layers, stacked on dim 0)."""

    qweight: torch.Tensor  # int32 [(L,) K//8, N]
    scales: torch.Tensor  # [(L,) G, N]
    scaled_zeros: torch.Tensor  # [(L,) G, N]
    oweight: Optional[torch.Tensor] = None  # [(L,) r, N]
    bias: Optional[torch.Tensor] = None  # [(L,) N]
    reorder_ids: Optional[torch.Tensor] = None  # [(L,) K]
    group_size: int = 128

    @property
    def in_features(self) -> int:
        return self.qweight.shape[-2] * 8

    @property
    def out_features(self) -> int:
        return self.qweight.shape[-1]

    @property
    def n_outlier(self) -> int:
        return 0 if self.oweight is None else self.oweight.shape[-2]

    def layer(self, l: int) -> "QLinearParams":
        """Layer ``l`` of a stacked linear, as views (no copy)."""
        def pick(t):
            return None if t is None else t[l]

        return QLinearParams(
            qweight=self.qweight[l], scales=self.scales[l],
            scaled_zeros=self.scaled_zeros[l], oweight=pick(self.oweight),
            bias=pick(self.bias), reorder_ids=pick(self.reorder_ids),
            group_size=self.group_size,
        )

    def map(self, fn) -> "QLinearParams":
        """Apply ``fn`` to every tensor leaf (device moves, dtype casts)."""
        def f(t):
            return None if t is None else fn(t)

        return QLinearParams(
            qweight=f(self.qweight), scales=f(self.scales),
            scaled_zeros=f(self.scaled_zeros), oweight=f(self.oweight),
            bias=f(self.bias), reorder_ids=f(self.reorder_ids),
            group_size=self.group_size,
        )


def resolve_group(k: int, group_size: int) -> int:
    g = group_size if group_size > 0 else k
    if g % 8 or k % g:
        raise ValueError(f"group size {group_size} does not tile K={k} in 8s")
    return g


def unpack_codes(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """int32 [K//8, N] -> int32 codes [K, N] (inverse of the packer)."""
    k8, n = packed.shape
    k = k8 * 8
    g = resolve_group(k, group_size)
    h = g // 8
    w = packed.reshape(h, k // g, n).transpose(0, 1)  # [G, h, N]
    planes = [(w >> (4 * p)) & 0xF for p in range(8)]  # each [G, h, N]
    return torch.stack(planes, dim=1).reshape(k, n)


def dequantize_weight(p: QLinearParams, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``[K, N]`` weight of the INT4 part: ``code * scale + zero``
    computed in f32, then cast (the oweight slab is not folded in)."""
    k = p.in_features
    g = resolve_group(k, p.group_size)
    codes = unpack_codes(p.qweight, p.group_size).to(torch.float32)
    scales = p.scales.to(torch.float32).repeat_interleave(g, dim=0)
    szeros = p.scaled_zeros.to(torch.float32).repeat_interleave(g, dim=0)
    return (codes * scales + szeros).to(dtype)


# ---------------------------------------------------------------------------
# writing the layout


def pack_codes(codes: torch.Tensor, group_size: int) -> torch.Tensor:
    """int codes [K, N] (0..15) -> int32 [K//8, N] in the plane layout
    above (``qeft_tpu/ops/packing.py::pack_codes``)."""
    k, n = codes.shape
    g = resolve_group(k, group_size)
    h = g // 8
    c = codes.reshape(k // g, 8, h, n).to(torch.int64)  # [G, plane, h, N]
    word = torch.zeros(k // g, h, n, dtype=torch.int64, device=codes.device)
    for p in range(8):
        word |= c[:, p] << (4 * p)
    # the int64 word's low 32 bits, as int32 (two's complement)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)
    return word.transpose(0, 1).reshape(k // 8, n)


def pack_codes_np(codes: np.ndarray, group_size: int) -> np.ndarray:
    """NumPy twin of `pack_codes` for host-side checkpoint tooling."""
    k, n = codes.shape
    g = group_size if group_size > 0 else k
    h = g // 8
    c = codes.reshape(k // g, 8, h, n).astype(np.int64)
    word = np.zeros((k // g, h, n), np.int64)
    for p in range(8):
        word |= c[:, p] << (4 * p)
    return word.astype(np.int32).transpose(1, 0, 2).reshape(k // 8, n)


def pack_layer(w_fake_kn: torch.Tensor, scale_group: torch.Tensor, zero_group: torch.Tensor,
               n_outlier: int, group_size: int, sym: bool = False, bits: int = 4,
               bias: Optional[torch.Tensor] = None, dtype=torch.bfloat16) -> QLinearParams:
    """One reordered fake-quantized layer packed (``qeft_tpu/ops/packing.py::
    pack_layer``, bit for bit).

    ``w_fake_kn`` [K, N] with the weak rows last along K; ``scale_group`` /
    ``zero_group`` [N, G] as GPTQ returns them.  A symmetric quantizer's
    zero points shift by 2^(bits-1); the weak rows' codes are set to the
    zero point, so the INT4 product adds exactly 0 for them, and their
    values go to ``oweight``."""
    k, n = w_fake_kn.shape
    g = resolve_group(k, group_size)
    if tuple(scale_group.shape) != (n, k // g):
        raise ValueError(f"scale_group is {tuple(scale_group.shape)}, expected {(n, k // g)}")
    zeros = zero_group.to(torch.float32)
    if sym:
        zeros = zeros + 2 ** (bits - 1)
    scales = scale_group.to(torch.float32)  # [N, G]
    w = w_fake_kn.to(torch.float32)
    scales_kn = scales.t().repeat_interleave(g, dim=0)  # [K, N]
    zeros_kn = zeros.t().repeat_interleave(g, dim=0)
    codes = torch.clamp(torch.round(w / scales_kn + zeros_kn), 0, 2 ** bits - 1).to(torch.int32)
    if n_outlier > 0:
        codes[k - n_outlier:] = zeros_kn[k - n_outlier:].to(torch.int32)
    return QLinearParams(
        qweight=pack_codes(codes, group_size),
        scales=scales.t().to(dtype).contiguous(),
        scaled_zeros=(-(zeros * scales)).t().to(dtype).contiguous(),
        oweight=w_fake_kn[k - n_outlier:].to(dtype).contiguous() if n_outlier > 0 else None,
        bias=None if bias is None else bias.to(dtype),
        group_size=group_size,
    )
