"""The JAX package's kernel-path environment variables, read in one place.

``qeft_tpu`` reads these names where it picks a kernel or a tile
(``ops/qlinear.py``, ``models/llama.py``, ``ops/pallas_qmm.py``,
``ops/pallas_flash.py``, ``ops/pallas_attention.py``, ``ops/permute.py``,
``pipeline.py``).  The port reads every one of them here, so that none is
set without effect and without a word:

- a selector whose "off" value changes the arithmetic (an XLA ablation of a
  Pallas kernel) raises `NotImplementedError` naming ROADMAP A11;
- a selector whose "off" value only picks another kernel is honoured:
  ``QEFT_FUSED_DECODE=0`` runs the decode stages as the norm in PyTorch,
  the plain stacked matvec (K6) and the residual add; ``QEFT_STACKED_GEMV=0``
  runs them through the unstacked matvec (K5) on each layer's view;
- a TPU tiling or layout knob has no counterpart in the port (its kernels
  tile for the H100): setting one prints one warning per process.

`check` runs where every entry point resolves its device
(``device.resolve_device``).  The two selectors are read there (and once
at import) into `STACKED_GEMV` and `FUSED_DECODE`, which the decode stages
read on every call; a change of the environment takes effect at the next
entry point.
"""

from __future__ import annotations

import os
import warnings

# the off values as qeft_tpu compares them
_OFF_PALLAS = ("0", "false", "off")
_OFF_FLAG = ("0", "", "false")

# name -> (off values, what the off value asks for): XLA ablations, ROADMAP A11
ABLATIONS = {
    "QEFT_PALLAS": (_OFF_PALLAS, "the XLA dequantize-then-matmul linears"),
    "QEFT_FLASH_ATTN": (_OFF_PALLAS, "XLA window attention with bf16 scores"),
    "QEFT_PALLAS_ATTN": (_OFF_PALLAS, "XLA decode attention over the whole cache"),
    "QEFT_GEMV_F32W": (_OFF_FLAG, "the decode matvec's weights multiplied in bf16"),
}
# the TPU tiling and layout knobs, not ported on purpose (ROADMAP, "Port the
# math, not TPU-only workarounds")
TPU_KNOBS = ("QEFT_ATTN_BLK", "QEFT_FLASH_BLKQ", "QEFT_FLASH_BLKK", "QEFT_O_BAND",
             "QEFT_PAD_UPGATE", "QEFT_SEXP_REPEAT", "QEFT_GEMV_TELE", "QEFT_GEMV_BN")

_warned: set = set()


def _flag(name: str) -> bool:
    return os.environ.get(name, "1") not in _OFF_FLAG


def _read_selectors() -> None:
    """``QEFT_STACKED_GEMV`` (default on): the decode matvec reads the
    stacked linear at its layer (K6, and K1 for a fused stage); off, each
    layer's view goes through K5, as qeft_tpu's scan-sliced layers do.
    ``QEFT_FUSED_DECODE`` (default on) with the stacked matvec: a decode
    stage runs K1, the norm and the residual inside the kernel; off, the
    norm, the matvec and the residual add run one after another."""
    global STACKED_GEMV, FUSED_DECODE
    STACKED_GEMV = _flag("QEFT_STACKED_GEMV")
    FUSED_DECODE = _flag("QEFT_FUSED_DECODE") and STACKED_GEMV


STACKED_GEMV = FUSED_DECODE = True
_read_selectors()


def check() -> None:
    """Raise for an ablation the port does not have; warn once per process
    for each TPU knob that is set; read the two kernel selectors."""
    for name, (off, what) in ABLATIONS.items():
        v = os.environ.get(name)
        if v is not None and v in off:
            raise NotImplementedError(
                f"{name}={v!r} asks for {what}, which the port does not have (ROADMAP A11); "
                "unset it or set it to 1")
    for name in TPU_KNOBS:
        if name in os.environ and name not in _warned:
            _warned.add(name)
            warnings.warn(f"{name} tunes a TPU kernel of qeft_tpu; the port's CUDA kernels do "
                          "not carry it and ignore it", RuntimeWarning, stacklevel=3)
    _read_selectors()
