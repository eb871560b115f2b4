"""The JAX package's kernel-path environment variables, read in one place.

``qeft_tpu`` reads these names where it picks a kernel or a tile
(``ops/qlinear.py``, ``models/llama.py``, ``ops/pallas_qmm.py``,
``ops/pallas_flash.py``, ``ops/pallas_attention.py``, ``ops/permute.py``,
``pipeline.py``).  The port reads every one of them here, so that none is
set without effect and without a word:

- the kernel ablations, each honoured only when its variable asks for it,
  as in JAX, and announced with one line on its first use in a process
  (`announce`):

  - ``QEFT_PALLAS=0`` (`PALLAS`): every packed linear dequantized, then
    multiplied by ``torch.matmul`` (``qlinear_xla``), in place of K1, K2,
    K5, K6 and K7; training differentiates through that path;
  - ``QEFT_FLASH_ATTN=0`` (`FLASH_ATTN`): window attention the plain masked
    softmax, q.k rounded to the activation dtype (XLA's attention), in
    place of K3;
  - ``QEFT_PALLAS_ATTN=0`` (`PALLAS_ATTN`): decode attention the plain path
    over the whole cache, in place of K4 and K4q;
  - ``QEFT_GEMV_F32W=0`` (`GEMV_F32W`): a variant of the decode matvec
    kernel (K1, K5, K6) that rounds each dequantized weight, code x scale,
    to bf16 before the product (``pallas_qmm._plane_dot``);

- a selector whose "off" value only picks another kernel:
  ``QEFT_FUSED_DECODE=0`` runs the decode stages as the norm in PyTorch,
  the plain stacked matvec (K6) and the residual add; ``QEFT_STACKED_GEMV=0``
  runs them through the unstacked matvec (K5) on each layer's view;
- a TPU tiling or layout knob has no counterpart in the port (its kernels
  tile for the H100): setting one prints one warning per process.

`check` runs where every entry point resolves its device
(``device.resolve_device``).  Every variable is read there (and once at
import) into the module's flags, which the kernel paths read on every
call; a change of the environment takes effect at the next entry point.
"""

from __future__ import annotations

import contextlib
import os
import warnings

# the off values as qeft_tpu compares them
_OFF_PALLAS = ("0", "false", "off")
_OFF_FLAG = ("0", "", "false")

# name -> (flag of this module, off values, what the off value runs instead)
ABLATIONS = {
    "QEFT_PALLAS": ("PALLAS", _OFF_PALLAS,
                    "every packed linear dequantized, then multiplied by torch.matmul, in "
                    "place of K1, K2, K5, K6 and K7"),
    "QEFT_FLASH_ATTN": ("FLASH_ATTN", _OFF_PALLAS,
                        "window attention as the plain masked softmax (q.k rounded to the "
                        "activation dtype) in place of K3"),
    "QEFT_PALLAS_ATTN": ("PALLAS_ATTN", _OFF_PALLAS,
                         "decode attention as the plain path over the whole cache in place of "
                         "K4 and K4q"),
    "QEFT_GEMV_F32W": ("GEMV_F32W", _OFF_FLAG,
                       "K1, K5 and K6 with each dequantized weight rounded to bf16 before the "
                       "product (their bf16w variant)"),
}
# the TPU tiling and layout knobs, not ported on purpose (ROADMAP, "Port the
# math, not TPU-only workarounds")
TPU_KNOBS = ("QEFT_ATTN_BLK", "QEFT_FLASH_BLKQ", "QEFT_FLASH_BLKK", "QEFT_O_BAND",
             "QEFT_PAD_UPGATE", "QEFT_SEXP_REPEAT", "QEFT_GEMV_TELE", "QEFT_GEMV_BN")

_warned: set = set()
_announced: set = set()


def _flag(name: str, off=_OFF_FLAG) -> bool:
    return os.environ.get(name, "1") not in off


def _read_selectors() -> None:
    """``QEFT_STACKED_GEMV`` (default on): the decode matvec reads the
    stacked linear at its layer (K6, and K1 for a fused stage); off, each
    layer's view goes through K5, as qeft_tpu's scan-sliced layers do.
    ``QEFT_FUSED_DECODE`` (default on) with the stacked matvec: a decode
    stage runs K1, the norm and the residual inside the kernel; off, the
    norm, the matvec and the residual add run one after another.  The
    ablation flags of `ABLATIONS` (default on: the kernels)."""
    global STACKED_GEMV, FUSED_DECODE
    STACKED_GEMV = _flag("QEFT_STACKED_GEMV")
    FUSED_DECODE = _flag("QEFT_FUSED_DECODE") and STACKED_GEMV
    for name, (flag, off, _) in ABLATIONS.items():
        globals()[flag] = _flag(name, off)


STACKED_GEMV = FUSED_DECODE = PALLAS = FLASH_ATTN = PALLAS_ATTN = GEMV_F32W = True
_read_selectors()


def announce(name: str) -> None:
    """One line, the first time in a process that ablation ``name`` (a key
    of `ABLATIONS`) takes effect, naming what runs in place of the kernels."""
    if name not in _announced:
        _announced.add(name)
        print(f"[qeft_tpu_torch] {name}={os.environ.get(name)!r}: {ABLATIONS[name][2]}",
              flush=True)


@contextlib.contextmanager
def setting(**values: str):
    """The variables ``values`` set in the environment (and the flags read)
    inside the block, their previous values back after it."""
    old = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    _read_selectors()
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value
        _read_selectors()


def check() -> None:
    """Warn once per process for each TPU knob that is set; read the
    selectors and the ablation flags."""
    for name in TPU_KNOBS:
        if name in os.environ and name not in _warned:
            _warned.add(name)
            warnings.warn(f"{name} tunes a TPU kernel of qeft_tpu; the port's CUDA kernels do "
                          "not carry it and ignore it", RuntimeWarning, stacklevel=3)
    _read_selectors()
