"""Device selection shared by every entry point of the package."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU.  Without one the call fails: the CPU is used
    only when the caller names it (``device="cpu"``), never as a fallback.
    Every entry point passes here, so the kernel-path environment variables
    are checked here (`env.check`)."""
    from qeft_tpu_torch import env

    env.check()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``t`` lives on ``device`` (index-agnostic for cuda)."""
    if t.device.type != device.type:
        raise ValueError(f"{what} lives on {t.device}, expected {device}")


# What a tree placed on the card must leave free beside it: a block's working
# set while it is quantized or evaluated (its f32 weights and their quantized
# copy, the Hessians, the GPTQ column programs with their MSE grid chunk of
# up to 4 GiB, the calibration activations).  Llama-2-7B at full depth in
# f32 with 128 x 2048 calibration peaked at 64.61 GB on an H100 80GB HBM3
# (the quantize CLIs): the tree and its fake copy (2 x 27 GB) plus 10.6 GB.
DEVICE_MARGIN = 16 << 30


def fits_on_device(nbytes: int, device: torch.device) -> bool:
    """Whether ``nbytes`` fit on ``device`` with `DEVICE_MARGIN` to spare,
    from the free memory ``torch.cuda.mem_get_info`` reads; host memory
    always holds them."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return nbytes + DEVICE_MARGIN <= free
