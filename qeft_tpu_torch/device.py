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
