"""Which device an entry point of the port runs on.

The port runs on a CUDA device unless the caller names another one: every
entry point that takes ``device=None`` resolves it here, and none of them
carries on on the CPU because no card was found.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; without one this raises rather
    than fall back to the CPU, which only an explicit ``device="cpu"``
    selects."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "viennaray_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
