"""Device resolution shared by the port's entry points.

Entry points default to ``"cuda"``. A CUDA request on a machine without a
usable GPU raises; nothing silently drops to the CPU. Tests and CPU runs
pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cpu"``/`torch.device` -> a usable device.

    Raises RuntimeError when a CUDA device is requested and none exists.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
