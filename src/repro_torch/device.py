"""Device policy shared by every entry point of the PyTorch package.

Entry points take ``device=None`` and run on the CUDA card by default.
Without a card they raise; they never fall back to the CPU on their own.
The CPU is an explicit request (``device="cpu"``), and on it every kernel
wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` as given.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present, ``ValueError`` for other device types.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")


def device_name(device: torch.device) -> str:
    """Human-readable name of the device a result was computed on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


__all__ = ["DeviceLike", "resolve_device", "device_name"]
