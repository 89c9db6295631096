"""Device resolution: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; asking for cuda without a GPU raises.

    The CPU is used only when the caller names it: nothing falls back to the
    CPU quietly, so a run that was meant for the card never measures the
    host by mistake.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev



def on_cuda(x: torch.Tensor) -> bool:
    """Does ``x`` live on the GPU (and so take the hand-written kernels)?"""
    return x.device.type == "cuda"
