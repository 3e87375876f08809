"""Device selection shared by the port's entry points.

Every entry point runs on the CUDA card unless its caller names another
device; with no card and no explicit device it raises instead of carrying on
silently on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")
