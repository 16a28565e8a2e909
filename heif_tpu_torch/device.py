"""Explicit device selection.

The port never moves work to the CPU behind the caller's back: asking
for "cuda" on a host without a usable CUDA device raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch.device the caller asked for, or raise.

    None means "cuda". A CUDA device requires torch.cuda.is_available();
    a CUDA index must exist. Only "cpu" and "cuda" devices are accepted.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
