"""Where the port runs: CUDA unless the caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None,
                   who: str = "StreakEngine") -> torch.device:
    """The device `who` runs on: CUDA unless the caller asks for another one.

    Raises when CUDA is asked for (explicitly, or by passing None) and is
    not available — nothing in the port drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain torch versions of the kernels")
    return device
