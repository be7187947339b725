"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, raising where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)
