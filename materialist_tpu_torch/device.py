"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and a missing card is an error,
never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
