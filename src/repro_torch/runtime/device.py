"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """The ``torch.device`` for ``device``; a CUDA device must exist.

    The port's entry points default to ``"cuda"`` and raise here on a host
    without a GPU: running on the CPU is the caller's explicit choice
    (``device="cpu"``), never a silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch path on the host"
        )
    return dev
