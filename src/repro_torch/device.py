"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card; a
caller without one must ask for the CPU (``device="cpu"``), which runs the
plain PyTorch version of every kernel.  There is no silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a :class:`torch.device` with its index filled in;
    raises if it names a CUDA device and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
