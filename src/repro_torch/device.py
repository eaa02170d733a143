"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card; a
caller without one must ask for the CPU (``device="cpu"``), which runs the
plain PyTorch version of every kernel.  There is no silent fallback.
"""
from __future__ import annotations

import numpy as np
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


def seeded_generator(device: torch.device | str, *ids: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers ``ids``
    (a run's seed, then the stream's and the client's index, ...), so that
    each stream of a run draws independently and reproducibly."""
    seed = int(np.random.SeedSequence([int(i) for i in ids]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)
