"""Checkpoints as a flat ``.npz`` of arrays keyed by tree path plus a JSON
manifest, the port's copy of the JAX package's ``checkpoint/
checkpoint.py``: the same file names (``ckpt_{step:08d}.npz`` and
``.json``), written atomically by tmp-then-rename, so either package reads
the other's files (:mod:`repro_torch.checkpoint.fed_checkpoint` maps the
port's states onto the reference's keys)."""
from __future__ import annotations

import json
import os
import re
from typing import Mapping

import numpy as np


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, flat: Mapping[str, np.ndarray],
                    treedef: str = "") -> str:
    """Write ``flat`` as checkpoint ``step`` of ``ckpt_dir``; returns the
    ``.npz`` path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path + ".npz")
    manifest = {"step": step, "keys": sorted(flat), "treedef": treedef}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    return path + ".npz"


def latest_step(ckpt_dir: str) -> int | None:
    """The largest step with a checkpoint in ``ckpt_dir`` (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None
                       ) -> tuple[int, dict[str, np.ndarray]]:
    """(step, every array of checkpoint ``step``, the latest by default)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(_path(ckpt_dir, step) + ".npz") as data:
        return step, {k: data[k] for k in data.files}
