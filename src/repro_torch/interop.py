"""Carry state across from the JAX package, as numpy arrays.

``generator_from_reference`` takes generator parameters in the flat
checkpoint key format of the reference (``"res0/fc/w"``, ``"res0/bn_scale"``,
``"out/b"``, ...; ``checkpoint/checkpoint.py``) with Linear weights in
``(fan_in, fan_out)`` layout, and returns the port's :class:`Generator`.
``encoders_from_reference`` takes per-column VGM arrays and label-encoder
categories and returns the port's :class:`TableEncoders`.  With both, the
two packages compute from the same state.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device
from .gan.ctgan import Generator
from .tabular.encoders import ColumnSpec, LabelEncoder, TableEncoders
from .tabular.vgm import VGMParams


def generator_from_reference(flat: Mapping[str, np.ndarray], *,
                             device: torch.device | str = "cuda") -> Generator:
    """The port's generator holding the reference's parameters; its widths
    are read off the arrays' shapes."""
    dev = resolve_device(device)
    n_hidden = len({k.split("/")[0] for k in flat if k.startswith("res")})
    w0 = np.asarray(flat["res0/fc/w"]) if n_hidden else np.asarray(flat["out/w"])
    hidden = [np.asarray(flat[f"res{i}/fc/w"]).shape[1] for i in range(n_hidden)]
    data_dim = np.asarray(flat["out/w"]).shape[1]
    gen = Generator(w0.shape[0], hidden, data_dim, device=dev)

    def put(param, key, transpose=False):
        a = np.asarray(flat[key], np.float32)
        a = np.array(a.T if transpose else a, order="C")
        if tuple(param.shape) != a.shape:
            raise ValueError(f"{key}: shape {a.shape} does not fit "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(a).to(dev))

    with torch.no_grad():
        for i, block in enumerate(gen.res):
            put(block.fc.weight, f"res{i}/fc/w", transpose=True)
            put(block.fc.bias, f"res{i}/fc/b")
            put(block.bn_scale, f"res{i}/bn_scale")
            put(block.bn_bias, f"res{i}/bn_bias")
        put(gen.out.weight, "out/w", transpose=True)
        put(gen.out.bias, "out/b")
    return gen


def encoders_from_reference(schema: Sequence,
                            vgms: Mapping[int, Mapping[str, np.ndarray]],
                            categories: Mapping[int, np.ndarray], *,
                            device: torch.device | str = "cuda"
                            ) -> TableEncoders:
    """``schema`` entries carry ``name/kind/n_categories/max_modes`` (the
    reference's ``ColumnSpec`` will do); ``vgms[j]`` holds column ``j``'s
    ``weights/means/stds/valid`` arrays and ``categories[j]`` its sorted
    raw category ids."""
    dev = resolve_device(device)
    port_schema = [ColumnSpec(c.name, c.kind, c.n_categories, c.max_modes)
                   for c in schema]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    params = {j: VGMParams(t(v["weights"]), t(v["means"]), t(v["stds"]),
                           t(v["valid"], torch.bool))
              for j, v in vgms.items()}
    les = {j: LabelEncoder(np.asarray(c)) for j, c in categories.items()}
    return TableEncoders(port_schema, les, params, dev)
