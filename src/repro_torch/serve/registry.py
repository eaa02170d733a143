"""Multi-tenant table registry: per-schema device state for serving.

One :class:`TableEntry` per registered table schema holds everything a
request needs resident on the device: the generator, the table's
:class:`~repro_torch.tabular.encoders.DecodePlan` and, for conditional
sampling, the :class:`~repro_torch.synth.sampler.SamplerTables`.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..gan.ctgan import CTGANConfig, Generator
from ..synth.sampler import DeviceSampler, SamplerTables
from ..tabular.encoders import DecodePlan, TableEncoders
from .bucketing import BucketLadder, default_ladder


@dataclasses.dataclass
class TableEntry:
    """Everything resident for one served table schema."""
    name: str
    cfg: CTGANConfig
    encoders: TableEncoders
    gen: Generator
    ladder: BucketLadder
    decode_plan: DecodePlan
    spans: tuple
    cond_dim: int
    tables: SamplerTables | None       # conditional-mode marginals
    device: torch.device
    uid: int = -1                      # registration identity: updating a
                                       # model means unregister(name) then
                                       # register(name, ...) again, which
                                       # yields a fresh uid
    served_rows: int = 0
    served_requests: int = 0
    offered_rows: int = 0              # rows submitted (vs served)
    # live request-size histogram the adaptive ladder refits from
    size_histogram: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def observed_sizes(self) -> tuple[int, ...]:
        """Distinct request sizes seen so far (the refit input)."""
        return tuple(sorted(self.size_histogram))


class TableRegistry:
    """Name -> :class:`TableEntry` map the server draws tenants from."""

    def __init__(self):
        self._entries: dict[str, TableEntry] = {}
        self._next_uid = 0

    def register(self, name: str, cfg: CTGANConfig, encoders: TableEncoders,
                 gen: Generator, *, ladder: BucketLadder | None = None,
                 tables: SamplerTables | None = None,
                 encoded: torch.Tensor | np.ndarray | None = None,
                 device: torch.device | str = "cuda") -> TableEntry:
        """Make a table servable on ``device``.  Builds the decode plan now
        so that its construction never lands inside a request.  Conditional sampling
        needs marginals: pass prebuilt ``tables`` or the table's
        ``encoded`` rows (from ``encoders.encode``, which runs the
        ``vgm_encode_table`` kernel) to derive them from; with neither
        the tenant serves unconditional requests only.  ``gen`` and
        ``encoders`` must already live on ``device``."""
        if name in self._entries:
            raise ValueError(f"table {name!r} already registered")
        dev = resolve_device(device)
        for where, d in (("generator", gen.out.weight.device),
                         ("encoders", encoders.device)):
            if d != dev:
                raise ValueError(f"register({name!r}): {where} on {d}, "
                                 f"not {dev}")
        decode_plan = encoders.decode_plan()
        if tables is None and encoded is not None:
            if isinstance(encoded, torch.Tensor):
                encoded = encoded.cpu().numpy()
            tables = DeviceSampler(encoded, encoders, dev).tables
        entry = TableEntry(
            name=name, cfg=cfg, encoders=encoders, gen=gen,
            ladder=ladder or default_ladder(), decode_plan=decode_plan,
            spans=tuple(encoders.spans()), cond_dim=encoders.cond_dim,
            tables=tables, device=dev, uid=self._next_uid)
        self._next_uid += 1
        self._entries[name] = entry
        return entry

    def get(self, name: str) -> TableEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown table {name!r}; registered: "
                           f"{sorted(self._entries)}") from None

    def unregister(self, name: str) -> None:
        self.get(name)
        del self._entries[name]

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)
