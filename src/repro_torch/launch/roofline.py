"""Roofline terms of a step on the H100, the port's copy of the JAX
package's ``launch/roofline.py``.

The reference walks a compiled XLA program (``analyze_hlo``).  The port
counts what a function runs instead: :func:`count_ops` runs it under
:class:`repro_torch.counting.OpCounter` and returns the same
:class:`HLOStats` fields (FLOPs, HBM bytes, collective bytes by kind,
loops of unknown trip count), plus FLOPs per dtype and each hand-written
kernel's launches and work.  The count is the same whichever route runs:
the kernels on the card, their plain versions on the CPU, or shapes alone
on the meta device.  HBM bytes are operand plus result bytes of every
eager op, so they read higher than XLA's count of a fused program; they
are not held to the reference's.

Peaks (NVIDIA H100 SXM5 data sheet, dense, at the card's 700 W limit;
spec constants, not measurements): 989 TFLOP/s for bf16 and fp16
products, 67 TFLOP/s for float32 with TF32 off (any other dtype is
charged at that rate), 3.35 TB/s of HBM3, 450 GB/s per direction of
NVLink (the reference has one ICI link at 50 GB/s).  Each dtype's FLOPs
go to its own peak.
"""
from __future__ import annotations

import dataclasses

import torch

from ..counting import OpCounter

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction


@dataclasses.dataclass
class HLOStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    bytes_by_device: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @classmethod
    def from_counter(cls, c: OpCounter) -> "HLOStats":
        return cls(flops=c.flops, hbm_bytes=float(c.hbm_bytes),
                   collective_bytes=c.collective_bytes,
                   collectives=dict(c.collectives),
                   unknown_trip_loops=c.unknown_trip_loops,
                   flops_by_dtype={str(k).replace("torch.", ""): v
                                   for k, v in c.flops_by_dtype.items()},
                   kernels={k: dict(v) for k, v in c.kernels.items()},
                   bytes_by_device=dict(c.bytes_by_device),
                   peak_live_bytes=float(c.peak_live_bytes))

    def compute_s(self) -> float:
        """Each dtype's FLOPs over its peak."""
        return sum(f / PEAK_FLOPS.get(getattr(torch, d), PEAK_FLOPS[
            torch.float32]) for d, f in self.flops_by_dtype.items())


def count_ops(fn, *args, **kwargs) -> HLOStats:
    """What ``fn(*args, **kwargs)`` runs, counted per rank."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return HLOStats.from_counter(c)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops (hlo_flops is per rank)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def mfu(self, seconds: float) -> float:
        """Model FLOPs over what the cards' bf16 peak does in ``seconds``."""
        return self.model_flops / (seconds * self.chips * PEAK_BF16)

    def as_dict(self, seconds: float | None = None) -> dict:
        """The report; with a measured step time also ``seconds`` and
        ``mfu``."""
        out = {**dataclasses.asdict(self), "dominant": self.dominant,
               "useful_flops_ratio": self.useful_flops_ratio}
        if seconds is not None:
            out.update(seconds=seconds, mfu=self.mfu(seconds))
        return out


def roofline_from_stats(stats: HLOStats, *, arch: str, shape: str, mesh: str,
                        chips: int, model_flops: float) -> RooflineReport:
    """Stats are per rank, so the terms divide by one card's peaks."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=stats.flops, hbm_bytes=stats.hbm_bytes,
        collective_bytes=stats.collective_bytes,
        model_flops=model_flops,
        compute_s=stats.compute_s(),
        memory_s=stats.hbm_bytes / HBM_BW,
        collective_s=stats.collective_bytes / NVLINK_BW,
    )


def model_flops_for(cfg, shape, mode: str) -> float:
    """6 N_active D for training, 2 N_active D for an inference forward."""
    n_active = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
