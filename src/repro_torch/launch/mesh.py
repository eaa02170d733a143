"""Production meshes as ``torch.distributed`` ``DeviceMesh``es, the port's
copy of the JAX package's ``launch/mesh.py``.  Functions, not module
constants: importing this module touches no process group.

A mesh needs a process group of its size.  The production meshes (16x16 =
256 ranks, 2x16x16 = 512) exist here only as dry runs: :func:`fake_world`
makes a world of that size in one process on torch's fake backend, which
runs no collective and moves no data.  It is a dry-run device, never a
run.  :func:`make_host_mesh` spans the real group the caller created (an
NCCL group over the cards, or gloo).
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(size: int):
    """A world of ``size`` ranks on the fake backend, this process rank 0,
    destroyed on exit.  Raises if a process group already exists: the
    fake group must not meet a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current world."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks ("data","model").  Multi-pod: 2x16x16
    = 512 ranks ("pod","data","model").  Needs a world of that size
    (:func:`fake_world` for a dry run)."""
    return make_mesh(*PRODUCTION[multi_pod])


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """A (world // model, model) ("data","model") mesh over the process
    group the caller initialized, on the cards when it is NCCL's."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: initialize a process group "
                           "first (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return make_mesh((n // model, model), ("data", "model"), device)


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch axes of a production mesh ('pod' included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
