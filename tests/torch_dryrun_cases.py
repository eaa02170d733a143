"""Shared by the port's dry-run tests (``tests/test_torch_dryrun.py``,
``test_torch_fed_dryrun.py``): the smoke modes, the fixtures and the check
of one smoke combo."""
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config, supported_shapes
from repro_torch.launch import dryrun
from repro_torch.models import InputShape

ROOT = Path(__file__).resolve().parent.parent
MESH = (2, 2)
# the three modes at a smoke size: (name the record carries, shape)
MODES = {"train_4k": InputShape("train_4k", 16, 2, "train"),
         "prefill_32k": InputShape("prefill_32k", 16, 2, "prefill"),
         "decode_32k": InputShape("decode_32k", 16, 2, "decode")}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def check_smoke_combo(arch, mode):
    """One smoke combo on the 2x2 mesh: OK (SKIP where the arch does not
    run the shape), rank 0's argument bytes equal to the arithmetic."""
    cfg, shape = get_smoke_config(arch), MODES[mode]
    rec = dryrun.run_combo(arch, mode, mesh_shape=MESH, cfg=cfg, shape=shape,
                           verbose=False)
    if mode not in supported_shapes(arch):
        assert rec["status"] == "SKIP"
        return
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["memory"]["argument_size_in_bytes"] == \
        dryrun.spec_argument_bytes(cfg, shape, MESH)
    roof = rec["roofline"]
    assert roof["hlo_flops"] > 0 and roof["hbm_bytes"] > 0
    assert rec["collectives"], "a sharded step moves data"
    assert rec["unknown_trip_loops"] == 0
