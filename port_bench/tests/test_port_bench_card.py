"""On the card, at each cell's own size: the program's readings stay
within the cell's limits, and the control (the reference with TF32 on,
the nearest precision below the configurations' float32) and every fault
planted in the reference put in the program's place exceed at least one
of them.  Needs a CUDA card; skips without one:

    python -m pytest -q port_bench/tests/test_port_bench_card.py
"""
import json

import pytest

from _small import ROOT, SEED

from port_bench import control, harness

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_control_and_faults_fail_the_program_passes(card, cell):
    limits = harness.limits(cell)
    out = control.readings(harness.context(cell, SEED, 2.0, False, "cuda"), 1)

    def fails(nums):                 # the numbers a run compares
        return any(v > limits[k] for k, v in nums.items() if k in limits)
    assert not fails(out["sound"]), out["sound"]
    for name, nums in out.items():
        if name == "control" or name.startswith("fault:"):
            assert fails(nums), (name, nums)
