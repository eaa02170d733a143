"""The port's dry runs (``launch/dryrun.py``, ``launch/fed_dryrun.py``) on
fake process groups: smollm-135m x train_4k at full size on 16x16 as the
user runs it (in a subprocess), and the federated rounds on 4 clients.

Each record must be OK (SKIP exactly where ``supported_shapes`` skips),
and its per-rank ``argument_size_in_bytes`` must equal an independent sum
of rank 0's shard bytes computed from the specs (``ceil(dim / ways)`` per
sharded dim), exactly.  Every fake group is made and destroyed inside the
dry run; each test checks that none is left.  No JAX: the dry runs are
the port's own (their specs are held to the reference's in
``test_torch_shardings.py``).  The smoke combos are in
``test_torch_dryrun.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import fed_dryrun  # noqa: E402
from repro_torch.models import (INPUT_SHAPES, InputShape,  # noqa: E402
                                Transformer, tree_items)
from repro_torch.launch.dryrun import spec_argument_bytes  # noqa: E402
from torch_dryrun_cases import (ROOT, no_group_left,  # noqa: E402,F401
                                one_thread)

pytestmark = pytest.mark.usefixtures("one_thread", "no_group_left")


def test_full_size_train_combo_as_the_user_runs_it(tmp_path):
    """smollm-135m x train_4k on 16x16 (256 ranks on the fake backend), by
    the module's command line in its own process."""
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "OK" and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_size_in_bytes"] == spec_argument_bytes(
        get_config("smollm-135m"), INPUT_SHAPES["train_4k"], (16, 16))
    assert "1 OK, 0 SKIP, 0 FAIL" in proc.stdout


@pytest.mark.parametrize("variant", ["default", "shard_map", "faults"])
def test_ctgan_fed_round_on_4_clients(variant):
    rec = fed_dryrun.run_one("ctgan-paper", False,
                             shard_map=variant == "shard_map",
                             faults=variant == "faults", mesh_shape=(4, 2))
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["clients"] == 4
    k = rec["kernels"]
    steps = fed_dryrun.LOCAL_STEPS
    clients = 1 if variant == "shard_map" else 4
    # a critic step and a generator step each run the generator forward;
    # the generator step's backward runs the activations' backward
    assert k["segment_activations"]["launches"] == 2 * steps * clients
    assert k["segment_activations_bwd"]["launches"] == steps * clients
    if variant == "shard_map":
        assert "weighted_agg" not in k
        assert set(rec["collectives"]) == {"all-reduce"}
    else:
        assert k["weighted_agg"]["launches"] == 1
        assert rec["collectives"] == {}


@pytest.mark.parametrize("agg", ["f32", "bf16"])
def test_lm_fed_round_merges_in_one_all_reduce(agg):
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"))
    rec = fed_dryrun.run_one("smollm-135m", False, agg, mesh_shape=(4, 2),
                             cfg=cfg, shape=InputShape("train_4k", 16, 8,
                                                       "train"))
    assert rec["status"] == "OK", rec.get("traceback")
    n = sum(t.numel() for _, t in tree_items(
        Transformer(cfg).init(device="meta")))
    assert rec["collectives"] == {
        "all-reduce": 2 * n * (4 if agg == "f32" else 2)}
