"""The port's evaluation matrix (``repro_torch.fed.scenarios``) held
against the JAX package's ``fed/scenarios.py`` on the CPU.

* Partitions are numpy on both sides: every scenario's shards equal the
  reference's exactly, at two seeds.
* Fault regimes draw from ``torch.Generator`` streams in the port and from
  threefry keys in the reference, so a regime's plan is held to its
  semantics (shape, validation, determinism in the seed, the dropout and
  straggler rates within 4 standard deviations), and a chaos cell is run
  with the reference's plan injected.
* ``run_matrix``: the reference's matrix is run with its training stubbed
  out (its record assembly, partitions and weights are what is compared;
  compiling its rounds would take about 30 s a cell here).  The records'
  keys are the reference's, in its order; ``client_rows`` are equal; the
  ``uniform`` and ``quantity`` weights within rtol 1e-5, the tolerance of
  ``tests/test_torch_fed.py::test_weights_match_reference`` (both round
  the same float32 weights to 4 places).  The ``fedtgan`` weights are not
  compared here: each package builds its divergence matrix from its own
  random VGM fits (held on a shared matrix in ``test_torch_fed.py``); the
  quantity split's big client must carry the largest of them.
"""
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.architectures as jarch  # noqa: E402
from repro.fed import scenarios as jscen  # noqa: E402
from repro.fed.program import resolve_weights as jax_weights  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro_torch.fed import FaultPlan, scenarios  # noqa: E402
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.tabular import make_dataset  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(batch_size=8, gen_hidden=(16,), disc_hidden=(16,), pac=2,
                  z_dim=8)
ROWS, CLIENTS = 200, 3
MATRIX = dict(scenarios=("quantity", "malicious"),
              weightings=("uniform", "quantity"), n_clients=CLIENTS,
              rows=ROWS, rounds=1, cfg=CFG, eval_samples=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one machine,
    and torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- partitions -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_partition_matches_reference(name, seed):
    ds = make_dataset("adult", n_rows=ROWS, seed=seed)
    jd = jds.make_dataset("adult", n_rows=ROWS, seed=seed)
    np.testing.assert_array_equal(ds.data, jd.data)
    ours = scenarios.partition(name, ds, 4, seed=seed)
    theirs = jscen.partition(name, jd, 4, seed=seed)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert sorted(scenarios.SCENARIOS) == sorted(jscen.SCENARIOS)


def test_unknown_names_raise():
    ds = make_dataset("adult", n_rows=ROWS)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.partition("nope", ds, 2)
    with pytest.raises(ValueError, match="unknown fault regime"):
        scenarios.build_fault_plan("nope", 2, 2)
    with pytest.raises(ValueError, match="unknown weighting"):
        scenarios.run_matrix(scenarios=("iid",), weightings=("nope",),
                             rows=ROWS, device="cpu")
    assert sorted(scenarios.FAULTS) == sorted(jscen.FAULTS)


# ---- fault regimes ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jscen.FAULTS))
def test_fault_regimes_are_validated_and_deterministic(name):
    R, P = 400, 8
    plan = scenarios.build_fault_plan(name, R, P, seed=3)
    if name == "none":
        assert plan is None
        return
    again = scenarios.build_fault_plan(name, R, P, seed=3)
    # one client of 8 picked: two seeds may pick the same one
    others = [scenarios.build_fault_plan(name, R, P, seed=s)
              for s in (4, 5, 6, 7)]
    for leaf in plan:
        assert tuple(leaf.shape) == (R, P)
    assert plan.participate.dtype == torch.bool
    assert bool(plan.participate.any(1).all())
    for a, b in zip(plan, again):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for other in others
               for a, b in zip(plan, other))
    s = plan.summary()
    rate = {"dropout": 0.3, "straggler": float(np.exp(-1.0)),
            "chaos": 0.3}.get(name, 0.0)
    band = 4 * np.sqrt(rate * (1 - rate) / (R * P))
    assert abs(s["dropout_rate"] - rate) <= band, s
    assert s["nan_client_rounds"] == (R if name in ("nan", "chaos") else 0)
    assert s["byzantine_client_rounds"] == (R if name in ("byzantine", "chaos")
                                            else 0)


# ---- run_matrix -------------------------------------------------------------

def _stub_run(calls):
    """The reference's ``run_federated`` reduced to what its matrix reads:
    the resolved weights of the partition, a report, no training."""
    def run_federated(parts, schema, *, weighting, faults, **kw):
        n_rows = jnp.asarray([p.shape[0] for p in parts], jnp.float32)
        calls.append(dict(kw, weighting=weighting, faults=faults))
        return types.SimpleNamespace(
            weights=jax_weights(weighting, jnp.zeros((len(parts), 1)),
                                n_rows),
            history=[{"avg_jsd": 0.0, "avg_wd": 0.0}],
            final_g_params={"w": jnp.zeros(1)}, seconds=0.0, retries=0,
            epsilon=None)
    return run_federated


@pytest.fixture(scope="module")
def reference_records():
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jarch, "run_federated", _stub_run(calls))
        recs = jscen.run_matrix(**MATRIX)
        chaos = jscen.run_matrix(**dict(MATRIX, scenarios=("iid",),
                                        weightings=("fedtgan",),
                                        faults=("chaos",), rounds=2))
    return recs, chaos, calls


def test_run_matrix_records_match_reference(reference_records):
    theirs = reference_records[0]
    ours = scenarios.run_matrix(**MATRIX, device="cpu")
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in ("dataset", "scenario", "weighting", "faults", "clients",
                  "dp_noise", "epsilon", "client_rows", "retries",
                  "fault_summary"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["weights"], b["weights"], rtol=1e-5)
        assert a["finite"] is True
        assert np.isfinite(a["avg_jsd"]) and np.isfinite(a["avg_wd"])
    rows = [r["client_rows"] for r in ours]
    assert rows[0] == [ROWS // 10, ROWS // 10, ROWS]          # quantity
    assert rows[2] == [ROWS // 4, ROWS // 4, ROWS]            # malicious


def test_chaos_cell_with_the_reference_plan(reference_records, monkeypatch):
    """The reference's chaos plan for the cell, injected through
    ``build_fault_plan``: the same fault summary as the reference's
    record, a finite final model, and no retry (the default guard drops
    the NaN and the x64 updates)."""
    _, [theirs], calls = reference_records
    jplan = calls[-1]["faults"]
    plan = FaultPlan(*(torch.from_numpy(np.array(x)) for x in jplan))
    seen = []

    def build(name, rounds, n_clients, *, seed=0):
        seen.append((name, rounds, n_clients, seed))
        return plan.validate()
    monkeypatch.setattr(scenarios, "build_fault_plan", build)
    [ours] = scenarios.run_matrix(**dict(MATRIX, scenarios=("iid",),
                                         weightings=("fedtgan",),
                                         faults=("chaos",), rounds=2),
                                  device="cpu")
    assert seen == [("chaos", 2, CLIENTS, 0)]
    assert ours["fault_summary"] == theirs["fault_summary"]
    assert ours["fault_summary"]["nan_client_rounds"] == 2
    assert ours["finite"] is True and ours["retries"] == 0
    assert list(ours) == list(theirs)


# ---- the CLI ----------------------------------------------------------------

def test_main_prints_the_table(monkeypatch, capsys, tmp_path):
    """The quantity split through the CLI on the CPU: the header and one
    line a cell; under ``fedtgan`` the big client weighs the most, above
    the uniform third."""
    import json
    out = tmp_path / "matrix.json"
    monkeypatch.setattr(sys, "argv", [
        "scenarios", "--device", "cpu", "--rows", str(ROWS), "--rounds", "1",
        "--scenarios", "quantity", "--out", str(out)])
    scenarios.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:3] == ["dataset", "scenario", "weighting"]
    assert [ln.split()[2] for ln in lines[1:]] == ["fedtgan", "uniform"]
    fed = json.loads(out.read_text())[0]
    assert fed["weighting"] == "fedtgan" and fed["finite"]
    assert np.argmax(fed["weights"]) == CLIENTS - 1
    assert fed["weights"][-1] > 1 / CLIENTS


def test_main_exits_nonzero_on_a_non_finite_cell(monkeypatch, capsys):
    rec = {"dataset": "adult", "scenario": "iid", "weighting": "uniform",
           "faults": "nan", "dp_noise": None, "epsilon": None,
           "avg_jsd": float("nan"), "avg_wd": float("nan"), "finite": False,
           "retries": 2, "weights": [0.5, 0.5]}
    monkeypatch.setattr(scenarios, "run_matrix", lambda **kw: [rec])
    monkeypatch.setattr(sys, "argv", ["scenarios", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        scenarios.main()
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "FAIL: non-finite" in out.err and " N " in out.out
