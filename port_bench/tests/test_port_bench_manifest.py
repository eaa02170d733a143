"""BENCHMARK.json against the contract's shapes and the files the harness
finds by name: names and units, cells, configurations, traffic mixes,
limits and metric readers."""
import ast
import json
import re
import types

import pytest

from _small import ROOT

from port_bench import harness

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = [c["name"] for c in MAN["workloads"]]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys():
    assert sorted(MAN) == sorted(["command", "paths", "run_seconds",
                                  "configs", "workloads", "end_to_end",
                                  "per_layer"])
    assert MAN["paths"] == ["port_bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    ctx = harness.context(cell, 1, 1.0, False, "cpu")
    assert ctx.cell["chips"] == 1
    assert (ROOT / "port_bench" / "kinds"
            / f"{ctx.traffic['kind']}.py").exists()
    assert set(harness.limits(cell)) >= {"cat_mismatch", "value_gap"} or \
        set(harness.limits(cell)) >= {"encode_gap", "weight_gap", "loss_gap",
                                      "grad_gap", "change_gap"}
    reported = {m["name"] for m in harness.cell_metrics(MAN, cell,
                                                        "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(MAN, cell, "per_layer")


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    for cell in metric["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(MAN, cell,
                                                       "end_to_end")}
        assert metric["moves"] in e2e, (metric["name"], cell)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_reader_declares_what_the_manifest_says(metric):
    mod = harness.reader(metric["name"])
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]
        assert mod.MOVES == metric["moves"]
    else:
        assert mod.MOVES is None


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["dtype"] == "float32"
    assert cfg["file"].startswith("port_bench/")
    # the schema: Table 1's column counts, and the encoded width its
    # categories and (1 + max_modes) lanes a continuous column give
    cats = data["categorical"]
    assert len(cats) == data["categorical_columns"]
    assert len(data["continuous"]) == data["continuous_columns"]
    assert data["encoded_width"] == (
        sum(len(c["counts"]) for c in cats)
        + len(data["continuous"]) * (1 + data["max_modes"]))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "port_bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference_package(path):
    top = {m.split(".")[0] for m in _imports(path) if m}
    assert not top & BANNED
    if "reference" in path.parts:
        assert "repro_torch" not in top      # nothing of the program


@pytest.mark.parametrize("busy_s", [0.5, 0.0])
def test_device_readers_divide_the_traced_busy_time(busy_s):
    """The end-to-end metrics: the traced window's busy time over its rows;
    nothing without a trace (the CPU's runs)."""
    from port_bench import work
    trace = types.SimpleNamespace(busy_s=busy_s, window_s=10.0)
    train = {"kind": "train", "trace": trace,
             "traced": {"rows": 250_000, "steps": 500, "model_flops": 1e12}}
    reqs = [{"rows": 100, "done": 1.0, "bucket": 128},
            {"rows": 60, "done": 2.0, "bucket": 64},
            {"rows": 50, "done": None, "bucket": None}]
    serve = {"kind": "serve", "trace": trace, "traced": {"requests": reqs}}
    want = {"train_busy_us_per_row": (train, 1e6 * busy_s / 250_000),
            "train_mfu": (train, 100 * 1e12 / (busy_s * work.PEAK_F32_FLOPS)
                          if busy_s else None),
            "serve_busy_us_per_row": (serve, 1e6 * busy_s / 160),
            "bulk_busy_us_per_row": (serve, 1e6 * busy_s / 160)}
    for name, (run, value) in want.items():
        got = harness.reader(name).read(run)
        if busy_s:
            assert got == pytest.approx(value), name
        else:
            assert got is None, name
    assert harness.reader("train_busy_us_per_row").read(serve) is None
    assert harness.reader("serve_busy_us_per_row").read(train) is None
