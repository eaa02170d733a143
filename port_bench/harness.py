"""The benchmark's harness: one run of one cell.

Everything is found by name.  ``BENCHMARK.json`` names the cell; the
cell names its configuration (``configs/<config>.json``) and its traffic
mix (``traffic/<traffic>.json``), whose ``kind`` names its module
(``kinds/<kind>.py``: ``setup``, ``window``, ``check``); each metric is a
reader ``metrics/<metric>.py`` with ``read(run)``; the limits of the
output check are ``limits/<cell>.json``.  A new cell, mix or metric is new
files and entries; no file here changes.

A run: set-up (timed as ``setup_s`` from the process's start), the
measured window of ``--seconds`` under the device trace, which the
end-to-end metrics read (with ``--trace 1`` an untraced window as long
comes first, which the per-layer metrics of the host's clock read), the
peak device memory, the program's state freed, then the output check
against the plain reference.  The last line of standard output is the result;
every number compared, beside its limit, ends standard error and the
result's line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# compared whole, by the top-level name of each loaded module: the
# measured package's name starts with the reference package's
BANNED = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; options: "
                     f"{[c['name'] for c in man['workloads']]}")


def cell_metrics(man: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those without a ``workloads`` key and those that list
    it."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The module ``metrics/<name>.py`` (``read(run) -> float | None``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(BANNED))


@dataclasses.dataclass
class Context:
    """What a kind's module is given: the cell's entry, its configuration and
    traffic, the seed, the window and the device."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str


def context(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str) -> Context:
    cell = find_cell(manifest(), cell_name)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return Context(cell, config, traffic, int(seed), float(seconds),
                   bool(trace), device)


_CORES: list[int] | None = None


def pin_fastest_core(threads: list[int] = ()) -> int:
    """Pin the calling thread, which runs the program's host path, and
    ``threads`` (thread ids) to the core that runs a fixed Python loop
    fastest now (the median of five passes over every core the process
    may use), and say so on standard error.  The cores of one machine run
    such a loop up to 1.8 times apart, and a core's rate changes within
    minutes.  Threads started before the first pin (the CUDA driver's)
    keep every core."""
    global _CORES
    if _CORES is None:                  # before the first pin: every core
        _CORES = sorted(os.sched_getaffinity(0))
    cores = _CORES
    times: dict[int, list[float]] = {c: [] for c in cores}
    for _ in range(5):
        for c in cores:
            os.sched_setaffinity(0, {c})
            t = time.perf_counter()
            x = 0
            for i in range(20_000):
                x += i
            times[c].append(time.perf_counter() - t)
    med = {c: statistics.median(v) for c, v in times.items()}
    best = min(cores, key=med.__getitem__)
    for tid in (0, *threads):
        try:
            os.sched_setaffinity(tid, {best})
        except OSError:              # the thread has ended
            pass
    print(f"host path on core {best}; loop ms by core: "
          + ", ".join(f"{c}: {1e3 * t:.3f}" for c, t in med.items()),
          file=sys.stderr)
    return best


def threads_on(core: int) -> list[int]:
    """The ids of this process's threads pinned to ``core`` alone: those
    started after the first pin inherit it (autograd's worker for the
    card, which runs the backward's host path)."""
    out = []
    for name in os.listdir("/proc/self/task"):
        try:
            if os.sched_getaffinity(int(name)) == {core}:
                out.append(int(name))
        except OSError:
            pass
    return out


def _quiet_collector() -> None:
    """Collect, then move every live object out of the collector's
    generations, so that its passes in the window walk the window's own
    objects only."""
    gc.collect()
    gc.freeze()


def limits(cell_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell_name}.json")


def run(ctx: Context, t_start: float, core: int | None = None) -> dict:
    """One run of a cell; returns the result line as a dict.  ``core``:
    the core the host path was pinned to, moved before each window to the
    core fastest then."""
    import torch

    from . import tracing
    kind = importlib.import_module(f"port_bench.kinds.{ctx.traffic['kind']}")
    on_card = ctx.device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = kind.setup(ctx)
    if on_card:
        torch.cuda.synchronize()

    # the end-to-end metrics are the device's, read from a traced window;
    # with --trace 1 an untraced window comes first, for the per-layer
    # metrics the host's clock gives, and the traced window follows it
    def before_window():
        nonlocal core
        if core is not None:
            core = pin_fastest_core(threads_on(core))
        _quiet_collector()

    before_window()
    setup_s = time.perf_counter() - t_start
    record = None
    if ctx.trace:
        record = kind.window(state, ctx.seconds, tracing.Trace(False))
        before_window()
    trace = tracing.Trace(on_card)
    traced = kind.window(state, ctx.seconds, trace)
    windows = [traced] if record is None else [record, traced]
    record = dict(traced) if record is None else record
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    record.update(setup_s=setup_s, trace=trace, traced=traced,
                  config=ctx.config, traffic=ctx.traffic)
    numbers = kind.check(state)     # frees the program's state first

    limit_table = limits(ctx.cell["name"])
    # a number that is not finite reads as 1e300: the line stays JSON
    compared = {k: {"value": v if math.isfinite(v) else 1e300,
                    "limit": limit_table[k]} for k, v in numbers.items()}
    correct = (all(w["complete"] for w in windows)
               and all(c["value"] <= c["limit"] for c in compared.values()))

    man = manifest()
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(man, ctx.cell["name"], section):
        value = reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name() if on_card else "cpu"),
              "count": int(ctx.cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct),
              "attempted": sum(r["attempted"] for r in windows),
              "failed": sum(r["failed"] for r in windows), "metrics": metrics,
              "device": device}
    if ctx.trace:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["compared"] = compared
    return result


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda")
    chips = int(ctx.cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.empty(1, device="cuda")          # the context, and its threads
    result = run(ctx, t_start, pin_fastest_core())

    found = banned_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
