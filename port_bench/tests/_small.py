"""Shared by the benchmark's CPU tests: the harness on the CPU at a small
size (the cells' kinds, traffic shapes and checks, small widths).

Both sides' federation set-ups (the §4.1 VGM merges of 20,000 draws a
column take most of a small run) are kept per process for the inputs they
were made from, and handed out as copies: runs on the same cell and seed
share them.  ``program_setup=False`` makes the program's afresh, for a
test that plants its fault inside that set-up."""
import contextlib
import copy
import hashlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 3_000_000_019          # past 32 signed bits, as a check's may be
SMALL = {"z_dim": 16, "gen_hidden": [32, 32], "disc_hidden": [24, 24],
         "pac": 5, "batch_size": 50, "rows": 600}
TRAFFIC = {"federated": {"clients": 2, "draw_pool": 2},
           "open_loop": {"tenants": 2, "rate_per_s": 30, "size_median": 96,
                         "size_max": 256, "check_requests": 4},
           "closed_loop": {"tenants": 2, "rows": 256, "check_requests": 3}}

_KEPT: dict = {}


def _key(parts, *rest) -> tuple:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.tobytes())
    return (h.hexdigest(), *rest)


def _kept(fn, name):
    def wrapper(parts, *args, **kwargs):
        key = _key(parts, name, repr(args), repr(sorted(kwargs.items())))
        if key not in _KEPT:
            _KEPT[key] = fn(parts, *args, **kwargs)
        return copy.deepcopy(_KEPT[key])
    return wrapper


@contextlib.contextmanager
def _shared_setups(program_setup: bool):
    import repro_torch.fed.setup as program

    from port_bench.reference import protocol
    saved = protocol.federation, program.setup_federation
    protocol.federation = _kept(saved[0], "reference")
    if program_setup:
        program.setup_federation = _kept(saved[1], "program")
    try:
        yield
    finally:
        protocol.federation, program.setup_federation = saved


def run_small(cell: str, seed: int = SEED, seconds: float = 0.2,
              trace: bool = False, program_setup: bool = True) -> dict:
    import torch

    from port_bench import harness
    torch.set_num_threads(1)
    ctx = harness.context(cell, seed, seconds, trace, "cpu")
    ctx.config.update(SMALL)
    ctx.traffic.update(TRAFFIC[ctx.traffic["kind"]])
    with _shared_setups(program_setup):
        return harness.run(ctx, time.perf_counter())
