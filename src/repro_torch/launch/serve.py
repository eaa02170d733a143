"""Serving entry point: streaming tabular synthesis on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --requests 16 --sizes 100,256,777 [--conditional] [--device cpu]

The counterpart of the JAX package's ``run_tabular_server``
(``launch/serve.py``, tabular mode): a short Fed-TGAN run
(``run_federated``, 3 quantity-skewed clients of ``adult``) trains the
generator and fits the encoders, the table is registered with a ladder
fitted to the expected sizes, warmed up, and a mixed-size trace drains
through :class:`~repro_torch.serve.StreamingSynthesizer`.  ``make_tenant``
builds a servable table with a freshly initialized generator instead,
for serving runs that need no training.  The LLM mode of the reference
is not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ctgan_paper
from ..core.architectures import run_federated
from ..device import resolve_device, seeded_generator
from ..gan.ctgan import CTGANConfig, Generator, init_generator
from ..serve import StreamingSynthesizer, TableRegistry, ladder_from_sizes
from ..tabular import (TableEncoders, fit_centralized_encoders, make_dataset,
                       partition_quantity_skew)
from ..tabular.datasets import TabularDataset

# the reference's warm-up model (launch/serve.py, run_tabular_server)
WARMUP_CONFIG = CTGANConfig(batch_size=100, gen_hidden=(128, 128),
                            disc_hidden=(128, 128), pac=10, z_dim=64)


def make_tenant(name: str, *, n_rows: int | None = None,
                cfg: CTGANConfig = ctgan_paper.CONFIG, seed: int = 0,
                device: torch.device | str = "cuda"
                ) -> tuple[TabularDataset, TableEncoders, Generator,
                           torch.Tensor]:
    """One servable table on ``device``: the dataset, its encoders (VGMs
    fitted on the device), a generator initialized from ``seed``, and the
    table's encoded rows (one ``vgm_encode_table`` dispatch) from which
    registration derives the conditional-sampling marginals."""
    dev = resolve_device(device)
    ds = make_dataset(name, n_rows=n_rows, seed=seed)
    rng = torch.Generator(device=dev).manual_seed(seed)
    enc = fit_centralized_encoders(ds.data, ds.schema, generator=rng,
                                   device=dev)
    gen = init_generator(cfg, enc.cond_dim, enc.encoded_dim, generator=rng,
                         device=dev)
    encoded = enc.encode(ds.data, generator=rng)
    return ds, enc, gen, encoded


def run_tabular_server(*, requests: int = 16,
                       sizes: tuple[int, ...] = (100, 256, 777),
                       rounds: int = 4, local_steps: int = 2,
                       n_rows: int = 1500, conditional: bool = False,
                       scheduler: str = "fifo", seed: int = 0,
                       cfg: CTGANConfig = WARMUP_CONFIG,
                       device: torch.device | str = "cuda",
                       quiet: bool = False) -> dict:
    """Warm up a generator federatedly (``rounds`` x ``local_steps`` on
    ``adult`` with ``n_rows`` rows over 3 quantity-skewed clients), register
    it, warm up the server, and serve a trace of ``requests`` requests
    cycling through ``sizes``.  Returns the server stats plus throughput
    fields."""
    def say(msg):
        if not quiet:
            print(msg)

    dev = resolve_device(device)
    ds = make_dataset("adult", n_rows=n_rows, seed=seed)
    parts = partition_quantity_skew(ds, 3, small_rows=200)
    say(f"warm-up: {rounds} federated rounds on {ds.name} ({ds.n_rows} rows,"
        f" {len(ds.schema)} cols) on {dev}")
    res = run_federated(parts, ds.schema, cfg=cfg, rounds=rounds,
                        local_steps=local_steps, seed=seed, device=dev)
    enc, gen = res.encoders, res.final_g_params
    encoded = enc.encode(ds.data, generator=seeded_generator(dev, seed, 7))
    registry = TableRegistry()
    registry.register(ds.name, cfg, enc, gen, ladder=ladder_from_sizes(sizes),
                      encoded=encoded, device=dev)
    server = StreamingSynthesizer(registry, scheduler=scheduler, device=dev)
    built = server.warmup(conditional=conditional)
    ladder = registry.get(ds.name).ladder.buckets
    say(f"warmup: ran {built} programs for buckets {ladder} on {dev}")

    for r in range(requests):
        server.submit(ds.name, sizes[r % len(sizes)], seed=seed * 1000 + r,
                      conditional=conditional)
    t0 = time.perf_counter()
    responses = server.serve()
    dt = time.perf_counter() - t0

    stats = server.stats()
    rows = sum(r.rows for r in responses)
    if not all(np.isfinite(r.data).all() for r in responses):
        raise RuntimeError("a response holds non-finite values")
    stats.update(seconds=dt, rows_per_s=rows / max(dt, 1e-9),
                 buckets=list(ladder))
    say(f"served {len(responses)} requests / {rows} rows in {dt:.3f}s "
        f"({stats['rows_per_s']:.0f} rows/s) on {dev}: "
        f"{stats['serving_compiles']} serving compiles, "
        f"{stats['cache_hits']}/{len(responses)} warm, "
        f"decode dispatches {stats['decode_dispatches']}")
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16, help="trace length")
    ap.add_argument("--sizes", default="100,256,777",
                    help="comma list of request row counts, cycled")
    ap.add_argument("--rows", type=int, default=1500,
                    help="rows of the registered table")
    ap.add_argument("--rounds", type=int, default=4,
                    help="federated warm-up rounds")
    ap.add_argument("--conditional", action="store_true",
                    help="draw condition vectors from the table's marginals")
    ap.add_argument("--scheduler", choices=("fifo", "continuous"),
                    default="fifo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run_tabular_server(requests=args.requests,
                       sizes=tuple(int(s) for s in args.sizes.split(",")),
                       rounds=args.rounds,
                       n_rows=args.rows, conditional=args.conditional,
                       scheduler=args.scheduler, device=args.device)


if __name__ == "__main__":
    main()
