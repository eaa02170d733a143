"""The federated architectures of the paper (§3, §5) on the port's CTGAN:
Fed-TGAN (``weighting="fedtgan"``), vanilla FL-TGAN (``"uniform"``) and
the Fed\\SW ablation (``"quantity"``), the port's copy of the JAX
package's ``core/architectures.py:run_federated``.

``run_federated`` stages the federation (:func:`repro_torch.fed.
setup_federation`), runs the global rounds through
:class:`repro_torch.fed.FederatedProgram` in stretches between evaluation
points, and evaluates through ``synthesize_table`` and
``similarity_report``.  Only the dense one-program path (``program="fed"``)
is ported; the options of the other renderings raise
``NotImplementedError`` naming their ROADMAP entry, and
``run_centralized`` and ``run_mdtgan`` are not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device, seeded_generator
from ..fed.program import FederatedProgram
from ..fed.setup import setup_federation
from ..gan.ctgan import CTGANConfig, Generator
from ..synth import synthesize_table
from ..tabular.encoders import ColumnSpec, TableEncoders
from ..tabular.metrics import similarity_report
from . import comm_model

EVAL_STREAM = 999

# the ROADMAP entries (queue 1, item 3) that port the other renderings
_FAULTS = ("program='host', faults, guard, participation, FedProx and "
           "checkpoint/resume")
_PRIVACY = "DP and privacy"
_SCALE = "client_chunk, tile_federation, scenarios and sharded"


@dataclasses.dataclass
class FedRunResult:
    name: str
    weights: np.ndarray
    history: list[dict]            # per eval point: round, metrics, losses
    encoders: TableEncoders
    final_g_params: Generator      # the merged generator (every client's)
    seconds: float                 # the rounds and evaluations, not setup
    comm_bytes_per_round: float


def run_federated(client_data: Sequence[np.ndarray],
                  schema: Sequence[ColumnSpec], *,
                  cfg: CTGANConfig = CTGANConfig(), rounds: int = 20,
                  local_steps: int = 1, seed: int = 0,
                  weighting: str = "fedtgan",
                  eval_real: np.ndarray | None = None,
                  eval_every: int = 5, eval_samples: int = 4096,
                  name: str | None = None, program: str = "fed",
                  faults=None, guard=None, participation: float = 1.0,
                  fedprox_mu: float = 0.0, client_chunk: int | None = None,
                  edges: int | None = None, ckpt_dir: str | None = None,
                  resume: bool = False, dp=None, trace=None,
                  on_round: Callable | None = None,
                  device: torch.device | str = "cuda") -> FedRunResult:
    """Fed-TGAN (``weighting="fedtgan"``), vanilla FL (``"uniform"``) or
    Fed\\SW (``"quantity"``) on ``device``.

    ``edges`` merges through that many edge aggregators, then the
    federator: one fused ``weighted_agg`` per tier.  With ``eval_real``,
    every ``eval_every`` rounds and after the last, ``eval_samples`` rows
    synthesized from the merged generator are scored against it
    (``avg_jsd``, ``avg_wd``) into ``history``.  ``on_round(r, states,
    metrics)`` is called after round r's merge, with every client's
    :class:`~repro_torch.gan.trainer.GANState` and the round's metrics
    (clients, local steps) on the device."""
    for option, given, entry in (
            ("program='host'", program == "host", _FAULTS),
            ("faults", faults is not None, _FAULTS),
            ("guard", guard is not None, _FAULTS),
            ("participation < 1", participation < 1.0, _FAULTS),
            ("fedprox_mu", fedprox_mu > 0, _FAULTS),
            ("ckpt_dir/resume", bool(ckpt_dir) or resume, _FAULTS),
            ("dp", dp is not None, _PRIVACY),
            ("trace", trace is not None, _PRIVACY),
            ("client_chunk", client_chunk is not None, _SCALE)):
        if given:
            raise NotImplementedError(f"run_federated: {option} is not "
                                      f"ported yet (ROADMAP: {entry})")
    if program != "fed":
        raise ValueError(f"unknown program {program!r}; options: fed, host")
    dev = resolve_device(device)
    P = len(client_data)
    fe = setup_federation(client_data, schema, cfg, seed, weighting,
                          device=dev)
    prog = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                            batch=cfg.batch_size, local_steps=local_steps,
                            weighting=weighting, n_edges=edges)
    bytes_round = comm_model.fl_bytes_per_round(
        P, comm_model.param_bytes(fe.states[0].params()))

    history: list[dict] = []
    t0 = time.perf_counter()

    def is_eval_round(r: int) -> bool:
        return eval_real is not None and ((r + 1) % eval_every == 0
                                          or r == rounds - 1)

    states = fe.states
    stops = [r for r in range(rounds) if is_eval_round(r)]
    if rounds and (not stops or stops[-1] != rounds - 1):
        stops.append(rounds - 1)
    start = 0
    for stop in stops:
        def hook(i, st, m, start=start):
            if on_round is not None:
                on_round(start + i, st, m)
        states, metrics = prog.run(states, fe.tables, fe.S, fe.n_rows,
                                   stop + 1 - start, on_round=hook)
        if is_eval_round(stop):
            synth_raw = synthesize_table(
                states[0].gen, cfg, fe.enc, eval_samples, device=dev,
                generator=seeded_generator(dev, seed, EVAL_STREAM, stop))
            rep = similarity_report(eval_real, synth_raw, schema)
            rep.update(round=stop + 1,
                       d_loss=float(torch.mean(metrics["d_loss"][-1])),
                       g_loss=float(torch.mean(metrics["g_loss"][-1])),
                       t=time.perf_counter() - t0)
            history.append(rep)
        start = stop + 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return FedRunResult(name or f"fed-{weighting}",
                        fe.weights.cpu().numpy(), history, fe.enc,
                        states[0].gen, time.perf_counter() - t0, bytes_round)
