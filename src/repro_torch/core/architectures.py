"""The decentralized-training architectures of the paper (§3, §5) on the
port's CTGAN, the port's copy of the JAX package's
``core/architectures.py``: Centralized (``run_centralized``), vanilla
FL-TGAN (``run_federated(weighting="uniform")``), Fed-TGAN (``"fedtgan"``),
the Fed\\SW ablation (``"quantity"``) and MD-TGAN (``run_mdtgan``), all on
the same CTGAN so that their comparison is like for like.

``run_federated`` stages the federation (:func:`repro_torch.fed.
setup_federation`), runs the global rounds in stretches between
evaluation points, and evaluates through ``synthesize_table`` and
``similarity_report``.  ``program="fed"`` runs the rounds through
:class:`repro_torch.fed.FederatedProgram` (one fused ``weighted_agg`` merge
per round); ``program="host"`` is the per-round oracle with the per-leaf
merge (:func:`repro_torch.core.aggregation.weighted_average`, plain torch
ops).  Both honour the degraded-mode options (a ``FaultPlan``, the update
guard, partial participation, FedProx), checkpoint every stretch, resume
from the latest checkpoint, and retry a stretch whose merged model went
non-finite with its suspects blocked.  ``dp`` makes every local step
DP-SGD (:mod:`repro_torch.gan.dp`) and ``trace`` records what the
federation transmits (:class:`repro_torch.privacy.RoundTrace`), under
both programs.  Bytes on the wire come from :mod:`.comm_model`.
``client_chunk`` (the reference's chunked client axis) is taken by both
programs and gives the dense run's result.

Every random stream is seeded from ``seed`` and the stream's index
(:func:`repro_torch.device.seeded_generator`): each round's participation
draw and each evaluation have their own, so a resumed run draws what the
uninterrupted one drew.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..checkpoint import (latest_step, restore_fed_checkpoint,
                          save_fed_checkpoint)
from ..device import resolve_device, seeded_generator
from ..fed.faults import (DEFAULT_NORM_MULT, FaultPlan, PoisonedRunError,
                          UpdateGuard, apply_faults_tree, guard_ok,
                          no_faults, sanitize_stacked, update_diagnostics)
from ..fed.merge import flatten_stacked, replicate
from ..fed.program import FederatedProgram
from ..fed.setup import CLIENT_RNG, ENCODE, INIT, MODEL, setup_federation
from ..gan.ctgan import (CTGANConfig, Generator, apply_activations_fused,
                         conditional_loss, gradient_penalty)
from ..gan.dp import DPConfig
from ..gan.trainer import (GANState, StepNoise, critic_grads, draw_step_noise,
                           init_gan_state, stack_metrics)
from ..interop import flat_to_reference, gan_flat_index
from ..optim import AdamState, adam
from ..synth import (DeviceSampler, RoundEngine, SamplerDraws, SamplerTables,
                     draw_batch, synthesize_table)
from ..tabular.encoders import (ColumnSpec, SpanInfo, TableEncoders,
                                fit_centralized_encoders)
from ..tabular.metrics import similarity_report
from . import comm_model
from .aggregation import weighted_average
from .fedavg import sample_participation

# seed streams of the entry points (beside setup_federation's)
EVAL_STREAM = 999
PARTICIPATION_STREAM = 777

# run_federated's guard default: UpdateGuard() when a FaultPlan is given
# (a chaos run should survive), no guard otherwise
_AUTO_GUARD = object()


@dataclasses.dataclass
class FedRunResult:
    name: str
    weights: np.ndarray
    history: list[dict]            # per eval point: round, metrics, losses
    encoders: TableEncoders
    final_g_params: Generator      # the merged (or central) generator
    seconds: float                 # the rounds and evaluations, not setup
    comm_bytes_per_round: float    # per epoch for MD-TGAN
    retries: int = 0               # poisoned stretches re-run
    blocked: np.ndarray | None = None   # (P,) retry blocklist at exit
    epsilon: float | None = None   # DP (eps, delta) spent per client over
                                   # the run, at the smallest client (None
                                   # without dp=; inf when the batch exceeds
                                   # that client's rows, where the
                                   # subsampling estimate is undefined)


def _evaluate(gen: Generator, cfg: CTGANConfig, enc: TableEncoders,
              eval_real: np.ndarray, schema, n: int, dev: torch.device,
              *stream: int) -> dict:
    synth_raw = synthesize_table(gen, cfg, enc, n, device=dev,
                                 generator=seeded_generator(dev, *stream))
    return similarity_report(eval_real, synth_raw, schema)


def _clone_states(states: Sequence[GANState]) -> list[GANState]:
    """Independent copies of the states, generator states included."""
    out = []
    for s in states:
        rng = torch.Generator(device=s.rng.device)
        rng.set_state(s.rng.get_state())
        out.append(s.replica(rng))
    return out


def _stacked_leaves(states: Sequence[GANState]) -> list[torch.Tensor]:
    """Parameter k of every client stacked on a leading client axis (a
    copy)."""
    with torch.no_grad():
        return [torch.stack(leaves) for leaves in
                zip(*(s.params() for s in states))]


def _flat(stacked: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stacked leaves as the ``(P, D)`` stack :func:`repro_torch.fed.
    flatten_stacked` builds (each client's leaves in order)."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in stacked], dim=1)


def run_federated(client_data: Sequence[np.ndarray],
                  schema: Sequence[ColumnSpec], *,
                  cfg: CTGANConfig = CTGANConfig(), rounds: int = 20,
                  local_steps: int = 1, seed: int = 0,
                  weighting: str = "fedtgan",
                  eval_real: np.ndarray | None = None,
                  eval_every: int = 5, eval_samples: int = 4096,
                  name: str | None = None, program: str = "fed",
                  faults: FaultPlan | None = None, guard=_AUTO_GUARD,
                  participation: float = 1.0, fedprox_mu: float = 0.0,
                  client_chunk: int | None = None,
                  edges: int | None = None, ckpt_dir: str | None = None,
                  resume: bool = False, max_retries: int = 2,
                  retry_backoff: float = 0.0, dp: DPConfig | None = None,
                  trace=None,
                  on_round: Callable | None = None,
                  device: torch.device | str = "cuda") -> FedRunResult:
    """Fed-TGAN (``weighting="fedtgan"``), vanilla FL (``"uniform"``) or
    Fed\\SW (``"quantity"``) on ``device``.

    ``program="fed"`` merges through :class:`FederatedProgram` (one fused
    ``weighted_agg`` per round); ``program="host"`` is the per-round
    oracle with the per-leaf merge and no kernel.  Both draw the same
    streams, so they agree up to the merges' rounding.  ``edges`` merges
    through that many edge aggregators, then the federator (``"fed"``
    only).  ``client_chunk`` runs the local rounds in chunks of that many
    clients under both programs (it must divide the client count); the
    run is bit-identical to the dense one.  With ``eval_real``, every
    ``eval_every`` rounds and after the last, ``eval_samples`` rows
    synthesized from the merged generator are scored against it
    (``avg_jsd``, ``avg_wd``) into ``history``.
    ``on_round(r, states, metrics)`` is called after round r's merge, with
    every client's :class:`~repro_torch.gan.trainer.GANState` and the
    round's metrics on the device.

    Degraded mode:

    ``faults`` -- an (R, P) :class:`~repro_torch.fed.faults.FaultPlan`; the
    rounds run as degraded rounds (mask, guard and renormalization folded
    into the one merge).
    ``guard`` -- the :class:`~repro_torch.fed.faults.UpdateGuard` that
    zeroes corrupt updates; ``UpdateGuard()`` when a plan is given, off
    otherwise; ``None`` turns it off (the diagnostics stay advisory).
    ``participation`` -- each round keeps each client with this
    probability (an empty draw rescues one random client),
    :func:`~repro_torch.core.fedavg.sample_participation`.
    ``fedprox_mu`` -- FedProx's pull toward the round's global parameters
    after every local step.
    ``ckpt_dir`` -- a checkpoint (states, round cursor, blocklist) after
    every stretch; ``resume=True`` restarts from the latest one.
    ``max_retries`` -- a stretch whose merged model is non-finite is run
    again from its starting state with the suspects of its first suspect
    round blocked; past ``max_retries`` such stretches
    :class:`~repro_torch.fed.faults.PoisonedRunError` is raised.
    ``retry_backoff`` sleeps ``retry_backoff * attempt`` seconds before
    each re-run.

    Privacy:

    ``dp`` -- a :class:`~repro_torch.gan.dp.DPConfig`: every client's
    critic step becomes DP-SGD (per-pack clip and Gaussian noise); the
    round still merges in one launch.  ``epsilon`` reports the
    strong-composition estimate at the smallest client (``inf`` when the
    batch exceeds its rows).
    ``trace`` -- a :class:`repro_torch.privacy.RoundTrace` that records the
    §4.1 setup statistics and every round's transmitted ``(P, D)`` stack
    in the reference's layout, under both programs (bit-identical to an
    untraced run); not with faults, a guard or partial participation (a
    masked round's wire is not the dense stack it records)."""
    if program not in ("fed", "host"):
        raise ValueError(f"unknown program {program!r}; options: fed, host")
    if edges is not None and program != "fed":
        raise ValueError("hierarchical aggregation (edges=) requires "
                         "program='fed'; the host oracle keeps the flat "
                         "per-leaf merge")
    P = len(client_data)
    if guard is _AUTO_GUARD:
        guard = UpdateGuard() if faults is not None else None
    use_faulted = faults is not None or guard is not None or participation < 1
    if trace is not None and use_faulted:
        raise ValueError("trace= records the dense transmitted stack; it "
                         "cannot be combined with faults/guard/partial "
                         "participation (the degraded path masks the wire)")
    if use_faulted and faults is None:
        faults = no_faults(rounds, P)
    if faults is not None:
        if (faults.rounds, faults.n_clients) != (rounds, P):
            raise ValueError(
                f"FaultPlan is {(faults.rounds, faults.n_clients)}, run "
                f"needs (rounds, clients) = {(rounds, P)}")
        faults.validate()
    dev = resolve_device(device)
    fe = setup_federation(client_data, schema, cfg, seed, weighting,
                          device=dev)
    layout = None
    if trace is not None:
        trace.record_setup(fe)
        trace.meta.setdefault("program", program)
        trace.meta.setdefault("seed", seed)
        trace.meta.setdefault("dp", dp is not None)
        layout = gan_flat_index(fe.states[0].gen, fe.states[0].disc)
    prog = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                            batch=cfg.batch_size, local_steps=local_steps,
                            weighting=weighting, participation=participation,
                            fedprox_mu=fedprox_mu, guard=guard,
                            client_chunk=client_chunk, n_edges=edges, dp=dp)
    epsilon = None
    if dp is not None:
        n_min = int(torch.min(fe.n_rows))
        epsilon = (dp.epsilon(rounds * local_steps, cfg.batch_size, n_min)
                   if cfg.batch_size <= n_min else float("inf"))
    bytes_round = comm_model.fl_bytes_per_round(
        P, comm_model.param_bytes(fe.states[0].params()))
    w = fe.weights

    history: list[dict] = []
    t0 = time.perf_counter()

    def is_eval_round(r: int) -> bool:
        return eval_real is not None and ((r + 1) % eval_every == 0
                                          or r == rounds - 1)

    def cohort_rngs(start: int, stop: int):
        if participation >= 1.0:
            return None
        return [seeded_generator(dev, seed, PARTICIPATION_STREAM, r)
                for r in range(start, stop + 1)]

    def record(r, flat):
        trace.record_round(r, flat_to_reference(flat, layout).cpu().numpy())

    def host_round(states, fault, rng, r):
        """The oracle round: local rounds, then the per-leaf merge (the
        transmitted stack recorded first when tracing); under a fault
        slice the same degraded math as ``faulted_round``."""
        trees = [s.params() for s in states]
        if fault is None:
            states, m = prog.clients(states, fe.tables)
            if trace is not None:
                record(r, flatten_stacked(trees))
            replicate(weighted_average(_stacked_leaves(states), w), trees)
            return states, m
        participate = fault.participate.to(dev)
        if participation < 1.0:
            participate = participate & sample_participation(
                w, participation, generator=rng)
        prev = _stacked_leaves(states)
        states, m = prog.clients(states, fe.tables)
        tree_f = apply_faults_tree(_stacked_leaves(states), prev,
                                   fault.nan_mask.to(dev),
                                   fault.scale.to(dev))
        nm = (guard.norm_mult if guard is not None and guard.norm_mult > 0
              else DEFAULT_NORM_MULT)
        diag = update_diagnostics(_flat(tree_f), _flat(prev), participate,
                                  norm_mult=nm)
        ok = guard_ok(guard, diag, participate)
        w_eff = w * ok
        wsum = torch.sum(w_eff)
        merged = weighted_average(sanitize_stacked(tree_f, ok), w_eff)
        replicate([torch.where(wsum > 0, a, p[0])
                   for a, p in zip(merged, prev)], trees)
        return states, dict(m, client_ok=ok,
                            client_suspect=participate & diag["suspect"],
                            update_norm=diag["norm"],
                            w_eff=w_eff / torch.clamp(wsum, min=1e-12),
                            merged=wsum > 0)

    def run_chunk(states, start, stop, plan):
        """Rounds start..stop inclusive.  Returns (states, (d, g) last-round
        mean losses, (rounds, P) per-round suspects)."""
        n = stop + 1 - start
        suspects = np.zeros((n, P), bool)
        rngs = cohort_rngs(start, stop)

        def hook(i, st, m):
            if on_round is not None:
                on_round(start + i, st, m)
        if program == "host":
            out = []
            for i in range(n):
                fault = (None if plan is None else
                         FaultPlan(*(leaf[i] for leaf in plan)))
                states, m = host_round(states, fault,
                                       None if rngs is None else rngs[i],
                                       start + i)
                hook(i, states, m)
                out.append(m)
            metrics = stack_metrics(out)
        elif plan is None and trace is not None:
            states, metrics, arts = prog.run_traced(
                states, fe.tables, fe.S, fe.n_rows, n, on_round=hook)
            for i, flat in enumerate(arts["updates"]):
                record(start + i, flat)
        elif plan is None:
            states, metrics = prog.run(states, fe.tables, fe.S, fe.n_rows, n,
                                       on_round=hook)
        else:
            states, metrics = prog.run_faulted(states, fe.tables, fe.S,
                                               fe.n_rows, plan,
                                               generators=rngs, on_round=hook)
        if plan is not None:
            suspects = metrics["client_suspect"].cpu().numpy()
        return states, (torch.mean(metrics["d_loss"][-1]),
                        torch.mean(metrics["g_loss"][-1])), suspects

    stops = [r for r in range(rounds) if is_eval_round(r)]
    if rounds and (not stops or stops[-1] != rounds - 1):
        stops.append(rounds - 1)
    start, retries = 0, 0
    blocked = np.zeros(P, bool)
    states = fe.states
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        start, states, blocked = restore_fed_checkpoint(ckpt_dir, fe.states, P)
    for stop in stops:
        if stop < start:
            continue                      # stretch already checkpointed
        plan = None
        if use_faulted:
            plan = (faults.slice_rounds(start, stop + 1)
                    .block_clients(blocked).validate())
        while True:
            # the states change in place: a degraded stretch runs on a
            # copy, so that a poisoned one restarts from where it began
            work = _clone_states(states) if use_faulted else states
            work, losses, suspects = run_chunk(work, start, stop, plan)
            if not use_faulted or all(bool(torch.isfinite(t).all())
                                      for s in work for t in s.params()):
                break
            retries += 1
            if retries > max_retries:
                raise PoisonedRunError(
                    f"global state non-finite after rounds {start}..{stop}; "
                    f"retry budget ({max_retries}) exhausted")
            # blocklist from the FIRST suspect round: once the merge is
            # poisoned every later round flags everyone (all clients train
            # from NaN), and the union would block the world
            bad_rounds = np.nonzero(suspects.any(axis=1))[0]
            offenders = (suspects[bad_rounds[0]] & ~blocked
                         if bad_rounds.size else np.zeros(P, bool))
            if not offenders.any():
                raise PoisonedRunError(
                    f"global state non-finite after rounds {start}..{stop} "
                    f"but no client is suspect; cannot form a blocklist")
            blocked |= offenders
            plan = (faults.slice_rounds(start, stop + 1)
                    .block_clients(blocked).validate())
            if retry_backoff > 0:
                time.sleep(retry_backoff * retries)
        states = work
        if ckpt_dir:
            save_fed_checkpoint(ckpt_dir, stop + 1, states, blocked)
        if is_eval_round(stop):
            rep = _evaluate(states[0].gen, cfg, fe.enc, eval_real, schema,
                            eval_samples, dev, seed, EVAL_STREAM, stop)
            rep.update(round=stop + 1, d_loss=float(losses[0]),
                       g_loss=float(losses[1]), t=time.perf_counter() - t0)
            history.append(rep)
        start = stop + 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return FedRunResult(name or f"fed-{weighting}", w.cpu().numpy(), history,
                        fe.enc, states[0].gen, time.perf_counter() - t0,
                        bytes_round, retries=retries,
                        blocked=blocked if use_faulted else None,
                        epsilon=epsilon)


def run_centralized(data: np.ndarray, schema: Sequence[ColumnSpec], *,
                    cfg: CTGANConfig = CTGANConfig(), epoch_steps: int = 20,
                    epochs: int = 1, seed: int = 0,
                    eval_real: np.ndarray | None = None,
                    eval_every: int = 5, eval_samples: int = 4096,
                    on_epoch: Callable | None = None,
                    device: torch.device | str = "cuda") -> FedRunResult:
    """The single-site baseline: pooled data, encoders fitted on it, one
    ``vgm_encode_table`` encode for the sampler, and one
    :class:`RoundEngine` round of ``epoch_steps`` steps per epoch.
    ``on_epoch(ep, metrics)`` is called after each epoch (metrics
    (steps,) on the device)."""
    dev = resolve_device(device)
    enc = fit_centralized_encoders(data, schema, device=dev,
                                   generator=seeded_generator(dev, seed, INIT))
    encoded = enc.encode(data, generator=seeded_generator(dev, seed, ENCODE))
    sampler = DeviceSampler(encoded.cpu().numpy(), enc, dev)
    state = init_gan_state(cfg, enc.cond_dim, enc.encoded_dim,
                           generator=seeded_generator(dev, seed, MODEL),
                           rng=seeded_generator(dev, seed, CLIENT_RNG, 0),
                           device=dev)
    engine = RoundEngine(cfg, enc.spans(), enc.condition_spans(),
                         batch=cfg.batch_size, local_steps=epoch_steps)

    history: list[dict] = []
    t0 = time.perf_counter()
    for ep in range(epochs):
        state, metrics = engine.run_round(state, sampler.tables)
        if on_epoch is not None:
            on_epoch(ep, metrics)
        if eval_real is not None and ((ep + 1) % eval_every == 0
                                      or ep == epochs - 1):
            rep = _evaluate(state.gen, cfg, enc, eval_real, schema,
                            eval_samples, dev, seed, EVAL_STREAM, ep)
            rep.update(round=ep + 1, d_loss=float(metrics["d_loss"][-1]),
                       g_loss=float(metrics["g_loss"][-1]),
                       t=time.perf_counter() - t0)
            history.append(rep)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return FedRunResult("centralized", np.ones(1), history, enc, state.gen,
                        time.perf_counter() - t0, 0.0)


def make_md_step(cfg: CTGANConfig, spans: Sequence[SpanInfo],
                 cond_spans: Sequence[SpanInfo], batch: int):
    """Returns MD-TGAN's global step ``md_step(gen, g_opt, d_states,
    tables, *, draws=None, noise=None) -> (g_opt, metrics)``:

    1. every client draws one batch from its own table;
    2. every client's critic (``d_states[p].disc``, ``.d_opt``) takes a
       WGAN-GP step on fakes of the central generator ``gen``;
    3. ``gen`` takes one Adam step on the EQUAL-weight mean of the P
       per-client losses ``-mean(critic_p(fake_p)) + conditional_loss``,
       against the critics just updated (MD-GAN's uniform averaging).

    Both passes use the soft activations (``hard=False``), as the
    reference's.  The generator has batch norm, so the P fakes of each
    pass are P separate forwards: one ``segment_activations`` forward per
    client and pass, one backward per client.  ``draws[p]`` injects client
    p's :class:`SamplerDraws` and ``noise[p]`` a :class:`StepNoise` (the
    critic's fields and the generator's); what is not injected is drawn
    from ``d_states[p].rng``: the batch, then the noise.  ``gen`` and the
    critics are updated in place; metrics: ``g_loss`` and the (P,)
    ``d_loss``, on the device."""
    opt = adam(cfg.lr, cfg.b1, cfg.b2)
    spans, cond_spans = tuple(spans), tuple(cond_spans)
    cond_dim = sum(s.width for s in cond_spans)

    def md_step(gen: Generator, g_opt: AdamState,
                d_states: Sequence[GANState],
                tables: Sequence[SamplerTables], *,
                draws: Sequence[SamplerDraws] | None = None,
                noise: Sequence[StepNoise] | None = None):
        batches, noises = [], []
        for p, (st, tb) in enumerate(zip(d_states, tables, strict=True)):
            cond, mask, real = draw_batch(
                tb, batch, cond_dim, generator=st.rng,
                draws=None if draws is None else draws[p])
            batches.append((cond, mask, real))
            noises.append(noise[p] if noise is not None else draw_step_noise(
                st.rng, cfg, st.disc, batch, real.shape[1], real.device))

        d_losses = []
        for st, (cond, _, real), nz in zip(d_states, batches, noises):
            with torch.no_grad():
                fake = apply_activations_fused(gen(nz.z_d, cond), spans,
                                               nz.u_d, cfg.tau)
            fake_in = torch.cat([fake, cond], dim=1)
            real_in = torch.cat([real, cond], dim=1)
            wgan = (torch.mean(st.disc(fake_in, keep=nz.keep_d_fake))
                    - torch.mean(st.disc(real_in, keep=nz.keep_d_real)))
            pen = cfg.gp_lambda * gradient_penalty(st.disc, real_in, fake_in,
                                                   nz.gp_eps)
            d_loss = wgan + pen
            d_params = list(st.disc.parameters())
            st.d_opt = opt.update(critic_grads(wgan, pen, d_params),
                                  st.d_opt, d_params)
            d_losses.append(d_loss.detach())

        losses = []
        for st, (cond, mask, _), nz in zip(d_states, batches, noises):
            logits = gen(nz.z_g, cond)
            fake = apply_activations_fused(logits, spans, nz.u_g, cfg.tau)
            y_fake = st.disc(torch.cat([fake, cond], dim=1), keep=nz.keep_g)
            losses.append(-torch.mean(y_fake)
                          + conditional_loss(logits, cond, mask, cond_spans))
        gl = torch.mean(torch.stack(losses))
        g_params = list(gen.parameters())
        g_opt = opt.update(torch.autograd.grad(gl, g_params), g_opt, g_params)
        return g_opt, {"g_loss": gl.detach(), "d_loss": torch.stack(d_losses)}

    return md_step


def run_mdtgan(client_data: Sequence[np.ndarray],
               schema: Sequence[ColumnSpec], *,
               cfg: CTGANConfig = CTGANConfig(), epochs: int = 20,
               steps_per_epoch: int = 1, seed: int = 0,
               eval_real: np.ndarray | None = None, eval_every: int = 5,
               eval_samples: int = 4096, swap: bool = True,
               on_epoch: Callable | None = None,
               device: torch.device | str = "cuda") -> FedRunResult:
    """MD-GAN [9] adapted to CTGAN: ONE central generator (client 0's
    initial model), one critic per client, the generator stepped on the
    uniform mean of the per-client losses (:func:`make_md_step`), and the
    peer-to-peer critic swap after every epoch (``numpy.random.
    default_rng(seed).permutation``, the reference's order).  MD gets the
    same §4.1 encoder init (``"uniform"`` weights), as in the paper.
    ``on_epoch(ep, metrics)`` is called after each epoch's steps, with the
    last step's metrics."""
    dev = resolve_device(device)
    P = len(client_data)
    fe = setup_federation(client_data, schema, cfg, seed, "uniform",
                          device=dev)
    enc = fe.enc
    md_step = make_md_step(cfg, fe.spans, fe.cond_spans, cfg.batch_size)
    bytes_epoch = comm_model.md_bytes_per_epoch(
        P, steps_per_epoch, cfg.batch_size, enc.encoded_dim + enc.cond_dim,
        comm_model.param_bytes(fe.states[0].disc.parameters()), swap=swap)

    gen, g_opt = fe.states[0].gen, fe.states[0].g_opt
    d_states = list(fe.states)
    history: list[dict] = []
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for ep in range(epochs):
        for _ in range(steps_per_epoch):
            g_opt, metrics = md_step(gen, g_opt, d_states, fe.tables)
        if swap:                                   # p2p critic swap
            d_states = [d_states[i] for i in rng.permutation(P)]
        if on_epoch is not None:
            on_epoch(ep, metrics)
        if eval_real is not None and ((ep + 1) % eval_every == 0
                                      or ep == epochs - 1):
            rep = _evaluate(gen, cfg, enc, eval_real, schema, eval_samples,
                            dev, seed, EVAL_STREAM, ep)
            rep.update(round=ep + 1, g_loss=float(metrics["g_loss"]),
                       t=time.perf_counter() - t0)
            history.append(rep)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return FedRunResult("md-tgan", np.full(P, 1.0 / P), history, enc, gen,
                        time.perf_counter() - t0, bytes_epoch)
