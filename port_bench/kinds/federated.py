"""Fed-TGAN training: global rounds of the program's
``FederatedProgram.global_round``, round after round.

Traffic keys: ``clients``, ``local_steps``, ``weighting`` (the §4.2
rule), ``check_rounds`` (rounds run in set-up and followed by the
reference), ``draw_pool`` (rounds of draws made in set-up, which the
window's rounds take in turn).

Set-up: the benchmark's table split IID over the clients, the program's
``setup_federation`` (the §4.1 protocol, the encode and the sampler
tables), the benchmark's weights loaded into every client by name, then
``check_rounds`` rounds through the window's own call: they warm every
shape up, and their outputs are kept for the check.  Every round's random
draws (the sampler's and each step's noise) are the benchmark's, made on
the card from the seed and injected, so that the reference gets the same;
the window's are made in set-up too, so that it times the program alone.

The check works the set-up out again from the raw tables and the seed
(:mod:`port_bench.reference.protocol`) and follows the kept rounds
(:mod:`port_bench.reference.ctgan`).  It compares, each against its limit:

* ``encode_gap``: the largest difference of an encoded row's entry;
* ``weight_gap``: the largest relative difference of a §4.2 weight;
* ``loss_gap``: every local step's critic and generator loss in the first
  round, the gap over the larger of the reference's magnitude and its
  median magnitude;
* ``grad_gap``: each leaf's first-moment norm after the first round (the
  gradients as Adam got them), worst leaf and client, the gap of the
  norms over the larger of the reference's norm and its median leaf's;
* ``change_gap``: each leaf's change over the kept rounds, measured so,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone); the median
  leaf's gap, worst client.

(Why the losses of the first round only, and the median leaf's change:
see :func:`compare`.)
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from .. import data, work
from ..reference import ctgan as ref_ctgan
from ..reference import protocol as ref_protocol

DATA, PART, FED, WEIGHTS, DRAWS = range(5)
CTGAN_KEYS = ("z_dim", "gen_hidden", "disc_hidden", "pac", "tau",
              "gp_lambda", "dropout", "lr", "b1", "b2", "batch_size")


def ctgan_config(cfg: dict):
    from repro_torch.gan.ctgan import CTGANConfig
    return CTGANConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                          else cfg[k] for k in CTGAN_KEYS})


def named_params(state) -> dict:
    """A client's parameters by state-dict name, generator then critic."""
    return {**{"gen." + n: p for n, p in state.gen.named_parameters()},
            **{"disc." + n: p for n, p in state.disc.named_parameters()}}


def load_weights(states, flat: torch.Tensor, layout) -> None:
    """Copy the benchmark's weights into every client, by name."""
    ref = ref_ctgan.unflatten(flat, layout)
    with torch.no_grad():
        for st in states:
            named = named_params(st)
            if sorted(named) != sorted(ref):
                raise RuntimeError(
                    f"the program's parameters {sorted(named)} are not the "
                    f"configuration's {sorted(ref)}")
            for k, t in named.items():
                t.copy_(ref[k])


def make_draws(g: torch.Generator, cfg: dict, P: int, E: int, n_spans: int,
               data_dim: int, device) -> dict:
    """One round's draws for every client, in a few large calls: the
    sampler's span ids and uniforms, and each step's noise."""
    from repro_torch.gan.trainer import StepNoise
    from repro_torch.synth import SamplerDraws
    B, pac = cfg["batch_size"], cfg["pac"]
    z = torch.randn((P, E, 2, B, cfg["z_dim"]), generator=g, device=device)
    u = torch.rand((P, E, 2, B, data_dim), generator=g, device=device)
    keep = [torch.rand((P, E, 3, B // pac, h), generator=g, device=device)
            < 1 - cfg["dropout"] for h in cfg["disc_hidden"]]
    eps = torch.rand((P, E, B // pac, 1, 1), generator=g, device=device)
    span = torch.randint(0, n_spans, (P, E * B), generator=g, device=device)
    uc = torch.rand((P, 2, E * B), generator=g, device=device)
    draws = [SamplerDraws(span[p], uc[p, 0], uc[p, 1]) for p in range(P)]
    noise = [[StepNoise(z[p, e, 0], u[p, e, 0], [k[p, e, 0] for k in keep],
                        [k[p, e, 1] for k in keep], eps[p, e], z[p, e, 1],
                        u[p, e, 1], [k[p, e, 2] for k in keep])
              for e in range(E)] for p in range(P)]
    return {"draws": draws, "noise": noise}


def to_host(inj: dict) -> dict:
    """A round's draws on the host, as plain tensors for the reference."""
    draws = [tuple(t.cpu() for t in d) for d in inj["draws"]]
    noise = [[{"z_d": n.z_d.cpu(), "u_d": n.u_d.cpu(),
               "keep_d_fake": [k.cpu() for k in n.keep_d_fake],
               "keep_d_real": [k.cpu() for k in n.keep_d_real],
               "gp_eps": n.gp_eps.cpu(), "z_g": n.z_g.cpu(),
               "u_g": n.u_g.cpu(), "keep_g": [k.cpu() for k in n.keep_g]}
              for n in steps] for steps in inj["noise"]]
    return {"draws": draws, "noise": noise}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tensors.items()}


def setup(ctx):
    from repro_torch.fed.program import FederatedProgram
    from repro_torch.fed.setup import setup_federation
    from repro_torch.tabular.encoders import ColumnSpec

    c, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    table, schema = data.make_table(c, c["rows"],
                                    data.stream_seed(ctx.seed, DATA))
    parts = data.partition_iid(table, tr["clients"],
                               data.stream_seed(ctx.seed, PART))
    kinds = [k for _, k in schema]
    fed_seed = data.stream_seed(ctx.seed, FED)
    cfg = ctgan_config(c)
    fe = setup_federation(
        parts, [ColumnSpec(n, k, max_modes=c["max_modes"]) for n, k in schema],
        cfg, fed_seed, tr["weighting"], device=dev)
    prog = FederatedProgram(cfg, fe.spans, fe.cond_spans, batch=cfg.batch_size,
                            local_steps=tr["local_steps"],
                            weighting=tr["weighting"])
    data_dim, cond_dim = fe.enc.encoded_dim, fe.enc.cond_dim
    layout = ref_ctgan.param_layout(c, data_dim, cond_dim)
    flat0 = ref_ctgan.make_weights(
        layout, torch.Generator(device=dev).manual_seed(
            data.stream_seed(ctx.seed, WEIGHTS)), dev)
    load_weights(fe.states, flat0, layout)

    st = types.SimpleNamespace(
        ctx=ctx, fe=fe, prog=prog, parts=parts, kinds=kinds,
        fed_seed=fed_seed, layout=layout, flat0=flat0.cpu(),
        data_dim=data_dim, cond_dim=cond_dim, P=tr["clients"],
        E=tr["local_steps"], n_spans=len(fe.cond_spans),
        widths=[s.width for s in fe.spans],
        rng=torch.Generator(device=dev).manual_seed(
            data.stream_seed(ctx.seed, DRAWS)),
        kept_draws=[], losses=[], mu_norms=None, change_norms=None)
    st.encoded = [t.encoded.cpu() for t in fe.tables]
    st.weights = fe.weights.cpu()

    start = {k: t.detach().clone()
             for k, t in named_params(fe.states[0]).items()}
    for r in range(tr["check_rounds"]):
        inj = make_draws(st.rng, c, st.P, st.E, st.n_spans, data_dim, dev)
        st.kept_draws.append(to_host(inj))
        _, m = prog.global_round(fe.states, fe.tables, fe.S, fe.n_rows, **inj)
        st.losses.append(torch.stack([m["d_loss"], m["g_loss"]], -1).cpu())
        if r == 0:
            st.mu_norms = [leaf_norms({
                **dict(zip(("gen." + n for n, _ in s.gen.named_parameters()),
                           s.g_opt.mu)),
                **dict(zip(("disc." + n for n, _ in s.disc.named_parameters()),
                           s.d_opt.mu))}) for s in fe.states]
    st.change_norms = [leaf_norms({k: t.detach() - start[k]
                                   for k, t in named_params(s).items()})
                       for s in fe.states]
    st.pool = [make_draws(st.rng, c, st.P, st.E, st.n_spans, data_dim, dev)
               for _ in range(tr["draw_pool"])]
    return st


def window(st, seconds: float, trace) -> dict:
    """Global rounds until ``seconds`` have passed; the rows all clients
    consume in local steps over the window's whole time."""
    fe, c, dev = st.fe, st.ctx.config, torch.device(st.ctx.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    metrics, rounds = [], 0
    sync()
    with trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            inj = st.pool[rounds % len(st.pool)]
            _, m = st.prog.global_round(fe.states, fe.tables, fe.S,
                                        fe.n_rows, **inj)
            metrics.append(m)
            rounds += 1
        sync()
        elapsed = time.perf_counter() - t0
    bad = sum(int(not bool(torch.isfinite(torch.stack(
        [m["d_loss"], m["g_loss"]])).all())) for m in metrics)
    steps = rounds * st.P * st.E
    flops = work.ctgan_step_flops(
        z_dim=c["z_dim"], gen_hidden=c["gen_hidden"],
        disc_hidden=c["disc_hidden"], pac=c["pac"], batch=c["batch_size"],
        data_dim=st.data_dim, cond_dim=st.cond_dim)["model"]
    return {"kind": "train", "elapsed_s": elapsed, "rounds": rounds,
            "steps": steps, "rows": steps * c["batch_size"],
            "model_flops": steps * flops, "attempted": rounds, "failed": bad,
            "complete": bad == 0, "spans": st.widths,
            "batch": c["batch_size"]}


def _gap(got: float, want: float, scale: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), scale, 1e-30)


def program_outputs(st) -> dict:
    """What the program produced in the kept rounds (taken in set-up)."""
    return {"encoded": st.encoded, "weights": st.weights,
            "losses": torch.stack(st.losses), "mu_norms": st.mu_norms,
            "change_norms": st.change_norms}


def check(st) -> dict:
    """Free the program's state, then hold what it produced to the
    reference."""
    st.fe = st.prog = st.pool = None
    if torch.device(st.ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    return compare(program_outputs(st), reference_outputs(st))


def _half(t):
    return t[:t.shape[0] // 2]


@torch.no_grad()
def reference_outputs(st, fault: str | None = None) -> dict:
    """The reference's set-up and kept rounds, from the raw tables, the
    seed, the benchmark's weights and the kept draws.  ``fault`` plants
    one of the faults the check must catch into the reference put in the
    program's place: "half" (each step on the first half of its batch),
    "no_merge" (the exchange left out), "encode" (an encoded entry
    altered), "weights" (a §4.2 weight altered where it is made)."""
    dev = torch.device(st.ctx.device)
    c = st.ctx.config
    ref = ref_protocol.federation(st.parts, st.kinds, st.fed_seed,
                                  c["max_modes"], dev)
    enc = ref["enc"]
    if fault == "weights":
        ref["weights"][0] *= 1.01
    if fault == "encode":
        ref["encoded"][0][0, 0] += 0.25
        ref["tables"][0] = ref_protocol.sampler_tables(
            ref["encoded"][0].cpu().numpy(), enc, dev)
    spans = enc.spans()
    cond_spans = [s for s in spans if s[3]]
    flat0 = st.flat0.to(dev)
    clients = [ref_ctgan.Client(c, flat0, st.layout) for _ in range(st.P)]
    B, E = c["batch_size"], st.E
    losses, mu_norms = [], None
    for r, kept in enumerate(st.kept_draws):
        per_client = []
        for p, cl in enumerate(clients):
            span, uc, ur = (t.to(dev) for t in kept["draws"][p])
            cond, mask, rows = ref_protocol.draw_conditions(
                ref["tables"][p], span, uc, ur, enc.cond_dim)
            real = ref["tables"][p]["encoded"][rows]
            steps = []
            for e in range(E):
                sl = slice(e * B, (e + 1) * B)
                batch = [cond[sl], mask[sl], real[sl]]
                noise = {k: ([t.to(dev) for t in v] if isinstance(v, list)
                             else v.to(dev))
                         for k, v in kept["noise"][p][e].items()}
                if fault == "half":
                    batch = [_half(t) for t in batch]
                    noise = {k: ([_half(t) for t in v] if isinstance(v, list)
                                 else _half(v)) for k, v in noise.items()}
                steps.append(cl.step(*batch, noise, spans, cond_spans))
            per_client.append(steps)
        losses.append(torch.tensor(per_client))
        if r == 0:
            mu_norms = [leaf_norms(cl.first_moments()) for cl in clients]
        if fault != "no_merge":
            ref_ctgan.merge(clients, ref["weights"], st.layout)
    start = ref_ctgan.unflatten(flat0, st.layout)
    change_norms = []
    for cl in clients:
        final = ref_ctgan.unflatten(cl.flat(st.layout), st.layout)
        change_norms.append(leaf_norms({k: final[k] - start[k]
                                        for k in final}))
    return {"encoded": [e.cpu() for e in ref["encoded"]],
            "weights": ref["weights"].cpu(), "losses": torch.stack(losses),
            "mu_norms": mu_norms, "change_norms": change_norms}


def _loss_gap(g: torch.Tensor, w: torch.Tensor) -> float:
    """The widest gap of a loss over ``w``'s steps, each over the larger of
    the reference's magnitude and its median magnitude."""
    if g.shape != w.shape:
        return math.inf
    gap = 0.0
    for i in range(2):
        scale = float(torch.median(torch.abs(w[..., i])))
        gap = max(gap, *(_gap(float(a), float(b), scale) for a, b in
                         zip(g[..., i].flatten(), w[..., i].flatten())))
    return gap


def compare(got: dict, want: dict, *, diagnostics: bool = False) -> dict:
    """The numbers the check holds ``got`` to ``want`` by.

    Later steps meet the ReLU's and the LeakyReLU's kinks: where a unit's
    input lies within rounding of 0 in one and not the other, its
    derivative (and the penalty's input gradient) differ by a step, and
    that step carries on.  Sound runs then read up to ~1e-3 on the widest
    loss gap of all kept rounds, and up to ~5e-4 on the widest leaf's
    change, as much as the TF32 control does; so the losses are compared
    over the first round, and the change by its median leaf
    (``diagnostics`` adds the widest of both, ``loss_gap_all_rounds`` and
    ``change_gap_widest_leaf``)."""
    encode_gap = max(
        (float(torch.max(torch.abs(p - r))) if p.shape == r.shape
         else math.inf) for p, r in zip(got["encoded"], want["encoded"]))
    weight_gap = float(torch.max(torch.abs(got["weights"] - want["weights"])
                                 / want["weights"]))
    g, w = got["losses"], want["losses"]
    grad_gap = 0.0
    for got_m, want_m in zip(got["mu_norms"], want["mu_norms"]):
        med = float(np.median(list(want_m.values())))
        grad_gap = max(grad_gap, *(_gap(got_m[k], want_m[k], med)
                                   for k in want_m))
    # leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move under Adam by round-off alone
    grad = {k: max(m[k] for m in want["mu_norms"])
            for k in want["mu_norms"][0]}
    med_grad = float(np.median(list(grad.values())))
    moved = [k for k in grad if grad[k] >= 1e-3 * med_grad]
    change_gap = widest = 0.0
    for got_c, want_c in zip(got["change_norms"], want["change_norms"]):
        med = float(np.median([want_c[k] for k in moved]))
        gaps = [_gap(got_c[k], want_c[k], med) for k in moved]
        change_gap = max(change_gap, float(np.median(gaps)))
        widest = max(widest, *gaps)
    out = {"encode_gap": encode_gap, "weight_gap": weight_gap,
           "loss_gap": _loss_gap(g[:1], w[:1]), "grad_gap": grad_gap,
           "change_gap": change_gap}
    if diagnostics:
        out["loss_gap_all_rounds"] = _loss_gap(g, w)
        out["change_gap_widest_leaf"] = widest
    return out
