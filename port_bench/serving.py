"""Synthesis serving: the set-up, the request loop and the check that the
open- and closed-loop kinds share.

Set-up: the benchmark's table, the program's ``fit_centralized_encoders``
with the benchmark's mean jitters, the program's encode with the
benchmark's Gumbel noise and its sampler tables (the conditional
marginals), and one generator per tenant with the benchmark's weights,
all registered with a ``StreamingSynthesizer``.

Requests carry a seed from the benchmark.  The program answers a request
``(rows, seed)`` with its generator run at the request's bucket size, the
noise drawn from a generator seeded with ``seed`` (conditional requests:
the sampler's span ids, category and row uniforms; then ``z``; then the
head's uniforms), the head's hard samples decoded to raw rows, the first
``rows`` of them.

The check draws a sample of the answers from the seed (a reservoir over
every answer of a request due in the window, with the longest request
added), frees the program's state, fits and encodes the table again with
the plain reference, and computes each sampled answer again.  It compares,
each against its limit:

* ``cat_mismatch``: the share of categorical cells whose category differs;
* ``value_gap``: the largest difference of a continuous cell over four
  standard deviations of the reference's mode (the alpha it encodes; a
  different mode reads large).
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from . import data
from .reference import ctgan as ref_ctgan
from .reference import protocol as ref_protocol

DATA, JITTER, GUMBEL, WEIGHTS, TRAFFIC, SAMPLE = range(6)


def setup(ctx) -> types.SimpleNamespace:
    from repro_torch.gan.ctgan import init_generator
    from repro_torch.serve import StreamingSynthesizer, TableRegistry
    from repro_torch.synth import DeviceSampler
    from repro_torch.tabular.encoders import (ColumnSpec,
                                              fit_centralized_encoders)

    from .kinds.federated import ctgan_config, load_weights

    c, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    table, schema = data.make_table(c, c["rows"],
                                    data.stream_seed(ctx.seed, DATA))
    kinds = [k for _, k in schema]
    cont = [j for j, k in enumerate(kinds) if k == "continuous"]
    K = c["max_modes"]
    g = torch.Generator(device=dev).manual_seed(
        data.stream_seed(ctx.seed, JITTER))
    jitter = torch.randn((len(cont), K), generator=g, device=dev)
    jitters = {j: jitter[q] for q, j in enumerate(cont)}
    g = torch.Generator(device=dev).manual_seed(
        data.stream_seed(ctx.seed, GUMBEL))
    u = torch.rand((table.shape[0], len(cont) * K), generator=g, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32)
                                             .tiny)))
    cfg = ctgan_config(c)
    enc = fit_centralized_encoders(
        table, [ColumnSpec(n, k, max_modes=K) for n, k in schema],
        jitters=jitters, device=dev)
    encoded = enc.encode(table, gumbel=gumbel)
    tables = DeviceSampler(encoded.cpu().numpy(), enc, dev).tables
    layout = [e for e in ref_ctgan.param_layout(c, enc.encoded_dim,
                                                enc.cond_dim)
              if e[0].startswith("gen.")]
    g = torch.Generator(device=dev).manual_seed(
        data.stream_seed(ctx.seed, WEIGHTS))
    registry, gens, weights = TableRegistry(), [], []
    names = [f"{c['table']}-{t}" for t in range(tr["tenants"])]
    for name in names:
        flat = ref_ctgan.make_weights(layout, g, dev)
        gen = init_generator(cfg, enc.cond_dim, enc.encoded_dim, device=dev)
        state = types.SimpleNamespace(gen=gen, disc=torch.nn.Module())
        load_weights([state], flat, layout)
        registry.register(name, cfg, enc, gen, tables=tables, device=dev)
        gens.append(gen)
        weights.append(flat.cpu())
    srv = StreamingSynthesizer(registry, pipeline=True,
                               scheduler=tr["scheduler"], device=dev)
    return types.SimpleNamespace(
        ctx=ctx, srv=srv, gens=gens, names=names, table=table, kinds=kinds,
        jitter=jitter.cpu(), gumbel=gumbel.cpu(), layout=layout,
        weights=weights, dim=enc.encoded_dim, cond_dim=enc.cond_dim,
        n_cont=len(cont), n_spans=len(enc.condition_spans()),
        rng=np.random.default_rng(data.stream_seed(ctx.seed, TRAFFIC)),
        sampler=np.random.default_rng(data.stream_seed(ctx.seed, SAMPLE)),
        sample=[], longest=None)


class Loop:
    """The request loop around the program's stream: submit, take the next
    answer, record when each request was due, dispatched and answered."""

    def __init__(self, st):
        self.st, self.srv = st, st.srv
        self.it = None
        self.t0 = 0.0
        self.outstanding = 0
        self.requests: dict[int, dict] = {}
        self.seen = 0
        self.dispatch: list[list[float]] = [[] for _ in st.gens]
        # the program's call of a tenant's generator is the dispatch
        self.hooks = [gen.register_forward_pre_hook(
            lambda m, a, t=t: self.dispatch[t].append(
                time.perf_counter() - self.t0))
            for t, gen in enumerate(st.gens)]

    def submit(self, tenant: int, rows: int, due: float, cond: bool) -> None:
        seed = int(self.st.rng.integers(0, 2 ** 62))
        rid = self.srv.submit(self.st.names[tenant], rows, seed=seed,
                              conditional=cond)
        self.requests[rid] = {"tenant": tenant, "rows": rows, "seed": seed,
                              "cond": cond, "due": due, "done": None,
                              "bucket": None, "order": None}
        self.outstanding += 1

    def next_answer(self) -> dict | None:
        """Block for the next answer; None when the stream has drained."""
        if self.it is None:
            self.it = self.srv.stream()
        resp = next(self.it, None)
        if resp is None:
            self.it = None
            return None
        req = self.requests[resp.rid]
        req.update(done=time.perf_counter() - self.t0, bucket=resp.bucket)
        self.outstanding -= 1
        self._keep(req, resp)
        return req

    def _keep(self, req: dict, resp) -> None:
        """A reservoir of the answers, and the longest request's."""
        st = self.st
        item = dict(req, data=resp.data)
        k = st.ctx.traffic["check_requests"]
        if len(st.sample) < k:
            st.sample.append(item)
        else:
            j = int(st.sampler.integers(0, self.seen + 1))
            if j < k:
                st.sample[j] = item
        self.seen += 1
        if st.longest is None or req["rows"] > st.longest["rows"]:
            st.longest = item

    def close(self, seconds: float, grace: float = 60.0) -> dict:
        """Drain what is left, up to ``grace`` seconds past the window."""
        end = seconds + grace
        while self.outstanding and time.perf_counter() - self.t0 < end:
            self.next_answer()
        for h in self.hooks:
            h.remove()
        order: dict[int, int] = {}      # a tenant's requests run in order
        for rid in sorted(self.requests):
            req = self.requests[rid]
            req["order"] = order.get(req["tenant"], 0)
            order[req["tenant"]] = req["order"] + 1
        reqs = list(self.requests.values())
        for req in reqs:
            d = self.dispatch[req["tenant"]]
            if req["order"] < len(d):
                req["dispatched"] = d[req["order"]]
        failed = sum(r["done"] is None for r in reqs)
        return {"requests": reqs, "attempted": len(reqs), "failed": failed,
                "complete": failed == 0}


def samples(st) -> list[dict]:
    """The sampled answers, with the longest request's."""
    out = list(st.sample)
    if st.longest is not None and all(s is not st.longest for s in out):
        out.append(st.longest)
    return out


def check(st) -> dict:
    """Free the program's state, then compute the sampled answers again
    with the reference."""
    st.srv = None
    st.gens = None
    if torch.device(st.ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    items = samples(st)
    return compare([it["data"] for it in items], reference_answers(st, items),
                   st.kinds)


@torch.no_grad()
def reference_answers(st, items: list[dict], fault: str | None = None
                      ) -> list[tuple[np.ndarray, dict]]:
    """The reference's answer to each request of ``items``: the raw rows
    and, per continuous column, the standard deviation of each row's mode.
    ``fault`` plants a fault the check must catch into the reference put
    in the program's place: "answer" (a value altered where the decode
    makes it), "half" (the generator on half of the bucket, repeated)."""
    dev = torch.device(st.ctx.device)
    c = st.ctx.config
    cont = [j for j, k in enumerate(st.kinds) if k == "continuous"]
    jitters = {j: st.jitter[q] for q, j in enumerate(cont)}
    enc = ref_protocol.fit_table_encoders(st.table, st.kinds, jitters,
                                          c["max_modes"], dev)
    encoded = enc.encode(st.table, st.gumbel.to(dev))
    tables = ref_protocol.sampler_tables(encoded.cpu().numpy(), enc, dev)
    return [answer(item, st, enc, tables, enc.spans(), dev, fault)
            for item in items]


def compare(got: list[np.ndarray], want: list[tuple[np.ndarray, dict]],
            kinds) -> dict:
    cat_bad = cat_all = 0
    value_gap = 0.0
    for g, (w, modes_sd) in zip(got, want):
        if g.shape != w.shape:
            return {"cat_mismatch": math.inf, "value_gap": math.inf}
        for j in range(len(kinds)):
            if j in modes_sd:
                gap = np.abs(g[:, j] - w[:, j]) / (4.0 * modes_sd[j])
                value_gap = max(value_gap, float(np.max(np.where(
                    np.isfinite(gap), gap, np.inf))))
            else:
                cat_bad += int(np.sum(g[:, j] != w[:, j]))
                cat_all += g.shape[0]
    return {"cat_mismatch": cat_bad / max(cat_all, 1), "value_gap": value_gap}


def answer(item: dict, st, enc, tables, spans, dev, fault=None):
    """The reference's answer to one request (see
    :func:`reference_answers`)."""
    c = st.ctx.config
    n = item["bucket"]
    g = torch.Generator(device=dev).manual_seed(item["seed"])
    m = n // 2 if fault == "half" else n
    if item["cond"]:
        span = torch.randint(0, st.n_spans, (m,), generator=g, device=dev)
        uc = torch.rand(m, generator=g, device=dev)
        ur = torch.rand(m, generator=g, device=dev)
        cond = ref_protocol.draw_conditions(tables, span, uc, ur,
                                            enc.cond_dim)[0]
    else:
        cond = torch.zeros((m, enc.cond_dim), device=dev)
    z = torch.randn((m, c["z_dim"]), generator=g, device=dev)
    p = ref_ctgan.unflatten(st.weights[item["tenant"]].to(dev), st.layout)
    logits = ref_ctgan.generator(p, z, cond, len(c["gen_hidden"]))
    u = torch.rand(logits.shape, generator=g, device=dev)
    act = ref_ctgan.activations(logits, spans, u, c["tau"], hard=True)
    if fault == "half":
        act = torch.cat([act, act])[:n]
    rows = item["rows"]
    raw = enc.decode(act)[:rows]
    if fault == "answer":
        raw[:, -1] += 1.0
    sd, pos = {}, 0
    for j, kind in enumerate(st.kinds):
        if kind == "continuous":
            k = torch.argmax(act[:rows, pos + 1:pos + 1 + enc.kmax], dim=1)
            sd[j] = enc.vgms[j][2].float()[k].cpu().numpy().astype(np.float64)
            pos += 1 + enc.kmax
        else:
            pos += len(enc.categories[j])
    return raw, sd
