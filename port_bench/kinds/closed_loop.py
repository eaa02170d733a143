"""Closed-loop bulk synthesis: each tenant keeps one request outstanding
and sends the next when the last is answered, as a consumer exporting a
synthetic copy of a table does.

Traffic keys: ``tenants``, ``rows`` (every request's size),
``conditional_share``, ``scheduler``, ``check_requests``.
"""
from __future__ import annotations

import time

import torch

from .. import serving

check = serving.check


def setup(ctx):
    st = serving.setup(ctx)
    tr = ctx.traffic
    # the mix's one shape per tenant, through the request path
    for t in range(tr["tenants"]):
        st.srv.submit(st.names[t], tr["rows"], seed=t,
                      conditional=tr["conditional_share"] > 0)
    st.srv.serve()
    return st


def window(st, seconds: float, trace) -> dict:
    tr = st.ctx.traffic
    loop = serving.Loop(st)
    n_cond = 0

    def send(t: int, now: float) -> None:
        nonlocal n_cond
        cond = n_cond < tr["conditional_share"] * (len(loop.requests) + 1)
        n_cond += cond
        loop.submit(t, tr["rows"], now, cond)

    cuda = torch.device(st.ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with trace:
        loop.t0 = t0 = time.perf_counter()
        for t in range(tr["tenants"]):
            send(t, 0.0)
        while loop.outstanding:
            req = loop.next_answer()
            if req is None:
                continue
            now = time.perf_counter() - t0
            if now < seconds:
                send(req["tenant"], now)
            elif now > seconds + 60.0:
                break
        record = loop.close(seconds)
        if cuda:
            torch.cuda.synchronize()
    record.update(kind="serve", elapsed_s=seconds, n_cont=st.n_cont,
                  kmax=st.ctx.config["max_modes"], dim=st.dim,
                  cond_dim=st.cond_dim)
    return record
