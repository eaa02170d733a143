"""Open-loop synthesis serving: independent consumers whose requests
arrive on a schedule fixed before the run, whatever the server does.

Traffic keys: ``tenants``; ``rate_per_s`` (the fixed offered load);
``size_median``, ``size_sigma``, ``size_min``, ``size_max`` (log-normal
rows, clipped); ``conditional_share``; ``scheduler``; ``base_seed``;
``check_requests`` (the sample the check computes again).

Every seed gets the same multiset of request sizes, modes and gaps (drawn
from ``base_seed``; ``rate_per_s * seconds`` requests, the gaps scaled to
end inside the window) in its own order, and its own tenants and request
seeds: the work is the same from seed to seed.  A request's latency runs
from when it was due, so a stall delays every request behind it.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import serving

check = serving.check


def arrivals(tr: dict, seconds: float, rng: np.random.Generator):
    """(due seconds, rows, conditional, tenant) per request, in due order."""
    n = max(1, round(tr["rate_per_s"] * seconds))
    base = np.random.default_rng(tr["base_seed"])
    rows = np.clip(np.round(base.lognormal(math.log(tr["size_median"]),
                                           tr["size_sigma"], n)),
                   tr["size_min"], tr["size_max"]).astype(np.int64)
    cond = np.arange(n) < round(tr["conditional_share"] * n)
    gaps = base.exponential(1.0, n)
    pick = rng.permutation(n)
    rows, cond = rows[pick], cond[pick]
    t = np.cumsum(gaps[rng.permutation(n)])
    due = (t - t[0]) / t[-1] * seconds * (n - 1) / n if n > 1 else np.zeros(1)
    tenants = rng.integers(0, tr["tenants"], n)
    return due, rows, cond, tenants


def setup(ctx):
    st = serving.setup(ctx)
    # every (tenant, bucket, mode) the mix can ask for, run once
    st.srv.warmup(hard=True, conditional=None)
    return st


def window(st, seconds: float, trace) -> dict:
    due, rows, cond, tenants = arrivals(st.ctx.traffic, seconds, st.rng)
    loop = serving.Loop(st)
    cuda = torch.device(st.ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with trace:
        loop.t0 = t0 = time.perf_counter()
        i, n = 0, len(due)
        while i < n or loop.outstanding:
            now = time.perf_counter() - t0
            while i < n and due[i] <= now:
                loop.submit(int(tenants[i]), int(rows[i]), float(due[i]),
                            bool(cond[i]))
                i += 1
            if loop.outstanding:
                loop.next_answer()
            elif i < n:
                wait = due[i] - (time.perf_counter() - t0)
                if wait > 2e-4:
                    time.sleep(wait - 2e-4)
            if now > seconds + 60.0:
                break
        record = loop.close(seconds)
        if cuda:
            torch.cuda.synchronize()
    record.update(kind="serve", elapsed_s=seconds, n_cont=st.n_cont,
                  kmax=st.ctx.config["max_modes"], dim=st.dim,
                  cond_dim=st.cond_dim)
    return record
