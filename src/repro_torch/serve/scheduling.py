"""Continuous-batching admission: per-tenant deficit round robin.

Pure Python: the port's own copy of the JAX package's
``serve/scheduling.py``, with ``jain_index``, the fairness measure of the
load benchmark, and the pass counts its starvation bound is held to.

The FIFO drain treats the queue as one line: a tenant that floods the
server parks every other tenant behind its burst.  Continuous batching
replaces the line with per-tenant queues and assembles each *dispatch
cycle* by deficit round robin (DRR): every assembly pass credits each
backlogged tenant ``quantum`` rows of service budget and admits that
tenant's requests (oldest first) while the budget covers their bucket
cost.  Requests submitted while a cycle drains are admitted at the next
assembly, between dispatches.

A tenant's own requests are never reordered, which is why a
single-tenant trace through the continuous path is identical to the FIFO
path.  ``assemble`` drops already-expired requests at admission
(reporting them to ``on_expired``) without charging the tenant's
deficit; the server re-checks expiry at dispatch time.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Sequence


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over the
    non-negative allocations ``values``: 1.0 = perfectly even, ``1/n`` =
    one tenant got everything.  An empty or all-zero allocation is
    vacuously fair (1.0)."""
    xs = [float(v) for v in values]
    if any(x < 0 for x in xs):
        raise ValueError(f"allocations must be non-negative, got {xs}")
    total = sum(xs)
    if not xs or total == 0.0:
        return 1.0
    return total * total / (len(xs) * sum(x * x for x in xs))


@dataclasses.dataclass
class AdmittedRequest:
    """One scheduled unit: an opaque payload plus the accounting the
    scheduler needs (tenant, bucket cost in rows, optional deadline) and
    the assembly passes it was pushed and admitted at, which the
    starvation bound is held against."""
    tenant: str
    item: Any
    cost: int
    deadline_at: float | None = None
    pushed_cycle: int = -1             # assembly passes done at the push
    admitted_cycle: int = -1           # the pass that admitted it


class ContinuousScheduler:
    """Deficit-round-robin admission over per-tenant FIFO queues.

    ``push`` enqueues; ``assemble`` runs ONE DRR pass over the active
    tenants and returns the ordered list of requests admitted into the
    next dispatch cycle.  The ring of active tenants rotates by one
    between passes so no tenant permanently owns the front of the cycle.
    """

    def __init__(self, quantum: int = 512):
        if quantum <= 0:
            raise ValueError(f"quantum must be positive rows, got {quantum}")
        self.quantum = int(quantum)
        self._queues: dict[str, collections.deque[AdmittedRequest]] = {}
        self._deficit: dict[str, float] = {}
        self._ring: collections.deque[str] = collections.deque()
        self.cycles = 0                # completed assembly passes

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def backlogged(self) -> list[str]:
        """Tenants with at least one queued request, in ring order."""
        return [t for t in self._ring if self._queues[t]]

    def push(self, tenant: str, item: Any, cost: int, *,
             deadline_at: float | None = None) -> AdmittedRequest:
        """Enqueue ``item`` for ``tenant`` at ``cost`` rows of service."""
        if cost <= 0:
            raise ValueError(f"cost must be positive rows, got {cost}")
        adm = AdmittedRequest(tenant, item, int(cost), deadline_at,
                              pushed_cycle=self.cycles)
        if tenant not in self._queues:
            self._queues[tenant] = collections.deque()
            self._deficit[tenant] = 0.0
            self._ring.append(tenant)
        self._queues[tenant].append(adm)
        return adm

    def starvation_bound(self, cost_ahead: int, max_cost: int) -> int:
        """Most assembly passes before a request with ``cost_ahead`` rows
        queued ahead of it (itself included) in its tenant's queue is
        admitted, when the tenant's largest request costs ``max_cost``."""
        return math.ceil((cost_ahead + max_cost) / self.quantum) + 1

    def assemble(self, *, now: float | None = None,
                 on_expired: Callable[[AdmittedRequest], None] | None = None
                 ) -> list[AdmittedRequest]:
        """One DRR pass: credit each backlogged tenant ``quantum`` rows,
        admit its queue head while the deficit covers the head's cost.
        Requests already past their deadline at ``now`` are dropped here
        without charging the deficit.  Tenants whose queue empties leave
        the ring with their deficit reset: credit does not bank across
        idle periods."""
        cycle: list[AdmittedRequest] = []
        for tenant in list(self._ring):
            queue = self._queues[tenant]
            if not queue:
                continue
            self._deficit[tenant] += self.quantum
            while queue:
                head = queue[0]
                if (now is not None and head.deadline_at is not None
                        and now > head.deadline_at):
                    queue.popleft()    # dead at admission: no deficit charge
                    if on_expired is not None:
                        on_expired(head)
                    continue
                if self._deficit[tenant] < head.cost:
                    break
                self._deficit[tenant] -= head.cost
                head.admitted_cycle = self.cycles
                cycle.append(queue.popleft())
            if not queue:
                self._deficit[tenant] = 0.0
        for tenant in [t for t in self._ring if not self._queues[t]]:
            self._ring.remove(tenant)
            del self._queues[tenant], self._deficit[tenant]
        self._ring.rotate(-1)
        self.cycles += 1
        return cycle
