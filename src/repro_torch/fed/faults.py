"""Fault injection and the degraded-round math, the port's copy of the JAX
package's ``fed/faults.py``.

* :class:`FaultPlan` is a per-round, per-client fault schedule
  (participation mask, NaN corruption mask, byzantine delta scale), every
  leaf ``(R, P)`` on the host.  The plan functions (:func:`dropout_uniform`,
  :func:`straggler_deadline`, :func:`corrupt_nans`, :func:`byzantine_scale`,
  combined with :func:`compose`) draw from a ``torch.Generator``, so a plan
  is reproducible from its seed; :meth:`repro_torch.fed.FederatedProgram.
  run_faulted` takes one ``(P,)`` slice per round and moves it to the
  device.
* The degraded-round math: :func:`apply_faults` corrupts the transmitted
  ``(P, D)`` update stack, :func:`update_diagnostics` computes the
  non-finite and update-norm guard signals on the device, and
  :class:`UpdateGuard` decides which clients' weights are zeroed before
  the single fused ``weighted_agg`` merge.  A masked client's values are
  zeroed too (0 x NaN is NaN), so it adds an exact ``+0.0`` to the merge.
  :func:`apply_faults_tree` and :func:`sanitize_stacked` are the per-leaf
  forms for the host oracle's merge.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

# a client whose update norm exceeds this multiple of the cohort's median
# is flagged: honest CTGAN clients take near-identical Adam steps, so
# their norms cluster; a byzantine scale multiplies the norm by |scale|
DEFAULT_NORM_MULT = 4.0


class NoSurvivingClients(ValueError):
    """Every client is masked in some round: the merge has nothing to
    merge.  Raised on the host (plan validation, blocklist growth); the
    round itself never divides by zero, it freezes instead."""


class PoisonedRunError(RuntimeError):
    """The global state went non-finite and the retry budget (or the
    ability to name offending clients) is spent."""


class FaultPlan(NamedTuple):
    """Per-round, per-client fault schedule; every leaf is ``(R, P)``.

    ``participate`` -- False: the client misses the round (dropout or a
    straggler past the deadline); it still trains, but its weight is 0 and
    its values are zeroed out of the merge.
    ``nan_mask`` -- True: the client's transmitted update is NaN (its
    local state stays finite; the next broadcast overwrites it anyway).
    ``scale`` -- byzantine delta scale: the client ships ``global + scale
    * (update - global)``; 1.0 is honest and passes bit-identically.
    """
    participate: torch.Tensor
    nan_mask: torch.Tensor
    scale: torch.Tensor

    @property
    def rounds(self) -> int:
        return int(self.participate.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.participate.shape[1])

    def slice_rounds(self, start: int, stop: int) -> "FaultPlan":
        """The plan of absolute rounds ``start..stop-1``."""
        return FaultPlan(self.participate[start:stop],
                         self.nan_mask[start:stop], self.scale[start:stop])

    def block_clients(self, blocked) -> "FaultPlan":
        """The plan with a (P,) bool blocklist removed from every round's
        participation."""
        blocked = torch.as_tensor(np.asarray(blocked, bool),
                                  device=self.participate.device)
        return self._replace(participate=self.participate & ~blocked[None, :])

    def validate(self) -> "FaultPlan":
        """Raise :class:`NoSurvivingClients` if some round masks everyone."""
        alive = self.participate.cpu().numpy().any(axis=1)
        if not alive.all():
            dead = np.nonzero(~alive)[0].tolist()
            raise NoSurvivingClients(
                f"fault plan leaves no participating client in "
                f"round(s) {dead}")
        return self

    def summary(self) -> dict:
        """Fault totals of the plan."""
        part = self.participate.cpu().numpy()
        return {
            "rounds": self.rounds, "clients": self.n_clients,
            "dropout_rate": float(1.0 - part.mean()),
            "nan_client_rounds": int(self.nan_mask.sum()),
            "byzantine_client_rounds": int((self.scale != 1.0).sum()),
        }


def no_faults(rounds: int, n_clients: int) -> FaultPlan:
    """The neutral plan: everyone participates, nothing is corrupted.
    Through the faulted round it gives the dense round's parameters."""
    return FaultPlan(torch.ones((rounds, n_clients), dtype=torch.bool),
                     torch.zeros((rounds, n_clients), dtype=torch.bool),
                     torch.ones((rounds, n_clients), dtype=torch.float32))


def _device(generator: torch.Generator | None) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def _ensure_participants(participate: torch.Tensor,
                         generator: torch.Generator | None,
                         min_participants: int) -> torch.Tensor:
    """Add one generator-chosen client to every round with fewer than
    ``min_participants`` (0 leaves the raw rates untouched)."""
    if min_participants <= 0:
        return participate
    R, P = participate.shape
    idx = torch.randint(0, P, (R,), generator=generator,
                        device=participate.device)
    forced = torch.nn.functional.one_hot(idx, P).bool()
    need = torch.sum(participate, dim=1) < min_participants
    return torch.where(need[:, None], participate | forced, participate)


def dropout_uniform(generator: torch.Generator | None, rounds: int,
                    n_clients: int, *, rate: float = 0.3,
                    min_participants: int = 1) -> FaultPlan:
    """Each client misses each round independently with probability
    ``rate``."""
    dev = _device(generator)
    drop = torch.rand((rounds, n_clients), generator=generator,
                      device=dev) < rate
    participate = _ensure_participants(~drop, generator, min_participants)
    return no_faults(rounds, n_clients)._replace(participate=participate.cpu())


def straggler_deadline(generator: torch.Generator | None, rounds: int,
                       n_clients: int, *, mean_latency: float = 1.0,
                       deadline: float = 2.0,
                       min_participants: int = 1) -> FaultPlan:
    """Per-(round, client) latency ~ Exponential(``mean_latency``); clients
    past ``deadline`` miss the round (P(miss) = exp(-deadline /
    mean_latency))."""
    dev = _device(generator)
    latency = torch.empty((rounds, n_clients), device=dev).exponential_(
        generator=generator) * float(mean_latency)
    participate = _ensure_participants(latency <= deadline, generator,
                                       min_participants)
    return no_faults(rounds, n_clients)._replace(participate=participate.cpu())


def _pick_clients(generator: torch.Generator | None, n_clients: int,
                  n_pick: int, clients: Sequence[int] | None) -> list[int]:
    if clients is not None:
        return [int(c) for c in clients]
    perm = torch.randperm(n_clients, generator=generator,
                          device=_device(generator))
    return perm[:n_pick].tolist()


def corrupt_nans(generator: torch.Generator | None, rounds: int,
                 n_clients: int, *, n_corrupt: int = 1, prob: float = 1.0,
                 clients: Sequence[int] | None = None) -> FaultPlan:
    """The chosen clients (drawn unless ``clients`` is given) ship NaN
    updates in each round with probability ``prob``."""
    chosen = _pick_clients(generator, n_clients, n_corrupt, clients)
    hit = torch.rand((rounds, len(chosen)), generator=generator,
                     device=_device(generator)) < prob
    nan_mask = torch.zeros((rounds, n_clients), dtype=torch.bool)
    nan_mask[:, chosen] = hit.cpu()
    return no_faults(rounds, n_clients)._replace(nan_mask=nan_mask)


def byzantine_scale(generator: torch.Generator | None, rounds: int,
                    n_clients: int, *, n_byzantine: int = 1,
                    scale: float = 64.0,
                    clients: Sequence[int] | None = None) -> FaultPlan:
    """The chosen clients ship ``global + scale * (update - global)`` every
    round: finite, with an exploded norm (the norm guard's case)."""
    chosen = _pick_clients(generator, n_clients, n_byzantine, clients)
    scales = torch.ones((rounds, n_clients), dtype=torch.float32)
    scales[:, chosen] = float(scale)
    return no_faults(rounds, n_clients)._replace(scale=scales)


def compose(*plans: FaultPlan) -> FaultPlan:
    """Overlay plans: participation intersects, NaN masks unite,
    byzantine scales multiply."""
    if not plans:
        raise ValueError("compose() needs at least one plan")
    shapes = {tuple(p.participate.shape) for p in plans}
    if len(shapes) != 1:
        raise ValueError(f"fault plans disagree on (rounds, clients): "
                         f"{sorted(shapes)}")
    out = plans[0]
    for p in plans[1:]:
        out = FaultPlan(out.participate & p.participate,
                        out.nan_mask | p.nan_mask, out.scale * p.scale)
    return out


# -- the degraded-round math (the fused path and the host oracle) --------


@dataclasses.dataclass(frozen=True)
class UpdateGuard:
    """Which corrupt updates lose their weight before the merge:
    ``nonfinite`` drops NaN/Inf updates; ``norm_mult > 0`` also drops
    updates whose delta norm exceeds ``norm_mult`` x the participating
    finite cohort's median (0 turns the norm guard off)."""
    nonfinite: bool = True
    norm_mult: float = DEFAULT_NORM_MULT


def apply_faults(new_flat: torch.Tensor, prev_flat: torch.Tensor,
                 nan_mask: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Corrupt the transmitted ``(P, D)`` update stack with one round's
    fault slice.  Honest clients (scale 1, no NaN) pass bit-identically:
    the scale formula is taken only where scale != 1."""
    scale = scale[:, None]
    scaled = prev_flat + scale * (new_flat - prev_flat)
    flat = torch.where(scale == 1.0, new_flat, scaled)
    return torch.where(nan_mask[:, None], torch.nan, flat)


def apply_faults_tree(new_tree: Sequence[torch.Tensor],
                      prev_tree: Sequence[torch.Tensor],
                      nan_mask: torch.Tensor,
                      scale: torch.Tensor) -> list[torch.Tensor]:
    """:func:`apply_faults` per stacked leaf (each ``(P, ...)``), with the
    same elementwise operations, for the host oracle's merge."""
    out = []
    for n, p in zip(new_tree, prev_tree, strict=True):
        sh = (-1,) + (1,) * (n.dim() - 1)
        s = scale.reshape(sh).float()
        nf, pf = n.float(), p.float()
        leaf = torch.where(s == 1.0, nf, pf + s * (nf - pf))
        out.append(torch.where(nan_mask.reshape(sh), torch.nan, leaf)
                   .to(n.dtype))
    return out


def _nanmedian(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The median of ``x`` over ``valid``, as ``jnp.nanmedian`` computes it:
    linear interpolation, so an even count gives the mean of the two
    middle values (``torch.nanmedian`` gives the lower one); NaN when no
    value is valid.  On the device, with no host wait."""
    s, _ = torch.sort(torch.where(valid, x, torch.nan))   # NaNs sort last
    n = torch.sum(valid).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    hi_w = q - lo
    lo_w = 1.0 - hi_w

    def at(i):
        return s[torch.clamp(torch.minimum(i, n - 1.0), min=0.0).long()]
    return at(lo) * lo_w + at(hi) * hi_w


def update_diagnostics(flat: torch.Tensor, prev_flat: torch.Tensor,
                       participate: torch.Tensor, *,
                       norm_mult: float = DEFAULT_NORM_MULT) -> dict:
    """Per-client update health on the ``(P, D)`` stack the merge takes:

    ``finite``  -- the transmitted update has no NaN/Inf;
    ``norm``    -- L2 norm of the delta from the round's global parameters,
                   non-finite entries left out;
    ``norm_ok`` -- norm <= ``norm_mult`` x the median over the
                   participating finite cohort (an empty cohort fails
                   everyone, and the round freezes);
    ``suspect`` -- ~finite | ~norm_ok, the retry blocklist's signal,
                   computed whether or not a guard enforces it.
    """
    delta = flat - prev_flat
    finite = torch.all(torch.isfinite(flat), dim=1)
    norm = torch.sqrt(torch.sum(
        torch.where(torch.isfinite(delta), delta, 0.0) ** 2, dim=1))
    med = _nanmedian(norm, participate & finite)
    norm_ok = norm <= norm_mult * torch.clamp(med, min=1e-12)
    return {"finite": finite, "norm": norm, "norm_ok": norm_ok,
            "suspect": ~finite | ~norm_ok}


def guard_ok(guard: UpdateGuard | None, diag: dict,
             participate: torch.Tensor) -> torch.Tensor:
    """The (P,) survivors: participation AND what the guard enforces
    (``guard=None`` enforces nothing; the diagnostics stay advisory)."""
    ok = participate
    if guard is not None:
        if guard.nonfinite:
            ok = ok & diag["finite"]
        if guard.norm_mult > 0:
            ok = ok & diag["norm_ok"]
    return ok


def sanitize_stacked(tree: Sequence[torch.Tensor],
                     ok: torch.Tensor) -> list[torch.Tensor]:
    """Zero the non-surviving clients of every stacked leaf, so a zero
    weight times a poisoned value adds an exact ``+0.0``."""
    return [torch.where(ok.reshape((-1,) + (1,) * (leaf.dim() - 1)), leaf,
                        torch.zeros((), dtype=leaf.dtype, device=leaf.device))
            for leaf in tree]
