"""Round traces: the federation's transmitted artifacts, recorded; the
port's copy of the JAX package's ``privacy/trace.py``.

Fed-TGAN's protocol transmits two kinds of data an honest-but-curious
federator (or a wire eavesdropper) can attack:

  * **setup time (§4.1)**: per-client categorical frequency tables and
    per-client VGM fits (means/stds/weights), shipped once before
    training;
  * **every round**: each client's post-local-training model parameters,
    the flat ``(P, D)`` stack the fused ``weighted_agg`` merge reads,
    plus the resolved §4.2 weights.

:class:`RoundTrace` records exactly those surfaces (no raw rows, no
per-step gradients the protocol never sends) to a replayable ``.npz``
without pickle, bit-exactly: ``save`` -> ``load`` round-trips every array
with identical bytes.  Flat parameters are stored in the JAX package's
layout (critic first, sorted keys, ``(fan_in, fan_out)`` weights;
:func:`repro_torch.interop.gan_flat_index`) with the same keys, so that a
trace recorded by either package loads and replays in the other.  The
attacks (:mod:`repro_torch.privacy.attacks`) read these traces; the
recorder hooks live in ``run_federated(trace=...)`` (the fused program
and the host oracle) through :meth:`repro_torch.fed.FederatedProgram.
run_traced`.

Example: record two fake rounds, round-trip through disk, bit-exact:

    >>> import numpy as np, tempfile, os
    >>> from repro_torch.privacy import RoundTrace
    >>> tr = RoundTrace()
    >>> tr.weights = np.array([0.75, 0.25], np.float32)
    >>> tr.n_rows = np.array([30.0, 10.0], np.float32)
    >>> tr.cat_freqs[1] = np.array([[0.5, 0.5], [1.0, 0.0]], np.float64)
    >>> rng = np.random.default_rng(0)
    >>> for r in range(2):
    ...     tr.record_round(r, rng.normal(size=(2, 8)).astype(np.float32))
    >>> path = os.path.join(tempfile.mkdtemp(), "trace.npz")
    >>> tr.save(path)
    >>> back = RoundTrace.load(path)
    >>> back.equals(tr), back.n_rounds, back.rounds
    (True, 2, [0, 1])
    >>> bool((back.update_stack(-1) == tr.updates[1]).all())
    True
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import field

import numpy as np


class TraceError(ValueError):
    """Malformed or incomplete trace (mismatched client axes, missing
    setup artifacts, unknown on-disk keys)."""


@dataclasses.dataclass
class RoundTrace:
    """One federation's recorded privacy surface.

    Setup-time artifacts (filled by :meth:`record_setup`):

    ``weights``     (P,) resolved §4.2 weights (protocol data — the
                    federator derives them from the transmitted stats).
    ``n_rows``      (P,) per-client row counts.
    ``global0``     (D,) the initial broadcast model, flattened in the
                    same layout as the update stacks (the federator
                    initialized it, so it trivially knows it).
    ``cat_freqs``   col j -> (P, C_j) per-client category frequencies on
                    the global label-encoder support.
    ``vgm_means`` / ``vgm_stds`` / ``vgm_weights``
                    col j -> (P, K_j) per-client VGM parameters.

    Per-round artifacts (appended by :meth:`record_round`):

    ``rounds``      absolute round indices, in recording order.
    ``updates``     per recorded round, the (P, D) float32 transmitted
                    parameter stack (post-local-training, pre-merge), in
                    the reference's flat layout.
    """
    weights: np.ndarray | None = None
    n_rows: np.ndarray | None = None
    global0: np.ndarray | None = None
    rounds: list[int] = field(default_factory=list)
    updates: list[np.ndarray] = field(default_factory=list)
    cat_freqs: dict[int, np.ndarray] = field(default_factory=dict)
    vgm_means: dict[int, np.ndarray] = field(default_factory=dict)
    vgm_stds: dict[int, np.ndarray] = field(default_factory=dict)
    vgm_weights: dict[int, np.ndarray] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    # -- recording hooks -------------------------------------------------

    def record_setup(self, fe) -> "RoundTrace":
        """Capture the §4.1 setup-time surface from a staged
        :class:`repro_torch.fed.Federation`: per-client categorical
        frequencies (on the unioned support), per-client VGM fits, row
        counts, resolved weights, and the initial broadcast model (client
        0's, in the reference's flat layout)."""
        from ..fed.merge import flatten_stacked
        from ..interop import flat_to_reference, gan_flat_index
        st = fe.states[0]
        self.weights = fe.weights.cpu().numpy()
        self.n_rows = fe.n_rows.cpu().numpy()
        self.global0 = flat_to_reference(
            flatten_stacked([st.params()])[0],
            gan_flat_index(st.gen, st.disc)).cpu().numpy()
        for j in (fe.init.client_cat_freqs[0] or {}):
            self.cat_freqs[j] = np.stack(
                [cf[j] for cf in fe.init.client_cat_freqs])
        if fe.client_stats:
            for j in fe.client_stats[0].vgms:
                for name, into in (("means", self.vgm_means),
                                   ("stds", self.vgm_stds),
                                   ("weights", self.vgm_weights)):
                    into[j] = np.stack(
                        [getattr(s.vgms[j], name).cpu().numpy()
                         for s in fe.client_stats])
        self.meta.setdefault("weighting", fe.weighting)
        self.meta.setdefault("P", int(self.n_rows.shape[0]))
        return self

    def record_round(self, round_index: int, updates) -> None:
        """Append one round's transmitted (P, D) parameter stack."""
        u = np.asarray(updates, np.float32)
        if u.ndim != 2:
            raise TraceError(f"updates must be (P, D), got {u.shape}")
        if self.updates and u.shape != self.updates[0].shape:
            raise TraceError(f"updates shape {u.shape} does not match the "
                             f"trace's {self.updates[0].shape}")
        self.rounds.append(int(round_index))
        self.updates.append(u)

    # -- views -----------------------------------------------------------

    @property
    def n_rounds(self) -> int:
        return len(self.updates)

    @property
    def n_clients(self) -> int:
        if self.updates:
            return int(self.updates[0].shape[0])
        if self.n_rows is not None:
            return int(self.n_rows.shape[0])
        raise TraceError("empty trace: no updates or setup recorded")

    def update_stack(self, index: int = -1) -> np.ndarray:
        """The (P, D) stack of the ``index``-th RECORDED round (python
        list indexing; -1 = latest)."""
        if not self.updates:
            raise TraceError("no rounds recorded")
        return self.updates[index]

    def global_before(self, index: int = -1) -> np.ndarray:
        """The (D,) global model every client started the ``index``-th
        recorded round from — what the federator broadcast.  For the
        first recorded round that is ``global0``; afterwards it is the
        weighted merge of the PREVIOUS round's updates (the federator's
        own computation, so the attacker has it exactly)."""
        if not self.updates:
            raise TraceError("no rounds recorded")
        i = index % len(self.updates)
        if i == 0:
            if self.global0 is None:
                raise TraceError("global_before(0) needs the recorded "
                                 "initial model (record_setup)")
            return self.global0
        if self.weights is None:
            raise TraceError("global_before needs the recorded weights")
        w = self.weights.astype(np.float64)
        w = w / max(w.sum(), 1e-12)
        prev = self.updates[i - 1].astype(np.float64)
        return (w[:, None] * prev).sum(axis=0).astype(np.float32)

    # -- persistence -----------------------------------------------------

    _DICT_FIELDS = ("cat_freqs", "vgm_means", "vgm_stds", "vgm_weights")

    def save(self, path: str) -> None:
        """Persist to ``.npz`` (bit-exact: arrays round-trip with their
        dtypes; ``meta`` rides along as JSON)."""
        arrays: dict[str, np.ndarray] = {
            "rounds": np.asarray(self.rounds, np.int64),
            "meta": np.array(json.dumps(self.meta)),
        }
        if self.updates:
            arrays["updates"] = np.stack(self.updates)
        for name in ("weights", "n_rows", "global0"):
            v = getattr(self, name)
            if v is not None:
                arrays[name] = v
        for fieldname in self._DICT_FIELDS:
            for j, v in getattr(self, fieldname).items():
                arrays[f"{fieldname}/{j}"] = v
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "RoundTrace":
        tr = cls()
        with np.load(path, allow_pickle=False) as z:
            for key in z.files:
                if key == "meta":
                    tr.meta = json.loads(str(z[key]))
                elif key == "rounds":
                    tr.rounds = [int(r) for r in z[key]]
                elif key == "updates":
                    tr.updates = [u for u in z[key]]
                elif key in ("weights", "n_rows", "global0"):
                    setattr(tr, key, z[key])
                elif "/" in key:
                    fieldname, j = key.split("/", 1)
                    if fieldname not in cls._DICT_FIELDS:
                        raise TraceError(f"unknown trace field {key!r}")
                    getattr(tr, fieldname)[int(j)] = z[key]
                else:
                    raise TraceError(f"unknown trace field {key!r}")
        return tr

    def equals(self, other: "RoundTrace") -> bool:
        """Bit-exact equality (values AND dtypes) across every recorded
        artifact — the record → replay contract."""
        def eq(a, b):
            if a is None or b is None:
                return a is None and b is None
            return (a.dtype == b.dtype and a.shape == b.shape
                    and np.array_equal(a, b))

        if not (eq(self.weights, other.weights)
                and eq(self.n_rows, other.n_rows)
                and eq(self.global0, other.global0)
                and self.rounds == other.rounds
                and self.meta == other.meta
                and len(self.updates) == len(other.updates)
                and all(eq(a, b) for a, b in zip(self.updates,
                                                 other.updates))):
            return False
        for fieldname in self._DICT_FIELDS:
            mine, theirs = getattr(self, fieldname), getattr(other, fieldname)
            if sorted(mine) != sorted(theirs):
                return False
            if not all(eq(mine[j], theirs[j]) for j in mine):
                return False
        return True
