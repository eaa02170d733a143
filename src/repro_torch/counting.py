"""Work counting: the operations a function runs, their FLOPs, the bytes
they move and the collectives they issue, from a ``TorchDispatchMode`` over
the aten ops (:class:`OpCounter`).  :mod:`repro_torch.launch.roofline`
turns a count into roofline terms.

The hand-written kernels are launched through ``ctypes`` and are invisible
to a dispatch mode, so every kernel entry of :mod:`repro_torch.kernels.ops`
reports its own least work (:mod:`repro_torch.kernels.work`) with
:func:`kernel` and hides the ops beneath it, on the card and on the plain
route alike: a step counts the same work on the card, on the CPU and on
the meta device.

Python loops that the reference runs as ``lax.scan`` (the sLSTM and Mamba
time loops) go through :func:`time_scan`: on tensors without values (the
meta device) under a counter it runs one trip and charges it as many times
as the loop has steps, as XLA's count multiplies a loop body by its known
trip count; anywhere else it walks the loop.

Nothing here touches a device or a process group when imported, and with
no counter active every helper is a plain call.
"""
from __future__ import annotations

import contextlib
import copy
import weakref
from collections import Counter, defaultdict
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that allocate without writing, or only touch metadata: no traffic
# (the reference's _SKIP_OPS); views are skipped by their schema
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.lift_fresh.default,
    aten.detach.default, aten.alias.default, aten._local_scalar_dense.default,
    aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_same_size.default,
    aten.set_.source_Storage_storage_offset,
}
# collective op names (``c10d`` and ``_c10d_functional`` namespaces) ->
# the reference's kinds
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "collective-permute"),
                ("send", "collective-permute"))
_COLLECTIVE_NS = ("c10d", "_c10d_functional")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._schema.name.split("::")[-1]
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None          # wait_tensor, _wrap_tensor_autograd, ...


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (``with OpCounter() as c: ...``).

    * FLOPs: ``torch.utils.flop_counter``'s formulas (the reference's dot
      rule, ``2 * prod(result) * prod(contracting)``, for ``mm``,
      ``addmm``, ``bmm``, ``baddbmm`` and the products ``einsum`` becomes;
      its own for convolutions), recorded per input dtype.
    * HBM bytes: operand plus result bytes of every op but views and the
      allocation and metadata ops.  Eager PyTorch does not fuse, so this
      reads higher than XLA's count of a fused program.
    * Collectives: all-gather is charged its result bytes, all-reduce
      twice its operand, and reduce-scatter, all-to-all and the
      point-to-point ops their operand; DTensor's redistributions are
      counted on the local shards they move.
    * Live bytes: each op's new output from its creation until the tensor
      the op returned is freed; ``peak_live_bytes`` is the largest sum.

    A DTensor op is let through to DTensor, whose local ops on each rank's
    shard come back here, so that counts are per rank.  Ops on other
    tensor subclasses (DTensor's fake tensors for sharding propagation)
    run uncounted."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Counter = Counter()
        self.hbm_bytes = 0.0
        self.bytes_by_device: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.collectives: Counter = Counter()
        self.kernels: dict = defaultdict(Counter)
        # every loop of the port has a known trip count (the reference's
        # XLA walk can meet one without)
        self.unknown_trip_loops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._mult = 1
        self._hidden = 0

    # -- what the kernels and loops call ----------------------------------
    def report(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype) -> None:
        """One launch of kernel ``name`` doing ``flops`` on ``dtype``
        inputs and moving ``nbytes``."""
        if self._hidden:
            return
        k = self.kernels[name]
        k["launches"] += self._mult
        k["flops"] += flops * self._mult
        k["bytes"] += nbytes * self._mult
        self.flops_by_dtype[dtype] += flops * self._mult
        self.hbm_bytes += nbytes * self._mult
        self.bytes_by_device["kernels"] += nbytes * self._mult

    @contextlib.contextmanager
    def hidden(self):
        """Ops run inside are not counted (a kernel's work is reported)."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    _COUNTS = ("flops_by_dtype", "hbm_bytes", "bytes_by_device",
               "bytes_by_op", "collectives")

    def snapshot(self) -> dict:
        """The counts so far (not the live bytes), for :meth:`restore`."""
        snap = {k: copy.copy(getattr(self, k)) for k in self._COUNTS}
        snap["kernels"] = {k: Counter(v) for k, v in self.kernels.items()}
        return snap

    def restore(self, snap: dict) -> None:
        """Forget what was counted since ``snap`` (an attempt that failed)."""
        for k in self._COUNTS:
            setattr(self, k, copy.copy(snap[k]))
        self.kernels = defaultdict(Counter, snap["kernels"])

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Everything counted inside is charged ``n`` times."""
        self._mult *= n
        try:
            yield
        finally:
            self._mult //= n

    # -- the mode -----------------------------------------------------------
    def __enter__(self):
        global _open
        _open += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _open
        _open -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._hidden or any(t is not torch.Tensor for t in types):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        m = self._mult
        kind = _collective_kind(func)
        if kind is not None:
            if kind == "all-gather":
                moved = _nbytes(_tensors(out))
            else:
                moved = _nbytes(_tensors(args[0] if args else ()))
                if kind == "all-reduce":
                    moved *= 2
            self.collectives[kind] += moved * m
            return
        if func.namespace in _COLLECTIVE_NS:
            return
        if func.is_view or func in _NO_TRAFFIC:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        nbytes = (_nbytes(ins) + _nbytes(outs)) * m
        self.hbm_bytes += nbytes
        # by the op's device: a card's step also copies host tensors (the
        # RNG states a remat region stashes)
        devices = {t.device.type for t in ins + outs}
        self.bytes_by_device[next(iter(devices - {"cpu"}), "cpu")] += nbytes
        self.bytes_by_op[str(func)] += nbytes
        packet = func.overloadpacket
        if packet in flop_registry and ins:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_dtype[ins[0].dtype] += flops * m
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in seen:          # in place: no new storage
                continue
            seen.add(st._cdata)
            n = st.nbytes()
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))


# OpCounters entered and not yet left, on any thread: with none, a kernel
# entry asks nothing of the dispatch mode stack
_open = 0


def active() -> OpCounter | None:
    """The innermost :class:`OpCounter` on this thread's dispatch mode
    stack, or None."""
    if not _open:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


_NOTHING = contextlib.nullcontext()


@contextlib.contextmanager
def _reported(c: OpCounter, name: str, work: Callable, dtype: torch.dtype):
    n_bytes, flops = work()
    c.report(name, flops, n_bytes, dtype)
    with c.hidden():
        yield


def kernel(name: str, work: Callable[[], tuple], dtype: torch.dtype):
    """A context around one kernel entry: report ``work()`` = (bytes,
    flops) of one launch of ``name`` on ``dtype`` inputs to the active
    counter, and hide the ops run inside (the launch's allocations on the
    card, the plain version's ops elsewhere).  With no counter, ``work`` is
    not called and the context does nothing."""
    c = active()
    return _NOTHING if c is None else _reported(c, name, work, dtype)


def _own_saved_tensors():
    """The inner graph of a Function keeps its saved tensors: an enclosing
    remat's hooks would otherwise recompute the whole checkpointed region
    inside the Function's backward (and its multiplier)."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


class _HiddenPlain(torch.autograd.Function):
    """A plain version with a backward kernel, under a counter: the
    forward's and the backward's ops hidden, each reported as its
    kernel's launch.  The gradient is autograd's through the plain
    version, as without a counter."""

    @staticmethod
    def forward(ctx, fn, fwd, bwd, *args):
        ins = [a.detach().requires_grad_(a.requires_grad)
               if isinstance(a, torch.Tensor) else a for a in args]
        with kernel(*fwd), torch.enable_grad(), _own_saved_tensors():
            out = fn(*ins)
        ctx.ins, ctx.out, ctx.bwd = ins, out, bwd
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        wrt = [a for a in ctx.ins
               if isinstance(a, torch.Tensor) and a.requires_grad]
        with kernel(*ctx.bwd):
            got = iter(torch.autograd.grad(ctx.out, wrt, grad))
        return (None, None, None) + tuple(
            next(got) if isinstance(a, torch.Tensor) and a.requires_grad
            else None for a in ctx.ins)


def plain_with_backward(fn: Callable, args: Sequence, fwd: tuple,
                        bwd: tuple) -> torch.Tensor:
    """``fn(*args)``, the plain version of a kernel whose backward is a
    kernel too.  Under a counter the forward and, when autograd reaches
    it, the backward are hidden and reported as ``fwd`` and ``bwd`` =
    (name, work, dtype), as :func:`kernel` takes them; with none it is
    ``fn(*args)``."""
    if active() is None:
        return fn(*args)
    if not (torch.is_grad_enabled()
            and any(isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args)):
        with kernel(*fwd):
            return fn(*args)
    return _HiddenPlain.apply(fn, fwd, bwd, *args)


class _Trip(torch.autograd.Function):
    """One loop trip that autograd differentiates as a whole, so that its
    backward runs under the same multiplier as its forward."""

    @staticmethod
    def forward(ctx, step, counter, n, carry_of, n_carry, n_xs, *tensors):
        # a middle trip: its carry has a gradient whenever the loop's
        # inputs have one (the first trip's carry has none)
        flows = any(t.requires_grad for t in tensors[n_carry:])
        ins = [t.detach().requires_grad_(t.requires_grad
                                         or (i < n_carry and flows))
               for i, t in enumerate(tensors)]
        with torch.enable_grad(), _own_saved_tensors():
            carry, y = step(carry_of(ins[:n_carry]),
                            tuple(ins[n_carry:n_carry + n_xs]),
                            tuple(ins[n_carry + n_xs:]))
        ctx.ins, ctx.outs, ctx.counter, ctx.n = ins, (*carry, y), counter, n
        return tuple(t.detach() for t in (*carry, y))

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in ctx.ins if t.requires_grad]
        with ctx.counter.repeated(ctx.n):
            got = iter(torch.autograd.grad([o for o, _ in pairs],
                                           wrt, [g for _, g in pairs],
                                           allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in ctx.ins]
        return (None,) * 6 + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[6:]))


def time_scan(step: Callable, carry: tuple, xs: tuple, consts: tuple = ()):
    """Run ``carry, y = step(carry, xs_t, consts)`` for every t < S, where
    ``xs_t = tuple(x[:, t] for x in xs)`` (each x is (B, S, ...)); return
    the last carry and the ``y``s stacked on dim 1.

    Under a counter on tensors without values (the meta device), one trip
    runs and is charged S times, its backward too when autograd reaches
    it; the ``y``s are that trip's, repeated.  The stack is the same op as
    the walked loop's, so a forward counts exactly what the walk counts;
    a backward counts a middle trip's gradient S times, where the walk's
    first trip has no carry gradient, so it reads one trip's carry
    gradient high."""
    S = xs[0].shape[1]
    c = active()
    if c is None or S < 2 or xs[0].device.type != "meta":
        ys = []
        for t in range(S):
            carry, y = step(carry, tuple(x[:, t] for x in xs), consts)
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    xs_0 = tuple(x[:, 0] for x in xs)
    tensors = (*carry, *xs_0, *consts)
    kind = type(carry)

    def carry_of(items):         # a NamedTuple state keeps its type
        return kind(*items) if hasattr(kind, "_fields") else tuple(items)
    with c.repeated(S):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            *new, y = _Trip.apply(step, c, S, carry_of, len(carry), len(xs),
                                  *tensors)
            carry = carry_of(new)
        else:
            carry, y = step(carry, xs_0, consts)
    return carry, torch.stack([y] * S, dim=1)


def repeat(n: int, fn: Callable, carry, *, like: torch.Tensor):
    """``carry = fn(carry)`` ``n`` times (a Python loop the reference runs
    as ``lax.scan``, such as a round's local steps).  Under a counter when
    ``like`` has no values (the meta device), one call is charged ``n``
    times."""
    c = active()
    if c is not None and like.device.type == "meta":
        with c.repeated(n):
            return fn(carry)
    for _ in range(n):
        carry = fn(carry)
    return carry
