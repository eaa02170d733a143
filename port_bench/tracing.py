"""The device trace of a run's window: ``torch.profiler`` with CUDA
activity only (cheap for windows of a million kernels), reduced as the
trace comes, without ``key_averages``.

``Trace`` is a context manager.  Disabled (``--trace 0``) it does nothing.
Enabled, it profiles the window and, on exit, keeps per kernel name its
summed device nanoseconds and launches, the busy seconds (every device
record's duration: one stream, so nothing overlaps), and the idle gaps
between consecutive records summed by the pair of records around them
(what the card finished, what it waited to start: the host's work lies
between).
"""
from __future__ import annotations

import collections
import time


class Trace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.by_name: dict[str, list] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.kernels = 0
        self.gaps: collections.Counter = collections.Counter()
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._reduce()
        return False

    def _reduce(self) -> None:
        from torch.autograd import DeviceType
        records = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                records.append((e.start_ns(), e.duration_ns(), e.name()))
        records.sort()
        by_name: dict[str, list] = {}
        busy = 0
        for start, dur, name in records:
            acc = by_name.setdefault(name, [0, 0])
            acc[0] += dur
            acc[1] += 1
            busy += dur
        self.by_name = by_name
        self.busy_s = busy / 1e9
        self.kernels = sum(n for name, (_, n) in by_name.items()
                           if not name.startswith(("Memcpy", "Memset")))
        for (s0, d0, n0), (s1, _, n1) in zip(records, records[1:]):
            gap = s1 - (s0 + d0)
            if gap > 0:
                self.gaps[f"{short(n0)} -> {short(n1)}"] += gap
        self._prof = None

    def device_ns(self, *fragments: str) -> tuple[int, int]:
        """(ns, launches) summed over the kernels whose name holds any of
        ``fragments``."""
        ns = n = 0
        for name, (t, k) in self.by_name.items():
            if any(f in name for f in fragments):
                ns += t
                n += k
        return ns, n

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = self.gaps.most_common(10)
        return {"device_ops": [[short(n), t / 1e9] for n, (t, _) in ops],
                "idle_gaps": [[k, ns / 1e9] for k, ns in gaps]}


def short(name: str) -> str:
    """A kernel's name without ``void``, ``at::native::`` and its argument
    list, at most 72 characters."""
    name = name.replace("void ", "").replace("at::native::", "")
    return name.split("(")[0][:72] or "(unnamed)"
