"""Reading the device's work out of a ``torch.profiler`` trace of the window.

``Trace.start()`` before the window's first unit and ``Trace.stop()``
after its last (which ends in a synchronize) bracket the traced window.
From the profiler's events it keeps every device operation (kernels,
copies, sets: name, start, duration) and the host's torch operations,
and works out the busy time (the union of the device operations), the
device operations that took most time, and the idle gaps between device
operations, each named by the innermost host operation running at its
middle ("host Python" where none was).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10
LOOK_BACK = 64


class Trace:
    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.window_s = 0.0
        self.device_ops: list[tuple[str, int, int]] = []  # (name, start ns, end ns)
        self.host_ops: list[tuple[str, int, int]] = []

    def start(self) -> None:
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        for ev in self.prof.profiler.kineto_results.events():
            span = (ev.name(), int(ev.start_ns()), int(ev.start_ns()) + int(ev.duration_ns()))
            if ev.device_type() == DeviceType.CUDA:
                self.device_ops.append(span)
            elif ev.device_type() == DeviceType.CPU:
                self.host_ops.append(span)
        self.device_ops.sort(key=lambda s: s[1])
        self.prof = None

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _, a, b in self.device_ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for name, a, b in self.device_ops if match(name)) / 1e9

    def top_device_ops(self) -> list:
        per: dict = defaultdict(int)
        for name, a, b in self.device_ops:
            per[name[:120]] += b - a
        return [[name, ns / 1e9] for name, ns in sorted(per.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """Idle time between device operations, summed by what the host was
        doing at each gap's middle: the latest-started host operation still
        running then (among the ``LOOK_BACK`` that started last)."""
        busy = self.busy_intervals()
        host = sorted(self.host_ops, key=lambda s: s[1])
        starts = [s[1] for s in host]
        per: dict = defaultdict(int)
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) // 2
            label = "host Python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - LOOK_BACK, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            per[label[:120]] += start - end
        return [[name, ns / 1e9] for name, ns in sorted(per.items(), key=lambda kv: -kv[1])[:TOP]]
