"""Reading ``torch.profiler`` traces of stretches of serving.

A traced run profiles two stretches after the window. The first records the
device alone (``ProfilerActivity.CUDA``), which costs the host little, so
its batches run near the window's pace: its busy time, idle share, kernel
times and counters are what the metrics read. The second records the host's
ops as well, which slows the host, and serves only to name the idle gaps.
Device intervals are the trace's CUDA events (kernels, copies, memsets;
user annotations left out). ``busy_s`` is the length of their union; an idle
gap is an interval between two merged busy intervals inside the stretch,
named by the innermost host op that was running at its midpoint (``host
python`` where none was).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10


class Stretch:
    """The profiler over one stretch of the serving loop. ``host``: record the
    host's ops too (on a machine without a card they are all there is).
    ``counters``: name -> a function read at the start and the stop; the
    difference lands in ``counted``."""

    def __init__(self, cuda: bool = True, host: bool = False):
        self.cuda = cuda
        self.prof = profile(activities=([ProfilerActivity.CPU] if host or not cuda else [])
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.t0 = self.t1 = None
        self.batches = 0
        self.counters, self.counted = {}, {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.counted = {k: -fn() for k, fn in self.counters.items()}
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        for k, fn in self.counters.items():
            self.counted[k] += fn()
        self.read()

    def read(self):
        dev, host = [], []
        for e in self.prof.events():
            if getattr(e, "is_user_annotation", False):
                continue
            span = (e.time_range.start, e.time_range.end, e.name)
            (dev if e.device_type == DeviceType.CUDA else host).append(span)
        self.device = sorted(dev)
        self.host = sorted(host)
        self.window_s = self.t1 - self.t0
        self.busy = _union(self.device)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self, substring: str) -> dict:
        """{exact kernel name: (total device us, records)} of kernels whose name
        contains ``substring``."""
        out = defaultdict(lambda: [0.0, 0])
        for a, b, name in self.device:
            if substring in name:
                out[name][0] += b - a
                out[name][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def device_ops(self) -> list:
        """The TOP device ops by their summed time (s)."""
        ops = defaultdict(float)
        for a, b, name in self.device:
            ops[name] += (b - a) * 1e-6
        return _top(ops)

    def idle_gaps(self) -> list:
        """The TOP idle gaps (s), summed by the host op running at their midpoints."""
        starts = [a for a, _, _ in self.host]
        gaps = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            gaps[self._host_at((e0 + s1) * 0.5, starts)] += (s1 - e0) * 1e-6
        return _top(gaps)

    def _host_at(self, t: float, starts) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            a, b, name = self.host[i]
            if b >= t:
                return name
            i -= 1
            if t - a > 5e5:            # no host op spans half a second of a stretch
                break
        return "host python"


def _top(d: dict) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]


def _union(spans):
    merged = []
    for a, b, _ in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged
