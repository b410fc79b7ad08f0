"""A traced window: torch.profiler around a few steps, reduced to what the
per-layer readers and the result's `breakdown` need.

Two traced windows: one of the device alone, whose idle share, launches
and kernel times the readers take, and one with the host's operators too,
which slow the launches, for naming the idle gaps. Device operations are
every event on the device but the shadows of the benchmark's spans
(kernels, copies, sets); the device is busy where their union covers the
window. Idle gaps are named by what the host was doing at their middle:
the benchmark's own span and the outermost PyTorch operator open there.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# the benchmark's own spans (record_function) around and inside each step
SPANS = ("step", "upload", "track", "readback")


class Trace:
    """Device intervals (ns) with names, host spans and operators, the
    window's length and whatever the runner recorded beside it (`extra`:
    steps, the kernel's searches, the card's power limit, ...)."""

    def __init__(self, events, window_s, extra):
        self.window_s = window_s
        self.extra = extra
        self.device = []        # (start_ns, end_ns, name)
        self.spans = []         # benchmark spans: (start_ns, end_ns, name)
        ops = []                # host operators: (start_ns, end_ns, name)
        for e in events:
            name = e.name()
            iv = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name not in SPANS:           # not a span's shadow on the device
                    self.device.append(iv)
            elif name in SPANS:
                self.spans.append(iv)
            elif not name.startswith("cu"):     # not a CUDA API call (cuda*, cu*)
                ops.append(iv)
        self.device.sort()
        self.top_ops = []       # host operators not inside another one
        for s, e, n in sorted(ops):
            if not self.top_ops or s >= self.top_ops[-1][1]:
                self.top_ops.append((s, e, n))
        self._top_starts = [s for s, _, _ in self.top_ops]

    def busy_intervals(self):
        """The union of the device intervals, in order."""
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, fragment):
        """Device seconds of the operations whose name holds `fragment`."""
        return sum(e - s for s, e, n in self.device if fragment in n) * 1e-9

    def device_ops(self, top=10):
        """[name, seconds] of the device operations that took most time."""
        tot = defaultdict(int)
        for s, e, n in self.device:
            tot[n] += e - s
        return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t):
        inner = [(e - s, n) for s, e, n in self.spans if s <= t < e]
        span = min(inner)[1] if inner else "outside"
        i = bisect.bisect_right(self._top_starts, t) - 1
        op = self.top_ops[i][2] if i >= 0 and t < self.top_ops[i][1] else None
        return f"{span}/{op}" if op else span

    def idle_gaps(self, top=10):
        """[what the host was doing, idle seconds] summed over the gaps
        between device operations inside each "step" span."""
        busy = self.busy_intervals()
        starts = [s for s, _ in busy]
        tot = defaultdict(int)
        for s0, s1, name in self.spans:
            if name != "step":
                continue
            prev = s0
            for s, e in busy[max(bisect.bisect_right(starts, s0) - 1, 0):]:
                if s >= s1:
                    break
                s, e = max(s, s0), min(e, s1)
                if s > prev:
                    tot[self._host_at((prev + s) // 2)] += s - prev
                prev = max(prev, e)
            if s1 > prev:
                tot[self._host_at((prev + s1) // 2)] += s1 - prev
        return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def traced(fn, steps, device, host_ops=True):
    """Run fn(k) for k in range(steps) under the profiler; each step in a
    span "step". Without `host_ops` only the device is traced, which leaves
    the host's launch rate nearly as it is untraced. Returns (the list of
    fn's results, the profiler's events, the window's host seconds, the
    seconds from its start to the end of each step)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host_ops or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    outs, ends = [], []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            with record_function("step"):
                outs.append(fn(k))
            ends.append(time.perf_counter() - t0)
        window_s = time.perf_counter() - t0
    return outs, prof.profiler.kineto_results.events(), window_s, ends
