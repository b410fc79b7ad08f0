"""The program's own spans in a traced window: the device operations, their
device time and the device's idle time put down to the span the host was in.

The window (`trace.extra["program"]`: the profiler's `events` and the
`records` of the program's `StageTimer`, each (name, parent, start_ns,
end_ns) on the clock of the profiler's host events) is traced with the
device alone, so the host's launch rate stays near its untraced pace.

- Device operations are the device events that are not user annotations
  (kernels, copies, sets; a span's shadow on the device is none of them).
- Each operation belongs to every span that was open on the host when the
  CUDA API call with its correlation id started; where the window has no
  such call, to the spans whose shadows on the device hold its start.
- Each idle gap that an operation launched inside a `multiseq.step` span
  ends, from the end of the device work before it, is put down to that
  operation's spans: what the host was doing while the device waited. The
  gaps are read on the device's clock alone: the profiler's device
  timestamps drift against its host records (by up to milliseconds over a
  window on an H100 host), so no device time is compared with a host one,
  and `early` only measures that drift.
"""
from __future__ import annotations

import torch

STEP = "multiseq.step"


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _open_at(t, ivs):
    """(names of the intervals (start, end, name) that hold t, the latest of
    their starts or None)."""
    held = [(s, n) for s, e, n in ivs if s <= t < e]
    return frozenset(n for _, n in held), max((s for s, _ in held), default=None)


class Spans:
    """The window's operations, each with the names of the spans it was
    launched in, and the idle gaps the steps' operations end, with the same."""

    def __init__(self, events, records):
        cuda = torch.autograd.DeviceType.CUDA
        ops, shadows, launch = [], [], {}
        for e in events:
            s = e.start_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation():
                    shadows.append((s, s + e.duration_ns(), e.name()))
                else:
                    ops.append((s, s + e.duration_ns(), e.correlation_id()))
            elif e.name().startswith("cu") and not e.is_user_annotation():
                c = e.correlation_id()      # cudaLaunchKernel, cudaMemcpyAsync, cu*...
                launch[c] = min(s, launch.get(c, s))
        host = [(r[2], r[3], r[0]) for r in records]
        self.steps = sum(n == STEP for _, _, n in host)
        self.ops = sorted(ops)
        self.launched = [launch.get(c) for _, _, c in self.ops]   # host ns, or None
        held = [_open_at(t, host) if t is not None else _open_at(s, shadows)
                for (s, _, _), t in zip(self.ops, self.launched)]
        self.spans = [h[0] for h in held]
        self.opened = [h[1] for h in held]      # when the innermost of them opened
        self.gaps = self._gaps()

    def _gaps(self):
        """(ns, span names) of the idle gaps that an operation launched inside
        a step ends, each from the end of the device work before it."""
        out, busy_end = [], None
        for (s, e, _), sp in zip(self.ops, self.spans):      # in device order
            if busy_end is not None and s > busy_end and STEP in sp:
                out.append((s - busy_end, sp))
            busy_end = e if busy_end is None else max(busy_end, e)
        return out

    def per_step(self, name=None):
        """launches, device_ms and idle_ms a step of the span `name` (every
        operation and every gap where name is None); None without steps."""
        n = self.steps
        if not n or not self.ops:
            return None
        mine = [i for i, sp in enumerate(self.spans) if name is None or name in sp]
        busy = _union([self.ops[i][:2] for i in mine])
        idle = sum(g for g, sp in self.gaps if name is None or name in sp)
        return {"launches": len(mine) / n,
                "device_ms": sum(e - s for s, e in busy) / n * 1e-6,
                "idle_ms": idle / n * 1e-6}

    def early(self, tol_ns):
        """Operations that start on the device more than tol_ns before the
        innermost span they were launched in opened on the host. Each starts
        before its own launch too: the profiler's device clock is off."""
        return sum(o is not None and s < o - tol_ns
                   for (s, _, _), o in zip(self.ops, self.opened))


def read(trace, name, what):
    """One number a step of span `name` from the window with the program's
    spans on; None where the run traced no such window or no device work."""
    p = trace.extra.get("program")
    if not p:
        return None
    if "spans" not in p:
        p["spans"] = Spans(p["events"], p["records"])
    r = p["spans"].per_step(name)
    return None if r is None else r[what]
