"""The program's spans in the traced window of a `SlamSystem` cell: device
operations, device time and the device's idle time put down to the span
the host was in, per frame or per keyframe event.

The window (`trace.extra["program"]`: the profiler's `events`, traced with
the device alone, and the `records` of the program's `StageTimer`, each
(name, parent, start_ns, end_ns) on the clock of the profiler's host
events) is read as `_spans.py` reads the batched step's:

- device operations are the device events that are not user annotations;
- each belongs to every span that was open on the host when the CUDA API
  call with its correlation id started (an operation whose call the window
  lacks belongs to none);
- each idle gap that an operation launched inside a frame's `track` span
  ends, from the end of the device work before it, is put down to that
  operation's spans; gaps are read on the device's clock alone.

A frame is one `track` record (SlamSystem's stage of a tracked frame), an
event one `mapping.event` record. The window holds ~60k operations a VI
frame, so the spans' membership is computed with numpy over sorted
intervals (a span never nests in itself).
"""
from __future__ import annotations

import numpy as np
import torch

FRAME = "track"
EVENT = "mapping.event"


def _inside(t, ivs):
    """Whether each time t (N,) lies in one of the disjoint intervals ivs."""
    if not ivs:
        return np.zeros(t.shape, dtype=bool)
    iv = np.asarray(sorted(ivs), dtype=np.float64)
    i = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (i >= 0) & (t < iv[np.clip(i, 0, None), 1])


def _union_ns(start, end):
    """Length (ns) of the union of intervals [start, end)."""
    if not len(start):
        return 0.0
    o = np.argsort(start, kind="stable")
    s, e = start[o], end[o]
    reach = np.maximum.accumulate(e)
    gap = np.maximum(s[1:] - reach[:-1], 0)
    return float(reach[-1] - s[0] - gap.sum())


class SlamSpans:
    """The window's operations with their launch times, the spans' records,
    and the idle gap each operation ends."""

    def __init__(self, events, records):
        cuda = torch.autograd.DeviceType.CUDA
        ops, launch = [], {}
        for e in events:
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.correlation_id()))
            elif e.name().startswith("cu") and not e.is_user_annotation():
                c = e.correlation_id()
                launch[c] = min(e.start_ns(), launch.get(c, e.start_ns()))
        ops.sort()
        self.start = np.asarray([o[0] for o in ops], dtype=np.float64)
        self.end = np.asarray([o[1] for o in ops], dtype=np.float64)
        self.launched = np.asarray([launch.get(o[2], np.nan) for o in ops], dtype=np.float64)
        self.records = {}
        for r in records:
            self.records.setdefault(r[0], []).append((r[2], r[3]))
        self.frames = len(self.records.get(FRAME, []))
        self.events = len(self.records.get(EVENT, []))
        # the idle gap before each operation, in device order
        reach = np.maximum.accumulate(self.end) if len(self.end) else self.end
        self.gap = np.zeros(len(self.start))
        if len(self.start) > 1:
            self.gap[1:] = np.maximum(self.start[1:] - reach[:-1], 0)

    def mask(self, name, without=None):
        """Operations launched inside span `name` (and outside `without`)."""
        m = _inside(self.launched, self.records.get(name, []))
        if without is not None:
            m &= ~_inside(self.launched, self.records.get(without, []))
        return m

    def read(self, name, what, per, without=None):
        """launches, device_ms or idle_ms of span `name` (less `without`)
        per frame (`per` = "frame") or per event; None where the window has
        no device work or none of them."""
        n = self.frames if per == "frame" else self.events
        if not n or not len(self.start):
            return None
        m = self.mask(name, without)
        if what == "launches":
            return float(m.sum()) / n
        if what == "device_ms":
            return _union_ns(self.start[m], self.end[m]) / n * 1e-6
        framed = self.mask(FRAME)
        return float(self.gap[m & framed].sum()) / n * 1e-6


def read(trace, name, what, per, without=None):
    """One number of span `name` from the traced window with the program's
    spans on; None where the run traced no such window."""
    p = trace.extra.get("program")
    if not p:
        return None
    if "slam_spans" not in p:
        p["slam_spans"] = SlamSpans(p["events"], p["records"])
    return p["slam_spans"].read(name, what, per, without)
