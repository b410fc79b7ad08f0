"""Stage timing and VI-init observability (port of
mc_slam_tpu/utils/metrics.py).

  * StageTimer: named stages as context managers, with summaries (median /
    mean / max). On a CUDA device a stage is a pair of CUDA events recorded
    on the current stream and read at `summary()`: nothing inside the frame
    loop waits for the device. The host's clock is kept beside it. Stages
    nest (an event inside "local_mapping" inside "track"): each is reported by
    itself and they are not to be summed. Every stage also leaves a record
    (`records`: name, parent, host start and end) stamped in the clock of
    torch.profiler's events, and, while a profiler runs, a
    `record_function` range of its name, so a trace can tie device work and
    device gaps to the stages.
  * tracing / span: library code opens `span(name)`, a stage of the timer
    made active by `with tracing(timer):`; with no active timer it is one
    shared no-op context (no event, no range, no record). While a timer is
    active, every stage of another timer (SlamSystem's `timers`, say) is
    also a stage of the active one, so the library's spans nest under the
    caller's stages there; with none active a timer's stages are its own.
  * VIInitLog: the reference's diagnostic file set (scale.txt, biasg.txt,
    biasa.txt, gw.txt, condnum.txt, computetime.txt, Rwi.txt) written from
    VIInitResult records, format-compatible with plotinit.py.
Device-level kernel breakdowns come from tools/profile_event.py
(torch.profiler).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ACTIVE = contextvars.ContextVar("mc_slam_tpu_torch_active_timer", default=None)


class StageRecord(NamedTuple):
    name: str
    parent: str | None   # the innermost stage open when this one started
    start_ns: int        # host clock of torch.profiler's events (time.time_ns)
    end_ns: int


class StageTimer:
    def __init__(self, device=None):
        """device: a CUDA device makes every stage a pair of CUDA events as
        well; None or the CPU keeps the host clock only."""
        self.samples = defaultdict(list)        # name -> host seconds
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._events = defaultdict(list)        # name -> (start, end) CUDA events
        self.device_samples = defaultdict(list)  # name -> device seconds, read so far
        self.records = []                       # StageRecord, in the order stages close
        self._open = []                         # names of the stages open now

    @contextlib.contextmanager
    def stage(self, name):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        tracer = _ACTIVE.get()
        if tracer is not None and tracer is not self:
            ctx = tracer.stage(name)        # the active timer's stage opens the range
        else:
            ctx = record_function(name) if _profiler_enabled() else _OFF
        with ctx:
            if self.cuda:
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
            t0 = time.perf_counter()
            w0 = time.time_ns()
            try:
                yield
            finally:
                w1 = time.time_ns()
                self.samples[name].append(time.perf_counter() - t0)
                if self.cuda:
                    e.record()
                    self._events[name].append((s, e))
                self._open.pop()
                self.records.append(StageRecord(name, parent, w0, w1))

    def marks(self, prefix):
        """A callable(stage_name) for code that announces its stages one
        after the other (mapping_ctl.keyframe_event, viinit_ctl.maybe_vi_init):
        every call closes the stage opened by the call before and opens
        `prefix + stage_name`; "end" only closes."""
        stack = contextlib.ExitStack()

        def mark(name):
            stack.close()
            if name != "end":
                stack.enter_context(self.stage(prefix + name))
        return mark

    def _read_events(self):
        """Move the recorded event pairs into device_samples (waits for the
        last of them; called outside the frame loop)."""
        for name, pairs in self._events.items():
            for s, e in pairs:
                e.synchronize()
                self.device_samples[name].append(s.elapsed_time(e) * 1e-3)
        self._events.clear()

    def summary(self):
        """name -> n, median / mean / max in ms and the total in s of the host
        clock; on a CUDA device also device_median_ms / device_total_s, the
        time between the stage's two events on the stream."""
        self._read_events()
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {"n": len(a), "median_ms": float(np.median(a) * 1e3),
                         "mean_ms": float(a.mean() * 1e3),
                         "max_ms": float(a.max() * 1e3),
                         "total_s": float(a.sum())}
            if self.cuda and self.device_samples[name]:
                d = np.asarray(self.device_samples[name])
                out[name]["device_median_ms"] = float(np.median(d) * 1e3)
                out[name]["device_total_s"] = float(d.sum())
        return out

    def report(self):
        lines = []
        for name, s in sorted(self.summary().items()):
            line = (f"{name:<28} n={s['n']:<5} median={s['median_ms']:8.2f}ms "
                    f"mean={s['mean_ms']:8.2f}ms max={s['max_ms']:8.2f}ms")
            if "device_median_ms" in s:
                line += f" device median={s['device_median_ms']:8.2f}ms"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def tracing(timer):
    """Make `timer` the active one while the block runs (in this thread or
    task): every `span` opened inside is a stage of it."""
    token = _ACTIVE.set(timer)
    try:
        yield timer
    finally:
        _ACTIVE.reset(token)


def stage(timer, name):
    """timer.stage(name), or the shared no-op context where timer is None."""
    return _OFF if timer is None else timer.stage(name)


def span(name):
    """A stage of the active timer (`tracing`); the shared no-op context
    where none is active."""
    return stage(_ACTIVE.get(), name)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VIInitLog:
    """Streams VI-init attempts to the reference's diagnostic file set."""

    def __init__(self, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self._files = {}

    def _f(self, name):
        if name not in self._files:
            self._files[name] = open(os.path.join(self.dir, name), "a")
        return self._files[name]

    def log_attempt(self, t, result, compute_time_ms):
        """result: pipeline.viinit.VIInitResult (tensors or numpy)."""
        gw = _np(result.gw)
        self._f("scale.txt").write(f"{t} {float(result.scale)} {float(result.scale_star)} \n")
        self._f("biasg.txt").write(f"{t} " + " ".join(str(x) for x in _np(result.bg)) + " \n")
        self._f("biasa.txt").write(f"{t} " + " ".join(str(x) for x in _np(result.ba)) + " \n")
        self._f("gw.txt").write(f"{t} {gw[0]} {gw[1]} {gw[2]} {gw[0]} {gw[1]} {gw[2]} \n")
        self._f("condnum.txt").write(f"{t} " + " ".join(str(x) for x in _np(result.cond)) + " \n")
        self._f("computetime.txt").write(f"{t} {compute_time_ms} \n")
        with open(os.path.join(self.dir, "Rwi.txt"), "w") as f:
            f.write(" ".join(str(x) for x in _np(result.Rwi).reshape(-1)) + "\n")
        for fh in self._files.values():
            fh.flush()

    def close(self):
        for fh in self._files.values():
            fh.close()
        self._files = {}
