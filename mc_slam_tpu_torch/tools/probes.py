"""The card and the hand-written CUDA kernels, for the measurement tools and
`chip_smoke.py`: one copy of the card's published peaks and its
`nvidia-smi` line, a launch's bound, its warm and cold times on the card,
and a recorder of the calls a real path makes.

* `card_line()`, `power_limit_w(line)`: the first card's name and power
  limit, and the watts of that line.
* `bound_ms(bytes, ops, detail, rate=)`: the least milliseconds of a launch
  that moves `bytes` and issues `ops` at `rate` (a kernel's `work(...)`
  gives the three; SIMPLE_OPS_PER_S or FLOAT_OPS_PER_S).
* `time_cuda(fn)`: the median milliseconds of one `fn()` with the host's
  enqueue time hidden behind a device-side sleep.
* `time_cuda_cold(fn, flush)`: the same with the L2 evicted before each call.
* `Recorder(owner, name, ...)`: stands in for `owner.name` inside a `with`
  block and keeps the calls made through it; `search_recorder` is the one
  in front of `match_cuda.hamming_top2_windowed`.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

from mc_slam_tpu_torch.frontend import match_cuda

# Published peaks of one H100 SXM at its 700 W limit: 3.35 TB/s of HBM; 67
# TFLOP/s of float32 outside the tensor cores counts a fused multiply-add as
# two, so compares, subtracts, XORs and popcounts issue at half of it at most.
HBM_BYTES_PER_S = 3.35e12
FLOAT_OPS_PER_S = 67e12
SIMPLE_OPS_PER_S = FLOAT_OPS_PER_S / 2
PEAK_POWER_W = 700.0


def card_line():
    """nvidia-smi's "name, power.limit" of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def power_limit_w(line):
    """The watts of a card_line(), e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    return float(line.rsplit(",", 1)[1].strip().split()[0])


def bound_ms(n_bytes, ops, detail=(), *, rate):
    """The least milliseconds the card could take for a launch: the larger of
    n_bytes over the memory rate and `ops` over `rate`, at the published
    peaks. Returns (bound_ms, bound_by, detail), the detail `detail`'s items
    with the bytes, the operations and the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            dict(detail, bytes=n_bytes, operations=ops, bytes_ms=t_bytes, operations_ms=t_ops))


def time_cuda(fn, n=50, warmup=3, rounds=5):
    """Median over `rounds` of the milliseconds of one `fn()`: n calls are
    queued behind a device-side sleep, so the host's enqueue time is hidden
    and the card runs them back to back; CUDA events around the batch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def time_cuda_cold(fn, flush, n=20):
    """Median milliseconds of one `fn()` that finds the L2 cold: a pass over
    the 256 MB `flush` buffer evicts the 50 MB cache before each call."""
    fn()
    times = []
    for _ in range(n):
        flush.add_(1)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


class Recorder:
    """Stands in for `owner.<name>` inside a `with` block: a kernel's wrapper
    or dispatcher (match_cuda.hamming_top2_windowed, ba.pose_only_visual,
    ba_vi.pose_only_vi) or any function the program calls through its
    module. Every call goes on to what stood there; `n` counts the calls, and
    `calls` keeps (frame, args, kwargs) of the first `keep` calls (None: all)
    made while `frame` is one of `keep_frames` (an int: the first so many
    frames; None: any), with their tensors cloned (`clone`: inputs a run
    changes or frees later) or by reference. With `timed`, every call is
    bracketed by CUDA events, kept as (frame, start, end) in `events`. The
    run sets `frame` as it goes."""

    def __init__(self, owner, name, keep=None, keep_frames=None, clone=False, timed=False):
        self.owner, self.name = owner, name
        self.keep = keep
        self.keep_frames = (set(range(keep_frames)) if isinstance(keep_frames, int)
                            else None if keep_frames is None else set(keep_frames))
        self.clone, self.timed = clone, timed
        self.frame, self.n = 0, 0
        self.calls = []
        self.events = []
        self._prev = None

    def __enter__(self):
        self._prev = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._prev)

    def __call__(self, *args, **kwargs):
        self.n += 1
        if ((self.keep_frames is None or self.frame in self.keep_frames)
                and (self.keep is None or len(self.calls) < self.keep)):
            kept = [a.clone() if self.clone and isinstance(a, torch.Tensor) else a
                    for a in args]
            self.calls.append((self.frame, kept, dict(kwargs)))
        if not self.timed:
            return self._prev(*args, **kwargs)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = self._prev(*args, **kwargs)
        e.record()
        self.events.append((self.frame, s, e))
        return out


def search_recorder(keep_frames, timed=False):
    """A Recorder in front of the search kernel's wrapper that clones the
    inputs of the calls made while its `frame` is one of `keep_frames`."""
    return Recorder(match_cuda, "hamming_top2_windowed", keep_frames=keep_frames, clone=True,
                    timed=timed)
