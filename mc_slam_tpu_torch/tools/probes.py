"""Probes of the CUDA kernel `hamming_top2_windowed` for the measurement
tools and `chip_smoke.py`: its warm and cold times on the card, and a
recorder of the wrapper's calls on a real path.

* `time_cuda(fn)`: the median milliseconds of one `fn()` with the host's
  enqueue time hidden behind a device-side sleep.
* `time_cuda_cold(fn, flush)`: the same with the L2 evicted before each call.
* `SearchRecorder` and `recording(rec)`: the recorder stands in for
  `match_cuda.hamming_top2_windowed` inside the `with` block, calls the real
  wrapper (whose counter still counts each launch) and keeps copies of the
  inputs of the calls made while its `frame` is one of `keep_frames`.
"""
from __future__ import annotations

import contextlib
import statistics

import torch

from mc_slam_tpu_torch.frontend import match_cuda


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


class SearchRecorder:
    """Stands in for match_cuda.hamming_top2_windowed during a run: calls
    the real wrapper, brackets every call with CUDA events (kernel time
    inside the run) and keeps copies of the inputs of the calls made while
    `frame` is one of `keep_frames`, for the kernel-vs-twin check on real
    data."""

    def __init__(self, keep_frames, timed: bool):
        """keep_frames: an int (the first so many frames) or a collection of
        frame keys."""
        self.keep_frames = (set(range(keep_frames)) if isinstance(keep_frames, int)
                            else set(keep_frames))
        self.timed = timed
        self.frame = 0
        self.calls = []          # (frame, args, kwargs)
        self.events = []         # (frame, start, end)

    def __call__(self, *args, **kwargs):
        if self.frame in self.keep_frames:
            self.calls.append((self.frame, [a.clone() if isinstance(a, torch.Tensor)
                                            else a for a in args], dict(kwargs)))
        if self.timed:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = match_cuda._WRAPPER(*args, **kwargs)
            e.record()
            self.events.append((self.frame, s, e))
            return out
        return match_cuda._WRAPPER(*args, **kwargs)


@contextlib.contextmanager
def recording(rec):
    """`rec` in front of the wrapper for the block's duration."""
    prev = match_cuda.hamming_top2_windowed
    match_cuda.hamming_top2_windowed = rec
    try:
        yield rec
    finally:
        match_cuda.hamming_top2_windowed = prev
