"""Milliseconds a frame in which the card ran an operation launched inside the
span "tracking.solve" (the union of their device intervals), in the traced
window."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "tracking.solve", "device_ms", "frame")
