"""Milliseconds an event in which the card ran an operation launched inside
the span "mapping.vi_ba" (the window VI BA of a keyframe event), per event
of the traced window; None where it held no event."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "mapping.vi_ba", "device_ms", "event")
