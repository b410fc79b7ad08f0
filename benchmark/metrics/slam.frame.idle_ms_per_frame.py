"""Milliseconds a frame the card sat idle until an operation launched inside
SlamSystem's "track" stage and outside its keyframe event ("mapping.event"),
in the traced window with the program's spans on."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "track", "idle_ms", "frame", without="mapping.event")
