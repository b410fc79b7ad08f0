"""Device operations a keyframe event launched inside the span
"mapping.event" (the keyframe's insertion, the event and its loop-closing
attempt), per event of the traced window; None where it held no event."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "mapping.event", "launches", "event")
