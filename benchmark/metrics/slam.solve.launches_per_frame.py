"""Device operations a frame launched inside the span "tracking.solve": the
pose solves of a frame (both `pose_only_vi` calls of a VI frame, the
visual LM when the fallback runs), in the traced window."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "tracking.solve", "launches", "frame")
