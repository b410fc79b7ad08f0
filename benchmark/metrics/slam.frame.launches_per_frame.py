"""Device operations (kernels, copies, sets) a frame that the host launched inside
SlamSystem's "track" stage and outside its keyframe event ("mapping.event"),
per tracked frame, in the traced window with the program's spans on."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "track", "launches", "frame", without="mapping.event")
