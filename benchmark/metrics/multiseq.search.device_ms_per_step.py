"""Milliseconds a batched step in which the card ran the operations launched
inside the program's span `tracking.search`: the projection searches
(projection, level prediction, the search kernel, inversion; both rounds);
in the traced window with the program's spans on (`_spans`)."""
from benchmark.metrics import _spans


def read(trace):
    return _spans.read(trace, "tracking.search", "device_ms")
