"""Milliseconds a batched step the card sat idle until an operation launched
inside the program's span `tracking.solve`: the pose LM solves (both
rounds); in the traced window with the program's spans on (`_spans`)."""
from benchmark.metrics import _spans


def read(trace):
    return _spans.read(trace, "tracking.solve", "idle_ms")
