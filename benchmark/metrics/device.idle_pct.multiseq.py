"""Share of the traced window of batched steps in which no kernel, copy or
set ran on the card (the union of the profiler's device intervals)."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
