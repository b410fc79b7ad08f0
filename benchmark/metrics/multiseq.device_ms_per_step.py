"""Milliseconds a batched step in which the card ran a kernel, copy or set
(the union of the profiler's device intervals over the traced steps, per
step): the device's share of the step, steady where the host's pace is not."""


def read(trace):
    steps = trace.extra.get("steps", 0)
    if not trace.device or not steps:
        return None
    return 1e3 * trace.busy_s() / steps
