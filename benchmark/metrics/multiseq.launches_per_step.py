"""Device operations (kernels, copies and sets) the card ran per batched
step in the traced steps, from the profiler."""


def read(trace):
    steps = trace.extra.get("steps", 0)
    if not trace.device or not steps:
        return None
    return len(trace.device) / steps
