"""Device operations (kernels, copies, sets) a batched step launched inside the
program's span `frontend.extract`: the batched extraction (pyramid, FAST,
patches, BRIEF); in the traced window with the program's spans on
(`_spans`)."""
from benchmark.metrics import _spans


def read(trace):
    return _spans.read(trace, "frontend.extract", "launches")
