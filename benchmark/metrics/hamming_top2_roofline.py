"""Share of its roofline that the projection-search kernel reached in the
traced steps: the least time of the step's recorded searches
(`_roofline.search_bound_s`) over the kernel's device time by name."""
from __future__ import annotations

from benchmark.metrics import _roofline

KERNEL = "hamming_top2_windowed_kernel"


def read(trace):
    searches = trace.extra.get("searches")
    t = trace.kernel_seconds(KERNEL)
    if not searches or t <= 0:
        return None
    bound = sum(_roofline.search_bound_s(*s, trace.extra["power_limit_w"]) for s in searches)
    share = 100.0 * bound / t
    if share > 100.0:
        raise SystemExit(f"{KERNEL}: roofline share {share:.3f} % over 100 %: "
                         "the count or the time is wrong")
    return share
