"""A cell of the manifest cut to a size the CPU runs in seconds: the same
files, with the camera, the features, the maps, the world and the traffic
shrunk (a scaled EuRoC camera at 160x120, `streams` sequences of 12 s)."""
from __future__ import annotations

import copy

from benchmark.harness import manifest as mf


def tiny_spec(cell="multiseq.b11", streams=2):
    spec = copy.deepcopy(mf.resolve_cell(mf.load_manifest(), cell))
    cfg = spec["config"]
    c = cfg["camera"]
    sx, sy = 160 / c["width"], 120 / c["height"]
    c.update(fx=c["fx"] * sx, fy=c["fy"] * sy, cx=c["cx"] * sx, cy=c["cy"] * sy,
             width=160, height=120)
    cfg["orb"].update(n_features=128, n_levels=3)
    cfg["map"].update(kf_every=12, max_mp=512)
    cfg["world"].update(tex_size=256)
    spec["traffic"].update(streams=[{"name": f"s{i}", "seconds": 12.0} for i in range(streams)],
                           rendered_frames=3)
    spec["cell"].update(warmup_steps=1, trace_steps=2, sample_per_stream=1)
    return spec
