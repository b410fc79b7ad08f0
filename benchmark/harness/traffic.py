"""The one traffic generator: reads a mix's data file
(`benchmark/traffic/<name>.json`) and draws its arrivals from the run's
generator. Every seed gets the same sizes and counts; only the places in the
world differ."""
from __future__ import annotations

import torch


def sequence_starts(traffic, fps, gen):
    """Each stream's sequence length in frames, from the `seconds` of the
    mix's `streams` at the camera's `fps`, and the frame it starts at, drawn
    from `gen`."""
    lengths = [round(s["seconds"] * fps) for s in traffic["streams"]]
    u = torch.rand(len(lengths), generator=gen, device=gen.device, dtype=torch.float64)
    return lengths, [int(x * n) % n for x, n in zip(u.tolist(), lengths)]
