"""Peaks of the card and the least time of the projection-search kernel.

Frozen copies of the port's arithmetic (`chip_smoke.kernel_bound`,
`tools/bench.speed_of_light`), kept here so that no later change to the
program moves the yardstick. The peaks are NVIDIA's for one H100 SXM at its
700 W limit; a card set below that limit has them scaled by
power.limit / 700 W.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
SIMPLE_OPS_PER_S = 67e12 / 2    # float32 / int32 issue rate outside the tensor cores
PEAK_POWER_W = 700.0
GATE_OPS_PER_PAIR = 8      # 2 subtracts, 2 |.| < r compares, level subtract, |.|, compare, and
POPC_OPS_PER_PASS = 24     # 8 xor + 8 popcount + 8 adds / top-2 update


def peaks(power_limit_w):
    """(bytes/s, simple ops/s) at the card's power limit."""
    scale = min(1.0, power_limit_w / PEAK_POWER_W)
    return HBM_BYTES_PER_S * scale, SIMPLE_OPS_PER_S * scale


def search_bound_s(a_uv, a_lvl, a_valid, b_uv, b_lvl, b_valid, radius, power_limit_w,
                   level_tol=1):
    """The least seconds the card could take for one windowed top-2 search
    of B problems ((B, M, .) queries against (B, N, .) candidates): the
    larger of its bytes over the memory rate (each input read once, each
    output written once) and of its operations over the issue rate (the gate
    for every valid pair, the popcount for every pair that passes it)."""
    B, M = a_valid.shape
    N = b_valid.shape[-1]
    n_pass = 0
    for b in range(B):      # one problem at a time: (M, N) masks stay small
        gate = (torch.abs(a_uv[b, :, None, 0] - b_uv[b, None, :, 0]) < radius) \
            & (torch.abs(a_uv[b, :, None, 1] - b_uv[b, None, :, 1]) < radius) \
            & (torch.abs(a_lvl[b, :, None] - b_lvl[b, None, :]) <= level_tol) \
            & a_valid[b, :, None] & b_valid[b, None, :]
        n_pass += int(gate.sum())
    pairs = int((a_valid.sum(-1).to(torch.int64) * b_valid.sum(-1).to(torch.int64)).sum())
    n_bytes = B * ((M + N) * (32 + 8 + 4 + 1) + 3 * 4 * M)
    ops = pairs * GATE_OPS_PER_PAIR + n_pass * POPC_OPS_PER_PASS
    bw, issue = peaks(power_limit_w)
    return max(n_bytes / bw, ops / issue)
