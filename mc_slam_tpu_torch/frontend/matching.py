"""Hamming-distance data association (port of mc_slam_tpu/frontend/matching.py).

ORBmatcher's thresholds (TH_HIGH=100, TH_LOW=50), 30-bin rotation histogram,
NN-ratio test and windowed projection search as dense masked tensors. The
projection search runs the hand-written CUDA kernel for CUDA tensors, always
(there is no shape eligibility rule), and its plain twin for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from mc_slam_tpu_torch.frontend import match_cuda

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
BIG = match_cuda.BIG


def hamming_matrix(pm1_a, pm1_b):
    """(Na, 256) x (Nb, 256) +/-1 int8 -> (Na, Nb) int32 Hamming distances,
    hamming = (256 - a.b) / 2. The dot runs in float32 (TF32 off): every
    partial sum is an integer of magnitude <= 256, so it is exact. Either
    side may carry leading batch dims."""
    dot = pm1_a.to(torch.float32) @ pm1_b.to(torch.float32).transpose(-1, -2)
    return torch.div(256 - dot.to(torch.int32), 2, rounding_mode="floor")


def rotation_consistency_mask(angle_a, angle_b, match_b_for_a, matched_mask,
                              keep_bins=3, coverage=0.9,
                              min_concentration=0.5, participate=None):
    """30-bin relative-rotation histogram filter (ORBmatcher::ComputeThreeMaxima)
    with the JAX package's coverage widening, 0.1*max cutoff, concentration
    guard and optional per-row `participate` mask. angle_b, the matches and
    the mask may carry leading batch dims (one histogram per problem)."""
    db = angle_a - torch.gather(angle_b, -1, match_b_for_a)
    two_pi = 2.0 * math.pi
    db = torch.remainder(db, two_pi)
    bins = torch.clamp((db * (HISTO_BINS / two_pi)).to(torch.int64), 0, HISTO_BINS - 1)
    in_hist = matched_mask if participate is None else (matched_mask & participate)
    hist = torch.zeros(bins.shape[:-1] + (HISTO_BINS,), dtype=torch.int32,
                       device=db.device).scatter_add(-1, bins, in_hist.to(torch.int32))
    n_total = torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=1)
    order = torch.argsort(-hist, dim=-1, stable=True)   # bins by population, desc
    hsort = torch.gather(hist, -1, order)
    csum = torch.cumsum(hsort, -1)
    rank_kept = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                          dim=-1) < coverage * n_total
    rank_kept = rank_kept | (torch.arange(HISTO_BINS, device=db.device) < keep_bins)
    rank_kept = rank_kept & (hsort.to(torch.float32)
                             >= 0.1 * hsort[..., :1].to(torch.float32))
    keep_bin = torch.zeros_like(rank_kept).scatter(-1, order, rank_kept & (hsort > 0))
    concentrated = (csum[..., keep_bins - 1:keep_bins].to(torch.float32)
                    >= min_concentration * n_total.to(torch.float32))
    passed = torch.gather(keep_bin, -1, bins) | ~concentrated
    if participate is not None:
        passed = passed | ~participate
    return matched_mask & passed


def match_nn(dist, mask, max_dist=TH_LOW, ratio=None, ratio_mask=None):
    """Nearest-neighbour match from a masked distance matrix (..., Na, Nb).
    Returns (idx_b (..., Na) int64, best_dist (..., Na), ok (..., Na) bool)."""
    d = torch.where(mask, dist, BIG)
    best, idx = torch.min(d, dim=-1)         # first minimum, as jnp.argmin
    ok = best <= max_dist
    if ratio is not None:
        dr = torch.where(ratio_mask, dist, BIG) if ratio_mask is not None else d
        d2 = dr.scatter(-1, idx[..., None], BIG)   # the best column out of the running
        second = torch.amin(d2, dim=-1)
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return idx, best, ok


def resolve_duplicates(idx_b, best, ok, Nb):
    """Keep only the best match per target b; exact ties keep the lowest row."""
    idx_b = idx_b.to(torch.int64)
    d = torch.where(ok, best, BIG).to(torch.int32)
    best_for_b = torch.full((Nb,), BIG, dtype=torch.int32, device=d.device)
    best_for_b = best_for_b.scatter_reduce(0, idx_b, d, reduce="amin")
    is_min = ok & (d == best_for_b[idx_b])
    rows = torch.arange(idx_b.shape[0], dtype=torch.int32, device=d.device)
    far = torch.full((Nb,), 2 ** 30, dtype=torch.int32, device=d.device)
    first_row = far.scatter_reduce(
        0, idx_b, torch.where(is_min, rows, 2 ** 30).to(torch.int32), reduce="amin")
    return is_min & (first_row[idx_b] == rows)


def window_mask(uv_a, uv_b, radius, level_a=None, level_b=None, level_tol=1):
    """(Na, Nb) gate: |uv_a - uv_b| inside a square window of `radius` pixels,
    optionally with |level_a - level_b| <= level_tol."""
    du = torch.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dv = torch.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    m = (du < radius) & (dv < radius)
    if level_a is not None:
        dl = torch.abs(level_a[:, None] - level_b[None, :])
        m = m & (dl <= level_tol)
    return m


def search_by_projection(proj_uv, proj_valid, proj_level, proj_desc, proj_pm1,
                         feat_uv, feat_level, feat_desc, feat_pm1, feat_valid,
                         radius_px, max_dist=TH_HIGH, ratio=0.9,
                         proj_angle=None, feat_angle=None,
                         proj_angle_valid=None):
    """Project-and-match: map points (projected to proj_uv) vs frame features
    (ORBmatcher::SearchByProjection, map-points variant): windowed top-2
    Hamming search, ratio test, per-feature dedup, optional rotation prune.

    Descriptors come twice: packed int32 words (proj_desc / feat_desc, what
    the CUDA kernel reads) and +/-1 int8 rows (what the CPU twin reads); the
    map and extractor always write both together.

    Returns (feat_idx (Nm,) int64, dist (Nm,) int32, ok (Nm,) bool)."""
    best, second, idx = match_cuda.hamming_top2_windowed(
        proj_desc, proj_pm1, proj_uv, proj_level.to(torch.int32), proj_valid,
        feat_desc, feat_pm1, feat_uv, feat_level, feat_valid, radius_px)
    idx = idx.to(torch.int64)
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    ok = resolve_duplicates(idx, best, ok, feat_uv.shape[0])
    if proj_angle is not None and feat_angle is not None:
        ok = rotation_consistency_mask(proj_angle, feat_angle, idx, ok,
                                       participate=proj_angle_valid)
    return idx, best, ok


def search_for_initialization(f0_uv, f0_pm1, f0_valid, f1_uv, f1_pm1, f1_valid,
                              radius=100.0, max_dist=TH_LOW, ratio=0.9,
                              f0_angle=None, f1_angle=None):
    """Frame-frame matching for the monocular two-view bootstrap
    (ORBmatcher::SearchForInitialization): window around the same position,
    low threshold, ratio test, dedup, rotation-consistency prune when both
    angle tables are given. Returns (idx (N0,) int64, best, ok)."""
    dist = hamming_matrix(f0_pm1, f1_pm1)
    gate = window_mask(f0_uv, f1_uv, radius)
    gate = gate & f0_valid[:, None] & f1_valid[None, :]
    idx, best, ok = match_nn(dist, gate, max_dist=max_dist, ratio=ratio)
    ok = resolve_duplicates(idx, best, ok, f1_uv.shape[0])
    if f0_angle is not None and f1_angle is not None:
        ok = rotation_consistency_mask(f0_angle, f1_angle, idx, ok)
    return idx, best, ok


def mutual_match(pm1_a, valid_a, pm1_b, valid_b, max_dist=TH_LOW, ratio=0.75,
                 angle_a=None, angle_b=None):
    """Unwindowed mutual nearest-neighbour matching (where the reference uses
    SearchByBoW), with the optional rotation-histogram prune. The b side
    (pm1_b, valid_b, angle_b) may carry one leading batch dim C: the a side
    is then matched against C tables at once and every result is (C, Na)."""
    Na = pm1_a.shape[-2]
    dist = hamming_matrix(pm1_a, pm1_b)
    gate = valid_a[..., :, None] & valid_b[..., None, :]
    idx_ab, best_ab, ok_ab = match_nn(dist, gate, max_dist=max_dist, ratio=ratio)
    _, idx_ba = torch.min(torch.where(gate, dist, BIG), dim=-2)
    mutual = torch.gather(idx_ba, -1, idx_ab) == torch.arange(Na, device=idx_ab.device)
    ok = ok_ab & mutual
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency_mask(angle_a, angle_b, idx_ab, ok)
    return idx_ab, best_ab, ok
