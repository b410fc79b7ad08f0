"""Stereo depth from rectified left / right feature matching (port of
mc_slam_tpu/frontend/stereo.py; Frame::ComputeStereoMatches).

Left features match right features inside an epipolar row band and a
disparity range by Hamming distance, with the NN-ratio test and a left-right
mutual check; depth = fx * baseline / disparity. Plain PyTorch: a gated
nearest neighbour over an (N, M) distance matrix, as the JAX package's.
"""
from __future__ import annotations

import torch

from mc_slam_tpu_torch.frontend import matching


def argmin_lowest(d, dim):
    """Index of the minimum along `dim`, ties to the LOWEST index, stated
    explicitly (jnp.argmin's rule; torch promises no order among ties on
    CUDA)."""
    best = torch.amin(d, dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    ar = torch.arange(n, device=d.device).reshape(shape)
    return torch.amin(torch.where(d == best, ar, n), dim=dim)


def stereo_depth(uvL, pm1L, validL, uvR, pm1R, validR, fx, baseline, row_tol=2.0,
                 max_disp=128.0, min_disp=0.5, max_dist=matching.TH_HIGH):
    """Per-left-feature depth from rectified stereo matching.

    uvL / uvR: (N, 2) / (M, 2) undistorted pixels; pm1L / pm1R: +/-1
    descriptor rows; fx, baseline: floats or 0-d tensors. Returns
    (depth (N,), ok (N,) bool) with depth = fx * b / disparity where
    matched, -1 elsewhere."""
    dist = matching.hamming_matrix(pm1L, pm1R)
    dv = torch.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]          # positive for a valid pair
    gate = (dv <= row_tol) & (disp >= min_disp) & (disp <= max_disp)
    gate = gate & validL[:, None] & validR[None, :]
    idx, _, ok = matching.match_nn(dist, gate, max_dist=max_dist, ratio=0.9)
    # mutual (left-right) consistency kills wrong-row matches, whose bogus
    # disparities would seed gross-outlier landmarks
    idx_rl = argmin_lowest(torch.where(gate, dist, matching.BIG), dim=0)
    mutual = idx_rl[idx] == torch.arange(uvL.shape[0], device=idx.device)
    ok = ok & mutual
    d = uvL[:, 0] - uvR[idx, 0]
    depth = fx * baseline / torch.clamp(d, min=1e-6)
    return torch.where(ok, depth, -1.0), ok
