"""Absolute trajectory error (ATE) with Horn alignment — the scoring oracle.

Reimplements evaluate/evaluate_ate.py + associate.py of the reference (Horn
closed-form similarity/rigid alignment of matched timestamp pairs, max
association difference 0.02 s, RMSE/mean/median stats) as plain numpy so it can
score both our trajectories and reference-format text files.
"""
from __future__ import annotations

import numpy as np


def associate(t_a, t_b, max_diff=0.02):
    """Greedy timestamp association (reference associate.py). Returns index pairs."""
    pairs = []
    used_b = set()
    j = 0
    order = np.argsort(t_b)
    tb_sorted = np.asarray(t_b)[order]
    for i, ta in enumerate(t_a):
        k = np.searchsorted(tb_sorted, ta)
        best, bestd = -1, max_diff
        for kk in (k - 1, k, k + 1):
            if 0 <= kk < len(tb_sorted):
                d = abs(tb_sorted[kk] - ta)
                if d <= bestd and order[kk] not in used_b:
                    best, bestd = order[kk], d
        if best >= 0:
            pairs.append((i, best))
            used_b.add(best)
    return pairs


def horn_align(P_est, P_gt, with_scale=True):
    """Closed-form (s, R, t) minimizing ||P_gt - (s R P_est + t)||^2.
    P_est, P_gt: (N, 3). Mirrors evaluate_ate.py:48-86 (which uses rigid; mono
    needs with_scale=True as align_mono.py does)."""
    mu_e = P_est.mean(0)
    mu_g = P_gt.mean(0)
    E = P_est - mu_e
    G = P_gt - mu_g
    W = E.T @ G
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    if with_scale:
        s = np.trace(np.diag(d) @ S) / np.maximum((E * E).sum(), 1e-12)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(t_est, P_est, t_gt, P_gt, max_diff=0.02, with_scale=True):
    """Associate by timestamp, align, return dict of error stats (meters)."""
    pairs = associate(t_est, t_gt, max_diff)
    if len(pairs) < 3:
        return {"rmse": np.inf, "n": len(pairs)}
    ie = np.asarray([p[0] for p in pairs])
    ig = np.asarray([p[1] for p in pairs])
    Pe = np.asarray(P_est)[ie]
    Pg = np.asarray(P_gt)[ig]
    s, R, t = horn_align(Pe, Pg, with_scale)
    Pa = (s * (R @ Pe.T)).T + t
    err = np.linalg.norm(Pa - Pg, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n": len(pairs),
        "scale": float(s),
    }
