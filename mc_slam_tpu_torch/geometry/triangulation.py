"""Batched linear triangulation (port of mc_slam_tpu/geometry/triangulation.py:
Initializer::Triangulate and LocalMapping::CreateNewMapPoints' DLT).

All functions take normalized (ideal, undistorted, K-removed) image
coordinates and world-from-camera poses, batched over leading dims.
"""
from __future__ import annotations

import torch


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def triangulate_two_view(Rwc0, Pwc0, Rwc1, Pwc1, xn0, xn1):
    """DLT triangulation of point pairs seen in two cameras.

    Rwc*, Pwc*: world-from-camera rotations / centres; xn*: (..., 2)
    normalized coords. Returns (Xw (..., 3), depth0, depth1). The null vector
    comes from an SVD of the (..., 4, 4) system, as in the JAX package; its
    sign is arbitrary and cancels in the homogeneous division."""
    Rcw0 = Rwc0.transpose(-1, -2)
    Rcw1 = Rwc1.transpose(-1, -2)
    t0 = -_mv(Rcw0, Pwc0)
    t1 = -_mv(Rcw1, Pwc1)
    P0 = torch.cat([Rcw0, t0[..., None]], dim=-1)          # (..., 3, 4)
    P1 = torch.cat([Rcw1, t1[..., None]], dim=-1)

    def rows(P, xn):
        r0 = xn[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = xn[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(P0, xn0)
    a2, a3 = rows(P1, xn1)
    A = torch.stack([a0, a1, a2, a3], dim=-2)               # (..., 4, 4)
    _, _, Vh = torch.linalg.svd(A)
    Xh = Vh[..., 3, :]
    w = Xh[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12 * torch.ones_like(w), w)
    Xw = Xh[..., :3] / w_safe[..., None]
    d0 = _mv(Rcw0, Xw)[..., 2] + t0[..., 2]
    d1 = _mv(Rcw1, Xw)[..., 2] + t1[..., 2]
    return Xw, d0, d1


def parallax_cos(Pwc0, Pwc1, Xw):
    """Cosine of the ray angle at the triangulated point (CheckRT's parallax)."""
    r0 = Xw - Pwc0
    r1 = Xw - Pwc1
    n0 = torch.linalg.norm(r0, dim=-1)
    n1 = torch.linalg.norm(r1, dim=-1)
    return torch.sum(r0 * r1, dim=-1) / torch.clamp(n0 * n1, min=1e-12)
