"""Pixel-space Sim3 refinement between two keyframes (port of
mc_slam_tpu/solver/sim3opt.py, the role of Optimizer::OptimizeSim3).

Given matched map points expressed in each keyframe's camera frame and their
observed pixels, the relative Sim3 S12 is optimized with forward (P2 -> cam1)
and inverse (P1 -> cam2) reprojection edges, truncated-Huber weights, a chi2
gate at 9.21 and the left-multiplicative retraction. A singular damped
system gives a NaN step (`solve_ex`), which the LM rejects: no exception, no
host read.
"""
from __future__ import annotations

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.solver import factors, lm

CHI2_SIM3 = 9.21


def optimize_sim3(s0, R0, t0, Pc1, Pc2, uv1, uv2, w, cam: Camera, iters: int = 15,
                  huber_delta2: float = CHI2_SIM3, fix_scale: bool = False,
                  curve: bool = False):
    """Refine S12 (mapping cam2 coordinates into cam1). Pc1 / Pc2 (N, 3): the
    matched landmark in each camera frame; uv1 / uv2 (N, 2): its observed
    ideal pixels in each image; w (N,): validity.

    Every array may carry one leading batch dim C (s0 (C,), R0 (C, 3, 3),
    t0 (C, 3), Pc2 / uv2 / w (C, N, ..), Pc1 / uv1 (N, ..) or (C, N, ..)):
    C problems in one LM with per-problem damping and acceptance.
    Returns (s, R, t, n_inliers), and the cost curve as a fifth when `curve`."""

    def residuals(x):
        s, R, t = x
        r1, J1, z1 = factors.sim3_reproj(cam, s, R, t, Pc2, uv1)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        r2, J2i, z2 = factors.sim3_reproj(cam, si, Ri, ti, Pc1, uv2)
        return r1, J1, z1, r2, J2i, z2

    def chi2_of(x):
        r1, _, z1, r2, _, z2 = residuals(x)
        return torch.sum(r1 * r1, -1), torch.sum(r2 * r2, -1), z1, z2

    def cost_fn(x):
        c1, c2, z1, z2 = chi2_of(x)
        # a point behind the camera pays far more than the saturated Huber cost:
        # else the scale can escape by pushing the whole cloud past the camera
        pen = 100.0 * huber_delta2
        t1 = torch.where(z1 > 0, lm.trunc_huber_cost(c1, huber_delta2), pen)
        t2 = torch.where(z2 > 0, lm.trunc_huber_cost(c2, huber_delta2), pen)
        return torch.sum(w * (t1 + t2), dim=-1)

    def linearize_solve(x, lam):
        s, R, t = x
        r1, J1, z1, r2, J2i, z2 = residuals(x)
        # the inverse edge's chain rule: S12 <- Exp(xi) S12 gives
        # S21 <- Exp(-Ad_{S21} xi) S21, so d r2 / d xi = -J2i @ Ad_{S21}
        Ad21 = lie.sim3_adjoint(*lie.sim3_inv(s, R, t))
        J2 = -(J2i @ Ad21[..., None, :, :])
        w1 = w * lm.trunc_huber_weight(torch.sum(r1 * r1, -1), huber_delta2) * (z1 > 0)
        w2 = w * lm.trunc_huber_weight(torch.sum(r2 * r2, -1), huber_delta2) * (z2 > 0)
        H = torch.einsum('...n,...nri,...nrj->...ij', w1, J1, J1) \
            + torch.einsum('...n,...nri,...nrj->...ij', w2, J2, J2)
        g = torch.einsum('...n,...nri,...nr->...i', w1, J1, r1) \
            + torch.einsum('...n,...nri,...nr->...i', w2, J2, r2)
        H = H + torch.diag_embed(lam[..., None] * torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)
        dx, info = torch.linalg.solve_ex(H, g[..., None])
        dx = -torch.where((info == 0)[..., None, None], dx, float("nan"))[..., 0]
        if fix_scale:
            dx = torch.cat([dx[..., :6], torch.zeros_like(dx[..., 6:])], dim=-1)
        return dx

    def retract(x, dx):
        return lie.sim3_mul(*lie.sim3_exp(dx), *x)

    (s, R, t), _, costs = lm.lm_optimize((s0, R0, t0), linearize_solve, retract, cost_fn,
                                         iters)
    c1, c2, z1, z2 = chi2_of((s, R, t))
    inlier = (w > 0) & (c1 < huber_delta2) & (c2 < huber_delta2) & (z1 > 0) & (z2 > 0)
    out = (s, lie.so3_normalize_fast(R), t, torch.sum(inlier, dim=-1))
    return out + (costs,) if curve else out
