"""Sim3 / SE3 pose-graph optimization for loop closing (port of
mc_slam_tpu/solver/posegraph.py, the role of Optimizer::OptimizeEssentialGraph).

Sim3 vertices (7 DoF; the scale frozen in SE3 mode), edges from the loop
constraint, the spanning tree, covisibility and earlier loop edges, LM with a
tiny initial damping. Vertices store the world->keyframe Sim3 (s, R, t) with
the LEFT-multiplicative retraction S <- Exp(xi) S; an edge's residual is
r = log(S_meas * S_i * S_j^{-1}).

The JAX package differentiates the residual with `jacfwd` under `vmap`. Here
the Jacobians are in closed form: with E = S_meas S_i S_j^{-1} and r = log E,
    S_meas Exp(xi_i) S_i S_j^{-1} Exp(-xi_j) = Exp(Ad_{S_meas} xi_i) Exp(-Ad_E xi_j) E,
so dr/dxi_i = Jl^{-1}(r) Ad_{S_meas} and dr/dxi_j = -Jl^{-1}(r) Ad_E, where
Jl^{-1}(r) = sum_n B_n / n! ad_r^n is the inverse left Jacobian of Sim(3)
(the Bernoulli series in the 7x7 matrix ad_r, to order 12: residuals of a
loop correction stay far inside its radius 2 pi).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.solver import lm


class Sim3Graph(NamedTuple):
    # vertices: world->keyframe transforms (g2o VertexSim3 convention, Scw)
    s: torch.Tensor       # (K,)
    R: torch.Tensor       # (K, 3, 3)
    t: torch.Tensor       # (K, 3)
    # edges i -> j with the measurement S_ji = S_j * S_i^{-1}
    ei: torch.Tensor      # (E,) int64
    ej: torch.Tensor      # (E,) int64
    s_m: torch.Tensor     # (E,)
    R_m: torch.Tensor     # (E, 3, 3)
    t_m: torch.Tensor     # (E, 3)
    w: torch.Tensor       # (E,) edge weight / validity
    free: torch.Tensor    # (K,) 0/1 (the loop keyframe is fixed)


def edge_measurement(s_i, R_i, t_i, s_j, R_j, t_j):
    """S_ji = S_j * S_i^{-1} from the current vertex estimates."""
    return lie.sim3_mul(s_j, R_j, t_j, *lie.sim3_inv(s_i, R_i, t_i))


def _edge_error(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """E = S_m * S_i * S_j^{-1}."""
    sm1 = lie.sim3_mul(s_m, R_m, t_m, s_i, R_i, t_i)
    return lie.sim3_mul(*sm1, *lie.sim3_inv(s_j, R_j, t_j))


def _edge_residual(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    return lie.sim3_log(*_edge_error(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m))


def sim3_ad(xi):
    """ad of a sim(3) element [rho, phi, sigma]: (..., 7) -> (..., 7, 7), the
    derivative of `lie.sim3_adjoint` at the identity."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = torch.zeros(xi.shape[:-1] + (7, 7), dtype=xi.dtype, device=xi.device)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    A[..., :3, :3] = lie.hat(phi) + sigma[..., None, None] * eye
    A[..., :3, 3:6] = lie.hat(rho)
    A[..., :3, 6] = -rho
    A[..., 3:6, 3:6] = lie.hat(phi)
    return A


# B_n / n! for n = 0 .. 12 (B_1 = -1/2: the LEFT Jacobian's inverse)
_BERNOULLI_OVER_FACT = (1.0, -0.5, 1.0 / 12, 0.0, -1.0 / 720, 0.0, 1.0 / 30240, 0.0,
                        -1.0 / 1209600, 0.0, 1.0 / 47900160, 0.0,
                        -691.0 / 1307674368000)


def sim3_jl_inv(xi):
    """Inverse left Jacobian of Sim(3): log(Exp(d) Exp(xi)) = xi + Jl^{-1}(xi) d
    to first order in d. (..., 7) -> (..., 7, 7)."""
    ad = sim3_ad(xi)
    eye = torch.eye(7, dtype=xi.dtype, device=xi.device).expand_as(ad)
    out, power = eye.clone(), eye
    for c in _BERNOULLI_OVER_FACT[1:]:
        power = power @ ad
        if c != 0.0:
            out = out + c * power
    return out


def _res_and_jac(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """Residuals (E, 7) and the Jacobians (E, 7, 7) w.r.t. the left
    perturbations of vertex i and of vertex j."""
    E = _edge_error(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m)
    r = lie.sim3_log(*E)
    Jl_inv = sim3_jl_inv(r)
    return r, (Jl_inv @ lie.sim3_adjoint(s_m, R_m, t_m), -(Jl_inv @ lie.sim3_adjoint(*E)))


def optimize_pose_graph(g: Sim3Graph, iters: int = 20, lam0: float = 1e-8,
                        fix_scale: bool = False, curve: bool = False):
    """LM over the Sim3 pose graph. Returns (R, s, t, cost) per vertex (the
    JAX function's order), and the cost curve as a fifth when `curve`."""
    K = g.s.shape[0]
    DC = 7
    dtype, dev = g.s.dtype, g.s.device
    E = g.ei.shape[0]
    cam = torch.stack([g.ei, g.ej], dim=-1)
    info = torch.eye(7, dtype=dtype, device=dev).expand(E, 7, 7)

    def cost_fn(x):
        s, R, t = x
        r = _edge_residual(s[g.ei], R[g.ei], t[g.ei], s[g.ej], R[g.ej], t[g.ej],
                           g.s_m, g.R_m, g.t_m)
        return torch.sum(g.w * torch.sum(r * r, dim=-1))

    def linearize_solve(x, lam):
        s, R, t = x
        r, (Ji, Jj) = _res_and_jac(s[g.ei], R[g.ei], t[g.ei], s[g.ej], R[g.ej], t[g.ej],
                                   g.s_m, g.R_m, g.t_m)
        fac = lm.CamFactors(cam=cam, J=torch.stack([Ji, Jj], dim=1), r=r, info=info, w=g.w)
        H = torch.zeros((K, DC, K, DC), dtype=dtype, device=dev)
        gv = torch.zeros((K, DC), dtype=dtype, device=dev)
        H, gv, _ = lm.accumulate_cam_factors(H, gv, torch.zeros((), dtype=dtype, device=dev),
                                             fac, g.free)
        dx = lm.solve_cam_system(H, gv, lam, g.free)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], dim=-1)
        return dx

    def retract(x, dx):
        return lie.sim3_mul(*lie.sim3_exp(dx), *x)

    (s, R, t), cost, costs = lm.lm_optimize((g.s, g.R, g.t), linearize_solve, retract,
                                            cost_fn, iters, lam0=lam0)
    out = (lie.so3_normalize_fast(R), s, t, cost)
    return out + (costs,) if curve else out


def correct_map_points(mp_pos, mp_ref_kf, s_old, R_old, t_old, s_new, R_new, t_new):
    """Move each map point with its reference keyframe's Sim3 correction
    (CorrectLoop's point remap): X' = S_new^{-1}(S_old(X)) with that
    keyframe's world->keyframe transforms."""
    r = mp_ref_kf
    Xk = lie.sim3_apply(s_old[r], R_old[r], t_old[r], mp_pos)
    return lie.sim3_apply(*lie.sim3_inv(s_new[r], R_new[r], t_new[r]), Xk)
