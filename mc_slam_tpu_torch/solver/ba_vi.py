"""Tracking-time visual-inertial pose optimization (port of the tracking part
of mc_slam_tpu/solver/ba_vi.py): Optimizer::PoseOptimization(Frame, Frame,
preint, gw, bComputeMarg), src/Optimizer.cpp:1671-2041, including the 15x15
marginal information prior handed to the next frame.

State layout per frame (DC = 15): [dP, dphi, dV, ddbg, ddba].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import PreintState
from mc_slam_tpu_torch.solver import factors, lm
from mc_slam_tpu_torch.solver.ba import (VisualObs, _obs_weights, _robust_cost,
                                         obs_reproj)

DC = 15


class IMUEdges(NamedTuple):
    """PRV chain + bias random-walk edges between state pairs (i -> j)."""
    i: torch.Tensor           # (E,) int64
    j: torch.Tensor           # (E,) int64
    pre: PreintState          # batched (E, ...)
    info_prv: torch.Tensor    # (E, 9, 9)
    info_bias: torch.Tensor   # (E, 6, 6)
    valid: torch.Tensor       # (E,)


class PriorFactor(NamedTuple):
    """15d prior on one state (order [P, phi, V, dbg, dba])."""
    cam: torch.Tensor         # () int
    ns0: NavState             # linearization point (single state)
    info: torch.Tensor        # (15, 15)
    valid: torch.Tensor       # ()


def retract_states(ns: NavState, dx) -> NavState:
    return ns._replace(
        P=ns.P + dx[..., 0:3],
        R=ns.R @ lie.so3_exp(dx[..., 3:6]),
        V=ns.V + dx[..., 6:9],
        dbg=ns.dbg + dx[..., 9:12],
        dba=ns.dba + dx[..., 12:15],
    )


def _imu_edge_factors(ns: NavState, edges: IMUEdges, gw):
    """PRV + bias-RW residuals/Jacobians of all edges as two CamFactors (K=2)."""
    i, j = edges.i, edges.j
    r, J_pri, J_prj, J_vi, J_vj, J_bi = factors.imu_prv(
        ns.P[i], ns.R[i], ns.V[i], ns.dbg[i], ns.dba[i],
        ns.P[j], ns.R[j], ns.V[j], edges.pre, gw)
    E = i.shape[0]
    z = lambda *s: torch.zeros((E,) + s, dtype=r.dtype, device=r.device)
    J_i = torch.cat([J_pri, J_vi, J_bi], dim=-1)          # (E, 9, 15)
    J_j = torch.cat([J_prj, J_vj, z(9, 6)], dim=-1)
    cams = torch.stack([i, j], dim=-1)
    prv = lm.CamFactors(cam=cams, J=torch.stack([J_i, J_j], dim=1), r=r,
                        info=edges.info_prv, w=edges.valid)
    r_b = factors.bias_rw(ns.bg[i] + ns.dbg[i], ns.ba[i] + ns.dba[i],
                          ns.bg[j] + ns.dbg[j], ns.ba[j] + ns.dba[j])
    I6 = torch.eye(6, dtype=r.dtype, device=r.device).expand(E, 6, 6)
    Jb_i = torch.cat([z(6, 9), -I6], dim=-1)
    Jb_j = torch.cat([z(6, 9), I6], dim=-1)
    bias = lm.CamFactors(cam=cams, J=torch.stack([Jb_i, Jb_j], dim=1), r=r_b,
                         info=edges.info_bias, w=edges.valid)
    return prv, bias


def _prior_factor(ns: NavState, prior: PriorFactor):
    # a (1,) index gathers on the device; a 0-d tensor index would be read
    # back to the host
    c = prior.cam.reshape(1).to(torch.int64)
    r, J = factors.prior_pr_v_bias(
        ns.P[c][0], ns.R[c][0], ns.V[c][0], ns.dbg[c][0], ns.dba[c][0],
        prior.ns0.P, prior.ns0.R, prior.ns0.V, prior.ns0.dbg, prior.ns0.dba)
    return lm.CamFactors(cam=c.reshape(1, 1), J=J[None, None], r=r[None],
                         info=prior.info[None], w=prior.valid.reshape(1))


def _quad_cost(fac: lm.CamFactors):
    return torch.sum(fac.w * torch.einsum('er,ers,es->e', fac.r, fac.info, fac.r))


def _vi_total_cost(ns: NavState, pts, obs: VisualObs, edges: IMUEdges, prior,
                   camera, ext, gw):
    r, _, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                pts[obs.pt], obs)
    c = _robust_cost(r, z, obs.inv_sigma2, obs.valid, d2)
    prv, bias = _imu_edge_factors(ns, edges, gw)
    c = c + _quad_cost(prv) + _quad_cost(bias)
    if prior is not None:
        c = c + _quad_cost(_prior_factor(ns, prior))
    return c


def pose_only_vi(ns_cur0: NavState, ns_last: NavState, pre_last_cur: PreintState,
                 pts_w, obs: VisualObs, camera: Camera, ext: factors.Extrinsics,
                 gw, prior_last: PriorFactor, info_prv, info_bias,
                 iters: int = 40, compute_marg: bool = True, rtol: float = 0.0):
    """Joint (last, current) frame optimization tied by the IMU PRV + bias
    edges, last frame held by its marginal prior, map points fixed.
    Returns (ns_cur, chi2 (O,), n_inliers, H_marg (15, 15)); H_marg is the
    current frame's marginal information (last frame Schur-eliminated)."""
    dev, dt = ns_cur0.P.device, ns_cur0.P.dtype
    Nc = 2  # state 0 = last, state 1 = current
    ns0 = NavState(*[torch.stack([a, b]) for a, b in zip(ns_last, ns_cur0)])
    edges = IMUEdges(i=torch.zeros(1, dtype=torch.int64, device=dev),
                     j=torch.ones(1, dtype=torch.int64, device=dev),
                     pre=PreintState(*[a[None] for a in pre_last_cur]),
                     info_prv=info_prv[None], info_bias=info_bias[None],
                     valid=torch.ones(1, dtype=dt, device=dev))
    obs = obs._replace(cam=torch.ones_like(obs.cam))  # all obs on the current frame
    free = torch.ones(2, dtype=dt, device=dev)
    pts_o = pts_w[obs.pt]

    def build(ns, valid):
        r, J_pr, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                       pts_o, obs)
        w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
        wJ = J_pr * w[:, None, None]
        H = torch.zeros((Nc, DC, Nc, DC), dtype=r.dtype, device=dev)
        g = torch.zeros((Nc, DC), dtype=r.dtype, device=dev)
        # all obs are on state 1; reprojection touches only its 6-d [dP, dphi] block
        H[1, :6, 1, :6] = torch.einsum('orc,ord->cd', wJ, J_pr)
        g[1, :6] = torch.einsum('orc,or->c', wJ, r)
        cost = torch.zeros((), dtype=r.dtype, device=dev)
        prv, bias = _imu_edge_factors(ns, edges, gw)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost,
                                               _prior_factor(ns, prior_last), free)
        return H, g

    def make_fns(valid):
        vobs = obs._replace(valid=valid)

        def cost_fn(ns):
            return _vi_total_cost(ns, pts_w, vobs, edges, prior_last, camera,
                                  ext, gw)

        def linearize_solve(ns, lam):
            H, g = build(ns, valid)
            return lm.solve_cam_system(H, g, lam, free)

        return linearize_solve, retract_states, cost_fn

    def classify(ns, valid0):
        r, _, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                    pts_o, obs)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).to(valid0.dtype)

    ns, _, _ = lm.lm_two_phase(ns0, make_fns, obs.valid, classify, iters,
                               p1_frac=0.5, rtol=rtol, enable=False)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))

    r, _, _, z, d2_f = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                  pts_o, obs)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    inlier = (chi2 <= d2_f) & (z > 0) & (obs.valid > 0)

    if compute_marg:
        H, _ = build(ns, classify(ns, obs.valid))
        Hll = H[0, :, 0, :] + 1e-8 * torch.eye(DC, dtype=H.dtype, device=dev)
        Hlc = H[0, :, 1, :]
        Hcc = H[1, :, 1, :]
        H_marg = Hcc - Hlc.T @ torch.linalg.solve_ex(Hll, Hlc).result
    else:
        H_marg = torch.zeros((DC, DC), dtype=dt, device=dev)

    ns_cur = NavState(*[a[1] for a in ns])
    return ns_cur, chi2, torch.sum(inlier), H_marg
