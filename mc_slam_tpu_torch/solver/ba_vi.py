"""Visual-inertial optimizers on the LM + Schur engine (port of
mc_slam_tpu/solver/ba_vi.py): `pose_only_vi`, Optimizer::PoseOptimization
(Frame, Frame, preint, gw, bComputeMarg), src/Optimizer.cpp:1671-2041, with
the 15x15 marginal information prior handed to the next frame; and `vi_ba`,
Optimizer::Local / GlobalBundleAdjustmentNavStatePRV (:937, :629), the BA
over 15-d NavStates and XYZ landmarks with the IMU PRV chain and bias
random-walk edges.

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


def edges_from_map(kf_preint: PreintState, ks, idx_i, idx_j, ev, sigma_bg,
                   sigma_ba) -> IMUEdges:
    """PRV + bias edges along a window of keyframe slots `ks` (local index
    space) from the map's stored preintegrations: edge e integrates into
    keyframe ks[idx_j[e]]. A masked edge (ev == 0) may carry a degenerate
    preintegration (dT = 0) whose information is inf / NaN; it gets identity
    informations so that 0 * inf cannot poison the system."""
    dev = ks.device
    idx_i = idx_i.to(torch.int64)
    idx_j = idx_j.to(torch.int64)
    pre = PreintState(*[x[ks[idx_j]] for x in kf_preint])
    info_prv = factors.imu_prv_info(pre)
    info_bias = factors.bias_rw_info(pre.dT, sigma_bg, sigma_ba)
    sel = ev[:, None, None] > 0
    info_prv = torch.where(sel, info_prv, torch.eye(9, dtype=info_prv.dtype, device=dev))
    info_bias = torch.where(sel, info_bias, torch.eye(6, dtype=info_bias.dtype, device=dev))
    return IMUEdges(i=idx_i, j=idx_j, pre=pre, info_prv=info_prv, info_bias=info_bias,
                    valid=ev)


def _build_H_cam(ns, edges, prior, gw, free_mask, Nc):
    """Dense camera system (H (Nc, DC, Nc, DC), g (Nc, DC)) of the camera-only
    factors: IMU PRV edges, bias random-walk edges and the optional prior."""
    dt, dev = ns.P.dtype, ns.P.device
    H = torch.zeros((Nc, DC, Nc, DC), dtype=dt, device=dev)
    g = torch.zeros((Nc, DC), dtype=dt, device=dev)
    cost = torch.zeros((), dtype=dt, device=dev)
    prv, bias = _imu_edge_factors(ns, edges, gw)
    H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free_mask)
    H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free_mask)
    if prior is not None:
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, _prior_factor(ns, prior),
                                               free_mask)
    return H, g


def vi_ba(ns0: NavState, pts0, obs: VisualObs, edges: IMUEdges, camera: Camera,
          ext: factors.Extrinsics, gw, free_cam, pt_mask,
          prior: PriorFactor | None = None, iters: int = 10, lam0: float = 1e-4,
          fix_points: bool = False, rtol: float = 0.0, two_phase: bool = True):
    """Windowed / global VI bundle adjustment over NavStates + XYZ landmarks
    in the full landmark-table index space.

    ns0: NavState with (Nc, ...) rows (window keyframes + fixed observers);
    pts0 (Np, 3); free_cam (Nc,), pt_mask (Np,). fix_points=True turns this
    into multi-frame pose-only optimization (the relocalization bias
    recompute). Returns (ns, pts, chi2 (O,), cost, costs): `costs` is the cost
    curve, for each round its starting cost followed by the cost after every
    iteration."""
    Nc, Np = ns0.P.shape[0], pts0.shape[0]
    i64 = lambda a: a.to(torch.int64)
    obs = obs._replace(cam=i64(obs.cam), pt=i64(obs.pt))
    edges = edges._replace(i=i64(edges.i), j=i64(edges.j))
    cam_k = obs.cam[:, None]

    def per_obs(x):
        ns, pts = x
        return obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam], pts[obs.pt], obs)

    def retract(x, dx):
        ns, pts = x
        dxc, dxp = dx
        return retract_states(ns, dxc), pts + dxp

    def make_fns(valid):
        vobs = obs._replace(valid=valid)

        def cost_fn(x):
            ns, pts = x
            return _vi_total_cost(ns, pts, vobs, edges, prior, camera, ext, gw)

        def linearize_solve(x, lam):
            ns, pts = x
            r, J_pr, J_pt, z, d2 = per_obs(x)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            # the visual system in 6-d [dP, dphi] space, embedded once into the
            # 15-d VI system (reprojection has zero V / bias columns)
            o = lm.Observations(cam=cam_k, pt=obs.pt, Jc=J_pr[:, None], Jp=J_pt,
                                r=r, w=w)
            Hcc6, g6, Hpp, g_p, Wcp6, _ = lm.build_landmark_system(
                o, free_cam, Nc, 6, Np, 3)
            H, g = _build_H_cam(ns, edges, prior, gw, free_cam, Nc)
            H = H.clone()
            H[:, :6, :, :6] += Hcc6
            g = g.clone()
            g[:, :6] += g6
            if fix_points:
                return lm.solve_cam_system(H, g, lam, free_cam), torch.zeros_like(pts)
            return lm.schur_solve_pr(H, g, Hpp, g_p, Wcp6, lam, free_cam, pt_mask)

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        r, _, _, z, d2 = per_obs(x)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).to(valid0.dtype)

    curve = []
    (ns, pts), cost, _ = lm.lm_two_phase(
        (ns0, pts0), make_fns, obs.valid, classify, iters, lam0=lam0, rtol=rtol,
        enable=two_phase, curve=curve)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    r, _, _, z, _ = per_obs((ns, pts))
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    chi2 = torch.where(z > 0, chi2, torch.full_like(chi2, 1e9))
    return ns, pts, chi2, cost, torch.stack(curve)


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
