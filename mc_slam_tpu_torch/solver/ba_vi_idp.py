"""Anchored inverse-depth VI window BA (port of mc_slam_tpu/solver/ba_vi_idp.py:
Optimizer::LocalBAPRVIDP, src/Optimizer.cpp:32).

Landmarks are 1-D inverse depths anchored to the pixel ray of their anchor
keyframe; each observation carries two camera blocks (anchor + observer,
6-d [dP, dphi], embedded into the 15-d VI state) and a 1-d landmark block,
solved by the Schur engine of `lm` (K = 2, DP = 1).

Differences of form from the JAX package, none of intent:
* `.at[...].set(..., mode="drop")` scatters write into a buffer with one
  extra row that is sliced off; `.at[].min/.max` are `scatter_reduce`
  (`amin` / `amax`, include_self=True on purpose: the initial value is the
  neutral element of the reduction).
* The anchor pixel `uv0` of a landmark is the one of its lowest-index
  anchor observation (a keyframe may hold one point in two features after
  fusion; the JAX scatter-set leaves the winner to the scatter order).
* Padded window rows are never written back: the NavState and association
  scatter-backs of `window_vi_ba_map` send rows past `n_real` out of range.
  The JAX package pads with copies of the last slot and writes that slot
  several times, old values among them.
* Landmarks past `Pw` are still dropped for the solve, but counted:
  `BAStats.overflow`.
* Nothing here reads a device value on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.slam_map.mapstate import _set_drop
from mc_slam_tpu_torch.solver import factors, lm
from mc_slam_tpu_torch.solver.ba import CHI2_MONO
from mc_slam_tpu_torch.solver.ba_vi import (DC, IMUEdges, PriorFactor,
                                            _imu_edge_factors, _prior_factor,
                                            _quad_cost, edges_from_map,
                                            retract_states)


class IDPObs(NamedTuple):
    """Padded anchored-inverse-depth observation table."""
    anchor: torch.Tensor      # (O,) int64 anchor keyframe (local index)
    obs_kf: torch.Tensor      # (O,) int64 observing keyframe (local index)
    pt: torch.Tensor          # (O,) int64 landmark index (into rho)
    uv0: torch.Tensor         # (O, 2) anchor-frame ideal pixel of the landmark
    uv: torch.Tensor          # (O, 2) observed ideal pixel
    inv_sigma2: torch.Tensor  # (O,)
    valid: torch.Tensor       # (O,)


class BAStats(NamedTuple):
    """What a window BA reports beside its result (all 0-d device tensors
    except `costs`)."""
    cost0: torch.Tensor       # robust cost at the starting point
    cost: torch.Tensor        # final cost (over the second round's inliers)
    costs: torch.Tensor       # (rounds * (1 + iters),) start + per-iteration costs
    n_landmarks: torch.Tensor  # landmarks of the window that entered the solve
    overflow: torch.Tensor    # landmarks dropped because the window saw > Pw


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def vi_ba_idp(ns0: NavState, rho0, obs: IDPObs, edges: IMUEdges, camera: Camera,
              ext: factors.Extrinsics, gw, free_cam, pt_mask, iters: int = 10,
              huber_delta2: float = CHI2_MONO, lam0: float = 1e-4,
              rtol: float = 0.0, prior: PriorFactor | None = None,
              two_phase: bool = True):
    """Windowed VI BA over NavStates + anchored inverse depths.

    ns0: (Nc, ...) NavStates; rho0 (Np,) inverse depths; obs references local
    keyframe indices; prior: optional 15-d prior on one keyframe.
    Returns (ns, rho, chi2 (O,), cost, costs): `costs` is the cost curve, for
    each round its starting cost followed by the cost after every iteration."""
    Nc = ns0.P.shape[0]
    Np = rho0.shape[0]
    dev, dt = rho0.device, rho0.dtype
    i64 = lambda a: a.to(torch.int64)
    obs = obs._replace(anchor=i64(obs.anchor), obs_kf=i64(obs.obs_kf), pt=i64(obs.pt))
    edges = edges._replace(i=i64(edges.i), j=i64(edges.j))
    cams = torch.stack([obs.anchor, obs.obs_kf], dim=-1)

    def per_obs(ns, rho):
        return factors.reproj_idp(
            camera, ext, rho[obs.pt], obs.uv0,
            ns.P[obs.anchor], ns.R[obs.anchor],
            ns.P[obs.obs_kf], ns.R[obs.obs_kf], obs.uv)

    def retract(x, dx):
        ns, rho = x
        dxc, drho = dx
        # the reference clamps inverse depth at 1e-6 (VertexIDP, g2otypes.h:40)
        return retract_states(ns, dxc), torch.clamp(rho + drho, min=1e-6)

    def make_fns(valid):
        def linearize(x):
            """One residual / Jacobian pass -> (normal-equation blocks, cost)."""
            ns, rho = x
            r, J_rho, J_pr0, J_pri, z = per_obs(ns, rho)
            chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
            front = (z > 1e-6)
            w = obs.inv_sigma2 * lm.trunc_huber_weight(chi2, huber_delta2) \
                * valid * front.to(dt)
            rr = lm.trunc_huber_cost(chi2, huber_delta2)
            rr = torch.where(front, rr, lm.trunc_plateau(huber_delta2))
            cost = torch.sum(valid * rr)
            # 6-d pose blocks; embedded into the 15-d VI system after assembly
            o = lm.Observations(cam=cams, pt=obs.pt,
                                Jc=torch.stack([J_pr0, J_pri], dim=1),
                                Jp=J_rho, r=r, w=w)
            Hcc6, g6, Hpp, g_p, Wcp6, _ = lm.build_landmark_system(
                o, free_cam, Nc, 6, Np, 1)
            H = torch.zeros((Nc, DC, Nc, DC), dtype=dt, device=dev)
            g = torch.zeros((Nc, DC), dtype=dt, device=dev)
            zero = torch.zeros((), dtype=dt, device=dev)
            prv, bias = _imu_edge_factors(ns, edges, gw)
            cost = cost + _quad_cost(prv) + _quad_cost(bias)
            H, g, _ = lm.accumulate_cam_factors(H, g, zero, prv, free_cam)
            H, g, _ = lm.accumulate_cam_factors(H, g, zero, bias, free_cam)
            if prior is not None:
                pf = _prior_factor(ns, prior)
                cost = cost + _quad_cost(pf)
                H, g, _ = lm.accumulate_cam_factors(H, g, zero, pf, free_cam)
            H = H.clone()
            H[:, :6, :, :6] += Hcc6
            g = g.clone()
            g[:, :6] += g6
            return (H, g, Hpp, g_p, Wcp6), cost

        def solve(lin, lam):
            H, g, Hpp, g_p, Wcp6 = lin
            dxc, dxp = lm.schur_solve_pr(H, g, Hpp, g_p, Wcp6, lam, free_cam, pt_mask)
            return dxc, dxp[:, 0]

        return linearize, solve

    def classify(x, valid0):
        ns, rho = x
        r, _, _, _, z = per_obs(ns, rho)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= huber_delta2) & (z > 1e-6)).to(valid0.dtype)

    def one_round(x0, valid, n_it, rt):
        lin, sol = make_fns(valid)
        lin0 = lin(x0)
        x, cost, costs = lm.lm_optimize_fused(x0, lin, sol, retract, n_it, lam0=lam0,
                                              rtol=rt, lin0=lin0)
        return x, cost, torch.cat([lin0[1][None], costs])

    # two rounds with inlier re-classification between them; rtol > 0 is the
    # abortable-BA mode: one round with early exit
    if two_phase and rtol == 0.0:
        it1 = max(2, int(round(iters * 0.4)))
        it2 = max(2, iters - it1)
        x1, _, curve1 = one_round((ns0, rho0), obs.valid, it1, 0.0)
        (ns, rho), cost, curve2 = one_round(x1, classify(x1, obs.valid), it2, 0.0)
        costs = torch.cat([curve1, curve2])
    else:
        (ns, rho), cost, costs = one_round((ns0, rho0), obs.valid, iters, rtol)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    r, _, _, _, z = per_obs(ns, rho)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    chi2 = torch.where(z > 0, chi2, torch.full_like(chi2, 1e9))
    return ns, rho, chi2, cost, costs


def vi_window_ba(ns_w, mp_pos, mp_active, obs_pt, obs_cam, obs_uv,
                 obs_inv_sigma2, obs_valid, edges: IMUEdges, camera: Camera,
                 ext: factors.Extrinsics, gw, free_cam,
                 prior: PriorFactor | None = None, iters: int = 8,
                 rtol: float = 0.0, two_phase: bool = True, Pw: int = 4096):
    """The pipeline's windowed VI BA entry, landmark-compacted: the window's
    landmarks are renumbered into a fixed Pw-slot problem (cumsum over the
    observed mask), anchored at their first observing window keyframe, solved
    (vi_ba_idp) and scattered back. Landmarks past Pw drop their observations
    for this solve and are counted in BAStats.overflow.

    Returns (ns2, mp_pos2, chi2, idp_valid, stats) with chi2 / idp_valid
    aligned to the input observation order."""
    P = mp_pos.shape[0]
    n = ns_w.P.shape[0]
    dev = mp_pos.device
    obs_pt = obs_pt.to(torch.int64)
    obs_cam = obs_cam.to(torch.int64)
    ov = (obs_valid > 0) & mp_active[obs_pt]
    present = _set_drop(torch.zeros(P, dtype=torch.bool, device=dev),
                        torch.where(ov, obs_pt, P), True)
    cid = torch.cumsum(present.to(torch.int64), 0) - 1           # (P,)
    keep = present & (cid < Pw)
    n_present = torch.sum(present)
    overflow = torch.clamp(n_present - Pw, min=0)
    # inverse map compact -> full slot (unused compact slots point at 0 with
    # used = False; their rho stays frozen through rho_free = 0)
    tgt = torch.where(keep, cid, Pw)
    slot_of = _set_drop(torch.zeros(Pw, dtype=torch.int64, device=dev), tgt,
                        torch.arange(P, dtype=torch.int64, device=dev))
    used = _set_drop(torch.zeros(Pw, dtype=torch.bool, device=dev), tgt, True)
    pt_c = torch.where(keep[obs_pt], cid[obs_pt], 0)
    valid_c = (ov & keep[obs_pt]).to(obs_valid.dtype)
    mp_pos_c = mp_pos[slot_of]

    BIGI = 2 ** 30
    anchor_loc = torch.full((Pw,), BIGI, dtype=torch.int64, device=dev).scatter_reduce(
        0, pt_c, torch.where(valid_c > 0, obs_cam, BIGI), reduce="amin",
        include_self=True)
    has_anchor = anchor_loc < n
    anchor_cl = torch.clamp(anchor_loc, 0, n - 1)
    is_anchor_obs = (valid_c > 0) & (obs_cam == anchor_cl[pt_c]) & has_anchor[pt_c]
    # the anchor pixel: the lowest-index anchor observation of each landmark
    O = obs_pt.shape[0]
    o_idx = torch.arange(O, dtype=torch.int64, device=dev)
    first = torch.full((Pw,), O, dtype=torch.int64, device=dev).scatter_reduce(
        0, pt_c, torch.where(is_anchor_obs, o_idx, O), reduce="amin",
        include_self=True)
    uv0 = torch.where((first < O)[:, None], obs_uv[torch.clamp(first, max=O - 1)],
                      torch.zeros((), dtype=obs_uv.dtype, device=dev))
    rho0 = xyz_to_idp(mp_pos_c, ns_w.P[anchor_cl], ns_w.R[anchor_cl], uv0, camera, ext)
    idp_valid = ((valid_c > 0) & ~is_anchor_obs & has_anchor[pt_c]).to(torch.float32)
    idp_obs = IDPObs(anchor=anchor_cl[pt_c], obs_kf=obs_cam, pt=pt_c, uv0=uv0[pt_c],
                     uv=obs_uv, inv_sigma2=obs_inv_sigma2, valid=idp_valid)
    rho_free = torch.zeros(Pw, dtype=torch.float32, device=dev).scatter_reduce(
        0, pt_c, idp_valid, reduce="amax", include_self=True) * used
    ns2, rho, chi2, cost, costs = vi_ba_idp(
        ns_w, rho0, idp_obs, edges, camera, ext, gw, free_cam, rho_free,
        iters=iters, prior=prior, rtol=rtol, two_phase=two_phase)
    Xw = idp_to_xyz(rho, uv0, ns2.P[anchor_cl], ns2.R[anchor_cl], camera, ext)
    upd = rho_free > 0
    mp_pos2 = _set_drop(mp_pos, torch.where(upd, slot_of, P),
                        torch.where(upd[:, None], Xw, mp_pos_c))
    stats = BAStats(cost0=costs[0], cost=cost, costs=costs,
                    n_landmarks=torch.sum(keep), overflow=overflow)
    return ns2, mp_pos2, chi2, idp_valid, stats


def window_vi_ba_map(m, ks, idx_i, idx_j, ev, n_real, free_cam,
                     camera: Camera, ext: factors.Extrinsics, gw,
                     sigma_bg, sigma_ba, prior: PriorFactor | None = None,
                     iters: int = 8, rtol: float = 0.0, two_phase: bool = True,
                     Pw: int = 4096, do_prune: bool = True,
                     chi2_gate: float = CHI2_MONO):
    """The whole windowed VI-BA event stage on the MapState: observation
    gather from the keyframe tables, preintegration-edge assembly (masked
    edges get identity informations), the landmark-compacted inverse-depth
    solve (vi_window_ba), NavState / landmark scatter-back and the post-BA
    chi2 association prune.

    ks: (n,) int64 window + fixed slots, padded to a fixed length (any valid
    slot as padding); idx_i / idx_j / ev: (E,) edge lists
    (mapping_ctl.imu_edge_lists); n_real: the count of real (non-pad) slots,
    an int or a 0-d tensor; free_cam: (n,) free mask.
    Returns (m, BAStats). Rows of `ks` past n_real are never written back."""
    Fn = m.F
    n = ks.shape[0]
    dev = ks.device
    ks = ks.to(torch.int64)
    cam_idx = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(Fn)
    real = torch.arange(n, device=dev) < n_real                      # (n,)
    mp = m.kf_mp[ks].reshape(-1)
    uv = m.kf_uv[ks].reshape(-1, 2)
    lvl = m.kf_level[ks].reshape(-1)
    fv = m.kf_feat_valid[ks].reshape(-1)
    valid = (mp >= 0) & fv & real[cam_idx]
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * lvl.to(torch.float32)))
    pt = torch.clamp(mp, 0, m.P - 1)
    edges = edges_from_map(m.kf_preint, ks, idx_i, idx_j, ev, sigma_bg, sigma_ba)
    ns_w = NavState(*[a[ks] for a in m.kf_ns])
    ns2, mp_pos2, chi2, idp_valid, stats = vi_window_ba(
        ns_w, m.mp_pos, m.mp_active, pt, cam_idx, uv, inv_sigma2,
        valid.to(torch.float32), edges, camera, ext, gw, free_cam,
        prior=prior, iters=iters, rtol=rtol, two_phase=two_phase, Pw=Pw)
    ks_real = torch.where(real, ks, m.K)          # pad rows fall off the table
    kf_ns2 = NavState(*[_set_drop(full, ks_real, w) for full, w in zip(m.kf_ns, ns2)])
    m = m._replace(kf_ns=kf_ns2, mp_pos=mp_pos2)
    if do_prune:
        bad = (chi2 > chi2_gate * 1.5) & (idp_valid > 0)
        rows = torch.where(bad.reshape(n, -1), -1, m.kf_mp[ks])
        m = m._replace(kf_mp=_set_drop(m.kf_mp, ks_real, rows))
    return m, stats


def xyz_to_idp(pts_w, anchor_P, anchor_R, anchor_uv_ideal, cam: Camera,
               ext: factors.Extrinsics):
    """World landmarks -> anchored inverse depth w.r.t. their anchor keyframe
    camera: rho = 1 / depth along the anchor ray."""
    Pb = _mv(anchor_R.transpose(-1, -2), pts_w - anchor_P)
    Pc = _mv(ext.Rcb, Pb) + ext.tcb
    return 1.0 / torch.clamp(Pc[..., 2], min=1e-6)


def idp_to_xyz(rho, uv0, anchor_P, anchor_R, cam: Camera, ext: factors.Extrinsics):
    """Anchored inverse depth back to world coordinates."""
    d = 1.0 / torch.clamp(rho, min=1e-6)
    xn = torch.stack([(uv0[..., 0] - cam.cx) / cam.fx,
                      (uv0[..., 1] - cam.cy) / cam.fy], -1)
    Pc = torch.cat([xn * d[..., None], d[..., None]], dim=-1)
    Pb = _mv(ext.Rcb.transpose(-1, -2), Pc - ext.tcb)
    return _mv(anchor_R, Pb) + anchor_P
