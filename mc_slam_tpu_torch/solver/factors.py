"""Residual / analytic-Jacobian kernels of the tracking and window-BA factors
(port of the parts of mc_slam_tpu/solver/factors.py that tracking and the
keyframe event reach).

Body pose (P = t_wb, R = R_wb) with retraction P <- P + dP, R <- R Exp(dphi).
Reprojection residual r = project(Pc) - uv_obs; IMU PRV residual order
[rP, rPhi, rV] (EdgeNavStatePRV, src/IMU/g2otypes.cpp:163-227).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.device import resolve

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera, project_jacobian


class Extrinsics(NamedTuple):
    """Camera-from-body extrinsic: Pc = Rcb @ Pb + tcb."""
    Rcb: torch.Tensor  # (3, 3)
    tcb: torch.Tensor  # (3,)


def identity_extrinsics(dtype=torch.float32, device=None) -> Extrinsics:
    device = resolve(device)
    return Extrinsics(torch.eye(3, dtype=dtype, device=device),
                      torch.zeros(3, dtype=dtype, device=device))


def extrinsics_from_Tbc(Tbc, dtype=torch.float32, device=None) -> Extrinsics:
    """From the body-from-camera matrix Tbc (config/euroc.yaml:40-44)."""
    Tbc = torch.as_tensor(Tbc, dtype=dtype, device=resolve(device))
    Rcb = Tbc[:3, :3].T.contiguous()
    return Extrinsics(Rcb=Rcb, tcb=-Rcb @ Tbc[:3, 3])


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _project_ideal(cam: Camera, Pc):
    z = Pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
    u = cam.fx * Pc[..., 0] / z_safe + cam.cx
    v = cam.fy * Pc[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), z


def reproj_xyz(cam: Camera, ext: Extrinsics, P_wb, R_wb, Pw, uv):
    """Residual + Jacobians for a batch of mono observations.
    Returns r (..., 2), J_pr (..., 2, 6) w.r.t. [dP, dphi], J_pt (..., 2, 3)
    w.r.t. Pw, and z (...,) camera depth."""
    RwbT = R_wb.transpose(-1, -2)
    Pb = _mv(RwbT, Pw - P_wb)
    Pc = _mv(ext.Rcb, Pb) + ext.tcb
    uv_hat, z = _project_ideal(cam, Pc)
    r = uv_hat - uv
    Jpi = project_jacobian(cam, Pc)
    RcbRwbT = ext.Rcb @ RwbT
    J_phi = ext.Rcb @ lie.hat(Pb)
    J_pr = torch.cat([Jpi @ (-RcbRwbT), Jpi @ J_phi], dim=-1)
    J_pt = Jpi @ RcbRwbT
    return r, J_pr, J_pt, z


def reproj_idp(cam: Camera, ext: Extrinsics, rho, uv0, P_wb0, R_wb0, P_wbi, R_wbi, uv):
    """Residual + Jacobians for anchored inverse-depth observations
    (EdgePRIDP, src/IMU/g2otypes.cpp:20-158).

    rho (...,): inverse depth in the anchor camera; uv0 (..., 2): the
    anchor-frame ideal pixel of the landmark; (P_wb0, R_wb0): anchor body
    pose; (P_wbi, R_wbi): observing body pose.
    Returns r (..., 2), J_rho (..., 2, 1), J_pr0 (..., 2, 6), J_pri (..., 2, 6),
    z (...,)."""
    rho_safe = torch.clamp(rho, min=1e-6)   # the reference clamps the same way
    d = 1.0 / rho_safe
    xn0 = torch.stack([(uv0[..., 0] - cam.cx) / cam.fx,
                       (uv0[..., 1] - cam.cy) / cam.fy], dim=-1)
    P0c = torch.cat([xn0 * d[..., None], d[..., None]], dim=-1)   # in the anchor camera

    # anchor camera -> world: Pw = Rwb0 (Rbc P0c + pbc) + P0, Rbc = Rcb^T
    Rbc = ext.Rcb.transpose(-1, -2)
    RbcP = _mv(Rbc, P0c - ext.tcb)
    Pw = _mv(R_wb0, RbcP) + P_wb0

    # world -> observing camera
    RwbiT = R_wbi.transpose(-1, -2)
    Pbi = _mv(RwbiT, Pw - P_wbi)
    Pci = _mv(ext.Rcb, Pbi) + ext.tcb
    uv_hat, z = _project_ideal(cam, Pci)
    r = uv_hat - uv
    Jpi = project_jacobian(cam, Pci)

    Rcic0 = (ext.Rcb @ RwbiT) @ (R_wb0 @ Rbc)   # observing camera from anchor camera
    # dPci/drho = Rcic0 dP0c/drho, dP0c/drho = -d * P0c
    J_rho = Jpi @ (Rcic0 @ (-d[..., None] * P0c)[..., None])

    RcbRwbiT = ext.Rcb @ RwbiT
    J_phi0 = -(RcbRwbiT @ R_wb0) @ lie.hat(RbcP)
    J_pr0 = torch.cat([Jpi @ RcbRwbiT, Jpi @ J_phi0], dim=-1)
    J_phii = ext.Rcb @ lie.hat(Pbi)
    J_pri = torch.cat([Jpi @ (-RcbRwbiT), Jpi @ J_phii], dim=-1)
    return r, J_rho, J_pr0, J_pri, z


def imu_prv(P_i, R_i, V_i, dbg_i, dba_i, P_j, R_j, V_j, pre, gw):
    """PRV preintegration factor. Returns r (..., 9) and Jacobians
    J_pri (..., 9, 6), J_prj (..., 9, 6), J_vi (..., 9, 3), J_vj (..., 9, 3),
    J_bi (..., 9, 6) (g2otypes.cpp:296-359)."""
    dT = pre.dT[..., None]
    dT2 = dT * dT
    RiT = R_i.transpose(-1, -2)

    dP_corr = pre.dP + _mv(pre.J_P_bg, dbg_i) + _mv(pre.J_P_ba, dba_i)
    dV_corr = pre.dV + _mv(pre.J_V_bg, dbg_i) + _mv(pre.J_V_ba, dba_i)

    pvec = P_j - P_i - V_i * dT - 0.5 * gw * dT2
    vvec = V_j - V_i - gw * dT
    rP = _mv(RiT, pvec) - dP_corr
    rV = _mv(RiT, vvec) - dV_corr

    corr_phi = _mv(pre.J_R_bg, dbg_i)
    dR_corr = pre.dR @ lie.so3_exp(corr_phi)
    rR = dR_corr.transpose(-1, -2) @ (RiT @ R_j)
    rPhi = lie.so3_log(rR)
    r = torch.cat([rP, rPhi, rV], dim=-1)

    O = torch.zeros_like(R_i)
    JrInv = lie.so3_jr_inv(rPhi)
    RjT = R_j.transpose(-1, -2)
    J_pri = torch.cat([
        torch.cat([-RiT, lie.hat(_mv(RiT, pvec))], dim=-1),
        torch.cat([O, -JrInv @ (RjT @ R_i)], dim=-1),
        torch.cat([O, lie.hat(_mv(RiT, vvec))], dim=-1),
    ], dim=-2)
    J_prj = torch.cat([
        torch.cat([RiT, O], dim=-1),
        torch.cat([O, JrInv], dim=-1),
        torch.cat([O, O], dim=-1),
    ], dim=-2)
    J_vi = torch.cat([-RiT * dT[..., None], O, -RiT], dim=-2)
    J_vj = torch.cat([O, O, RiT], dim=-2)
    J_rPhi_dbg = -(JrInv @ lie.so3_exp(-rPhi)) @ (lie.so3_jr(corr_phi) @ pre.J_R_bg)
    J_bi = torch.cat([
        torch.cat([-pre.J_P_bg, -pre.J_P_ba], dim=-1),
        torch.cat([J_rPhi_dbg, torch.zeros_like(O)], dim=-1),
        torch.cat([-pre.J_V_bg, -pre.J_V_ba], dim=-1),
    ], dim=-2)
    return r, J_pri, J_prj, J_vi, J_vj, J_bi


def imu_prv_info(pre):
    """9x9 information of the PRV factor: inverse of the preintegration
    covariance re-ordered P,V,Phi -> P,Phi,V, inverted after Jacobi
    normalization (see the JAX docstring for why)."""
    cov = pre.cov
    # P,V,Phi -> P,Phi,V by slices (an index tensor would be a host upload)
    perm = lambda a, d: torch.cat([a.narrow(d, 0, 3), a.narrow(d, 6, 3),
                                   a.narrow(d, 3, 3)], dim=d)
    cov_prv = perm(perm(cov, -2), -1)
    d = torch.sqrt(torch.clamp(torch.diagonal(cov_prv, dim1=-2, dim2=-1), min=1e-16))
    dinv = 1.0 / d
    cov_n = cov_prv * dinv[..., :, None] * dinv[..., None, :]
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    info_n = torch.linalg.inv_ex(cov_n + 1e-6 * eye).inverse
    return info_n * dinv[..., :, None] * dinv[..., None, :]


def bias_rw(bg_i_full, ba_i_full, bg_j_full, ba_j_full):
    """r (..., 6); J_bi = -I6, J_bj = +I6 (supplied by the caller)."""
    return torch.cat([bg_j_full - bg_i_full, ba_j_full - ba_i_full], dim=-1)


def bias_rw_info(dT, sigma_bg, sigma_ba):
    """info = diag(1/(sigma^2 * dT)) per block (Optimizer.cpp:1771-1788)."""
    ig = 1.0 / (sigma_bg ** 2 * dT)
    ia = 1.0 / (sigma_ba ** 2 * dT)
    ones3 = torch.ones(dT.shape + (3,), dtype=dT.dtype, device=dT.device)
    diag = torch.cat([ig[..., None] * ones3, ia[..., None] * ones3], dim=-1)
    return torch.diag_embed(diag)


def prior_pr_v_bias(P, R, V, dbg, dba, P0, R0, V0, dbg0, dba0):
    """15d prior: r (..., 15) = [rP, rPhi, rV, rdbg, rdba]; J w.r.t.
    [dP, dphi, dV, ddbg, ddba] is block-diag(I, JrInv(rPhi), I, I, I)."""
    rPhi = lie.so3_log(R0.transpose(-1, -2) @ R)
    r = torch.cat([P - P0, rPhi, V - V0, dbg - dbg0, dba - dba0], dim=-1)
    J = torch.eye(15, dtype=r.dtype, device=r.device).expand(
        r.shape[:-1] + (15, 15)).clone()
    J[..., 3:6, 3:6] = lie.so3_jr_inv(rPhi)
    return r, J


def gyr_bias(bg, dRij, J_R_bg, R_bi, R_bj):
    """Gyro-bias-only factor of VI init (EdgeGyrBias, src/IMU/g2otypes.cpp:
    1115-1161): r = Log((dRij Exp(J_R_bg bg))^T Rbi^T Rbj).
    Returns the residual (..., 3) and its Jacobian (..., 3, 3) w.r.t. bg."""
    Jbg = _mv(J_R_bg, bg)
    corr = lie.so3_exp(Jbg)
    rel = R_bi.transpose(-1, -2) @ R_bj
    rR = (dRij @ corr).transpose(-1, -2) @ rel
    r = lie.so3_log(rR)
    J = -(lie.so3_jr_inv(r) @ lie.so3_exp(-r)) @ (lie.so3_jr(Jbg) @ J_R_bg)
    return r, J
