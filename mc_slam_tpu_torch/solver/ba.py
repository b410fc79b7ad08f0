"""Vision-only bundle-adjustment problems on the LM + Schur engine (port of
mc_slam_tpu/solver/ba.py): `pose_only_visual`, Optimizer::PoseOptimization
(Frame) as a fixed-iteration LM over one body pose against fixed world
points, and `visual_ba`, Optimizer::BundleAdjustment / LocalBundleAdjustment
over camera poses and XYZ landmarks. With `VisualObs.ur` set, stereo / RGB-D
rows add the u_right residual (`factors.reproj_xyz3`, bf = fx * baseline) and
are gated at the 3-dof threshold CHI2_STEREO.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.solver import factors, lm

CHI2_MONO = 5.991    # 95% quantile of chi2(2), reference's mono gate
CHI2_STEREO = 7.815  # 95% quantile of chi2(3), reference's stereo gate


class VisualObs(NamedTuple):
    """Padded observation table (mono rows, optional stereo third row)."""
    cam: torch.Tensor         # (O,) int64 camera index
    pt: torch.Tensor          # (O,) int64 point index
    uv: torch.Tensor          # (O, 2) ideal (undistorted) pixels
    inv_sigma2: torch.Tensor  # (O,) per-level information scale
    valid: torch.Tensor       # (O,) {0,1} float
    # observed virtual right-image u (the reference's mvuRight); None => a
    # monocular problem (2-row residuals); entries < 0 => monocular rows of a
    # mixed table (third row masked)
    ur: torch.Tensor | None = None


def obs_reproj(cam: Camera, ext, P_wb, R_wb, Pw, obs: VisualObs, bf=0.0):
    """Mono 2-row or mixed 3-row reprojection for an observation batch.
    Returns (r, J_pr, J_pt, z, delta2), delta2 the per-row Huber knee."""
    return reproj_rows(cam, ext, P_wb, R_wb, Pw, obs.uv, obs.ur, bf)


def reproj_rows(cam: Camera, ext, P_wb, R_wb, Pw, uv, ur=None, bf=0.0):
    """`obs_reproj` on bare columns (also the chunked BA's rows): monocular
    when ur is None, else the 3-row factor with the per-row gate."""
    if ur is None:
        r, J_pr, J_pt, z = factors.reproj_xyz(cam, ext, P_wb, R_wb, Pw, uv)
        return r, J_pr, J_pt, z, CHI2_MONO
    r, J_pr, J_pt, z = factors.reproj_xyz3(cam, ext, P_wb, R_wb, Pw, uv, ur, bf)
    return r, J_pr, J_pt, z, chi2_gate(ur)


def chi2_gate(ur):
    """The per-row chi2 gate: CHI2_STEREO on rows with a u_right observation,
    CHI2_MONO elsewhere (and everywhere when ur is None)."""
    if ur is None:
        return CHI2_MONO
    return torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)


def _obs_weights(r, z, inv_sigma2, valid, delta2):
    """Robust scalar weight per obs: info * trunc-huber(chi2) * valid * (z > 0)."""
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w_rob = lm.trunc_huber_weight(chi2, delta2)
    pos = (z > 1e-6).to(r.dtype)
    return inv_sigma2 * w_rob * valid * pos, chi2


def _robust_cost(r, z, inv_sigma2, valid, delta2):
    """Truncated-Huber cost; out-of-frustum observations sit on the plateau.
    One cost per problem of the observations' leading batch dims."""
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    rho = lm.trunc_huber_cost(chi2, delta2)
    rho = torch.where(z > 1e-6, rho, lm.trunc_plateau(delta2))
    return torch.sum(valid * rho, dim=-1)


def pose_only_visual(P0, R0, pts_w, obs: VisualObs, camera: Camera,
                     ext: factors.Extrinsics, iters: int = 40, bf=0.0, rtol: float = 0.0):
    """Optimize a single body pose against fixed world points; with obs.ur
    set, stereo / RGB-D rows add the u_right row (bf = fx * baseline).
    With a leading batch dim B (P0 (B, 3), R0 (B, 3, 3), pts_w (B, Np, 3),
    every obs field (B, O)) the B problems are solved together, each with
    its own cost, accept and damping (lm.lm_optimize's batch).
    Returns (P, R, chi2 (O,), n_inlier), each with the batch dim."""
    if P0.dim() > 1:
        pts_o = torch.gather(pts_w, -2, obs.pt[..., None].expand(obs.pt.shape + (3,)))
        pose = lambda P, R: (P[..., None, :], R[..., None, :, :])   # against every row
    else:
        pts_o = pts_w[obs.pt]
        pose = lambda P, R: (P, R)

    def per_obs(P, R):
        return obs_reproj(camera, ext, *pose(P, R), pts_o, obs, bf)

    def retract(x, dx):
        P, R = x
        return (P + dx[..., :3], R @ lie.so3_exp(dx[..., 3:6]))

    def make_fns(valid):
        def cost_fn(x):
            r, _, _, z, d2 = per_obs(*x)
            return _robust_cost(r, z, obs.inv_sigma2, valid, d2)

        def linearize_solve(x, lam):
            r, J_pr, _, z, d2 = per_obs(*x)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            H = torch.einsum('...o,...orc,...ord->...cd', w, J_pr, J_pr)
            g = torch.einsum('...o,...orc,...or->...c', w, J_pr, r)
            H = H + torch.diag_embed(lam[..., None] * torch.diagonal(H, dim1=-2, dim2=-1)
                                     + 1e-10)
            return lm.cho_solve_nan(H, -g)

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        r, _, _, z, d2 = per_obs(*x)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).to(valid0.dtype)

    (P, R), _, _ = lm.lm_two_phase((P0, R0), make_fns, obs.valid, classify, iters,
                                   p1_frac=0.5, rtol=rtol, enable=False)
    r, _, _, z, d2 = per_obs(P, R)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    inlier = (chi2 <= d2) & (z > 0) & (obs.valid > 0)
    return P, lie.so3_normalize_fast(R), chi2, torch.sum(inlier, dim=-1)


def visual_ba(P0, R0, pts0, obs: VisualObs, camera: Camera, ext: factors.Extrinsics,
              free_cam, pt_mask, iters: int = 10, lam0: float = 1e-4, bf=0.0,
              rtol: float = 0.0, two_phase: bool = True):
    """Joint camera + landmark BA in the full landmark-table index space.

    P0 (Nc, 3), R0 (Nc, 3, 3), pts0 (Np, 3); free_cam (Nc,) float {0, 1};
    pt_mask (Np,). With obs.ur set, stereo / RGB-D rows constrain the metric
    scale (bf = fx * baseline). Returns (P, R, pts, chi2 (O,), final cost,
    costs): `costs` is the cost curve, for each round its starting cost
    followed by the cost after every iteration."""
    Nc, Np = P0.shape[0], pts0.shape[0]
    obs = obs._replace(cam=obs.cam.to(torch.int64), pt=obs.pt.to(torch.int64))
    cam_k = obs.cam[:, None]

    def per_obs(x):
        P, R, pts = x
        return obs_reproj(camera, ext, P[obs.cam], R[obs.cam], pts[obs.pt], obs, bf)

    def retract(x, dx):
        P, R, pts = x
        dxc, dxp = dx
        return (P + dxc[:, :3], R @ lie.so3_exp(dxc[:, 3:6]), pts + dxp)

    def make_fns(valid):
        def cost_fn(x):
            r, _, _, z, d2 = per_obs(x)
            return _robust_cost(r, z, obs.inv_sigma2, valid, d2)

        def linearize_solve(x, lam):
            r, J_pr, J_pt, z, d2 = per_obs(x)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            o = lm.Observations(cam=cam_k, pt=obs.pt, Jc=J_pr[:, None], Jp=J_pt,
                                r=r, w=w)
            Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(
                o, free_cam, Nc, 6, Np, 3)
            return lm.schur_solve(Hcc, g_c, Hpp, g_p, Wcp, lam, free_cam, pt_mask)

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        r, _, _, z, d2 = per_obs(x)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).to(valid0.dtype)

    curve = []
    (P, R, pts), cost, _ = lm.lm_two_phase(
        (P0, R0, pts0), make_fns, obs.valid, classify, iters, lam0=lam0, rtol=rtol,
        enable=two_phase, curve=curve)
    R = lie.so3_normalize_fast(R)
    r, _, _, z, _ = per_obs((P, R, pts))
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    chi2 = torch.where(z > 0, chi2, torch.full_like(chi2, 1e9))
    return P, R, pts, chi2, cost, torch.stack(curve)
