"""Per-frame tracking programs (port of mc_slam_tpu/pipeline/tracking.py).

Map-point projection search + pose optimization (TrackWithMotionModel /
TrackLocalMap and the IMU variants, src/Tracking.cpp:224-412), fused into two
search -> optimize rounds against the whole active map, and the per-frame VI
program `frame_pipeline_vi` (extract, undistort, preintegrate, track, 40 px
visual fallback, trajectory row) and its chained N-frame form
`frame_pipeline_vi_pair` (the frame loop's unit after VI init). With a depth
sensor (stereo / RGB-D) the frame's virtual right-image u (`feat_ur`, -1
where a feature has no depth) adds the u_right row to the pose solves (bf =
fx * baseline) and the inlier gate takes CHI2_STEREO on those rows; the
frame programs then take features extracted by the caller (`frame`),
because the depth lookup needs them first.

Differences of form from the JAX package, none of semantics:
* `.at[...].set(..., mode="drop")` scatters write into a buffer with one
  extra dummy slot that is sliced off (torch has no drop mode; `_set_drop`).
* The `lax.cond` fallbacks are a host `if` on one flag: ONE device->host
  sync per frame.
* The found/visible scatter marks every map point that some feature matched
  (`_seen_mask`); the JAX form also writes False for unmatched features
  through slot 0, so that slot's counter depends on scatter order there.
* `track_frame_visual` (and the functions it calls) takes B problems at once
  in place of `jax.vmap`: a stacked MapState, Features and poses with a
  leading dim B (parallel/multiseq.py). Without it, the call is the
  single-sequence one, unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera, undistort_points
from mc_slam_tpu_torch.frontend import extractor, matching
from mc_slam_tpu_torch.frontend.extractor import Features
from mc_slam_tpu_torch.geometry import pnp
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import predict_navstate, preintegrate
from mc_slam_tpu_torch.slam_map.mapstate import MapState, _set_drop_batched
from mc_slam_tpu_torch.solver import ba, ba_vi, factors
from mc_slam_tpu_torch.solver.ba import VisualObs
from mc_slam_tpu_torch.utils.metrics import span


class TrackResult(NamedTuple):
    P: torch.Tensor          # (3,) optimized body position
    R: torch.Tensor          # (3, 3)
    feat_mp: torch.Tensor    # (F,) int32 map-point index per feature (-1 none)
    n_matches: torch.Tensor  # () matches fed to the optimizer
    n_inliers: torch.Tensor  # () chi2-inliers after optimization


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def project_map_points(m: MapState, cam: Camera, ext: factors.Extrinsics, P, R):
    """Project all active map points into the frame at body pose (P, R).
    Returns (uv (Pn, 2), z (Pn,), visible (Pn,) bool): isInFrustum
    (src/Frame.cpp:492) with the distance and viewing-cone gates. A batch:
    P (B, 3), R (B, 3, 3) against a stacked map; outputs (B, Pn, .)."""
    if P.dim() > 1:
        P, R = P[..., None, :], R[..., None, :, :]    # one pose against every row
    Pb = _mv(R.transpose(-1, -2), m.mp_pos - P)
    Pc = _mv(ext.Rcb, Pb) + ext.tcb
    z = Pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Pc[..., 0] / z_safe + cam.cx
    v = cam.fy * Pc[..., 1] / z_safe + cam.cy
    vis = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) \
        & m.mp_active
    dist = torch.linalg.norm(Pb, dim=-1)
    vis = vis & (dist >= 0.5 * m.mp_min_dist) \
        & (dist <= 1.5 * torch.clamp(m.mp_max_dist, min=1e-6))
    Cw = P - _mv(R, _mv(ext.Rcb.transpose(-1, -2), ext.tcb))
    dir_w = m.mp_pos - Cw
    view_cos = torch.sum(dir_w * m.mp_normal, -1) \
        / torch.clamp(torch.linalg.norm(dir_w, dim=-1), min=1e-9)
    has_normal = torch.sum(m.mp_normal * m.mp_normal, -1) > 0.25
    vis = vis & ((view_cos > 0.5) | ~has_normal)
    return torch.stack([u, v], -1), z, vis


def last_frame_angles(m: MapState, prev_feat_mp, prev_angle):
    """Scatter the previous frame's keypoint angles onto map-point slots.
    Returns (angle (P,), seen (P,) bool), with the inputs' batch dims."""
    tgt = torch.where(prev_feat_mp >= 0, prev_feat_mp, m.P).to(torch.int64)
    shape = prev_feat_mp.shape[:-1] + (m.P,)
    angle = _set_drop_batched(torch.zeros(shape, dtype=prev_angle.dtype,
                                          device=prev_angle.device), tgt, prev_angle)
    seen = _set_drop_batched(torch.zeros(shape, dtype=torch.bool, device=prev_angle.device),
                             tgt, True)
    return angle, seen


def predict_level(m: MapState, P, dist_scale=1.2, n_levels=8):
    """Predicted pyramid level from distance (MapPoint::PredictScale)."""
    if P.dim() > 1:
        P = P[..., None, :]
    d = torch.linalg.norm(m.mp_pos - P, dim=-1)
    ratio = torch.clamp(m.mp_max_dist, min=1e-6) / torch.clamp(d, min=1e-6)
    log_scale = float(np.log(np.float32(dist_scale)))   # float32 log, as jnp.log
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_scale)
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)


def _invert_matches(m: MapState, mp_idx, ok, Fn):
    """(map point -> feature) to (feature -> map point), accepted matches only;
    duplicates are already resolved per feature."""
    feat_mp = torch.full(mp_idx.shape[:-1] + (Fn,), -1, dtype=torch.int32,
                         device=mp_idx.device)
    return _set_drop_batched(feat_mp, torch.where(ok, mp_idx, Fn),
                             torch.arange(m.P, dtype=torch.int32, device=mp_idx.device))


def _seen_mask(m: MapState, feat_mp):
    """(P,) bool: map points matched by some feature."""
    tgt = torch.where(feat_mp >= 0, feat_mp, m.P).to(torch.int64)
    return _set_drop_batched(torch.zeros(feat_mp.shape[:-1] + (m.P,), dtype=torch.bool,
                                         device=feat_mp.device), tgt, True)


def _search(m, feats, uv_ideal, cam, ext, P, R, radius, inv_sigma2,
            mp_last_angle, mp_seen_last, feat_ur=None):
    """One projection search against the active map; returns the pose-only
    observation table (with the u_right column `feat_ur`), feat_mp and the
    matched mask."""
    with span("tracking.search"):
        Fn = feats.valid.shape[-1]
        proj_uv, _, vis = project_map_points(m, cam, ext, P, R)
        lvl = predict_level(m, P)
        mp_idx, _, ok = matching.search_by_projection(
            proj_uv, vis, lvl, m.mp_desc, m.mp_pm1, uv_ideal, feats.level,
            feats.desc, feats.desc_pm1, feats.valid, radius_px=radius,
            proj_angle=mp_last_angle, feat_angle=feats.angle,
            proj_angle_valid=mp_seen_last)
        feat_mp = _invert_matches(m, mp_idx, ok, Fn)
        matched = feat_mp >= 0
        obs = VisualObs(cam=torch.zeros(feat_mp.shape, dtype=torch.int64, device=uv_ideal.device),
                        pt=torch.clamp(feat_mp, 0, m.P - 1).to(torch.int64),
                        uv=uv_ideal, inv_sigma2=inv_sigma2,
                        valid=matched.to(torch.float32), ur=feat_ur)
        return obs, feat_mp, matched


def _level_info(feats: Features):
    return 1.0 / (1.2 ** (2.0 * feats.level.to(torch.float32)))


def track_frame_visual(m: MapState, feats: Features, uv_ideal, cam: Camera,
                       ext: factors.Extrinsics, P0, R0, radius_coarse=15.0,
                       radius_fine=4.0, iters: int = 20, feat_ur=None, bf=0.0,
                       rtol: float = 0.0, prev_feat_mp=None, prev_angle=None) -> TrackResult:
    """Two-round project -> match -> optimize against the active map.
    feat_ur: optional (F,) observed virtual right-image u (stereo / RGB-D;
    < 0: no depth), the u_right row of the pose solve (bf = fx * baseline).
    B sequences at once: a stacked map, Features and uv_ideal with a leading
    B, P0 (B, 3), R0 (B, 3, 3); one kernel launch a round for all B, and
    every field of the result carries the B."""
    inv_sigma2 = _level_info(feats)
    if prev_feat_mp is not None:
        mp_last_angle, mp_seen_last = last_frame_angles(m, prev_feat_mp, prev_angle)
    else:
        mp_last_angle = mp_seen_last = None

    def one_round(P, R, radius):
        obs, feat_mp, matched = _search(m, feats, uv_ideal, cam, ext, P, R, radius,
                                        inv_sigma2, mp_last_angle, mp_seen_last, feat_ur)
        with span("tracking.solve"):
            Pn, Rn, chi2, n_in = ba.pose_only_visual(P, R, m.mp_pos, obs, cam, ext,
                                                     iters=iters, bf=bf, rtol=rtol)
        inlier = matched & (chi2 <= ba.chi2_gate(feat_ur))
        return Pn, Rn, torch.where(inlier, feat_mp, -1), torch.sum(matched, dim=-1), n_in

    P1, R1, _, _, _ = one_round(P0, R0, radius_coarse)
    P2, R2, fmp2, nm2, ni2 = one_round(P1, R1, radius_fine)
    return TrackResult(P=P2, R=R2, feat_mp=fmp2, n_matches=nm2, n_inliers=ni2)


def track_frame_visual_step(m: MapState, feats: Features, uv_ideal, cam: Camera,
                            ext: factors.Extrinsics, P_last, R_last, dP, dR,
                            iters: int = 20, feat_ur=None, bf=0.0, rtol: float = 0.0,
                            prev_feat_mp=None, prev_angle=None):
    """Velocity-model prediction + track_frame_visual + velocity update +
    found/visible counters. Returns (res, (dP', dR'), mp_found, mp_visible)."""
    P0 = P_last + _mv(R_last, dP)
    R0 = R_last @ dR
    res = track_frame_visual(m, feats, uv_ideal, cam, ext, P0, R0, iters=iters,
                             feat_ur=feat_ur, bf=bf, rtol=rtol, prev_feat_mp=prev_feat_mp,
                             prev_angle=prev_angle)
    RlT = R_last.transpose(-1, -2)
    vel = (_mv(RlT, res.P - P_last), RlT @ res.R)
    fv = _seen_mask(m, res.feat_mp).to(m.mp_found.dtype)
    return res, vel, m.mp_found + fv, m.mp_visible + fv


def track_frame_vi(m: MapState, feats: Features, uv_ideal, cam: Camera,
                   ext: factors.Extrinsics, ns_cur0, ns_last, pre_last_cur, gw,
                   prior_last: ba_vi.PriorFactor, radius_coarse=15.0,
                   radius_fine=4.0, iters: int = 20, sigma_bg=2e-5, sigma_ba=5e-3,
                   feat_ur=None, bf=0.0, rtol: float = 0.0, prev_feat_mp=None,
                   prev_angle=None):
    """VI tracking: IMU-predicted pose, projection search, joint (last, cur)
    optimization with IMU + prior factors, marginal extraction
    (TrackWithIMU + TrackLocalMapWithIMU, src/Tracking.cpp:224-412).
    Returns (ns2, feat_mp, n_matches, n_inliers, H_marg)."""
    inv_sigma2 = _level_info(feats)
    info_prv = factors.imu_prv_info(pre_last_cur)
    info_bias = factors.bias_rw_info(pre_last_cur.dT, sigma_bg, sigma_ba)
    if prev_feat_mp is not None:
        mp_last_angle, mp_seen_last = last_frame_angles(m, prev_feat_mp, prev_angle)
    else:
        mp_last_angle = mp_seen_last = None

    obs1, _, _ = _search(m, feats, uv_ideal, cam, ext, ns_cur0.P, ns_cur0.R,
                         radius_coarse, inv_sigma2, mp_last_angle, mp_seen_last, feat_ur)
    with span("tracking.solve"):
        ns1, _, _, _ = ba_vi.pose_only_vi(
            ns_cur0, ns_last, pre_last_cur, m.mp_pos, obs1, cam, ext, gw, prior_last,
            info_prv, info_bias, iters=iters, compute_marg=False, bf=bf, rtol=rtol)
    obs2, feat_mp, matched = _search(m, feats, uv_ideal, cam, ext, ns1.P, ns1.R,
                                     radius_fine, inv_sigma2, mp_last_angle,
                                     mp_seen_last, feat_ur)
    with span("tracking.solve"):
        ns2, chi2, n_in, H_marg = ba_vi.pose_only_vi(
            ns1, ns_last, pre_last_cur, m.mp_pos, obs2, cam, ext, gw, prior_last,
            info_prv, info_bias, iters=iters, compute_marg=True, bf=bf, rtol=rtol)
    inlier = matched & (chi2 <= ba.chi2_gate(feat_ur))
    return ns2, torch.where(inlier, feat_mp, -1), torch.sum(matched), n_in, H_marg


def reloc_candidates_batch(m: MapState, cand_slots, idx, desc_pm1, feat_valid,
                           feat_angle, xn, focal,
                           generator: torch.Generator | None = None, n_iters: int = 256):
    """Relocalization candidate evaluation for C keyframes as one batched
    pass (Tracking::Relocalization's per-candidate loop): mutual descriptor
    matching of the frame against each candidate's landmark features, then
    PnP RANSAC on the matched 2D-3D pairs.

    cand_slots: (C,) int64; idx: (C, n, 6) int64 sample indices, or None to
    draw n_iters of them a candidate from `generator` (the JAX package's
    pnp_ransac draws 256; `SlamConfig.pnp_iters`); xn: (F, 2) normalized ideal
    coordinates.
    Returns (C, 15) rows [n_match, pnp_ok, pnp_inliers, R_cw (9), t_cw (3)]:
    ONE host read decides which candidate (if any) to refine."""
    mp_k = m.kf_mp[cand_slots]                                   # (C, F)
    has = (mp_k >= 0) & m.kf_feat_valid[cand_slots]
    midx, _, okm = matching.mutual_match(
        desc_pm1, feat_valid, m.kf_pm1[cand_slots], has, max_dist=matching.TH_LOW,
        ratio=0.85, angle_a=feat_angle, angle_b=m.kf_angle[cand_slots])
    Xw = m.mp_pos[torch.clamp(torch.gather(mp_k, 1, midx), 0, m.P - 1).to(torch.int64)]
    w = okm.to(torch.float32)
    if idx is None:
        idx = pnp.draw_samples(generator, w, n_iters, 6)
    res = pnp.pnp_ransac(idx, Xw, xn, w, focal, min_inliers=12)
    C = cand_slots.shape[0]
    return torch.cat([torch.sum(okm, dim=-1).to(torch.float32)[:, None],
                      res.ok.to(torch.float32)[:, None],
                      res.n_inliers.to(torch.float32)[:, None],
                      res.R_cw.reshape(C, 9), res.t_cw], dim=1)


def _traj_row(m: MapState, P, R, anchor_slot):
    """Pose of this frame relative to its anchor keyframe
    (mlRelativeFramePoses, src/Tracking.cpp:1123). Returns (P_rel, R_rel, P, R)."""
    Pk = m.kf_ns.P[anchor_slot]
    RkT = m.kf_ns.R[anchor_slot].transpose(-1, -2)
    return _mv(RkT, P - Pk), RkT @ R, P, R


def _bias_jump(ns2, ns_last):
    return ((torch.amax(torch.abs(ns2.dbg - ns_last.dbg)) > 0.05)
            | (torch.amax(torch.abs(ns2.dba - ns_last.dba)) > 0.5))


def _extracted(img, cam, frame, n_features, n_levels):
    """(feats, uv) of the frame: `frame` when the caller extracted it, else
    ORB extraction of `img` and undistortion."""
    if frame is not None:
        return frame
    feats = extractor.extract(img, n_features=n_features, n_levels=n_levels)
    return feats, undistort_points(cam, feats.xy)


def _vi_frame_body(m: MapState, img, rawp, cam, ext, noise, ns_last, gw,
                   prior_last, pfm, pan, anchor_slot, dt_f, fresh_prior_fb,
                   sigma_bg, sigma_ba, n_features, n_levels, iters, rtol,
                   fb_min_inliers, frame=None, feat_ur=None, bf=0.0):
    """One VI frame: ORB extraction, undistortion, IMU prediction (the span
    "imu.preintegrate"), track_frame_vi, and the wide-window visual fallback
    (mono rows only, as the JAX package's).
    Returns (feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary_row)."""
    feats, uv = _extracted(img, cam, frame, n_features, n_levels)
    with span("imu.preintegrate"):
        pre_last_cur = preintegrate(rawp, ns_last.bg_full, ns_last.ba_full, noise)
        ns_cur0 = predict_navstate(ns_last, pre_last_cur, gw)
    ns2, feat_mp, n_m, n_in, H_marg = track_frame_vi(
        m, feats, uv, cam, ext, ns_cur0, ns_last, pre_last_cur, gw, prior_last,
        iters=iters, sigma_bg=sigma_bg, sigma_ba=sigma_ba, feat_ur=feat_ur, bf=bf,
        rtol=rtol, prev_feat_mp=pfm, prev_angle=pan)
    bias_jump = _bias_jump(ns2, ns_last)
    H_prior = 0.5 * (H_marg + H_marg.T) + 1e-3 * torch.eye(
        15, dtype=H_marg.dtype, device=H_marg.device)
    need_fb = (n_in < fb_min_inliers) | bias_jump

    ns_f, fmp_f, Hp_f, nin_f = ns2, feat_mp, H_prior, n_in
    used_fb = torch.zeros((), dtype=torch.bool, device=n_in.device)
    if bool(need_fb):            # the one device->host sync of the frame
        resv = track_frame_visual(m, feats, uv, cam, ext, ns_last.P, ns_last.R,
                                  radius_coarse=40.0, iters=iters,
                                  prev_feat_mp=pfm, prev_angle=pan)
        take = (resv.n_inliers > n_in) | bias_jump
        V_est = (resv.P - ns_last.P) / max(float(dt_f), 1e-3)
        ns_fb = ns_last._replace(P=resv.P, R=resv.R, V=V_est)
        ns_f = NavState(*[torch.where(take, a, b) for a, b in zip(ns_fb, ns2)])
        fmp_f = torch.where(take, resv.feat_mp, feat_mp)
        Hp_f = torch.where(take, fresh_prior_fb, H_prior)
        nin_f = torch.where(take, resv.n_inliers, n_in)
        used_fb = take
    fv = _seen_mask(m, fmp_f).to(m.mp_found.dtype)
    traj = _traj_row(m, ns_f.P, ns_f.R, anchor_slot)
    summary = torch.stack([nin_f.to(torch.float32), bias_jump.to(torch.float32),
                           used_fb.to(torch.float32), n_m.to(torch.float32)])
    return feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary


def frame_pipeline_vi(m: MapState, img, rawp, cam: Camera, ext: factors.Extrinsics,
                      noise, ns_last, gw, prior_last: ba_vi.PriorFactor,
                      prev_feat_mp, prev_angle, anchor_slot, dt_f, fresh_prior_fb,
                      sigma_bg=2e-5, sigma_ba=5e-3, n_features=1024, n_levels=8,
                      iters: int = 20, rtol: float = 0.0, has_prev: bool = True,
                      fb_min_inliers=20, frame=None, feat_ur=None, bf=0.0):
    """One VI frame (see _vi_frame_body). rawp: (T, 7) [gyro, acc, dt] rows
    since the last frame; pass the real rows (zero-dt padding rows are no-ops
    that only cost time). fresh_prior_fb: (15, 15) prior info used when the
    fallback is taken. frame: (feats, uv) extracted by the caller (img is
    then not read); feat_ur / bf: the depth sensor's u_right rows.

    Returns (feats, uv, ns2, feat_mp, H_prior, mp_found, mp_vis,
    traj (P_rel, R_rel, P_abs, R_abs), summary [n_in, bias_jump, used_fb,
    n_matches])."""
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary = _vi_frame_body(
        m, img, rawp, cam, ext, noise, ns_last, gw, prior_last, pfm, pan,
        anchor_slot, dt_f, fresh_prior_fb, sigma_bg, sigma_ba, n_features,
        n_levels, iters, rtol, fb_min_inliers, frame, feat_ur, bf)
    return (feats, uv, ns_f, fmp_f, Hp_f, m.mp_found + fv, m.mp_visible + fv,
            traj, summary)


def frame_pipeline_vi_pair(m: MapState, imgs, rawps, cam: Camera, ext: factors.Extrinsics,
                           noise, ns_last, gw, prior_last: ba_vi.PriorFactor,
                           prev_feat_mp, prev_angle, anchor_slot, dts, fresh_prior_fb,
                           sigma_bg=2e-5, sigma_ba=5e-3, n_features=1024, n_levels=8,
                           iters: int = 20, rtol: float = 0.0, has_prev: bool = True,
                           fb_min_inliers=20):
    """N consecutive VI frames, each chained on the one before it (NavState,
    the marginal prior `PriorFactor(info=Hp)`, the previous frame's
    associations and angles), against the same map: the frame loop's unit of
    dispatch after VI init (the JAX package fuses them into one program; here
    they are N `_vi_frame_body` calls back to back, and the gain is one
    summary copy and one harvest per N frames).

    imgs: N images; rawps: N (T_i, 7) IMU spans, each with its real rows;
    dts: N frame periods. Returns (frames, H_prior_last, mp_found, mp_vis,
    summary) with frames an N-tuple of (feats, uv, feat_mp, ns, traj) and
    summary ONE (N, 4) tensor [n_in, bias_jump, used_fb, n_matches]; the
    found / visible counters add every frame's matches."""
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    ns, prior = ns_last, prior_last
    fv_tot = None
    outs, sums = [], []
    for img, rawp, dt_f in zip(imgs, rawps, dts):
        feats, uv, ns, fmp, Hp, fv, traj, s = _vi_frame_body(
            m, img, rawp, cam, ext, noise, ns, gw, prior, pfm, pan, anchor_slot, dt_f,
            fresh_prior_fb, sigma_bg, sigma_ba, n_features, n_levels, iters, rtol,
            fb_min_inliers)
        prior = ba_vi.PriorFactor(cam=prior_last.cam, ns0=ns, info=Hp, valid=prior_last.valid)
        pfm, pan = fmp, feats.angle
        fv_tot = fv if fv_tot is None else fv_tot + fv
        outs.append((feats, uv, fmp, ns, traj))
        sums.append(s)
    return (tuple(outs), prior.info, m.mp_found + fv_tot, m.mp_visible + fv_tot,
            torch.stack(sums))


def frame_pipeline_visual(m: MapState, img, cam: Camera, ext: factors.Extrinsics,
                          P_last, R_last, dP, dR, prev_feat_mp, prev_angle,
                          anchor_slot, min_inliers, n_features=1024, n_levels=8,
                          iters: int = 20, rtol: float = 0.0,
                          has_prev: bool = True, frame=None, feat_ur=None, bf=0.0):
    """One visual frame: extraction, undistortion, velocity-model tracking
    and the wide-window retry from the last pose (one host sync on its flag).
    frame: (feats, uv) extracted by the caller (img is then not read);
    feat_ur / bf: the depth sensor's u_right rows, in both attempts.

    Returns (feats, uv, res, vel (dP, dR), mp_found, mp_vis, traj,
    summary [n_in, used_fb, n_matches])."""
    feats, uv = _extracted(img, cam, frame, n_features, n_levels)
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    res, vel, _, _ = track_frame_visual_step(
        m, feats, uv, cam, ext, P_last, R_last, dP, dR, iters=iters, feat_ur=feat_ur,
        bf=bf, rtol=rtol, prev_feat_mp=pfm, prev_angle=pan)
    res_f, vel_f = res, vel
    used_fb = torch.zeros((), dtype=torch.bool, device=uv.device)
    if bool(res.n_inliers < min_inliers):
        r2 = track_frame_visual(m, feats, uv, cam, ext, P_last, R_last,
                                radius_coarse=40.0, iters=iters, feat_ur=feat_ur, bf=bf)
        take = r2.n_inliers > res.n_inliers
        res_f = TrackResult(*[torch.where(take, a, b) for a, b in zip(r2, res)])
        RlT = R_last.transpose(-1, -2)
        vel_f = (_mv(RlT, res_f.P - P_last), RlT @ res_f.R)
        used_fb = take
    fv = _seen_mask(m, res_f.feat_mp).to(m.mp_found.dtype)
    traj = _traj_row(m, res_f.P, res_f.R, anchor_slot)
    summary = torch.stack([res_f.n_inliers.to(torch.float32),
                           used_fb.to(torch.float32),
                           res_f.n_matches.to(torch.float32)])
    return (feats, uv, res_f, vel_f, m.mp_found + fv, m.mp_visible + fv, traj,
            summary)
