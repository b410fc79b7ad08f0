"""Map initialization (port of the initialization pieces of
mc_slam_tpu/pipeline/system.py): seeding from metric depth (:418-463, with
tracking_ctl.py:109's prior) and the monocular two-view bootstrap
`try_initialize` (SlamSystem._try_initialize, :503-577).

The JAX package keeps these as SlamSystem methods reading `self.m`,
`self.cam`, `self.ext`, `self.frame_id` and `self.cfg`; here they are plain
functions of those values, for the port's SlamSystem to call.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.frontend import matching
from mc_slam_tpu_torch.geometry import init2view
from mc_slam_tpu_torch.imu.navstate import navstate_identity
from mc_slam_tpu_torch.pipeline import mapping, mapping_ctl
from mc_slam_tpu_torch.slam_map.mapstate import MapState
from mc_slam_tpu_torch.solver.factors import Extrinsics


def _depth_to_world(cam: Camera, ext: Extrinsics, uv, feat_depth, P_b, R_b):
    """Ideal pixel + depth -> world points under body pose (P_b, R_b)."""
    c = torch.stack([cam.cx, cam.cy])
    f = torch.stack([cam.fx, cam.fy])
    xn = (uv - c) / f
    Xc = torch.cat([xn * feat_depth[:, None], feat_depth[:, None]], dim=1)
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    Xb = (Rbc @ Xc[..., None])[..., 0] + pbc
    return (R_b @ Xb[..., None])[..., 0] + P_b


def _alloc_points(m: MapState, Xw, desc, pm1, level, ref_slot: int, order_sel,
                  n_levels: int, frame_id: int, angle=None):
    """Write new landmarks into free map slots, in feature order.

    order_sel: (F,) bool host mask of the features to add. Returns
    (m, feat_idx, slots) with the chosen feature indices and map slots as
    numpy arrays. The viewing normal is the unit direction from the
    reference keyframe's body position to the point; the JAX method writes
    Xw / dist, which is the same for its only caller (a keyframe at the
    origin) and not a unit vector for a keyframe elsewhere."""
    free_slots = np.nonzero(~m.mp_active.cpu().numpy())[0]
    feat_idx = np.nonzero(np.asarray(order_sel))[0]
    k = min(len(free_slots), len(feat_idx))
    feat_idx = feat_idx[:k]
    slots = free_slots[:k]
    if k == 0:
        return m, np.zeros(0, int), np.zeros(0, int)
    dev = m.mp_pos.device
    Xs = Xw.detach().cpu().numpy()[feat_idx]
    P_ref = m.kf_ns.P[ref_slot].cpu().numpy()
    dist = np.linalg.norm(Xs - P_ref, axis=1)
    lvl = np.asarray(level.cpu().numpy())[feat_idx].astype(np.float32)
    max_d = (dist * (1.2 ** lvl)).astype(np.float32)
    min_d = mapping.band_min_dist(max_d, n_levels).astype(np.float32)
    normal = ((Xs - P_ref) / np.maximum(dist, 1e-9)[:, None]).astype(np.float32)
    sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    fi = torch.as_tensor(feat_idx, dtype=torch.int64, device=dev)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    def put(field, value):
        out = field.clone()
        out[sl] = value
        return out

    kf_mp = m.kf_mp.clone()
    kf_mp[ref_slot, fi] = sl.to(torch.int32)
    m = m._replace(
        mp_pos=put(m.mp_pos, t(Xs)),
        mp_desc=put(m.mp_desc, desc[fi]),
        mp_pm1=put(m.mp_pm1, pm1[fi]),
        mp_normal=put(m.mp_normal, t(normal)),
        mp_min_dist=put(m.mp_min_dist, t(min_d)),
        mp_max_dist=put(m.mp_max_dist, t(max_d)),
        mp_ref_kf=put(m.mp_ref_kf, ref_slot),
        mp_angle=put(m.mp_angle, angle[fi]) if angle is not None else m.mp_angle,
        mp_first_kf=put(m.mp_first_kf, frame_id),
        mp_found=put(m.mp_found, 1.0),
        mp_visible=put(m.mp_visible, 1.0),
        mp_active=put(m.mp_active, True),
        kf_mp=kf_mp,
    )
    return m, feat_idx, slots


def _fresh_prior_info(pose_info):
    """15x15 prior information for a freshly (re)seated frame state, order
    [P, phi, V, dbg, dba]: `pose_info` on pose/velocity, window-BA-level
    confidence on the biases (see mc_slam_tpu/pipeline/tracking_ctl.py:109)."""
    d = np.full(15, float(pose_info), np.float32)
    d[9:12] = 1e6    # gyro bias: sigma ~1e-3 rad/s
    d[12:15] = 1e4   # accel bias: sigma ~1e-2 m/s^2
    return np.diag(d)


class InitAttempt(NamedTuple):
    """What one two-view attempt did (host values; `two_view` stays on the
    device)."""
    ok: bool                   # the map now holds two keyframes and the first points
    reset_ref: bool            # too few matches: make this frame the new reference
    n_matches: int
    two_view: init2view.TwoViewResult | None
    ba: mapping_ctl.BAStats | None


def try_initialize(m: MapState, st: mapping_ctl.MappingState,
                   cfg: mapping_ctl.MappingConfig, cam: Camera, ext: Extrinsics,
                   noise, ref, feats, uv, t, frame_id: int, imu_rows,
                   generator: torch.Generator | None = None, idx_samples=None):
    """Monocular initialization (Tracking::MonocularInitialization): match
    the reference frame against this one, solve the two-view geometry from
    200 8-point samples, rescale so that the median depth is 1, insert
    both frames as keyframes 0 and 1, allocate the triangulated points with
    their scale bands and normals, and run the whole-map visual BA.

    ref: (feats0, uv0, t0) of the reference frame; imu_rows: the (T, 7) IMU
    rows between the reference frame and this one, or None (they become
    keyframe 1's preintegration; the JAX package hands them to keyframe 0 and
    leaves keyframe 1 with none). idx_samples: (200, 8) sample indices; drawn from
    `generator` when not given. The host reads, one copy each:
    the match count, then ok / t / good / Xw of the two-view result.
    Returns (m, InitAttempt)."""
    f0, uv0, t0 = ref
    dev = uv.device
    idx, _, ok = matching.search_for_initialization(
        uv0, f0.desc_pm1, f0.valid, uv, feats.desc_pm1, feats.valid,
        radius=100.0, ratio=0.9, f0_angle=f0.angle, f1_angle=feats.angle)
    n = int(torch.sum(ok))
    if n < cfg.min_init_matches:
        return m, InitAttempt(False, True, n, None, None)
    c = torch.stack([cam.cx, cam.cy])
    f = torch.stack([cam.fx, cam.fy])
    xn0 = (uv0 - c) / f
    xn1 = ((uv - c) / f)[idx]
    w = ok.to(torch.float32)
    if idx_samples is None:
        idx_samples = init2view.draw_samples(w, generator=generator)
    res = init2view.initialize_two_view(idx_samples, xn0, xn1, w, float(cam.fx))
    N = xn0.shape[0]
    host = torch.cat([res.ok.to(torch.float32).reshape(1), res.t, res.R.reshape(-1),
                      res.good.to(torch.float32), res.Xw.reshape(-1),
                      idx.to(torch.float32)]).cpu().numpy()
    if host[0] < 0.5:
        return m, InitAttempt(False, False, n, res, None)
    C1, R1 = host[1:4], host[4:13].reshape(3, 3)
    good = host[13:13 + N] > 0.5
    Xw = host[13 + N:13 + 4 * N].reshape(N, 3)
    idx_h = host[13 + 4 * N:].astype(np.int64)
    # scale: the median depth of the good points -> 1 (CreateInitialMapMonocular)
    med = float(np.median(Xw[good][:, 2])) if good.sum() else 1.0
    if med <= 1e-6:
        return m, InitAttempt(False, False, n, res, None)
    scale = 1.0 / med
    Xw = Xw * scale
    C1 = C1 * scale

    # keyframe 0 at the camera origin, keyframe 1 at (R, C1); stored as body
    # poses through the extrinsics
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ns0 = navstate_identity(device=dev)
    m = mapping_ctl.insert_keyframe(m, st, len(st.kf_slots), ns0, f0, uv0, t0, frame_id,
                                    None, noise, cam_frame=True, ext=ext)
    slot1 = len(st.kf_slots)
    m = mapping_ctl.insert_keyframe(m, st, slot1, ns0._replace(P=t32(C1), R=t32(R1)),
                                    feats, uv, t, frame_id, imu_rows, noise,
                                    cam_frame=True, ext=ext)
    # map points and associations, in feature order, into slots 0 .. n_good-1
    good_idx = np.nonzero(good)[0]
    Xg = Xw[good_idx].astype(np.float32)
    dist = np.linalg.norm(Xg, axis=1).astype(np.float32)
    lvl = f0.level.cpu().numpy()[good_idx].astype(np.float32)
    max_d = dist * (1.2 ** lvl)
    min_d = mapping.band_min_dist(max_d, cfg.n_levels)
    k = len(good_idx)
    gi = torch.as_tensor(good_idx, device=dev)
    gi1 = torch.as_tensor(idx_h[good_idx], device=dev)
    slots32 = torch.arange(k, dtype=torch.int32, device=dev)

    def head(field, value):
        out = field.clone()
        out[:k] = value
        return out

    kf_mp = m.kf_mp.clone()
    kf_mp[0, gi] = slots32
    kf_mp[slot1, gi1] = slots32
    m = m._replace(
        mp_pos=head(m.mp_pos, t32(Xg)),
        mp_desc=head(m.mp_desc, f0.desc[gi]),
        mp_pm1=head(m.mp_pm1, f0.desc_pm1[gi]),
        mp_normal=head(m.mp_normal, t32(Xg / np.maximum(dist, 1e-9)[:, None])),
        mp_min_dist=head(m.mp_min_dist, t32(min_d)),
        mp_max_dist=head(m.mp_max_dist, t32(max_d)),
        mp_ref_kf=head(m.mp_ref_kf, 0),
        mp_angle=head(m.mp_angle, f0.angle[gi]),
        mp_first_kf=head(m.mp_first_kf, 0),
        mp_found=head(m.mp_found, 2.0),
        mp_visible=head(m.mp_visible, 2.0),
        mp_active=head(m.mp_active, True),
        kf_mp=kf_mp)
    # the initial visual BA over the two views (GlobalBundleAdjustment(20))
    gw = torch.zeros(3, device=dev)         # no factor reads gravity before VI init
    m, ba_stats = mapping_ctl.local_ba(m, st, cfg, cam, ext, gw, noise, force_all=True)
    return m, InitAttempt(True, False, n, res, ba_stats)
