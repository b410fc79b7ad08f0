"""Map seeding from metric depth (port of the RGB-D initialization pieces of
mc_slam_tpu/pipeline/system.py:418-463 and tracking_ctl.py:109).

The JAX package keeps these as SlamSystem methods reading `self.m`,
`self.cam`, `self.ext`, `self.frame_id` and `self.cfg`; here they are plain
functions of those values, for the port's SlamSystem to call.
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.pipeline import mapping
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
