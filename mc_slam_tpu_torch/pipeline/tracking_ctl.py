"""Per-frame control of tracking (port of the keyframe decision of
mc_slam_tpu/pipeline/tracking_ctl.py and of the per-frame decisions of
frameloop.py, `_dispatch_frame_visual` / `_dispatch_frame_vi` followed by
`_harvest_one`), in synchronous form: a frame is tracked, its summary is
read, and its decisions (LOST, keyframe -> event, VI-init attempt) are taken
before the next frame. Module functions over an explicit `TrackState` and
the `MappingState` of mapping_ctl; the orchestrator class comes later.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState, navstate_identity
from mc_slam_tpu_torch.imu.preintegration import IMUNoise
from mc_slam_tpu_torch.pipeline import mapping_ctl, system, tracking, viinit_ctl
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import MapState, observation_counts
from mc_slam_tpu_torch.solver import ba_vi, factors

OK = "ok"
LOST = "lost"


@dataclasses.dataclass
class TrackState:
    """What tracking carries from frame to frame (SlamSystem's per-frame
    state): the last pose and the constant-velocity model before VI init,
    the last NavState, marginal prior and gravity after it, the last frame's
    associations and keypoint angles, the IMU rows since the last keyframe
    and since the last frame, and the trajectory log."""
    state: str
    P: torch.Tensor                 # (3,) last body position
    R: torch.Tensor                 # (3, 3)
    dP: torch.Tensor                # velocity model: relative motion of the last step
    dR: torch.Tensor
    gw: torch.Tensor                # (3,) gravity in world
    prev_feat_mp: torch.Tensor      # (F,) int32
    prev_angle: torch.Tensor        # (F,)
    has_prev: bool = False
    n_inliers: int = 0
    ns: NavState | None = None      # after VI init
    prior: ba_vi.PriorFactor | None = None
    imu_since_kf: list = dataclasses.field(default_factory=list)
    imu_since_frame: list = dataclasses.field(default_factory=list)
    traj: TrajStore = dataclasses.field(default_factory=TrajStore)
    last_time: float = 0.0


class FrameOutcome(NamedTuple):
    state: str                      # OK or LOST
    n_inliers: int
    used_fallback: bool
    keyframe: int | None            # the slot of the keyframe this frame became
    event: mapping_ctl.EventResult | None
    vi: viinit_ctl.VIAttempt | None


def start_tracking(m: MapState, st: mapping_ctl.MappingState, g_mag: float,
                   t: float) -> TrackState:
    """The tracking state right after monocular initialization: at the newest
    keyframe's pose, zero velocity model, gravity along -z until VI init
    estimates it."""
    dev = m.mp_pos.device
    P, R = m.kf_ns.P[st.last_kf_slot], m.kf_ns.R[st.last_kf_slot]
    gw = torch.cat([torch.zeros(2, device=dev), torch.full((1,), -g_mag, device=dev)])
    return TrackState(state=OK, P=P, R=R, dP=torch.zeros(3, device=dev),
                      dR=torch.eye(3, device=dev), gw=gw,
                      prev_feat_mp=torch.full((m.F,), -1, dtype=torch.int32, device=dev),
                      prev_angle=torch.zeros(m.F, device=dev), last_time=t)


def need_new_kf(m: MapState, st: mapping_ctl.MappingState,
                cfg: mapping_ctl.MappingConfig, fid: int, n_inliers: int) -> bool:
    """NeedNewKeyFrame (src/Tracking.cpp:1865): never within kf_min_gap
    frames of the last keyframe, always after kf_max_gap; in between, when
    the frame tracks fewer than kf_ref_ratio of the reference keyframe's
    WELL-OBSERVED points (min_obs 2 while the map has two keyframes, 3 after)
    and still more than 15. The reference count comes from the last event's
    stats; before the first event it is read from the device, one copy, and
    kept (tracking never edits keyframe observation rows)."""
    since = fid - st.last_kf_frame
    if since < cfg.kf_min_gap:
        return False
    if since >= cfg.kf_max_gap:
        return True
    if st.ref_tracked is None:
        mp_ref = m.kf_mp[st.last_kf_slot]
        obs_n = observation_counts(m)
        min_obs = 2 if len(st.kf_slots) <= 2 else 3
        well = (mp_ref >= 0) & (obs_n[torch.clamp(mp_ref, 0, m.P - 1).to(torch.int64)]
                                >= min_obs)
        st.ref_tracked = int(torch.sum(well))
    return (n_inliers < cfg.kf_ref_ratio * max(st.ref_tracked, 1)) and n_inliers > 15


def create_keyframe(m: MapState, st: mapping_ctl.MappingState, ts: TrackState, feats,
                    uv, t, fid: int, feat_mp, noise: IMUNoise):
    """The tracked frame becomes a keyframe: its pose (its NavState after VI
    init), THIS frame's tracked associations, the IMU rows since the last
    keyframe. Returns (m, slot)."""
    dev = m.mp_pos.device
    ns = ts.ns if st.vi_inited else navstate_identity(device=dev)._replace(P=ts.P, R=ts.R)
    rows = torch.cat(ts.imu_since_kf) if ts.imu_since_kf else None
    slot = len(st.kf_slots)
    m = mapping_ctl.insert_keyframe(m, st, slot, ns, feats, uv, t, fid, rows, noise,
                                    feat_mp=feat_mp)
    ts.imu_since_kf = []
    return m, slot


def _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer):
    """One keyframe event and its state carry: the stats the next decisions
    use (ONE device->host copy), tracking re-seated on the optimised newest
    keyframe (after VI init with a fresh prior, the marginal one is stale)."""
    m, res = mapping_ctl.keyframe_event(m, st, cfg, fid, cam, ext, ts.gw, noise,
                                        timer=event_timer)
    host = torch.cat([res.stats[4].to(torch.float32).reshape(1),
                      res.stats[0]]).cpu().numpy()
    mapping_ctl.note_event_stats(st, host[1:], host[0])
    slot = st.last_kf_slot
    ts.P, ts.R = m.kf_ns.P[slot], m.kf_ns.R[slot]
    if st.vi_inited:
        ts.ns = mapping_ctl.keyframe_navstate(m, slot)
        ts.prior = None
        ts.imu_since_frame = list(ts.imu_since_kf)
    return m, res


def track_visual(m: MapState, st: mapping_ctl.MappingState,
                 cfg: mapping_ctl.MappingConfig, ts: TrackState, img, t, fid: int,
                 imu_rows, cam: Camera, ext: factors.Extrinsics, noise: IMUNoise,
                 n_features=1024, iters: int = 20, event_timer=None, vi_mark=None):
    """One frame before VI initialization: `tracking.frame_pipeline_visual`,
    then the decisions of `_harvest_one` on its summary (one host read):
    LOST below min_track_inliers, else the state carry, the trajectory row,
    keyframe -> event when `need_new_kf` says so, and the VI-init attempt.

    The JAX package tries its reference-keyframe fallback (descriptor
    matching against the last keyframe + PnP RANSAC) before it declares a
    frame lost; PnP is not ported yet, so this function returns LOST where
    that fallback would have been tried.

    imu_rows: (T, 7) rows since the last frame (kept for the next keyframe's
    preintegration), or None. Returns (m, FrameOutcome); `ts` and `st` are
    updated in place."""
    if imu_rows is not None and imu_rows.shape[0]:
        ts.imu_since_kf.append(imu_rows)
    anchor = st.last_kf_slot
    (feats, uv, res, vel, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_visual(
        m, img, cam, ext, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp, ts.prev_angle,
        anchor, cfg.min_track_inliers, n_features=n_features, n_levels=cfg.n_levels,
        iters=iters, has_prev=ts.has_prev)
    s = summary.cpu().numpy()
    n_in, used_fb = int(s[0]), bool(s[1])
    if n_in < cfg.min_track_inliers:
        ts.state, ts.has_prev = LOST, False
        return m, FrameOutcome(LOST, n_in, used_fb, None, None, None)
    ts.dP, ts.dR = vel
    ts.P, ts.R = res.P, res.R
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = res.feat_mp, feats.angle, True
    ts.n_inliers, ts.last_time = n_in, t
    m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
    ts.traj.append(traj_row, t, anchor, st.kf_id_host.get(anchor, -1))
    slot, event = None, None
    if need_new_kf(m, st, cfg, fid, n_in):
        m, slot = create_keyframe(m, st, ts, feats, uv, t, fid, res.feat_mp, noise)
        m, event = _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer)
    m, vi = viinit_ctl.maybe_vi_init(m, st, cfg, t, cam, ext, ts.gw, noise,
                                     traj=ts.traj, mark=vi_mark)
    if vi.accepted:
        # VI tracking continues from the newest keyframe: its NavState, the
        # estimated gravity, a fresh prior, the IMU rows since that keyframe
        last = st.kf_slots[-1]
        ts.ns = mapping_ctl.keyframe_navstate(m, last)
        ts.P, ts.R, ts.gw = ts.ns.P, ts.ns.R, vi.gw
        ts.prior = None
        ts.imu_since_frame = list(ts.imu_since_kf)
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, vi)


def track_vi(m: MapState, st: mapping_ctl.MappingState, cfg: mapping_ctl.MappingConfig,
             ts: TrackState, img, t, fid: int, imu_rows, cam: Camera,
             ext: factors.Extrinsics, noise: IMUNoise, n_features=1024,
             iters: int = 20, fb_min_inliers=20, event_timer=None):
    """One frame after VI initialization: `tracking.frame_pipeline_vi` from
    the last NavState over the IMU rows since it, then the decisions of
    `_harvest_one`: LOST below max(6, min_track_inliers // 2) inliers, else
    the state carry (this frame's marginal as the next prior), the
    trajectory row and keyframe -> event. Returns (m, FrameOutcome)."""
    dev = m.mp_pos.device
    if imu_rows is not None and imu_rows.shape[0]:
        ts.imu_since_kf.append(imu_rows)
        ts.imu_since_frame.append(imu_rows)
    rawp = (torch.cat(ts.imu_since_frame) if ts.imu_since_frame
            else torch.zeros((0, 7), device=dev))
    c0 = torch.zeros((), dtype=torch.int64, device=dev)
    c1 = torch.ones((), device=dev)
    if ts.prior is None:
        ts.prior = ba_vi.PriorFactor(
            cam=c0, ns0=ts.ns, valid=c1,
            info=torch.as_tensor(system._fresh_prior_info(1e3), device=dev))
    fresh_fb = torch.as_tensor(system._fresh_prior_info(1e2), device=dev)
    anchor = st.last_kf_slot
    (feats, uv, ns, fmp, H_prior, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_vi(
        m, img, rawp, cam, ext, noise, ts.ns, ts.gw, ts.prior, ts.prev_feat_mp,
        ts.prev_angle, anchor, max(t - ts.last_time, 1e-3), fresh_fb,
        sigma_bg=float(noise.sigma_bg), sigma_ba=float(noise.sigma_ba),
        n_features=n_features, n_levels=cfg.n_levels, iters=iters,
        has_prev=ts.has_prev, fb_min_inliers=fb_min_inliers)
    s = summary.cpu().numpy()
    n_in, used_fb = int(s[0]), bool(s[2])
    if n_in < max(6, cfg.min_track_inliers // 2):
        ts.state, ts.has_prev = LOST, False
        return m, FrameOutcome(LOST, n_in, used_fb, None, None, None)
    ts.ns, ts.P, ts.R = ns, ns.P, ns.R
    ts.prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=H_prior, valid=c1)
    ts.imu_since_frame = []
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = fmp, feats.angle, True
    ts.n_inliers, ts.last_time = n_in, t
    m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
    ts.traj.append(traj_row, t, anchor, st.kf_id_host.get(anchor, -1))
    slot, event = None, None
    if need_new_kf(m, st, cfg, fid, n_in):
        m, slot = create_keyframe(m, st, ts, feats, uv, t, fid, fmp, noise)
        m, event = _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer)
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, None)


def trajectory(m: MapState, ts: TrackState):
    """[(t, P_wb, R_wb)] of every tracked frame against the CURRENT keyframe
    poses (SlamSystem.get_trajectory)."""
    return ts.traj.compose(m.kf_ns.P, m.kf_ns.R, m.kf_id, m.kf_active)
