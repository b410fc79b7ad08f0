"""Per-frame control of tracking (port of the keyframe decision of
mc_slam_tpu/pipeline/tracking_ctl.py and of the per-frame decisions of
frameloop.py, `_dispatch_frame_visual` / `_dispatch_frame_vi` followed by
`_harvest_one`), in synchronous form: a frame is tracked, its summary is
read, and its decisions (LOST, keyframe -> event, VI-init attempt) are taken
before the next frame. Module functions over an explicit `TrackState` and
the `MappingState` of mapping_ctl; the orchestrator class
(pipeline/system.py) holds both and calls these per frame.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState, navstate_identity
from mc_slam_tpu_torch.imu.preintegration import IMUNoise
from mc_slam_tpu_torch.pipeline import mapping_ctl, tracking, viinit_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, OK
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import MapState, observation_counts
from mc_slam_tpu_torch.solver import ba_vi, factors

if TYPE_CHECKING:
    from mc_slam_tpu_torch.pipeline.system import SlamConfig


def fresh_prior_info(pose_info):
    """15x15 prior information for a freshly (re)seated frame state, order
    [P, phi, V, dbg, dba]: `pose_info` on pose/velocity, window-BA-level
    confidence on the biases (see mc_slam_tpu/pipeline/tracking_ctl.py:109)."""
    d = np.full(15, float(pose_info), np.float32)
    d[9:12] = 1e6    # gyro bias: sigma ~1e-3 rad/s
    d[12:15] = 1e4   # accel bias: sigma ~1e-2 m/s^2
    return np.diag(d)


class FrameConstants(NamedTuple):
    """Per-call constants of the frame programs, staged once by the caller
    (as the JAX SlamSystem's constructor stages them): built per frame, each
    tensor would be a pageable host->device copy and each sigma a device
    read."""
    c0: torch.Tensor            # () int64 zero: the prior's camera index
    c1: torch.Tensor            # () float one: the prior's validity
    prior_fresh: torch.Tensor   # (15, 15) information of a re-seated state's prior
    fresh_fb: torch.Tensor      # (15, 15) the fallback solve's prior information
    sigma_bg: float             # the IMU noise's bias random walks, read once
    sigma_ba: float


def frame_constants(noise: IMUNoise, device) -> FrameConstants:
    return FrameConstants(
        sigma_bg=float(noise.sigma_bg), sigma_ba=float(noise.sigma_ba),
        c0=torch.zeros((), dtype=torch.int64, device=device),
        c1=torch.ones((), device=device),
        prior_fresh=torch.as_tensor(fresh_prior_info(1e3), device=device),
        fresh_fb=torch.as_tensor(fresh_prior_info(1e2), device=device))


@dataclasses.dataclass
class TrackState:
    """What tracking carries from frame to frame (SlamSystem's per-frame
    state): the last pose and the constant-velocity model before VI init,
    the last NavState, marginal prior and gravity after it, the last frame's
    associations and keypoint angles, the IMU rows since the last keyframe
    and since the last frame, and the trajectory log."""
    state: int                      # pipebase.OK or LOST
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
    state: int                      # pipebase.OK or LOST
    n_inliers: int
    used_fallback: bool
    keyframe: int | None            # the slot of the keyframe this frame became
    event: mapping_ctl.EventResult | None
    vi: viinit_ctl.VIAttempt | None


def start_tracking(m: MapState, st: mapping_ctl.MappingState, g_mag: float,
                   t: float, traj: TrajStore | None = None) -> TrackState:
    """The tracking state right after monocular initialization: at the newest
    keyframe's pose, zero velocity model, gravity along -z until VI init
    estimates it."""
    dev = m.mp_pos.device
    P, R = m.kf_ns.P[st.last_kf_slot], m.kf_ns.R[st.last_kf_slot]
    gw = torch.cat([torch.zeros(2, device=dev), torch.full((1,), -g_mag, device=dev)])
    return TrackState(state=OK, P=P, R=R, dP=torch.zeros(3, device=dev),
                      dR=torch.eye(3, device=dev), gw=gw,
                      prev_feat_mp=torch.full((m.F,), -1, dtype=torch.int32, device=dev),
                      prev_angle=torch.zeros(m.F, device=dev), last_time=t,
                      traj=traj if traj is not None else TrajStore())


def need_new_kf(m: MapState, st: mapping_ctl.MappingState,
                cfg: SlamConfig, fid: int, n_inliers: int) -> bool:
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


def create_keyframe(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig,
                    ts: TrackState, feats, uv, t, fid: int, feat_mp, noise: IMUNoise):
    """The tracked frame becomes a keyframe: its pose (its NavState after VI
    init), THIS frame's tracked associations, the IMU rows since the last
    keyframe. Returns (m, slot)."""
    dev = m.mp_pos.device
    ns = ts.ns if st.vi_inited else navstate_identity(device=dev)._replace(P=ts.P, R=ts.R)
    rows = torch.cat(ts.imu_since_kf) if ts.imu_since_kf else None
    m, slot = mapping_ctl.insert_keyframe(m, st, cfg, ns, feats, uv, t, fid, rows, noise,
                                          feat_mp=feat_mp, traj=ts.traj)
    ts.imu_since_kf = []
    return m, slot


def reseat_on_newest_keyframe(m: MapState, st: mapping_ctl.MappingState, ts: TrackState):
    """Tracking continues from the newest keyframe's (optimised) state: its
    pose, after VI init its NavState with a fresh prior (the marginal one of
    the frame before is stale) and the IMU rows since that keyframe."""
    slot = st.last_kf_slot
    ts.P, ts.R = m.kf_ns.P[slot], m.kf_ns.R[slot]
    if st.vi_inited:
        ts.ns = mapping_ctl.keyframe_navstate(m, slot)
        ts.prior = None
        ts.imu_since_frame = list(ts.imu_since_kf)


def _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer, event_kw):
    """One keyframe event (its stats noted, keyframes culled) and its state
    carry: tracking re-seated on the optimised newest keyframe."""
    m, res = mapping_ctl.keyframe_event(m, st, cfg, fid, cam, ext, ts.gw, noise,
                                        timer=event_timer, traj=ts.traj, **event_kw)
    reseat_on_newest_keyframe(m, st, ts)
    return m, res


def track_visual(m: MapState, st: mapping_ctl.MappingState,
                 cfg: SlamConfig, ts: TrackState, img, t, fid: int,
                 imu_rows, cam: Camera, ext: factors.Extrinsics, noise: IMUNoise,
                 iters: int = 20, event_timer=None, vi_mark=None, vi_log=None,
                 allow_kf=True, event_kw=None):
    """One frame before VI initialization: `tracking.frame_pipeline_visual`,
    then the decisions of `_harvest_one` on its summary (one host read):
    LOST below min_track_inliers, else the state carry, the trajectory row,
    keyframe -> event when `need_new_kf` says so, and (with cfg.use_imu) the
    VI-init attempt.

    The JAX package tries its reference-keyframe fallback (descriptor
    matching against the last keyframe + PnP RANSAC) before it declares a
    frame lost; PnP is not ported yet, so this function returns LOST where
    that fallback would have been tried.

    imu_rows: (T, 7) rows since the last frame (kept for the next keyframe's
    preintegration), or None. allow_kf: False in localization mode (no
    keyframe, no mapping). event_kw: keywords for
    `mapping_ctl.keyframe_event` (max_new, ba_Pw); vi_mark / vi_log: the stage
    marks and the diagnostic log of `viinit_ctl.maybe_vi_init`. Returns
    (m, FrameOutcome);
    `ts` and `st` are updated in place."""
    if imu_rows is not None and imu_rows.shape[0]:
        ts.imu_since_kf.append(imu_rows)
    anchor = st.last_kf_slot
    (feats, uv, res, vel, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_visual(
        m, img, cam, ext, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp, ts.prev_angle,
        anchor, cfg.min_track_inliers, n_features=cfg.n_feat, n_levels=cfg.n_levels,
        iters=iters, rtol=cfg.track_rtol, has_prev=ts.has_prev)
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
    if allow_kf and need_new_kf(m, st, cfg, fid, n_in):
        m, slot = create_keyframe(m, st, cfg, ts, feats, uv, t, fid, res.feat_mp, noise)
        m, event = _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer,
                          event_kw or {})
    vi = None
    if cfg.use_imu:
        m, vi = viinit_ctl.maybe_vi_init(m, st, cfg, t, cam, ext, ts.gw, noise,
                                         traj=ts.traj, mark=vi_mark, log=vi_log)
        if vi.accepted:
            # VI tracking continues from the newest keyframe: its NavState, the
            # estimated gravity, a fresh prior, the IMU rows since that keyframe
            ts.gw = vi.gw
            reseat_on_newest_keyframe(m, st, ts)
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, vi)


def track_vi(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig,
             ts: TrackState, img, t, fid: int, imu_rows, cam: Camera,
             ext: factors.Extrinsics, noise: IMUNoise, consts: FrameConstants,
             iters: int = 20, fb_min_inliers=20, event_timer=None, allow_kf=True,
             event_kw=None):
    """One frame after VI initialization: `tracking.frame_pipeline_vi` from
    the last NavState over the IMU rows since it, then the decisions of
    `_harvest_one`: LOST below max(6, min_track_inliers // 2) inliers, else
    the state carry (this frame's marginal as the next prior), the
    trajectory row and keyframe -> event. consts: `frame_constants` of the
    system's width, staged once. Returns (m, FrameOutcome)."""
    dev = m.mp_pos.device
    if imu_rows is not None and imu_rows.shape[0]:
        ts.imu_since_kf.append(imu_rows)
        ts.imu_since_frame.append(imu_rows)
    rawp = (torch.cat(ts.imu_since_frame) if ts.imu_since_frame
            else torch.zeros((0, 7), device=dev))
    if ts.prior is None:
        ts.prior = ba_vi.PriorFactor(cam=consts.c0, ns0=ts.ns, valid=consts.c1,
                                     info=consts.prior_fresh)
    anchor = st.last_kf_slot
    (feats, uv, ns, fmp, H_prior, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_vi(
        m, img, rawp, cam, ext, noise, ts.ns, ts.gw, ts.prior, ts.prev_feat_mp,
        ts.prev_angle, anchor, max(t - ts.last_time, 1e-3), consts.fresh_fb,
        sigma_bg=consts.sigma_bg, sigma_ba=consts.sigma_ba,
        n_features=cfg.n_feat, n_levels=cfg.n_levels, iters=iters, rtol=cfg.track_rtol,
        has_prev=ts.has_prev, fb_min_inliers=fb_min_inliers)
    s = summary.cpu().numpy()
    n_in, used_fb = int(s[0]), bool(s[2])
    if n_in < max(6, cfg.min_track_inliers // 2):
        ts.state, ts.has_prev = LOST, False
        return m, FrameOutcome(LOST, n_in, used_fb, None, None, None)
    ts.ns, ts.P, ts.R = ns, ns.P, ns.R
    ts.prior = ba_vi.PriorFactor(cam=consts.c0, ns0=ns, info=H_prior, valid=consts.c1)
    ts.imu_since_frame = []
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = fmp, feats.angle, True
    ts.n_inliers, ts.last_time = n_in, t
    m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
    ts.traj.append(traj_row, t, anchor, st.kf_id_host.get(anchor, -1))
    slot, event = None, None
    if allow_kf and need_new_kf(m, st, cfg, fid, n_in):
        m, slot = create_keyframe(m, st, cfg, ts, feats, uv, t, fid, fmp, noise)
        m, event = _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer,
                          event_kw or {})
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, None)
