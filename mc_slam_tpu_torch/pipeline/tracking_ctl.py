"""Per-frame control of tracking (port of mc_slam_tpu/pipeline/tracking_ctl.py
and of the per-frame decisions of frameloop.py, `_dispatch_frame_visual` /
`_dispatch_frame_vi` followed by `_harvest_one`), in the synchronous form
that SlamSystem takes by default: a frame is tracked, its summary is read,
and its decisions (LOST, keyframe -> event -> loop closing, VI-init attempt)
are taken before the next frame (the deferred form is pipeline/frameloop.py,
which uses the keyframe, relocalization and VI-init steps here). Also the
paths off the steady state: the reference-keyframe fallback
(`track_reference_kf`), relocalization (`relocalize`), and the 20 visual
frames after a relocalization over which the biases are solved again
(`track_frame_reloc_window`, `recompute_bias_from_window`). Module functions
over an explicit `TrackState` and the `MappingState` of mapping_ctl; the
orchestrator class (pipeline/system.py) holds both and calls these per frame.

A depth frame (stereo / RGB-D, `FrameDepth`) is extracted before it is
tracked, because the depth lookup needs its features: the trackers take the
extracted (feats, uv) as `frame` and run the same decisions; the frame's
u_right rows reach every pose solve the JAX package hands them to (the
visual step and its 40 px retry, the VI step, the reference-keyframe
fallback, the bias window), and a keyframe it becomes gets its u_right table
and its depth points (`mapping_ctl.add_depth_points`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.frontend import bow, matching
from mc_slam_tpu_torch.geometry import pnp
from mc_slam_tpu_torch.imu.navstate import NavState, navstate_identity
from mc_slam_tpu_torch.imu.preintegration import IMUNoise, preintegrate_batch
from mc_slam_tpu_torch.pipeline import loopctl, mapping_ctl, tracking, viinit_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, OK
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import MapState, observation_counts
from mc_slam_tpu_torch.solver import ba_vi, factors
from mc_slam_tpu_torch.solver.ba import VisualObs
from mc_slam_tpu_torch.utils.metrics import span

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
    and since the last frame, each a list of (frame id, (T, 7) rows) so that
    a keyframe cut at an older frame than the newest takes only its own
    rows, and the trajectory log."""
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
    # the frames since a relocalization (after VI init), None outside that
    # window: dicts of t, P, R, feat_mp, uv, level, valid, imu rows
    reloc_buf: list | None = None
    # what the last relocalization attempt saw: candidates, their scores and
    # their rows [matches, PnP ok, PnP inliers], the inliers of each refinement
    reloc_diag: dict | None = None


class FrameDepth(NamedTuple):
    """A depth sensor's per-feature data of one frame."""
    depth: torch.Tensor         # (F,) metric depth, -1 where a feature has none
    ur: torch.Tensor            # (F,) virtual right-image u (u - bf / depth), -1 where none
    bf: torch.Tensor            # () fx * baseline


def _ur_bf(depth: FrameDepth | None):
    return (None, 0.0) if depth is None else (depth.ur, depth.bf)


class FrameOutcome(NamedTuple):
    state: int                      # pipebase.OK or LOST
    n_inliers: int
    used_fallback: bool
    keyframe: int | None            # the slot of the keyframe this frame became
    event: mapping_ctl.EventResult | None
    vi: viinit_ctl.VIAttempt | None
    feats: object = None            # a LOST frame's features and ideal pixels,
    uv: torch.Tensor | None = None  # for the relocalization attempt that follows
    loop: loopctl.LoopOutcome | None = None
    mode: str = ""                  # "ref_kf", "reloc", "reloc_window" off the steady state


def imu_rows(entries):
    """The (T, 7) rows of a list of (frame id, rows), in order; None when empty."""
    return torch.cat([r for _, r in entries]) if entries else None


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
                cfg: SlamConfig, fid: int, n_inliers: int, reloc_open: bool = False) -> bool:
    """NeedNewKeyFrame (src/Tracking.cpp:1865): never within kf_min_gap
    frames of the last keyframe, always after kf_max_gap; in between, when
    the frame tracks fewer than kf_ref_ratio of the reference keyframe's
    WELL-OBSERVED points (min_obs 2 while the map has two keyframes, 3 after)
    and still more than 15. The reference count comes from the last event's
    stats; before the first event it is read from the device, one copy, and
    kept (tracking never edits keyframe observation rows). reloc_open: the
    bias window after a relocalization is still filling (no keyframe then)."""
    if reloc_open:
        return False
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
                    ts: TrackState, feats, uv, t, fid: int, feat_mp, noise: IMUNoise,
                    detector=None, ur=None, pose=None, ns=None):
    """Frame `fid` becomes a keyframe: its pose (its NavState after VI
    init), ITS tracked associations, the IMU rows since the last keyframe up
    to its own (rows of newer frames stay for the next keyframe), its u_right
    table (`ur`, a depth frame's). pose / ns: the frame's (P, R) and NavState
    when it is not the last one tracked (the frame loop's in-flight frames);
    by default `ts`'s. Returns (m, slot)."""
    dev = m.mp_pos.device
    P, R = pose if pose is not None else (ts.P, ts.R)
    if not st.vi_inited:
        ns = navstate_identity(device=dev)._replace(P=P, R=R)
    elif ns is None:
        ns = ts.ns
    rows = imu_rows([(f, r) for f, r in ts.imu_since_kf if f <= fid])
    m, slot = mapping_ctl.insert_keyframe(m, st, cfg, ns, feats, uv, t, fid, rows, noise,
                                          feat_mp=feat_mp, traj=ts.traj, detector=detector,
                                          ur=ur)
    ts.imu_since_kf = [(f, r) for f, r in ts.imu_since_kf if f > fid]
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


def _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer, event_kw, loop=None):
    """One keyframe event (its stats noted, keyframes culled), the loop-closing
    attempt on its detection scores when a `loopctl.LoopContext` is given, and
    the state carry: tracking re-seated on the optimised newest keyframe.
    Returns (m, EventResult, LoopOutcome or None)."""
    hists = None
    if loop is not None:
        hists = loop.detector.hists
        loop.detector.snapshot_ids()        # the event scores these histograms
    m, res = mapping_ctl.keyframe_event(m, st, cfg, fid, cam, ext, ts.gw, noise, hists=hists,
                                        timer=event_timer, traj=ts.traj, **event_kw)
    reseat_on_newest_keyframe(m, st, ts)
    closed = None
    if loop is not None and loopctl.loop_gates_open(st, cfg, loop):
        m, closed = loopctl.try_close_loop(m, st, cfg, ts, loop, st.last_kf_slot, fid, cam,
                                           ext, noise, handles=res.detect)
    return m, res, closed


def _keyframe_tail(m, st, cfg, ts, feats, uv, t, fid, feat_mp, n_in, cam, ext, noise,
                   event_timer, allow_kf, event_kw, loop, depth=None):
    """The keyframe decision every tracked frame ends in: when `need_new_kf`
    says so the frame becomes a keyframe (with a depth frame's u_right table
    and depth points) and runs its event, all in the span "mapping.event".
    Returns (m, slot or None, EventResult or None, LoopOutcome or None)."""
    if not (allow_kf and need_new_kf(m, st, cfg, fid, n_in, ts.reloc_buf is not None)):
        return m, None, None, None
    with span("mapping.event"):
        m, slot = create_keyframe(m, st, cfg, ts, feats, uv, t, fid, feat_mp, noise,
                                  detector=loop.detector if loop is not None else None,
                                  ur=None if depth is None else depth.ur)
        if depth is not None:
            m = mapping_ctl.add_depth_points(m, cfg, cam, ext, slot, feats, uv, depth.depth,
                                             fid)
        m, event, closed = _event(m, st, cfg, ts, fid, cam, ext, noise, event_timer,
                                  event_kw or {}, loop)
    return m, slot, event, closed


def vi_init_tail(m, st, cfg, ts, t, cam, ext, noise, vi_mark=None, vi_log=None):
    """The VI-init attempt that ends a tracked frame before VI initialization
    (with cfg.use_imu). Returns (m, VIAttempt or None)."""
    if not cfg.use_imu or st.vi_inited:
        return m, None
    m, vi = viinit_ctl.maybe_vi_init(m, st, cfg, t, cam, ext, ts.gw, noise,
                                     traj=ts.traj, mark=vi_mark, log=vi_log)
    if vi.accepted:
        # VI tracking continues from the newest keyframe: its NavState, the
        # estimated gravity, a fresh prior, the IMU rows since that keyframe
        ts.gw = vi.gw
        reseat_on_newest_keyframe(m, st, ts)
    return m, vi


def track_visual(m: MapState, st: mapping_ctl.MappingState,
                 cfg: SlamConfig, ts: TrackState, img, t, fid: int,
                 rows, cam: Camera, ext: factors.Extrinsics, noise: IMUNoise,
                 iters: int = 20, event_timer=None, vi_mark=None, vi_log=None,
                 allow_kf=True, event_kw=None, loop=None, generator=None, frame=None,
                 depth: FrameDepth | None = None):
    """One frame before VI initialization: `tracking.frame_pipeline_visual`,
    then the decisions of `_harvest_one` on its summary (one host read):
    below min_track_inliers the reference-keyframe fallback
    (`track_reference_kf`: descriptor matching against the last keyframe +
    PnP RANSAC + a search from that pose) and LOST when it fails too; else the
    state carry, the trajectory row, keyframe -> event (-> loop closing, with
    `loop`) when `need_new_kf` says so, and (with cfg.use_imu) the VI-init
    attempt.

    rows: (T, 7) IMU rows since the last frame (kept, tagged `fid`, for the
    next keyframe's preintegration), or None. allow_kf: False in localization mode (no
    keyframe, no mapping). event_kw: keywords for
    `mapping_ctl.keyframe_event` (max_new, ba_Pw); vi_mark / vi_log: the stage
    marks and the diagnostic log of `viinit_ctl.maybe_vi_init`; loop: the
    `loopctl.LoopContext` (None: no histograms, no loop closing); generator:
    the RANSAC stream of the fallback; frame: the (feats, uv) of a frame the
    caller extracted (img is then not read); depth: a depth frame's
    `FrameDepth`. Returns (m, FrameOutcome); a LOST outcome carries the
    frame's features for the relocalization attempt. `ts` and `st` are
    updated in place."""
    if rows is not None and rows.shape[0]:
        ts.imu_since_kf.append((fid, rows))
    anchor = st.last_kf_slot
    ur, bf = _ur_bf(depth)
    (feats, uv, res, vel, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_visual(
        m, img, cam, ext, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp, ts.prev_angle,
        anchor, cfg.min_track_inliers, n_features=cfg.n_feat, n_levels=cfg.n_levels,
        iters=iters, rtol=cfg.track_rtol, has_prev=ts.has_prev, frame=frame, feat_ur=ur,
        bf=bf)
    s = summary.cpu().numpy()
    n_in, used_fb = int(s[0]), bool(s[1])
    mode = ""
    if n_in < cfg.min_track_inliers:
        # no motion prior left: against the reference keyframe
        # (TrackReferenceKeyFrame, src/Tracking.cpp:1524)
        res2, n2 = track_reference_kf(m, st, cfg, feats, uv, cam, ext, generator=generator,
                                      iters=iters, depth=depth)
        if res2 is None:
            ts.state, ts.has_prev = LOST, False
            return m, FrameOutcome(LOST, n_in, used_fb, None, None, None, feats, uv)
        res, n_in, mode = res2, n2, "ref_kf"
        RlT = ts.R.transpose(-1, -2)
        vel = (tracking._mv(RlT, res.P - ts.P), RlT @ res.R)
        fv = tracking._seen_mask(m, res.feat_mp).to(m.mp_found.dtype)
        mp_found, mp_vis = m.mp_found + fv, m.mp_visible + fv
        traj_row = tracking._traj_row(m, res.P, res.R, anchor)
    ts.dP, ts.dR = vel
    ts.P, ts.R = res.P, res.R
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = res.feat_mp, feats.angle, True
    ts.n_inliers, ts.last_time = n_in, t
    m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
    ts.traj.append(traj_row, t, anchor, st.kf_id_host.get(anchor, -1))
    m, slot, event, closed = _keyframe_tail(
        m, st, cfg, ts, feats, uv, t, fid, res.feat_mp, n_in, cam, ext, noise, event_timer,
        allow_kf, event_kw, loop, depth)
    m, vi = vi_init_tail(m, st, cfg, ts, t, cam, ext, noise, vi_mark, vi_log)
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, vi, loop=closed, mode=mode)


def track_vi(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig,
             ts: TrackState, img, t, fid: int, rows, cam: Camera,
             ext: factors.Extrinsics, noise: IMUNoise, consts: FrameConstants,
             iters: int = 20, fb_min_inliers=20, event_timer=None, allow_kf=True,
             event_kw=None, loop=None, frame=None, depth: FrameDepth | None = None):
    """One frame after VI initialization: `tracking.frame_pipeline_vi` from
    the last NavState over the IMU rows since it, then the decisions of
    `_harvest_one`: LOST below max(6, min_track_inliers // 2) inliers, else
    the state carry (this frame's marginal as the next prior), the
    trajectory row and keyframe -> event (-> loop closing, with `loop`, a
    `loopctl.LoopContext`). consts: `frame_constants` of the system's width,
    staged once. frame / depth: as in `track_visual`. Returns (m,
    FrameOutcome); a LOST outcome carries the frame's features for the
    relocalization attempt."""
    dev = m.mp_pos.device
    if rows is not None and rows.shape[0]:
        ts.imu_since_kf.append((fid, rows))
        ts.imu_since_frame.append((fid, rows))
    rawp = imu_rows(ts.imu_since_frame)
    if rawp is None:
        rawp = torch.zeros((0, 7), device=dev)
    if ts.prior is None:
        ts.prior = ba_vi.PriorFactor(cam=consts.c0, ns0=ts.ns, valid=consts.c1,
                                     info=consts.prior_fresh)
    anchor = st.last_kf_slot
    ur, bf = _ur_bf(depth)
    (feats, uv, ns, fmp, H_prior, mp_found, mp_vis, traj_row,
     summary) = tracking.frame_pipeline_vi(
        m, img, rawp, cam, ext, noise, ts.ns, ts.gw, ts.prior, ts.prev_feat_mp,
        ts.prev_angle, anchor, max(t - ts.last_time, 1e-3), consts.fresh_fb,
        sigma_bg=consts.sigma_bg, sigma_ba=consts.sigma_ba,
        n_features=cfg.n_feat, n_levels=cfg.n_levels, iters=iters, rtol=cfg.track_rtol,
        has_prev=ts.has_prev, fb_min_inliers=fb_min_inliers, frame=frame, feat_ur=ur, bf=bf)
    s = summary.cpu().numpy()
    n_in, used_fb = int(s[0]), bool(s[2])
    if n_in < max(6, cfg.min_track_inliers // 2):
        ts.state, ts.has_prev = LOST, False
        return m, FrameOutcome(LOST, n_in, used_fb, None, None, None, feats, uv)
    ts.ns, ts.P, ts.R = ns, ns.P, ns.R
    ts.prior = ba_vi.PriorFactor(cam=consts.c0, ns0=ns, info=H_prior, valid=consts.c1)
    ts.imu_since_frame = []
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = fmp, feats.angle, True
    ts.n_inliers, ts.last_time = n_in, t
    m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
    ts.traj.append(traj_row, t, anchor, st.kf_id_host.get(anchor, -1))
    m, slot, event, closed = _keyframe_tail(
        m, st, cfg, ts, feats, uv, t, fid, fmp, n_in, cam, ext, noise, event_timer,
        allow_kf, event_kw, loop, depth)
    return m, FrameOutcome(OK, n_in, used_fb, slot, event, None, loop=closed)


# ---------------------------------------------------------------------------
# Off the steady state: the reference-keyframe fallback, relocalization and
# the bias window after it
# ---------------------------------------------------------------------------

def _normalized(cam: Camera, uv):
    return (uv - torch.stack([cam.cx, cam.cy])) / torch.stack([cam.fx, cam.fy])


def _pnp_to_body(ext: factors.Extrinsics, R_cw, t_cw):
    """A PnP result (cam-from-world) as the body pose (P, R), world-from-body."""
    R_wc = R_cw.transpose(-1, -2)
    return mapping_ctl.cam_to_body(ext, -tracking._mv(R_wc, t_cw), R_wc)


def track_reference_kf(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig, feats,
                       uv, cam: Camera, ext: factors.Extrinsics, generator=None, idx=None,
                       iters: int = 20, depth: FrameDepth | None = None):
    """TrackReferenceKeyFrame (src/Tracking.cpp:1524): with no usable motion
    prior, the frame's descriptors are matched against the last keyframe's
    landmark features, PnP RANSAC gives a pose, and the map is searched from
    it (15 px; a depth frame's u_right rows in the pose solve). idx: (n, 6)
    PnP sample indices (cfg.pnp_iters of them drawn from `generator`
    when None). Two host reads: [matches, PnP ok], then the inliers.
    Returns (TrackResult, inliers) or (None, 0)."""
    k = st.last_kf_slot
    if k is None or k not in st.kf_slots:
        return None, 0
    mp_k = m.kf_mp[k]
    has = (mp_k >= 0) & m.kf_feat_valid[k]
    midx, _, okm = matching.mutual_match(
        feats.desc_pm1, feats.valid, m.kf_pm1[k], has, max_dist=matching.TH_LOW, ratio=0.85,
        angle_a=feats.angle, angle_b=m.kf_angle[k])
    w = okm.to(torch.float32)
    if idx is None:
        idx = pnp.draw_samples(generator, w, cfg.pnp_iters, 6)
    Xw = m.mp_pos[torch.clamp(mp_k[midx], 0, m.P - 1).to(torch.int64)]
    res = pnp.pnp_ransac(idx, Xw, _normalized(cam, uv), w, cam.fx, min_inliers=12)
    h = torch.stack([torch.sum(okm).to(torch.float32), res.ok.to(torch.float32)]).cpu().numpy()
    if h[0] < 15 or h[1] < 0.5:
        return None, 0
    P_b, R_b = _pnp_to_body(ext, res.R_cw, res.t_cw)
    ur, bf = _ur_bf(depth)
    tr = tracking.track_frame_visual(m, feats, uv, cam, ext, P_b, R_b, radius_coarse=15.0,
                                     iters=iters, feat_ur=ur, bf=bf)
    n_in = int(tr.n_inliers)
    if n_in < cfg.min_track_inliers:
        return None, 0
    return tr, n_in


C_PAD = 5            # relocalization candidates evaluated per attempt


def relocalize(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig, ts: TrackState,
               detector, feats, uv, t, cam: Camera, ext: factors.Extrinsics,
               generator=None, idx=None, iters: int = 20):
    """Tracking::Relocalization (src/Tracking.cpp:2388): the frame's BoW
    histogram scores every keyframe; the (at most 5) keyframes within 0.75 of
    the best score are candidates; ONE batched pass matches the frame against
    each and solves PnP (`tracking.reloc_candidates_batch`); the first
    candidate, best score first, whose pose the map confirms (a 15 px search,
    a 30 px one after a near miss) relocalizes the system.

    After VI init a success re-seats the NavState (zero velocity), drops the
    prior, opens the bias window (`ts.reloc_buf`), forgets the IMU rows so far
    and marks the next keyframe as the start of a new IMU chain.

    detector: the `LoopDetector` (vocabulary, idf, histogram table). idx:
    (5, n, 6) PnP sample indices, cfg.pnp_iters each drawn from `generator`
    when None. Host
    reads: the scores, the packed candidate rows, and the inlier count of each
    refinement that is tried (none for a candidate that fails PnP).
    Returns None, or dict(kf, n_in, feat_mp) of the relocalization; `ts`, `st`
    are updated in place."""
    act = list(st.kf_slots)
    if not act:
        return None
    dev = uv.device
    q = bow.bow_histogram(feats.desc_pm1, feats.valid.to(torch.float32), detector.vocab,
                          idf=detector.idf)
    scores = (detector.hists @ q).cpu().numpy()[act]
    order = np.argsort(-scores, kind="stable")
    best_s = scores[order[0]]
    cand = [act[int(oi)] for oi in order[:C_PAD] if scores[int(oi)] >= 0.75 * best_s]
    if not cand:
        return None
    cand_p = (cand + [cand[0]] * C_PAD)[:C_PAD]
    packed = tracking.reloc_candidates_batch(
        m, torch.as_tensor(cand_p, dtype=torch.int64, device=dev), idx, feats.desc_pm1,
        feats.valid, feats.angle, _normalized(cam, uv), cam.fx, generator=generator,
        n_iters=cfg.pnp_iters)
    host = packed.cpu().numpy()
    ts.reloc_diag = dict(cand=cand, score=[round(float(scores[act.index(k)]), 3) for k in cand],
                         rows=host[:len(cand), :3].astype(int).tolist(), refined=[])
    for i, k in enumerate(cand):
        if host[i, 0] < 15 or host[i, 1] < 0.5:
            continue
        P_b, R_b = _pnp_to_body(ext, packed[i, 3:12].reshape(3, 3), packed[i, 12:15])
        tr = tracking.track_frame_visual(m, feats, uv, cam, ext, P_b, R_b,
                                         radius_coarse=15.0, iters=iters)
        n_in = int(tr.n_inliers)
        if 0 < cfg.min_track_inliers - n_in <= 4:
            # near miss: a wider guided search from the refined pose
            tr2 = tracking.track_frame_visual(m, feats, uv, cam, ext, tr.P, tr.R,
                                              radius_coarse=30.0, iters=iters)
            n2 = int(tr2.n_inliers)
            if n2 > n_in:
                tr, n_in = tr2, n2
        ts.reloc_diag["refined"].append(n_in)
        if n_in < cfg.min_track_inliers:
            continue
        ts.P, ts.R = tr.P, tr.R
        ts.dP, ts.dR = torch.zeros(3, device=dev), torch.eye(3, device=dev)
        ts.prev_feat_mp, ts.n_inliers, ts.last_time = tr.feat_mp, n_in, t
        if st.vi_inited:
            ts.ns = ts.ns._replace(P=tr.P, R=tr.R, V=torch.zeros(3, device=dev))
            ts.prior = None
            ts.reloc_buf = []
            ts.imu_since_frame, ts.imu_since_kf = [], []
            st.chain_break_pending = True
        ts.state = OK
        invalidate_frame_caches(st)
        return dict(kf=k, n_in=n_in, feat_mp=tr.feat_mp)
    return None


def invalidate_frame_caches(st: mapping_ctl.MappingState):
    """Drop what the host keeps of the last event (the covisibility row, the
    reference keyframe's well-observed count) after a change that it does not
    reflect: a relocalization, the bias window's end, a loop closure."""
    st.covis_row = None
    st.ref_tracked = None


def track_frame_reloc_window(m: MapState, st: mapping_ctl.MappingState, cfg: SlamConfig,
                             ts: TrackState, feats, uv, t, cam: Camera,
                             ext: factors.Extrinsics, noise: IMUNoise, reloc_window=20,
                             iters: int = 20, depth: FrameDepth | None = None):
    """One frame while the bias window after a relocalization fills (the
    reference tracks without the IMU while mbRelocBiasPrepare is set): visual
    tracking from the velocity model, the 40 px retry from the last pose, LOST
    (and the window dropped) when both fail; a depth frame's u_right rows in
    both. The frame's pose, associations,
    observations and IMU rows join `ts.reloc_buf`; the `reloc_window`-th frame
    runs `recompute_bias_from_window` and closes the window.
    Returns (ok, inliers, used the retry); one host read, two with the retry."""
    rows = imu_rows(ts.imu_since_frame)
    if rows is None:
        rows = torch.zeros((0, 7), device=uv.device)
    ts.imu_since_frame = []
    P_last, R_last = ts.P, ts.R
    ur, bf = _ur_bf(depth)
    res = tracking.track_frame_visual(m, feats, uv, cam, ext,
                                      P_last + tracking._mv(R_last, ts.dP), R_last @ ts.dR,
                                      iters=iters, feat_ur=ur, bf=bf)
    n_in, used_fb = int(res.n_inliers), False
    if n_in < cfg.min_track_inliers:
        res = tracking.track_frame_visual(m, feats, uv, cam, ext, P_last, R_last,
                                          radius_coarse=40.0, iters=iters, feat_ur=ur, bf=bf)
        n_in, used_fb = int(res.n_inliers), True
        if n_in < cfg.min_track_inliers:
            ts.state, ts.has_prev = LOST, False
            ts.reloc_buf = None             # the window is dropped: relocalize again
            return False, n_in, used_fb
    RlT = R_last.transpose(-1, -2)
    ts.dP, ts.dR = tracking._mv(RlT, res.P - P_last), RlT @ res.R
    ts.P, ts.R = res.P, res.R
    ts.prev_feat_mp, ts.n_inliers, ts.last_time, ts.state = res.feat_mp, n_in, t, OK
    ts.reloc_buf.append(dict(t=t, P=res.P, R=res.R, feat_mp=res.feat_mp, uv=uv,
                             level=feats.level, valid=feats.valid, imu=rows))
    if len(ts.reloc_buf) >= reloc_window:
        recompute_bias_from_window(m, ts, cam, ext, noise)
        ts.reloc_buf = None
        invalidate_frame_caches(st)
    return True, n_in, used_fb


def recompute_bias_from_window(m: MapState, ts: TrackState, cam: Camera,
                               ext: factors.Extrinsics, noise: IMUNoise, iters: int = 10):
    """Solve the biases and the NavState again over the frames buffered since
    a relocalization (Tracking::RecomputeIMUBiasAndCurrentNavstate): every
    frame's state is free, chained by IMU PRV + bias random-walk edges (each
    integrated at the stale bias), against the FIXED map; one round, no
    outlier re-classification. The last frame's state becomes the tracking
    state (with no prior) when it is finite; the choice is made on the device.
    Returns the BA's cost curve."""
    buf = ts.reloc_buf
    N = len(buf)
    dev = m.mp_pos.device
    bg0, ba0 = ts.ns.bg_full, ts.ns.ba_full
    T = max(1, max(b["imu"].shape[0] for b in buf[1:]))
    raw = torch.zeros((N - 1, T, 7), device=dev)
    for i in range(1, N):
        r = buf[i]["imu"]
        raw[i - 1, :r.shape[0]] = r
    pre = preintegrate_batch(raw, bg0, ba0, noise)
    # the NavStates start from the visual poses, V by forward differences
    P = torch.stack([b["P"] for b in buf])
    R = torch.stack([b["R"] for b in buf])
    tt = torch.as_tensor([b["t"] for b in buf], dtype=torch.float64)
    dt = torch.clamp(tt[1:] - tt[:-1], min=1e-3).to(torch.float32).to(dev)
    V = (P[1:] - P[:-1]) / dt[:, None]
    V = torch.cat([V, V[-1:]])
    z3 = torch.zeros((N, 3), device=dev)
    ns0 = NavState(P=P, R=R, V=V, bg=bg0.expand(N, 3), ba=ba0.expand(N, 3), dbg=z3, dba=z3)
    ar = torch.arange(N, dtype=torch.int64, device=dev)
    edges = ba_vi.IMUEdges(
        i=ar[:-1], j=ar[1:], pre=pre, info_prv=factors.imu_prv_info(pre),
        info_bias=factors.bias_rw_info(pre.dT, float(noise.sigma_bg), float(noise.sigma_ba)),
        valid=torch.ones(N - 1, device=dev))
    mp = torch.stack([b["feat_mp"] for b in buf]).reshape(-1)
    lvl = torch.stack([b["level"] for b in buf]).reshape(-1)
    fv = torch.stack([b["valid"] for b in buf]).reshape(-1)
    obs = VisualObs(cam=ar.repeat_interleave(m.F),
                    pt=torch.clamp(mp, 0, m.P - 1).to(torch.int64),
                    uv=torch.stack([b["uv"] for b in buf]).reshape(-1, 2),
                    inv_sigma2=1.0 / (1.2 ** (2.0 * lvl.to(torch.float32))),
                    valid=((mp >= 0) & fv).to(torch.float32))
    ns2, _, _, _, costs = ba_vi.vi_ba(
        ns0, m.mp_pos, obs, edges, cam, ext, ts.gw, torch.ones(N, device=dev),
        m.mp_active.to(torch.float32), prior=None, iters=iters, fix_points=True,
        two_phase=False)
    nsl = NavState(*[a[-1] for a in ns2])
    finite = torch.all(torch.isfinite(nsl.P)) & torch.all(torch.isfinite(nsl.V))
    ts.ns = NavState(*[torch.where(finite, a, b) for a, b in zip(nsl, ts.ns)])
    ts.P, ts.R = ts.ns.P, ts.ns.R
    ts.prior = None
    return costs
