"""The asynchronous frame loop (port of mc_slam_tpu/pipeline/frameloop.py):
frames are dispatched and their decisions taken frames later.

`SlamSystem.track` takes this path on a steady frame (state OK, no depth
input, no relocalization window open) when `LAG_MAX` or `PAIR` is above 1
(`MC_SLAM_LAG_MAX`, `MC_SLAM_PAIR`): the frame's program is queued on the
device and the call returns without reading anything of it. Its summary
(inliers, fallback flag, matches) is copied to the host without blocking
(`pipebase.HostCopy`) and harvested at the start of a later call, once the
copy has landed and at the latest when `LAG_MAX` entries are in flight (2
before VI init): then the frame is declared LOST (rolling back every newer
frame), or becomes a keyframe (its own pose, NavState, associations and IMU
rows) and runs the device half of its event. After VI init, `PAIR` frames go
out as one `tracking.frame_pipeline_vi_pair` call with one summary copy.

The event's host half (stats, keyframe culling) and the loop-closing stages
(Sim3 batch, one guided verification at a time) are harvested the same way:
when their copies have landed, or forced (by the next event, by a drain, by
`flush`). Each change of the map bumps `LoopState.map_epoch`; a frame
dispatched on an older map never becomes a keyframe, and its rollback keeps
the newer state.

Module functions over the `SlamSystem` (its map, `st`, `ts`, constants,
timers and event log) and the `LoopState` it holds as `fl`; the names are the
JAX mixin's methods'. The tracking state is replaced, never written in
place: a pending frame's backup and the map tables it holds stay as they
were at its dispatch.

One host sync stays in every dispatched frame: the frame programs read the
flag of their 40 px fallback (`tracking.py`), which waits for the device
queue; a pending frame's keyframe decision may read the reference count
(`tracking_ctl.need_new_kf`) when no event's stats have landed since the
last keyframe.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

from mc_slam_tpu_torch.pipeline import loopctl, mapping_ctl, tracking, tracking_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, HostCopy
from mc_slam_tpu_torch.solver import ba_vi


@dataclasses.dataclass
class Pending:
    """A dispatched entry: one frame ("vi", "vis") or PAIR frames ("vi2")."""
    mode: str
    row: int                   # its first trajectory row
    summary: HostCopy          # (4,), (3,) or (N, 4)
    backup: tuple              # the tracking state before it (_state_backup)
    epoch: int                 # LoopState.map_epoch at its dispatch
    frames: list               # per frame: feats, uv, t, frame_id, feat_mp, pose, ns, pose_before


@dataclasses.dataclass
class LoopState:
    """What the frame loop holds between calls (the JAX SlamSystem's
    `_pendings`, `_pair_buf`, `_deferred_event`, `_deferred_sim3`,
    `_deferred_verify`, `_map_epoch`), and its counts."""
    pendings: collections.deque = dataclasses.field(default_factory=collections.deque)
    pair_buf: list | None = None
    event: mapping_ctl.PendingEvent | None = None
    sim3: loopctl.PendingSim3 | None = None
    verify: loopctl.PendingVerify | None = None
    map_epoch: int = 0
    n_dispatched: dict = dataclasses.field(
        default_factory=lambda: {"vi": 0, "vi2": 0, "vis": 0})
    max_depth: int = 0         # the deepest pending queue reached
    n_events_deferred: int = 0  # events harvested when their copy had landed
    n_events_forced: int = 0    # ... and harvested waiting for it


def _push(sys, p: Pending):
    fl = sys.fl
    fl.pendings.append(p)
    fl.n_dispatched[p.mode] += 1
    fl.max_depth = max(fl.max_depth, len(fl.pendings))


def _anchor(sys):
    k = sys.st.last_kf_slot
    return k, sys.st.kf_id_host.get(k, -1)


def invalidate(sys):
    """SlamSystem._invalidate_frame_caches: the host caches of the last event
    dropped and the map epoch bumped."""
    tracking_ctl.invalidate_frame_caches(sys.st)
    sys.fl.map_epoch += 1


def _capture_imu_frame(sys):
    """The IMU rows since the last dispatched frame, consumed (JAX :59-67;
    the real rows, no padding)."""
    ts = sys.ts
    rows = tracking_ctl.imu_rows(ts.imu_since_frame)
    ts.imu_since_frame = []
    return rows if rows is not None else torch.zeros((0, 7), device=sys.device)


def _state_backup(sys):
    """What a rollback restores (JAX :69-72)."""
    ts = sys.ts
    return (ts.ns, ts.prior, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp, ts.prev_angle,
            ts.has_prev, sys.m.mp_found, sys.m.mp_visible)


def _restore(sys, backup):
    ts = sys.ts
    (ts.ns, ts.prior, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp, ts.prev_angle, ts.has_prev,
     mp_found, mp_visible) = backup
    sys.m = sys.m._replace(mp_found=mp_found, mp_visible=mp_visible)


def _frame_dt(sys, t):
    dt = max(t - sys.ts.last_time, 1e-3)
    sys.ts.last_time = t
    return dt


def _prior(sys):
    ts, c = sys.ts, sys._consts
    if ts.prior is None:
        ts.prior = ba_vi.PriorFactor(cam=c.c0, ns0=ts.ns, valid=c.c1, info=c.prior_fresh)
    return ts.prior


def pair_push(sys, img, t):
    """Buffer a VI frame; on the PAIR-th, dispatch the buffer as one
    `frame_pipeline_vi_pair` call (JAX :74-92). The backup is the state
    before the first buffered frame."""
    fl = sys.fl
    rawp = _capture_imu_frame(sys)
    dt = _frame_dt(sys, t)
    if fl.pair_buf is None:
        fl.pair_buf = []
    fl.pair_buf.append(dict(img=img, t=t, rawp=rawp, dt=dt, fid=sys.frame_id,
                            backup=None if fl.pair_buf else _state_backup(sys)))
    if len(fl.pair_buf) >= sys.PAIR:
        bufs, fl.pair_buf = fl.pair_buf, None
        _dispatch_frame_vi_pair(sys, bufs)


def _flush_pair_buf(sys):
    """Dispatch the buffered frames one by one (the drain; JAX :94-103)."""
    bufs, sys.fl.pair_buf = sys.fl.pair_buf, None
    for b in bufs or ():
        dispatch_frame_vi(sys, b["img"], b["t"], rawp=b["rawp"], dt=b["dt"], fid=b["fid"])


def _dispatch_frame_vi_pair(sys, bufs):
    """JAX :105-148: the optimistic state carry from the last frame of the
    pair, one trajectory row a frame, one pending entry."""
    cfg, ts, c = sys.cfg, sys.ts, sys._consts
    prior = _prior(sys)
    anchor, kid = _anchor(sys)
    frames, Hp, mp_found, mp_vis, summary = tracking.frame_pipeline_vi_pair(
        sys.m, [b["img"] for b in bufs], [b["rawp"] for b in bufs], sys.cam, sys.ext,
        sys.noise, ts.ns, ts.gw, prior, ts.prev_feat_mp, ts.prev_angle, anchor,
        [b["dt"] for b in bufs], c.fresh_fb, sigma_bg=c.sigma_bg, sigma_ba=c.sigma_ba,
        n_features=cfg.n_feat, n_levels=cfg.n_levels, rtol=cfg.track_rtol,
        has_prev=ts.has_prev)
    copy = HostCopy(summary)
    feats_z, _, fmp_z, ns_z, _ = frames[-1]
    ts.ns, ts.P, ts.R = ns_z, ns_z.P, ns_z.R
    ts.prior = ba_vi.PriorFactor(cam=c.c0, ns0=ns_z, info=Hp, valid=c.c1)
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = fmp_z, feats_z.angle, True
    sys.m = sys.m._replace(mp_found=mp_found, mp_visible=mp_vis)
    row0 = len(sys.traj)
    for b, (_, _, _, _, traj) in zip(bufs, frames):
        sys.traj.append(traj, b["t"], anchor, kid)
    _push(sys, Pending("vi2", row0, copy, bufs[0]["backup"], sys.fl.map_epoch, [
        dict(feats=feats, uv=uv, t=b["t"], frame_id=b["fid"], feat_mp=fmp, pose=(ns.P, ns.R),
             ns=ns) for b, (feats, uv, fmp, ns, _) in zip(bufs, frames)]))


def dispatch_frame_vi(sys, img, t, rawp=None, dt=None, fid=None, backup=None):
    """One VI frame (`tracking.frame_pipeline_vi`), no host read of its
    result (JAX :150-197)."""
    cfg, ts, c = sys.cfg, sys.ts, sys._consts
    if rawp is None:
        rawp = _capture_imu_frame(sys)
    if dt is None:
        dt = _frame_dt(sys, t)
    if backup is None:
        backup = _state_backup(sys)
    prior = _prior(sys)
    anchor, kid = _anchor(sys)
    feats, uv, ns, fmp, H_prior, mp_found, mp_vis, traj, summary = tracking.frame_pipeline_vi(
        sys.m, img, rawp, sys.cam, sys.ext, sys.noise, ts.ns, ts.gw, prior, ts.prev_feat_mp,
        ts.prev_angle, anchor, dt, c.fresh_fb, sigma_bg=c.sigma_bg, sigma_ba=c.sigma_ba,
        n_features=cfg.n_feat, n_levels=cfg.n_levels, rtol=cfg.track_rtol,
        has_prev=ts.has_prev)
    copy = HostCopy(summary)
    ts.ns, ts.P, ts.R = ns, ns.P, ns.R
    ts.prior = ba_vi.PriorFactor(cam=c.c0, ns0=ns, info=H_prior, valid=c.c1)
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = fmp, feats.angle, True
    sys.m = sys.m._replace(mp_found=mp_found, mp_visible=mp_vis)
    sys.traj.append(traj, t, anchor, kid)
    _push(sys, Pending("vi", len(sys.traj) - 1, copy, backup, sys.fl.map_epoch, [
        dict(feats=feats, uv=uv, t=t, frame_id=sys.frame_id if fid is None else fid,
             feat_mp=fmp, pose=(ns.P, ns.R), ns=ns)]))


def dispatch_frame_visual(sys, img, t):
    """One visual frame (`tracking.frame_pipeline_visual`), before VI init
    (JAX :199-234); the IMU rows wait for the next keyframe."""
    cfg, ts = sys.cfg, sys.ts
    ts.imu_since_frame = []
    backup = _state_backup(sys)
    P_last, R_last = ts.P, ts.R
    anchor, kid = _anchor(sys)
    feats, uv, res, vel, mp_found, mp_vis, traj, summary = tracking.frame_pipeline_visual(
        sys.m, img, sys.cam, sys.ext, ts.P, ts.R, ts.dP, ts.dR, ts.prev_feat_mp,
        ts.prev_angle, anchor, cfg.min_track_inliers, n_features=cfg.n_feat,
        n_levels=cfg.n_levels, rtol=cfg.track_rtol, has_prev=ts.has_prev)
    copy = HostCopy(summary)
    ts.dP, ts.dR = vel
    ts.P, ts.R = res.P, res.R
    ts.prev_feat_mp, ts.prev_angle, ts.has_prev = res.feat_mp, feats.angle, True
    ts.last_time = t
    sys.m = sys.m._replace(mp_found=mp_found, mp_visible=mp_vis)
    sys.traj.append(traj, t, anchor, kid)
    _push(sys, Pending("vis", len(sys.traj) - 1, copy, backup, sys.fl.map_epoch, [
        dict(feats=feats, uv=uv, t=t, frame_id=sys.frame_id, feat_mp=res.feat_mp,
             pose=(res.P, res.R), ns=None, pose_before=(P_last, R_last))]))


def _rollback_pending(sys, p: Pending):
    """A lost entry: its trajectory rows and every newer entry's go, the
    newer entries and the buffered frames are counted lost, and the state
    before it comes back unless the map changed since its dispatch
    (JAX :236-254)."""
    fl = sys.fl
    sys.traj.truncate(p.row)
    sys.n_lost_frames += sum(len(q.frames) for q in fl.pendings)
    fl.pendings.clear()
    if fl.pair_buf:
        sys.n_lost_frames += len(fl.pair_buf)
    fl.pair_buf = None
    if p.epoch == fl.map_epoch:
        _restore(sys, p.backup)


def _lost(sys, p, fr, n_lost, mode, n_in):
    _rollback_pending(sys, p)
    sys.ts.has_prev = False
    sys.ts.state = sys.state = LOST
    sys.n_lost_frames += n_lost
    sys.events.append((fr["frame_id"], "lost", dict(mode=mode, n_in=n_in)))


def harvest_pending(sys, drain=False):
    """The deferred decisions of the due entries (JAX :263-288): the event
    and loop stages that have landed, then every entry whose summary has
    landed (with at least LAG_MIN in flight) and every entry at depth
    LAG_MAX (2 before VI init: the visual bootstrap needs its keyframes
    soon). drain: everything, waiting where needed, the pair buffer first."""
    fl = sys.fl
    if drain:
        _flush_pair_buf(sys)
    _harvest_event(sys, force=drain)
    _harvest_sim3(sys, force=drain)
    _harvest_verify(sys, force=drain)
    lag_max = sys.LAG_MAX if sys.st.vi_inited else 2
    while fl.pendings and (drain or len(fl.pendings) >= lag_max
                           or (len(fl.pendings) >= sys.LAG_MIN
                               and sys._summary_ready(fl.pendings[0]))):
        _harvest_one(sys)


def _pull(sys, p: Pending):
    # a pull on a landed copy is ~free; one that waits blocks on the device queue
    with sys.timers.stage("harvest_pull" if sys._summary_ready(p) else "harvest_pull_block"):
        return p.summary.numpy()


def _harvest_one(sys):
    """JAX :290-377: LOST below the inlier floor; a visual frame below
    min_track_inliers first tries the reference-keyframe fallback, which
    drops the newer entries and re-seats tracking on its solution; then the
    keyframe decision (on an unchanged map only) and, before VI init, the
    VI-init attempt."""
    fl, cfg, ts = sys.fl, sys.cfg, sys.ts
    p = fl.pendings.popleft()
    if p.mode == "vi2":
        return _harvest_pair(sys, p)
    fr = p.frames[0]
    s = _pull(sys, p)
    n_in = int(s[0])
    if p.mode == "vi":
        sys.n_vi_frames += 1
        sys.n_vi_fallbacks += bool(s[2])
        if n_in < max(6, cfg.min_track_inliers // 2):
            return _lost(sys, p, fr, 1, "vi", n_in)
    elif n_in < cfg.min_track_inliers:
        res2, n2 = tracking_ctl.track_reference_kf(sys.m, sys.st, cfg, fr["feats"], fr["uv"],
                                                   sys.cam, sys.ext, generator=sys._gen)
        if res2 is None:
            return _lost(sys, p, fr, 1, "vis", n_in)
        n_in = n2
        # the newer entries rode this frame's rejected pose: dropped
        sys.traj.truncate(p.row + 1)
        sys.n_lost_frames += sum(len(q.frames) for q in fl.pendings)
        fl.pendings.clear()
        P_last, R_last = fr["pose_before"]
        RlT = R_last.transpose(-1, -2)
        ts.dP, ts.dR = tracking._mv(RlT, res2.P - P_last), RlT @ res2.R
        ts.P, ts.R = res2.P, res2.R
        ts.prev_feat_mp, ts.prev_angle, ts.has_prev = res2.feat_mp, fr["feats"].angle, True
        mf, mv = p.backup[-2:]
        fv = tracking._seen_mask(sys.m, res2.feat_mp).to(mf.dtype)
        sys.m = sys.m._replace(mp_found=mf + fv, mp_visible=mv + fv)
        anchor, _ = _anchor(sys)
        sys.traj.replace_at(p.row, tracking._traj_row(sys.m, res2.P, res2.R, anchor))
        # a keyframe made of this frame carries the fallback's pose and associations
        fr["pose"], fr["feat_mp"] = (res2.P, res2.R), res2.feat_mp
    ts.n_inliers = n_in
    _keyframe_decision(sys, p, fr, n_in)
    if not sys.st.vi_inited and cfg.use_imu:
        with sys.timers.stage("vi_init"):
            sys.m, vi = tracking_ctl.vi_init_tail(
                sys.m, sys.st, cfg, ts, fr["t"], sys.cam, sys.ext, sys.noise,
                sys._marks("vi_", sys.vi_probe), sys.viinit_log)
        if vi is not None and vi.accepted:
            sys.events.append((sys.frame_id, "vi_init",
                               dict(n_kf=vi.n_kf, scale=vi.scale, cond=vi.cond)))
            invalidate(sys)


def _harvest_pair(sys, p: Pending):
    """JAX :379-411: one summary read for the PAIR frames, the LOST and
    keyframe decisions per frame; a loss anywhere rolls back to the state
    before the pair."""
    cfg = sys.cfg
    s = _pull(sys, p)
    for i, fr in enumerate(p.frames):
        n_in = int(s[i][0])
        sys.n_vi_frames += 1
        sys.n_vi_fallbacks += bool(s[i][2])
        if n_in < max(6, cfg.min_track_inliers // 2):
            return _lost(sys, p, fr, len(p.frames) - i, "vi2", n_in)
        sys.ts.n_inliers = n_in
        _keyframe_decision(sys, p, fr, n_in)


def _keyframe_decision(sys, p: Pending, fr, n_in):
    st, ts = sys.st, sys.ts
    if (sys.localization_only or p.epoch != sys.fl.map_epoch
            or not tracking_ctl.need_new_kf(sys.m, st, sys.cfg, fr["frame_id"], n_in,
                                            ts.reloc_buf is not None)):
        return
    with sys.timers.stage("local_mapping"):
        with sys.timers.stage("lm_insert"):
            sys.m, _ = tracking_ctl.create_keyframe(
                sys.m, st, sys.cfg, ts, fr["feats"], fr["uv"], fr["t"], fr["frame_id"],
                fr["feat_mp"], sys.noise, detector=sys.loop, pose=fr["pose"], ns=fr["ns"])
        _local_mapping(sys)
    invalidate(sys)


def _local_mapping(sys):
    """The device half of the new keyframe's event (JAX mapping_ctl.py:94-145,
    after the previous event's host half, forced), tracking re-seated on the
    optimised keyframe; the host half waits for `_harvest_event`."""
    _harvest_event(sys, force=True)
    sys.n_kf_events += 1
    det = sys.loop
    det.snapshot_ids()                  # the event scores these histograms
    mark = sys._marks("lm_", sys.event_probe)
    sys.m, sys.fl.event = mapping_ctl.dispatch_event(
        sys.m, sys.st, sys.cfg, sys.frame_id, sys.cam, sys.ext, sys.ts.gw, sys.noise,
        hists=det.hists, timer=mark, **sys.event_kw)
    mark("end")
    tracking_ctl.reseat_on_newest_keyframe(sys.m, sys.st, sys.ts)


def _harvest_event(sys, force=False):
    """The host half of the last event once its stats copy has landed (JAX
    :413-457): stats noted, keyframes culled, then loop closing dispatched
    on its detection scores. The "ev_chain_drain" sample is the time from
    the event's last dispatch to this harvest."""
    fl = sys.fl
    ev = fl.event
    if ev is None or not (force or ev.copy.ready()):
        return
    fl.event = None
    if force:
        fl.n_events_forced += 1
    else:
        fl.n_events_deferred += 1
    sys.timers.samples["ev_chain_drain"].append(time.perf_counter() - ev.t_disp)
    with sys.timers.stage("lm_harvest"):
        sys.m, res = mapping_ctl.harvest_event(sys.m, sys.st, sys.cfg, sys.noise, ev,
                                               traj=sys.traj)
    if res.removed:
        sys.events.append((sys.frame_id, "kf_culled", dict(slots=list(res.removed))))
    if res.detect is not None and ev.slot in sys.st.kf_slots:
        with sys.timers.stage("loop_closing"):
            _try_close_loop(sys, ev.slot, res.detect)


def _try_close_loop(sys, slot, handles):
    """JAX loopctl.py:42-118 with handles: the stages of an earlier attempt
    finished first (at most one Sim3 batch in flight), then the new batch
    dispatched."""
    _harvest_sim3(sys, force=True)
    while sys.fl.verify is not None:
        _harvest_verify(sys, force=True)
    sys.fl.sim3 = loopctl.dispatch_sim3(sys.m, sys.st, sys.cfg, sys._loopctx, slot,
                                        sys.frame_id, sys.cam, sys.ext, handles=handles)


def close_loop_now(sys, slot):
    """JAX `_try_close_loop(slot)` with no handles (loopctl.py:42-118), the
    attempt of a keyframe decided off the steady state: the stages of an
    earlier attempt finished first, then a detection of its own, the Sim3
    batch and the verifications, all in this call (`loopctl.try_close_loop`,
    which re-seats tracking on a closure). Returns its LoopOutcome or None."""
    _harvest_sim3(sys, force=True)
    while sys.fl.verify is not None:
        _harvest_verify(sys, force=True)
    sys.m, out = loopctl.try_close_loop(sys.m, sys.st, sys.cfg, sys.ts, sys._loopctx, slot,
                                        sys.frame_id, sys.cam, sys.ext, sys.noise)
    return out


def _harvest_sim3(sys, force=False):
    fl = sys.fl
    p = fl.sim3
    if p is None or not (force or p.copy.ready()):
        return
    fl.sim3 = None
    fl.verify = loopctl.harvest_sim3_pending(sys.m, sys.st, sys.cfg, sys._loopctx, p,
                                             sys.frame_id, sys.cam, sys.ext)


def _harvest_verify(sys, force=False):
    fl = sys.fl
    v = fl.verify
    if v is None or not (force or v.copy.ready()):
        return
    fl.verify = None
    sys.m, fl.verify, closed = loopctl.harvest_verify_pending(
        sys.m, sys.st, sys.cfg, sys.ts, sys._loopctx, v, sys.frame_id, sys.cam, sys.ext,
        sys.noise)
    if closed is not None:
        # tracking goes on from the corrected NEWEST keyframe (a newer one than
        # the closure's may exist by now), with no velocity model
        tracking_ctl.reseat_on_newest_keyframe(sys.m, sys.st, sys.ts)
        ts = sys.ts
        ts.dP, ts.dR = torch.zeros_like(ts.dP), torch.eye(3, device=ts.dR.device)
        invalidate(sys)


def flush(sys):
    """Finish everything in flight (JAX :459-468): the entries, the event,
    the Sim3 batch and every verification it leads to; then the trajectory
    rows. After it no entry is pending and every frame given to `track`
    that was not lost has its trajectory row."""
    harvest_pending(sys, drain=True)
    _harvest_event(sys, force=True)
    _harvest_sim3(sys, force=True)
    while sys.fl.verify is not None:
        _harvest_verify(sys, force=True)
    sys.traj.flush()
