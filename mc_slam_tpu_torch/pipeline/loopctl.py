"""Loop-closure orchestration (port of mc_slam_tpu/pipeline/loopctl.py, the
roles of LoopClosing::Run / ComputeSim3 / CorrectLoop): detection gating, the
Sim3 batch and its harvest, the guided verification, and the application of
an accepted closure. Module functions over the `MappingState` / `TrackState`
of mapping_ctl / tracking_ctl and a `LoopContext` (the detector, the RANSAC
stream, the event log, the timers).

Two forms. `try_close_loop` consumes every stage as soon as it is dispatched
(the JAX package's `sync=True` form; the synchronous frame path). The frame
loop (pipeline/frameloop.py) takes the deferred one: `dispatch_sim3` queues
detection's Sim3 batch and starts its copy, `harvest_sim3_pending` reads it
once it has landed and queues the guided verification of the first passing
candidate (`dispatch_verify_pending`), `harvest_verify_pending` reads that
count and closes the loop or queues the next candidate: one verification a
harvest, at most one Sim3 batch in flight. The RANSAC samples are drawn from
`LoopContext.generator` at dispatch, in the order of dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.geometry.sim3solver import Sim3Result
from mc_slam_tpu_torch.imu.preintegration import IMUNoise
from mc_slam_tpu_torch.pipeline import loopclosing, mapping, mapping_ctl
from mc_slam_tpu_torch.pipeline.pipebase import HostCopy
from mc_slam_tpu_torch.slam_map.mapstate import (MapState, covisibility_weights,
                                                 observation_counts)
from mc_slam_tpu_torch.solver import factors
from mc_slam_tpu_torch.utils import metrics

N_CAND = 3               # Sim3 candidates per event (2 streaked + 1 fallback, padded)
BAR_STREAKED = 20        # RANSAC consensus asked of a candidate with a consistency streak
BAR_FALLBACK = 40        # ... and of one without
BAR_PAD = 1 << 20        # pad rows: a bar no candidate reaches
MIN_GUIDED = 40          # guided matches for acceptance (LoopClosing.cpp:459-498)


@dataclasses.dataclass
class LoopContext:
    """What loop closing needs beside the map and the host state."""
    detector: loopclosing.LoopDetector
    generator: torch.Generator | None = None
    enabled: bool = True
    events: list = dataclasses.field(default_factory=list)   # (frame, kind, detail) log
    timers: object = None        # a utils.metrics.StageTimer, or None
    probe: object = None         # callable(stage name), called as each stage starts

    def stage(self, name):
        return metrics.stage(self.timers, name)

    def mark(self, name):
        if self.probe is not None:
            self.probe(name)


class LoopOutcome(NamedTuple):
    """What one `try_close_loop` did (host values)."""
    cands: list                  # [(slot, streaked)] of the detector
    sim3: dict | None            # cands, n_in, ok of the Sim3 batch
    verify: list                 # [dict(cand, n_guided, n_ransac)]
    closed: dict | None          # the "loop" event's detail when a closure was applied
    curves: dict                 # cost curves: "sim3" (iters, C), "posegraph", "gba"
    measured: dict = {}          # candidate slot -> dict(s, R, t) of each Sim3 that passed


def loop_gates_open(st: mapping_ctl.MappingState, cfg, loop: LoopContext) -> bool:
    """The cheap host gates in front of loop detection (LoopClosing::Run): on,
    VI init done in IMU mode, at least 8 keyframes, 10 keyframes since the
    last closure."""
    if loop is None or not loop.enabled:
        return False
    if cfg.use_imu and not st.vi_inited:
        return False
    if len(st.kf_slots) < 8:
        return False
    return st.n_kf - st.last_loop_nkf >= 10


def try_close_loop(m: MapState, st: mapping_ctl.MappingState, cfg, ts, loop: LoopContext,
                   slot: int, frame_id: int, cam: Camera, ext: factors.Extrinsics,
                   noise: IMUNoise, handles=None, idx=None):
    """The loop-closing work of one keyframe event: detection on `handles`
    ((scores, W) of the event; dispatched here when None), at most 2 streaked
    candidates (bar 20) and 1 other (bar 40) through ONE batched Sim3 RANSAC +
    refinement, the guided verification of each passing candidate in turn,
    and the closure of the first that reaches 40 guided matches.

    idx: (3, 300, 3) RANSAC sample indices (drawn from loop.generator when
    None). Host reads: the detection (scores and W), the packed Sim3 rows, one
    count per verified candidate, and those of `apply_closure`.
    Returns (m, LoopOutcome or None when the gates are shut); `st`, `ts` and
    the detector are updated in place."""
    if not loop_gates_open(st, cfg, loop):
        return m, None
    act = list(st.kf_slots)
    if slot not in act:
        return m, None
    loop.mark("detect")
    with loop.stage("lc_detect"):
        cands = loop.detector.detect(m, slot, act, kf_ids=st.kf_id_host, handles=handles)
    if loop.detector.last_diag is not None:
        loop.events.append((frame_id, "lc_diag", dict(loop.detector.last_diag)))
    streaked = [c for c, s in cands if s][:2]
    fallback = [c for c, s in cands if not s][:1]
    todo = [(c, BAR_STREAKED) for c in streaked] + [(c, BAR_FALLBACK) for c in fallback]
    if not todo:
        loop.mark("end")
        return m, LoopOutcome(cands, None, [], None, {})
    # pad rows repeat the first candidate under a bar that cannot be reached
    pad = (todo + [(todo[0][0], BAR_PAD)] * N_CAND)[:N_CAND]
    dev = m.mp_pos.device
    both = torch.as_tensor(np.asarray(pad, np.int64), device=dev)     # one upload
    loop.mark("sim3")
    with loop.stage("lc_sim3"):
        packed, sim3_costs = loopclosing.sim3_ransac_batch(
            m, idx, slot, both[:, 0], both[:, 1], cam, ext=ext, fix_scale=st.vi_inited,
            generator=loop.generator, curve=True)
        host = torch.cat([packed.reshape(-1), sim3_costs.reshape(-1)]).cpu().numpy()
    rows = host[:N_CAND * 15].reshape(N_CAND, 15)
    curves = dict(sim3=host[N_CAND * 15:].reshape(-1, N_CAND))
    loop.events.append((frame_id, "sim3_dispatch", dict(
        cur_fid=st.kf_id_host.get(slot, -1),
        cand_fids=[st.kf_id_host.get(int(c), -1) for c, _ in todo])))
    passing, sim3 = harvest_sim3(st, loop, frame_id, rows, [c for c, _ in todo])
    verify, closed = [], None
    for cv in passing:
        loop.mark("verify")
        n_guided = int(dispatch_verify(m, st, cfg, loop, slot, cv, cam, ext))
        accept = harvest_verify(st, loop, frame_id, cv, n_guided, verify)
        if accept:
            m, closed, c2 = apply_closure(m, st, cfg, ts, loop, slot, cv["c"], cv, frame_id,
                                          cam, ext, noise)
            curves.update(c2)
            break
    loop.mark("end")
    return m, LoopOutcome(cands, sim3, verify, closed, curves,
                          {cv["c"]: dict(s=cv["s"], R=cv["R"], t=cv["t"]) for cv in passing})


def harvest_sim3(st: mapping_ctl.MappingState, loop: LoopContext, frame_id: int, rows,
                 cands):
    """Read the packed rows of a Sim3 batch ((C, 15) host array; the first
    len(cands) are real): the candidates that passed their bar, in order, as
    dicts c, s, R, t, n_in; the "sim3_result" event.
    Returns (passing, the event's detail)."""
    n = len(cands)
    ok_a = rows[:, 0] > 0.5
    nin_a = rows[:, 1].astype(np.int64)
    passing = []
    for i in range(n):
        c = int(cands[i])
        if bool(ok_a[i]) and c in st.kf_slots:
            passing.append(dict(c=c, s=float(rows[i, 2]), R=rows[i, 3:12].reshape(3, 3).copy(),
                                t=rows[i, 12:15].copy(), n_in=int(nin_a[i])))
    detail = dict(cands=[int(c) for c in cands], n_in=[int(x) for x in nin_a[:n]],
                  ok=[bool(x) for x in ok_a[:n]])
    loop.events.append((frame_id, "sim3_result", detail))
    return passing, detail


def verify_group(st: mapping_ctl.MappingState, cfg, loop: LoopContext, c: int):
    """The loop-side covisibility group of candidate `c`, padded to 5 slots
    with copies of c: its (at most 4) strongest neighbours of at least
    covis_th, from the covisibility matrix that came with the detection."""
    W = loop.detector.last_W
    if W is None:
        return [c] * 5
    nb = mapping_ctl._ranked(st, W[c], c, 4, fallback=False, covis_th=cfg.covis_th)
    return ([c] + nb + [c] * 5)[:5]


def _sim3_tensors(cv, device):
    """(s, R, t) of a harvested candidate as device tensors: one upload."""
    flat = torch.as_tensor(np.concatenate([[cv["s"]], np.asarray(cv["R"]).reshape(-1),
                                           np.asarray(cv["t"])]).astype(np.float32),
                           device=device)
    return flat[0], flat[1:10].reshape(3, 3), flat[10:13]


def dispatch_verify(m: MapState, st: mapping_ctl.MappingState, cfg, loop: LoopContext,
                    slot: int, cv, cam: Camera, ext: factors.Extrinsics):
    """The guided-reprojection verification of one RANSAC-passing candidate
    over its loop-side covisibility group (a whole-map projection search).
    Returns the match count, on the device."""
    dev = m.mp_pos.device
    grp = torch.as_tensor(verify_group(st, cfg, loop, cv["c"]), dtype=torch.int64, device=dev)
    with loop.stage("lc_verify"):
        return loopclosing.guided_match_count(m, slot, cv["c"], grp, *_sim3_tensors(cv, dev),
                                              cam, ext=ext)


def harvest_verify(st: mapping_ctl.MappingState, loop: LoopContext, frame_id: int, cv,
                   n_guided: int, log: list) -> bool:
    """Note a guided-match count; True when the candidate is accepted (at
    least 40 matches, and its keyframe still there)."""
    detail = dict(cand=cv["c"], n_guided=n_guided, n_ransac=cv["n_in"])
    loop.events.append((frame_id, "verify_result", detail))
    log.append(detail)
    return n_guided >= MIN_GUIDED and cv["c"] in st.kf_slots


class PendingSim3(NamedTuple):
    """A Sim3 batch in flight (`dispatch_sim3`)."""
    slot: int                    # the current keyframe
    cands: list                  # the real candidates, in the batch's order
    copy: HostCopy               # its (C, 15) packed rows


class PendingVerify(NamedTuple):
    """A guided verification in flight (`dispatch_verify_pending`)."""
    slot: int
    passing: list                # the RANSAC-passing candidates (harvest_sim3's dicts)
    idx: int                     # the one being verified
    copy: HostCopy               # its guided-match count


def dispatch_sim3(m: MapState, st: mapping_ctl.MappingState, cfg, loop: LoopContext,
                  slot: int, frame_id: int, cam: Camera, ext: factors.Extrinsics,
                  handles=None, idx=None):
    """The dispatch of `try_close_loop` (SlamSystem._try_close_loop with
    handles): detection on `handles`, the candidates (2 streaked at bar 20, 1
    other at bar 40) through ONE batched Sim3 RANSAC + refinement, its copy
    to the host started and not waited for; the "lc_diag" and
    "sim3_dispatch" events. idx: (3, 300, 3) samples, drawn from
    loop.generator when None. Host reads: the detection's.
    Returns a PendingSim3, or None (gates shut, no candidate)."""
    if not loop_gates_open(st, cfg, loop) or slot not in st.kf_slots:
        return None
    with loop.stage("lc_detect"):
        cands = loop.detector.detect(m, slot, list(st.kf_slots), kf_ids=st.kf_id_host,
                                     handles=handles)
    if loop.detector.last_diag is not None:
        loop.events.append((frame_id, "lc_diag", dict(loop.detector.last_diag)))
    todo = ([(c, BAR_STREAKED) for c, s in cands if s][:2]
            + [(c, BAR_FALLBACK) for c, s in cands if not s][:1])
    if not todo:
        return None
    pad = (todo + [(todo[0][0], BAR_PAD)] * N_CAND)[:N_CAND]
    both = torch.as_tensor(np.asarray(pad, np.int64), device=m.mp_pos.device)
    with loop.stage("lc_sim3"):
        packed = loopclosing.sim3_ransac_batch(m, idx, slot, both[:, 0], both[:, 1], cam,
                                               ext=ext, fix_scale=st.vi_inited,
                                               generator=loop.generator)
        copy = HostCopy(packed)
    loop.events.append((frame_id, "sim3_dispatch", dict(
        cur_fid=st.kf_id_host.get(slot, -1),
        cand_fids=[st.kf_id_host.get(int(c), -1) for c, _ in todo])))
    return PendingSim3(slot, [c for c, _ in todo], copy)


def dispatch_verify_pending(m: MapState, st: mapping_ctl.MappingState, cfg,
                            loop: LoopContext, slot: int, passing: list, i: int, cam: Camera,
                            ext: factors.Extrinsics) -> PendingVerify:
    """Queue the guided verification of passing[i] and start its copy."""
    h = dispatch_verify(m, st, cfg, loop, slot, passing[i], cam, ext)
    return PendingVerify(slot, passing, i, HostCopy(h.reshape(1)))


def harvest_sim3_pending(m: MapState, st: mapping_ctl.MappingState, cfg, loop: LoopContext,
                         p: PendingSim3, frame_id: int, cam: Camera, ext: factors.Extrinsics):
    """Read a Sim3 batch (SlamSystem._harvest_sim3; waits if its copy has not
    landed): the "sim3_result" event, then the verification of the first
    passing candidate queued. Nothing when the keyframe is gone or the gates
    have shut meanwhile. Returns a PendingVerify or None."""
    if p.slot not in st.kf_slots or not loop_gates_open(st, cfg, loop):
        return None
    with loop.stage("lc_sim3_pull"):
        rows = p.copy.numpy()
    passing, _ = harvest_sim3(st, loop, frame_id, rows, p.cands)
    if not passing:
        return None
    return dispatch_verify_pending(m, st, cfg, loop, p.slot, passing, 0, cam, ext)


def harvest_verify_pending(m: MapState, st: mapping_ctl.MappingState, cfg, ts,
                           loop: LoopContext, v: PendingVerify, frame_id: int, cam: Camera,
                           ext: factors.Extrinsics, noise: IMUNoise):
    """Read a guided-match count (SlamSystem._harvest_verify; waits if its
    copy has not landed): the "verify_result" event, then the closure
    (`apply_closure`) when it reaches 40, else the next passing candidate's
    verification queued. Returns (m, PendingVerify or None, the "loop"
    event's detail or None)."""
    if v.slot not in st.kf_slots or not loop_gates_open(st, cfg, loop):
        return m, None, None
    with loop.stage("lc_verify_pull"):
        n_guided = int(v.copy.numpy()[0])
    cv = v.passing[v.idx]
    if harvest_verify(st, loop, frame_id, cv, n_guided, []):
        m, closed, _ = apply_closure(m, st, cfg, ts, loop, v.slot, cv["c"], cv, frame_id, cam,
                                     ext, noise)
        return m, None, closed
    nxt = v.idx + 1
    if nxt < len(v.passing) and v.passing[nxt]["c"] in st.kf_slots:
        return m, dispatch_verify_pending(m, st, cfg, loop, v.slot, v.passing, nxt, cam,
                                          ext), None
    return m, None, None


def fuse_seam(m, loop_side, cur_side, n, cam, ext):
    """Cross-seam fusion (CorrectLoop's SearchAndFuse at 4 px): each of the
    first n keyframes of one side against each of the other, both ways."""
    obs_n = observation_counts(m)
    for a in loop_side[:n]:
        for b in cur_side[:n]:
            m, _ = mapping.fuse_into_keyframe(m, a, b, cam, ext, radius=4.0, obs_n=obs_n)
            m, _ = mapping.fuse_into_keyframe(m, b, a, cam, ext, radius=4.0, obs_n=obs_n)
    return m


def body_sim3(ext: factors.Extrinsics, s_c, R_c, t_c):
    """A Sim3 between two CAMERA frames as the Sim3 between the two BODY
    frames: S_b = Tbc o S_c o Tcb (the scale is unchanged)."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Rcb = ext.Rcb
    return s_c, Rcb.T @ R_c @ Rcb, mv(Rcb.T, s_c * mv(R_c, ext.tcb) + t_c - ext.tcb)


def seam_sides(m: MapState, st: mapping_ctl.MappingState, cfg, slot: int, cand: int,
               extra=None):
    """The keyframes on the two sides of a seam, for cross-seam fusion: the
    current keyframe with its (at most 4) covisibles, and the loop keyframe
    with its own that are not on the current side. One host read (both
    covisibility rows, and `extra`, a 1-d tensor that rides along).
    Returns (cur_side, loop_side, extra on the host)."""
    K = m.K
    parts = [covisibility_weights(m, slot), covisibility_weights(m, cand)]
    host = torch.cat(parts + ([extra.reshape(-1)] if extra is not None else [])).cpu().numpy()
    covis = lambda row, s: mapping_ctl._ranked(st, row, s, 4, fallback=True,
                                               covis_th=cfg.covis_th)
    cur_side = [slot] + [s for s in covis(host[:K], slot) if s != cand]
    loop_side = [cand] + [s for s in covis(host[K:2 * K], cand)
                          if s != slot and s not in cur_side]
    return cur_side, loop_side, host[2 * K:]


def apply_closure(m: MapState, st: mapping_ctl.MappingState, cfg, ts, loop: LoopContext,
                  slot: int, cand: int, cv, frame_id: int, cam: Camera,
                  ext: factors.Extrinsics, noise: IMUNoise):
    """Apply an accepted closure (CorrectLoop): the measured Sim3 (camera
    frames) conjugated into body frames, the essential-graph correction
    (`loopclosing.close_loop`), the loop edge persisted, cross-seam fusion at
    4 px (3 x 3 keyframes of the two sides), the whole-map BA without the
    association prune, a second fusion round (2 x 2) on the refined geometry,
    and tracking re-seated on the current keyframe with a zero velocity model.

    cv: dict s, R, t (loop camera -> current camera), n_in. One host read for
    the covisibility rows and the implied correction, one in `close_loop`.
    Returns (m, the "loop" event's detail, cost curves)."""
    dev = m.mp_pos.device
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    s_c, R_b, t_b = body_sim3(ext, *_sim3_tensors(cv, dev))
    # the implied correction BEFORE the map is touched: how far the measured
    # Sim3 moves the current keyframe from its estimate (the drift healed)
    Rcw_l = m.kf_ns.R[cand].T
    tcw_l = -mv(Rcw_l, m.kf_ns.P[cand])
    R_impl = R_b @ Rcw_l
    t_impl = s_c * mv(R_b, tcw_l) + t_b
    P_impl = -mv(R_impl.T, t_impl) / torch.clamp(s_c, min=1e-9)
    corr = torch.linalg.norm(P_impl - m.kf_ns.P[slot])
    cur_side, loop_side, corr_h = seam_sides(m, st, cfg, slot, cand, extra=corr)

    res = Sim3Result(ok=True, s=s_c, R=R_b, t=t_b, inliers=None, n_inliers=cv["n_in"])
    loop.mark("posegraph")
    with loop.stage("lc_posegraph"):
        m, pg_costs = loopclosing.close_loop(
            m, list(st.kf_slots), slot, cand, res, cam, fix_scale=st.vi_inited,
            loop_edges=st.loop_edges, mesh=st.mesh_e, kf_ids=st.kf_id_host, curve=True)
    pair = (min(cand, slot), max(cand, slot))
    if pair not in {(min(a, b), max(a, b)) for a, b in st.loop_edges}:
        st.loop_edges.append((cand, slot))
    detail = dict(cur=slot, cand=cand, cur_fid=st.kf_id_host.get(slot, -1),
                  cand_fid=st.kf_id_host.get(cand, -1), n_inliers=int(cv["n_in"]),
                  corr_m=round(float(corr_h[0]), 3), s=round(float(cv["s"]), 4))
    loop.events.append((frame_id, "loop", detail))
    st.n_loops_closed += 1
    st.last_loop_nkf = st.n_kf
    loop.mark("fuse1")
    m = fuse_seam(m, loop_side, cur_side, 3, cam, ext)
    loop.mark("gba")
    m, gba = mapping_ctl.local_ba(m, st, cfg, cam, ext, ts.gw, noise, force_all=True,
                                  prune=False)
    loop.mark("fuse2")
    m = fuse_seam(m, loop_side, cur_side, 2, cam, ext)
    # tracking continues from the corrected current keyframe
    ts.P, ts.R = m.kf_ns.P[slot], m.kf_ns.R[slot]
    if st.vi_inited:
        ts.ns = mapping_ctl.keyframe_navstate(m, slot)
        ts.prior = None
    ts.dP, ts.dR = torch.zeros(3, device=dev), torch.eye(3, device=dev)
    st.covis_row = None
    st.ref_tracked = None
    return m, detail, dict(posegraph=pg_costs, gba=gba.costs if gba is not None else None)
