"""Cells of configurations with `"runner": "slam"`: one monocular-inertial
stream through the port's entry point, `SlamSystem(cam, cfg, Tbc).track(img,
t, imu)`, started from raw frames.

Set-up, timed by `setup_s`: the seed's world (a room of its own and one
closed lap of the clone's path over the sequence's duration, as
`runners/multiseq.World` makes them; the stream starts at the lap's start),
the stream's IMU rows (the true body rate and specific force at the
configuration's rate, constant biases, white noise of the EuRoC densities,
all drawn on the device), its frames rendered on the device into pinned
host memory (in chunks, as the cold start reaches them, then every frame
the window may use), the cold start from raw frame 0 (two-view bootstrap,
visual tracking and mapping, VI initialization) and `warmup_frames` VI
frames. VI initialization not accepted by frame `vi_init_deadline` stops
the run.

Release: a closed loop paced by the camera, as the reference's
mono_EuRoC_vins runs a recorded sequence: frame k of a phase is passed to
`track` no earlier than k / fps after the phase began, and never before the
previous call returned; each frame takes exactly its IMU rows since the
frame before. The window runs the VI frames that follow, with their
keyframe events, for `seconds`; `frames_per_s` is the frames completed
over the window, and a call that returns False counts as failed.

`correct`: a recorder in front of the port's VI frame
(`pipeline/tracking._vi_frame_body`) keeps each window frame's inputs and
outputs by reference (the port never writes its state in place, so the
map points, images and states it keeps stay as they were). After the
window, `sample` of those frames drawn from the seed are computed again by
the plain reference (`benchmark/reference/vi_frame.py`) from the same
inputs, and compared (`frame_gaps`); and the window's trajectory, as
`get_trajectory` composes it, against the world's truth after a rigid
alignment (`ate_mm`), and the keyframes right after VI initialization
against the truth after a similarity alignment (`vi_scale_err_pct`, the
similarity's scale off 1).

With `--trace 1`, VI frames run untraced until the next one is
`lead_kf_gap` frames past the last keyframe; then the window is VI frames
under the profiler with the device alone and a program timer active
(`harness/program_window.traced_with_spans`) until it holds `trace_frames`
frames and `trace_events` keyframe events, at most `trace_frames_max` (the
steps after that are empty). SlamSystem makes a keyframe at least every
20 frames, so from 10 past the last one 11 frames hold an event; a VI frame
is ~60k launches, and every traced frame costs seconds of the profiler's
processing, so the window stays that short. The per-layer readers take the
program's spans from it (`metrics/_slam_spans.py`), and `Trace` its device
operations; then `host_frames` more frames with the host's operators, for
the breakdown's idle gaps.
"""
from __future__ import annotations

import inspect
import math
import time

import numpy as np
import torch

from benchmark.harness.trace import traced
from benchmark.reference import track
from benchmark.reference.vi_frame import vi_frame
from benchmark.runners.multiseq import CHUNK, World, intrinsics, reference_precision
from benchmark.sim.trajectory import TBC

STATE = ("P", "V", "R", "bg", "ba", "dbg", "dba")
MAP_POINTS = dict(pos="mp_pos", pm1="mp_pm1", active="mp_active", min_dist="mp_min_dist",
                  max_dist="mp_max_dist", normal="mp_normal")
COUNTERS = ("n_vi_frames", "n_vi_fallbacks", "n_kf_events", "n_lost_frames")


class Recorder:
    """Stands in front of the port's VI frame (`body`, or a wrapper of it
    taking its arguments) and keeps, by reference, each call's arguments,
    named as the port's function names them, and results while `on`."""

    def __init__(self, body, port_body=None):
        self.body = body
        self.sig = inspect.signature(port_body or body)
        self.calls = []
        self.on = False

    def __call__(self, *args, **kwargs):
        out = self.body(*args, **kwargs)
        if self.on:
            a = self.sig.bind(*args, **kwargs)
            a.apply_defaults()
            x = dict(a.arguments)
            m = x.pop("m")
            x["mp"] = {k: getattr(m, f) for k, f in MAP_POINTS.items()}
            self.calls.append((x, out))
        return out


def state_dict(ns):
    return {k: getattr(ns, k) for k in STATE}


def reference_inputs(x):
    """The reference's inputs (`vi_frame.vi_frame`) from one recorded call."""
    if x["frame"] is not None or x["feat_ur"] is not None:
        raise SystemExit("slam runner: the recorded VI frame is not a monocular one")
    noise = x["noise"]
    return dict(img=x["img"], rows=x["rawp"], last=state_dict(x["ns_last"]), gw=x["gw"],
                prior_s0=state_dict(x["prior_last"].ns0), prior_info=x["prior_last"].info,
                prev_feat_mp=x["pfm"], prev_angle=x["pan"], dt=x["dt_f"],
                fresh_info=x["fresh_prior_fb"], noise=(float(noise.sigma_g),
                                                       float(noise.sigma_a)),
                sigma_bg=x["sigma_bg"], sigma_ba=x["sigma_ba"])


def program_answer(out):
    """The port's answer of one VI frame, in the reference's form."""
    _, _, ns, fmp, Hp, _, _, summary = out
    s = summary.cpu()
    return dict(state=state_dict(ns), feat_mp=fmp, H_prior=Hp, n_inliers=int(s[0]),
                fallback=bool(s[2]))


def frame_gaps(a, r):
    """One frame's answer against the reference's: position (mm), rotation
    (deg), velocity (mm/s), gyro bias (mrad/s), accelerometer bias (mm/s^2),
    the prior handed on (relative Frobenius), feature slots whose map point
    differs, slots either side associates, and whether the inlier counts
    differ."""
    d64 = lambda t: t.detach().cpu().to(torch.float64)
    sa, sr = a["state"], r["state"]
    gap = lambda u, v: float(torch.linalg.norm(d64(u) - d64(v)))
    M = d64(sa["R"]).T @ d64(sr["R"])
    w = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    ang = math.atan2(float(torch.linalg.norm(w)), (float(torch.trace(M)) - 1) / 2)
    fa, fr = a["feat_mp"].cpu().to(torch.int64), r["feat_mp"].cpu().to(torch.int64)
    Hr = d64(r["H_prior"])
    return (1e3 * gap(sa["P"], sr["P"]), math.degrees(ang), 1e3 * gap(sa["V"], sr["V"]),
            1e3 * gap(sa["bg"] + sa["dbg"], sr["bg"] + sr["dbg"]),
            1e3 * gap(sa["ba"] + sa["dba"], sr["ba"] + sr["dba"]),
            float(torch.linalg.norm(d64(a["H_prior"]) - Hr) / torch.linalg.norm(Hr)),
            int((fa != fr).sum()), int(((fa >= 0) | (fr >= 0)).sum()),
            a["n_inliers"] != r["n_inliers"])


GAP_NAMES = ("pose_gap_mm.p90", "rot_gap_deg.p90", "vel_gap_mm_s.p90", "bg_gap_mrad_s.p90",
             "ba_gap_mm_s2.p90", "marg_gap_rel.p90")


def gaps(pairs):
    """The compared numbers over (answer, reference) pairs: the 90th
    percentile of each per-frame gap, the share of frames whose inlier
    count differs, and the share of feature slots whose map point differs
    among those either side associates."""
    f = [frame_gaps(a, r) for a, r in pairs]
    out = {n: float(np.quantile([x[i] for x in f], 0.9)) for i, n in enumerate(GAP_NAMES)}
    out["inlier_diff_pct"] = 100.0 * sum(x[8] for x in f) / len(f)
    out["match_diff_pct"] = 100.0 * sum(x[6] for x in f) / max(sum(x[7] for x in f), 1)
    return out


def align(est, gt, scale):
    """Least-squares rigid (or, with `scale`, similarity) alignment of est
    (N, 3) onto gt (N, 3), float64 numpy (Umeyama). Returns (RMSE of the
    aligned est, the scale)."""
    me, mg = est.mean(0), gt.mean(0)
    E, G = est - me, gt - mg
    U, S, Vt = np.linalg.svd(G.T @ E / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt)) or 1.0])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / max((E ** 2).sum() / len(est), 1e-30)) if scale else 1.0
    err = s * (R @ E.T).T + mg - gt
    return float(np.sqrt((err ** 2).sum(1).mean())), s


class Cell:
    """A slam cell made from the seed: the world, the IMU rows, the frames
    (rendered as they are reached) and the system; `frame(k)` is frame k's
    arguments to `track`."""

    def __init__(self, spec, seed, device, seconds, step_wrapper=None):
        from mc_slam_tpu_torch.camera import make_camera
        from mc_slam_tpu_torch.pipeline import tracking
        from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
        cfg, tr = spec["config"], spec["traffic"]
        c, imu = cfg["camera"], cfg["imu"]
        self.cfg, self.cell, self.device = cfg, spec["cell"], device
        self.cuda = device.type == "cuda"
        self.world = World(cfg, tr, seed, device)
        self.traj = self.world.trajs[0]
        self.fps = c["fps"]
        self.per = int(round(imu["rate"] / self.fps))
        n_max = self.cell["vi_init_deadline"] + self.cell["warmup_frames"] + max(
            int(math.ceil(seconds * self.fps)) + 1,
            self.cell["lead_kf_gap"] + self.cell["trace_frames_max"] + self.cell["host_frames"])
        self.n_max = min(n_max, self.world.lengths[0])
        self.rows = self.traj.imu(0.0, self.n_max * self.per, rate=imu["rate"], bg=imu["bg"],
                                  ba=imu["ba"], noise_scale=imu["noise_scale"],
                                  gen=self.world.gen, device=device)
        self.chunks = []
        cam = make_camera(*intrinsics(c)[:4], k1=c["k1"], k2=c["k2"], p1=c["p1"], p2=c["p2"],
                          k3=c["k3"], width=c["width"], height=c["height"], device=device)
        self.slam = SlamSystem(cam, SlamConfig(**cfg["slam"]), Tbc=np.asarray(TBC),
                               device=device)
        self.rig = track.Rig(intrinsics(c), c["width"], c["height"], TBC, device)
        self.tracking, self.body = tracking, tracking._vi_frame_body
        self.recorder = Recorder(step_wrapper(self.body) if step_wrapper is not None
                                 else self.body, self.body)
        tracking._vi_frame_body = self.recorder
        self.k = 0                      # the next frame of the stream

    def close(self):
        """Give the port its own VI frame back."""
        self.tracking._vi_frame_body = self.body

    def render_to(self, k):
        """Render every chunk of frames up to frame k (uint8, pinned)."""
        while len(self.chunks) * CHUNK <= k:
            lo = len(self.chunks) * CHUNK
            ids = list(range(lo, min(lo + CHUNK, self.n_max)))
            img = self.world.render(0, ids)[0]
            host = torch.empty(img.shape, dtype=torch.uint8, pin_memory=self.cuda)
            host.copy_(img)
            self.chunks.append(host)

    def frame(self, k):
        """(image, time, IMU rows since frame k - 1) of frame k."""
        if k >= self.n_max:
            raise SystemExit(f"slam runner: frame {k} is past the {self.n_max} made")
        self.render_to(k)
        rows = self.rows[(k - 1) * self.per:k * self.per] if k else None
        return self.chunks[k // CHUNK][k % CHUNK], k / self.fps, rows

    def track_next(self):
        """The next frame through `track`; returns whether it was tracked."""
        ok = self.slam.track(*self.frame(self.k))
        self.k += 1
        return ok

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def paced(self, n, seconds=None, first=None):
        """Frames self.k, self.k + 1, ... paced by the camera from now: n of
        them, or as many as start within `seconds`. Returns (frames run,
        failed, host seconds)."""
        t0, done, failed = time.perf_counter(), 0, 0
        while (n is None or done < n):
            now = time.perf_counter()
            if seconds is not None and now - t0 >= seconds and done:
                break
            wait = t0 + done / self.fps - now
            if wait > 0:
                time.sleep(wait)
            failed += not self.track_next()
            done += 1
            if first is not None and first():
                break
        self.sync()
        return done, failed, time.perf_counter() - t0

    def cold_start(self):
        """Raw frames from frame 0 until VI initialization is accepted.
        Returns the keyframes' Sim3 scale error against the truth (%)."""
        slam, deadline = self.slam, self.cell["vi_init_deadline"]
        self.paced(deadline, first=lambda: slam.st.vi_inited)
        if not slam.st.vi_inited:
            raise SystemExit(f"slam runner: VI initialization not accepted by frame {deadline}")
        slots = torch.as_tensor(list(slam.st.kf_slots), device=self.device)
        t = slam.m.kf_time[slots].to(torch.float64)
        est = slam.m.kf_ns.P[slots].cpu().numpy().astype(np.float64)
        gt = self.traj.pose(t)[0].cpu().numpy()
        return 100.0 * abs(align(est, gt, scale=True)[1] - 1.0)

    def counters(self):
        return {k: getattr(self.slam, k, None) for k in COUNTERS}

    def ate_mm(self, k0, k1):
        """RMSE (mm) of the trajectory of frames k0 .. k1 - 1 against the
        truth after a rigid alignment."""
        times = {round(k / self.fps, 9) for k in range(k0, k1)}
        rows = [(t, P) for t, P, _ in self.slam.get_trajectory() if round(float(t), 9) in times]
        if not rows:
            return float("inf")
        t = torch.as_tensor([float(x[0]) for x in rows], dtype=torch.float64, device=self.device)
        est = np.stack([np.asarray(x[1], np.float64) for x in rows])
        return 1e3 * align(est, self.traj.pose(t)[0].cpu().numpy(), scale=False)[0]

    def sample(self, seed):
        """The recorded calls compared with the reference: `sample` of them
        drawn from the seed."""
        calls = self.recorder.calls
        gen = torch.Generator().manual_seed(seed)
        pick = torch.randperm(len(calls), generator=gen)[:self.cell["sample"]]
        return [calls[i] for i in sorted(pick.tolist())]

    def reference(self, x, tf32=False):
        """The plain reference's answer to one recorded call, in float32 or,
        for the control, with TF32 products."""
        cfg = self.cfg["slam"]
        with reference_precision(tf32):
            return vi_frame(reference_inputs(x), x["mp"], self.rig, cfg["n_feat"],
                            cfg["n_levels"], iters=x["iters"], fb_min_inliers=x["fb_min_inliers"])


def note(cell, before, k0, k1):
    after = cell.counters()
    moved = {k: None if before[k] is None else after[k] - before[k] for k in COUNTERS}
    if moved["n_vi_frames"] is None:
        return (f"window frames {k0}-{k1 - 1}; the program has no VI frame or event counters; "
                f"lost {moved['n_lost_frames']}")
    return (f"window frames {k0}-{k1 - 1}: {moved['n_vi_frames']} VI frames, "
            f"{moved['n_vi_fallbacks']} fallbacks, {moved['n_kf_events']} keyframe events, "
            f"{moved['n_lost_frames']} lost")


def run(spec, seed, seconds, trace, device, t_start, step_wrapper=None):
    """One run of a slam cell. Returns the harness's result dict."""
    cell = Cell(spec, seed, device, seconds, step_wrapper)
    try:
        return _run(cell, spec, seed, seconds, trace, device, t_start)
    finally:
        cell.close()


def _run(cell, spec, seed, seconds, trace, device, t_start):
    from benchmark.harness import program_window
    c = cell.cell
    scale_err = cell.cold_start()
    n_win = c["lead_kf_gap"] + c["trace_frames_max"] + c["host_frames"] if trace else \
        int(math.ceil(seconds * cell.fps)) + 1
    cell.render_to(min(cell.k + c["warmup_frames"] + n_win, cell.n_max) - 1)
    cell.paced(c["warmup_frames"])
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = dict(setup_s=time.perf_counter() - t_start)
    if trace:
        # untraced, until the next frame is lead_kf_gap frames past the last keyframe
        while cell.slam.frame_id - cell.slam.st.last_kf_frame < c["lead_kf_gap"]:
            cell.track_next()
    before, k0 = cell.counters(), cell.k
    cell.recorder.on = True
    if trace:
        kf0 = cell.slam.st.n_kf

        def step(_):
            """The next frame, until the window holds `trace_frames` frames
            and `trace_events` keyframe events; then an empty step."""
            if cell.k - k0 >= c["trace_frames"] and \
                    cell.slam.st.n_kf - kf0 >= c["trace_events"]:
                return None
            return cell.track_next()
        done, events, window_s, records = program_window.traced_with_spans(
            step, c["trace_frames_max"], device)
        done = [ok for ok in done if ok is not None]
        n, n_ev = len(done), cell.slam.st.n_kf - kf0
        more, host_events, host_s, _ = traced(lambda k: cell.track_next(), c["host_frames"],
                                              device)
        done += more
        # the device's operations for `Trace` (no span's shadow among them)
        cuda = torch.autograd.DeviceType.CUDA
        dev_events = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
        out["trace"] = (dev_events, window_s, dict(
            steps=n, host_events=host_events,
            program=dict(events=events, records=records, window_s=window_s)))
        failed = sum(not ok for ok in done)
    else:
        n_done, failed, window_s = cell.paced(None, seconds=seconds)
        done = range(n_done)
        out["frames_per_s"] = n_done / window_s
    cell.recorder.on = False
    cell.sync()
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cell.cuda else 0
    out["attempted"], out["failed"] = len(done), failed
    out["steps"], out["window_s"] = len(done), window_s
    out["note"] = note(cell, before, k0, cell.k)
    if trace:
        out["note"] += (f"; traced windows {window_s:.3f} s ({n} frames, {n_ev} keyframes, "
                        f"device alone, program spans on) and {host_s:.3f} s "
                        f"({c['host_frames']} frames with host operators)")
    sampled = cell.sample(seed)
    checks = gaps([(program_answer(o), cell.reference(x)) for x, o in sampled]) if sampled \
        else {k: float("inf") for k in GAP_NAMES + ("inlier_diff_pct", "match_diff_pct")}
    checks["ate_mm"] = cell.ate_mm(k0, cell.k)
    checks["vi_scale_err_pct"] = scale_err
    out["checks"] = checks
    return out
