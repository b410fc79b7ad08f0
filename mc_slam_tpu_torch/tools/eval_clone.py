"""End-to-end evaluation of the port on the synthetic EuRoC clone (the
counterpart of examples/eval_clone.py for `mc_slam_tpu_torch`).

    python3 -m mc_slam_tpu_torch.tools.eval_clone [--profile euroc|mid|small|loops|hard]
        [--dataset DIR] [--duration 120] [--max-frames N] [--final-gba] [--no-loops]
        [--out artifacts/ate_clone_PROFILE_torch.json]
        [--inject-drift [--drift-window T0 T1] [--drift-step DX DY DZ YAW]]
        [--gate [--gate-ate 0.15] [--gate-scale 0.02] [--gate-fps 20] [--gate-lost 60]]
        [--save-checkpoint PATH [--max-seconds S]] [--resume PATH]

Writes the clone dataset (an ASL folder: 752x480 distorted frames at 20 fps,
200 Hz IMU with EuRoC noise densities and non-zero biases, the real EuRoC
Tbc, ground truth; the arguments of examples/make_euroc_clone.py) with
`sim.euroc_writer` if it is not there yet, reads it back with `io.euroc`,
runs `SlamSystem` at the profile's configuration through `track(img, t,
imu)` with one frame of upload lookahead, scores the trajectory against
ground truth with `eval.ate` (similarity alignment, whole run and after VI
init) and writes the result, with the card's name and power limit, to
artifacts/ate_clone_PROFILE_torch.json, beside it the trajectory with each
frame's anchor keyframe (traj_clone_PROFILE_torch.npz), the aligned error
over time (drift_clone_PROFILE_torch.npz) and, where matplotlib is
installed, a picture of the map (map_clone_PROFILE_torch.png); the side
files take the stem of `--out` when it starts with "ate_clone_".

The profiles are the JAX script's (PROFILE_CONFIG, PROFILE_GEN,
PROFILE_DURATION): euroc (the default) and hard run max_kf 512, max_mp
16384, 1024 features, 8 levels, window 20; mid 256 / 8192 / 768 / 4 levels /
window 12; small 64 / 4096 / 512 / 3 levels / window 8; loops the euroc
tables with 384 features. Every profile waits 15 s before VI init. hard
renders 2 laps in 60 s with 1.6 x yaw, 25 ms blur and 0.55 x contrast;
loops 2 laps in 240 s at 6 x IMU noise with two weak-texture walls. A
`--duration` left at 120 s takes the profile's own; a dataset argument
given on the command line wins over the profile's.

`--inject-drift` is the JAX script's loop-closure demonstration: once VI is
initialized and tracking is OK, on every frame inside `--drift-window` (s,
from the first such frame) everything created after the first injected
frame (keyframes and points) and the tracker's last state and prior are
moved by one small gravity-preserving step (`--drift-step`: translation and
yaw a frame), on the device (`inject_drift`). It runs after every `track`
call in both modes; in the frame loop it moves the optimistic tracking
state and reads the state as the loop has it then, and the frames in flight
keep the poses they were dispatched with, as in the JAX script (whose
artifact ran in its loop at LAG_MAX 12 / PAIR 2). The JAX artifact's demo ran
`--drift-window 20 50 --drift-step 0.0008 -0.0005 0.0005 0.0004`. `--gate` exits 1
when the result breaks the JAX script's acceptance rules (`gate`).

A run can span several calls (a card call's time limit holds ~800 VI
frames): `--save-checkpoint PATH` stops at the first keyframe event at or
after frame `--max-frames` (or after `--max-seconds` of tracking, whichever
comes first) and saves the system there (`io.checkpoint`; the load reseats
tracking at the newest keyframe, which is then this frame, and the saved
`.track.npz` puts back the rest of the tracker's state, so the resumed call
tracks on as the uninterrupted run would), with the run's record so far
(and the drift injection's start and cutoff) in PATH.run.json; `--resume
PATH` loads it and goes on from the next frame, and its result covers the
whole run (the trajectory rows before the resume included) with the
aligned error on either side of each seam. Give every call the same
profile and drift arguments. Both render the clone in memory with the
draws of all its frames, so every call sees the frames and IMU rows of one
and the same full-length run, and render only their own frames (four views
ahead on one thread).

Loop closing and relocalization are on, as in the JAX script; `--no-loops`
turns loop closing off (relocalization stays). The result carries the JAX
script's keys beside the port's own, and the capacity evictions of the run
(`eviction_watch`: keyframes the allocator evicted, point-eviction passes;
one host read an event). Where no PNG codec is installed
(neither PIL nor imageio) the frames are rendered straight into the run and
nothing is written. Needs a GPU unless `--device cpu` is given.
MC_SLAM_LAG_MAX / MC_SLAM_PAIR select the frame loop (pipeline/system.py);
the result's `lag_max` / `pair` say which mode ran. The loop is flushed
after the last frame, before anything is counted.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

import numpy as np
import torch

# the reference's EuRoC Tbc (config/euroc.yaml:40-44)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
T_OFF = 100.0       # EuRoC-style large absolute timestamps

# The JAX script's profile tables (examples/eval_clone.py:38-52, 136-155).
# Its comment on PROFILE_GEN still describes an older 3-lap, 8 x IMU noise
# "loops" profile; the table itself, copied here, is 2 laps at 6 x.
PROFILE_GEN = {
    "loops": ["--laps", "2", "--imu-noise-scale", "6",
              "--weak-walls", "1", "3", "--weak-contrast", "0.45"],
    "hard": ["--laps", "2", "--yaw-scale", "1.6", "--blur-ms", "25",
             "--tex-contrast", "0.55"],
}
# the JAX script writes these under /tmp; the port keeps its data in the checkout
PROFILE_DATASET = {
    "loops": "_scratch/euroc_clone_loops",
    "hard": "_scratch/euroc_clone_hard",
}
DEFAULT_DATASET = "_scratch/euroc_clone"
PROFILE_DURATION = {"loops": 240.0, "hard": 60.0}
_EUROC = dict(max_kf=512, max_mp=16384, n_feat=1024, n_levels=8, local_window=20)
PROFILE_CONFIG = {
    "euroc": _EUROC,
    "hard": _EUROC,
    "loops": dict(_EUROC, n_feat=384),
    "mid": dict(max_kf=256, max_mp=8192, n_feat=768, n_levels=4, local_window=12),
    "small": dict(max_kf=64, max_mp=4096, n_feat=512, n_levels=3, local_window=8),
}
PROFILES = ("euroc", "mid", "small", "loops", "hard")
# The JAX script reads the clone through the repo's native loader, which
# gives the stream's first IMU sample a dt of 5 ms (native/euroc_loader.cc:
# 180-181) where io.euroc gives it 0: the rows between the first two frames
# would span 45 ms of their 50, and the IMU edge between the two-view
# keyframes (often those two frames) would disagree with their poses.
NATIVE_FIRST_DT = 0.005
# the StageTimer stages that no other stage encloses; the rest of the wall
# time (host glue, the event stages of a frame tracked off the steady state,
# a deferred event harvest of the frame loop) is reported as unattributed
TOP_STAGES = ("track", "extract", "initialize", "relocalize", "stereo", "global_refine",
              "harvest_pull", "harvest_pull_block", "local_mapping", "vi_init", "loop_closing")


def profile_config(profile: str):
    """The SlamConfig of a profile (IMU on, 15 s before VI init)."""
    from mc_slam_tpu_torch.pipeline.system import SlamConfig
    return SlamConfig(**PROFILE_CONFIG[profile], use_imu=True, vi_init_time=15.0, g_mag=9.810)


def drift_step(step, device):
    """(R_g, t_g) of one injection step [dx, dy, dz, yaw]: a rotation about
    the world's z axis (gravity kept) and a translation."""
    from mc_slam_tpu_torch import lie
    s = np.asarray(step, np.float32)
    Rg = lie.so3_exp(torch.tensor([0.0, 0.0, float(s[3])], device=device))
    return Rg, torch.as_tensor(s[:3], device=device)


def inject_drift(m, ns_last, ns0, Rg, tg, cutoff):
    """One drift step on the device (the JAX script's `_inject`): the
    keyframes whose id (their frame) is past `cutoff` move by x -> R_g x +
    t_g with their rotation and velocity turned by R_g, and so do the points
    first seen after it and their normals; the last NavState and the
    prior's linearization point `ns0` (None when there is no prior) move
    all the same. New tensors throughout; the inputs are left as they were.
    Returns (m, ns_last, ns0)."""
    ns = m.kf_ns
    kf = (m.kf_active & (m.kf_id > cutoff))[:, None]
    mp = (m.mp_active & (m.mp_first_kf > cutoff))[:, None]
    Rt = Rg.transpose(0, 1)
    kf_ns = ns._replace(P=torch.where(kf, ns.P @ Rt + tg, ns.P),
                        R=torch.where(kf[:, :, None], Rg @ ns.R, ns.R),
                        V=torch.where(kf, ns.V @ Rt, ns.V))
    m = m._replace(kf_ns=kf_ns, mp_pos=torch.where(mp, m.mp_pos @ Rt + tg, m.mp_pos),
                   mp_normal=torch.where(mp, m.mp_normal @ Rt, m.mp_normal))

    def move(s):
        return None if s is None else s._replace(P=Rg @ s.P + tg, R=Rg @ s.R, V=Rg @ s.V)
    return m, move(ns_last), move(ns0)


class DriftInjector:
    """When to inject (the JAX script's `maybe_inject`): VI initialized and
    tracking OK, inside [window[0], window[1]] s from the first such frame;
    the cutoff is the frame id of the first injected frame. `t_start` and
    `cutoff` are the state a run across calls carries. Called after each
    `track`; in the frame loop the state it reads and moves is the loop's
    at that moment (the tracker's optimistic NavState and prior), and the
    entries in flight and the pair buffer are left as they were
    dispatched."""

    def __init__(self, window, step, device, t_start=None, cutoff=None):
        self.window = tuple(float(w) for w in window)
        self.Rg, self.tg = drift_step(step, device)
        self.t_start, self.cutoff = t_start, cutoff
        self.n_injected = 0

    def __call__(self, slam, t_frame):
        from mc_slam_tpu_torch.pipeline.pipebase import OK
        if not slam.vi_inited or slam.state != OK:
            return False
        if self.t_start is None:
            self.t_start = t_frame
        if not self.window[0] <= t_frame - self.t_start <= self.window[1]:
            return False
        if self.cutoff is None:
            self.cutoff = slam.frame_id - 1
        ts = slam.ts
        ns0 = ts.prior.ns0 if ts.prior is not None else None
        slam.m, ts.ns, ns0 = inject_drift(slam.m, ts.ns, ns0, self.Rg, self.tg, self.cutoff)
        ts.P, ts.R = ts.ns.P, ts.ns.R
        if ts.prior is not None:
            ts.prior = ts.prior._replace(ns0=ns0)
        self.n_injected += 1
        return True


@contextlib.contextmanager
def eviction_watch():
    """While active, record the capacity evictions of a run. Yields a dict:
    "kf" one entry per keyframe slot that `mapping_ctl.alloc_kf_slot` freed
    by evicting (the slot, its keyframe's frame, whether VI was initialized,
    the active keyframes after the new one joins, the table's size); "mp" one
    entry per event whose landmark maintenance ran the eviction pass, with the
    active points of the map after the same maintenance without that pass and
    after it (the tables before and after, read here; the package counts
    nothing). Each entry costs one host read (and an entry of "mp" one more
    landmark maintenance without eviction)."""
    from mc_slam_tpu_torch.pipeline import mapping, mapping_ctl
    watch = dict(kf=[], mp=[])
    orig_alloc, orig_cull = mapping_ctl.alloc_kf_slot, mapping.cull_and_evict

    def alloc(m, st, cfg, noise, traj=None):
        full = not st.free_slots and st.next_fresh_slot >= m.K
        kid = dict(st.kf_id_host)
        m, slot = orig_alloc(m, st, cfg, noise, traj=traj)
        if full:
            watch["kf"].append(dict(slot=slot, kf_frame=kid.get(slot), vi=st.vi_inited,
                                    n_active=len(st.kf_slots) + 1, K=m.K))
        return m, slot

    def cull(m, current_kf_id, min_obs=3, n_evict=0):
        out = orig_cull(m, current_kf_id, min_obs=min_obs, n_evict=n_evict)
        if n_evict > 0:
            kept = orig_cull(m, current_kf_id, min_obs=min_obs, n_evict=0)
            a, b = torch.stack([torch.sum(kept.mp_active), torch.sum(out.mp_active)]).tolist()
            watch["mp"].append(dict(kf_frame=int(current_kf_id), before=int(a), after=int(b),
                                    evicted=int(a - b), P=m.P))
        return out

    mapping_ctl.alloc_kf_slot, mapping.cull_and_evict = alloc, cull
    try:
        yield watch
    finally:
        mapping_ctl.alloc_kf_slot, mapping.cull_and_evict = orig_alloc, orig_cull


def gate(result, on_card: bool, ate=0.15, scale=0.02, fps=20.0, lost=60):
    """The JAX script's acceptance rules (examples/eval_clone.py:431-466):
    the hard profile survives (longest lost streak at most 100 frames,
    tracking OK at the end), the others hold post-init ATE, scale error and
    lost frames under their limits; the loops profile with loop closing on
    closes a loop; on the card the amortized frame rate reaches `fps`.
    Returns the list of failures (empty: passed)."""
    fails = []
    if result["profile"] == "hard":
        if result["max_lost_streak"] > 100:
            fails.append(f"max_lost_streak {result['max_lost_streak']} > 100 frames")
        if not result["tracking_finished_ok"]:
            fails.append("tracking did not finish in OK state")
    else:
        if result["ate_rmse_post_init"] > ate:
            fails.append(f"ate_rmse_post_init {result['ate_rmse_post_init']:.3f} > {ate}")
        if result["abs_scale_err"] > scale:
            fails.append(f"abs_scale_err {result['abs_scale_err']:.4f} > {scale}")
        if result["n_lost"] > lost:
            fails.append(f"n_lost {result['n_lost']} > {lost}")
    if result["profile"] == "loops" and result["loop_closing_enabled"] \
            and result["loops_closed"] < 1:
        fails.append("loops_closed 0 on the multi-lap drift profile")
    if on_card and result["e2e_fps_amortized"] < fps:
        fails.append(f"e2e_fps {result['e2e_fps_amortized']:.1f} < {fps}")
    return fails


def drift_diagnostics(t_est, P_est, t_gt, P_gt, seg_len=5.0):
    """The JAX script's per-segment drift (examples/eval_clone.py:274-310):
    the similarity-aligned error over time, and per 5 s window its mean and
    its change per metre travelled. Returns (drift dict, te, err_t)."""
    from mc_slam_tpu_torch.eval.ate import associate, horn_align
    pairs = associate(t_est, t_gt, 0.02)
    ie = np.asarray([p[0] for p in pairs])
    ig = np.asarray([p[1] for p in pairs])
    Pe, Pg, te = P_est[ie], P_gt[ig], t_est[ie]
    s_al, R_al, t_al = horn_align(Pe, Pg, True)
    err_t = np.linalg.norm((s_al * (R_al @ Pe.T)).T + t_al - Pg, axis=1)
    rows = []
    t0, tend = te[0], te[-1]
    while t0 < tend:
        sel = (te >= t0) & (te < t0 + seg_len)
        if sel.sum() > 5:
            dist = np.linalg.norm(np.diff(Pg[sel], axis=0), axis=1).sum()
            de = err_t[sel][-1] - err_t[sel][0]
            rows.append({"t0": round(float(t0 - te[0]), 1), "dist_m": round(float(dist), 2),
                         "err_mean_m": round(float(err_t[sel].mean()), 4),
                         "derr_per_m": round(float(de / max(dist, 1e-6)), 4)})
        t0 += seg_len
    drift = {"segments": rows, "err_t_final_m": round(float(err_t[-1]), 4),
             "worst_segment": max(rows, key=lambda r: r["err_mean_m"]) if rows else {}}
    return drift, te, err_t


def dataset_hash(mav0):
    """The JAX script's dataset fingerprint: sha256 of the image and IMU
    CSVs and the first and last image files, 16 hex digits."""
    import hashlib
    h = hashlib.sha256()
    for rel in ("cam0/data.csv", "imu0/data.csv"):
        with open(os.path.join(mav0, rel), "rb") as f:
            h.update(f.read())
    img_dir = os.path.join(mav0, "cam0", "data")
    imgs = sorted(os.listdir(img_dir))
    for nm in (imgs[0], imgs[-1]):
        with open(os.path.join(img_dir, nm), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def stage_summary(samples):
    """name -> n, median / mean / max ms and total s of host-clock samples
    (utils.metrics.StageTimer.summary's host half)."""
    out = {}
    for name, xs in samples.items():
        a = np.asarray(xs, np.float64)
        if a.size:
            out[name] = {"n": int(a.size), "median_ms": round(float(np.median(a) * 1e3), 2),
                         "mean_ms": round(float(a.mean() * 1e3), 2),
                         "max_ms": round(float(a.max() * 1e3), 1),
                         "total_s": round(float(a.sum()), 1)}
    return out


def _step_occluders(occ, fdt):
    """Advance the drifting occluders; they bounce at the frame's edges."""
    for o in occ:
        o["uv"] = o["uv"] + o["vel"] * fdt
        for k in range(2):
            if not (0.0 <= o["uv"][k] <= 0.95):
                o["vel"][k] = -o["vel"][k]
                o["uv"][k] = np.clip(o["uv"][k], 0.0, 0.95)
    return occ


def _clone_world(args):
    """(generator, camera, world, trajectory) of the clone, the generator
    past the world's texture draws."""
    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
    rng = np.random.default_rng(args.seed)
    cam = euroc_camera(device="cpu")            # the renderer runs on the host
    world = RoomWorld(rng, tex_size=args.tex_size, tex_scale=args.tex_scale,
                      weak_walls=tuple(args.weak_walls), weak_contrast=args.weak_contrast)
    traj = MavTrajectory(duration=args.duration / max(args.laps, 1),
                         yaw_scale=args.yaw_scale)
    return rng, cam, world, traj


def _render_view(args, cam, world, traj, t):
    """The frame at time t before its draws from the generator: the room seen
    from the MAV's camera and, hardened, blended with the view blur_ms later."""
    Rbc, pbc = TBC[:3, :3], TBC[:3, 3]
    P_wb, R_wb = traj.pose(t)
    img = world.render(cam, R_wb @ Rbc, P_wb + R_wb @ pbc)
    if args.harden:
        P2, R2 = traj.pose(t + args.blur_ms * 1e-3)
        img2 = world.render(cam, R2 @ Rbc, P2 + R2 @ pbc)
        img = 0.5 * img.astype(np.float32) + 0.5 * img2.astype(np.float32)
    if args.tex_contrast != 1.0:
        img = np.clip(118.0 + args.tex_contrast * (np.asarray(img, np.float32) - 118.0),
                      0, 255).astype(np.float32 if args.harden else np.uint8)
    return img


def render_clone(args, n_frames, lo=0, hi=None, workers=0):
    """Yield (t, img uint8, P_wb, R_wb, V) for each frame of the clone, as
    examples/make_euroc_clone.py renders it: the textured room along the MAV
    trajectory and, with args.harden, motion blur over the exposure window,
    exposure flicker with sensor noise, and two drifting occluders. Then one
    last item (None, imu_rows) with the (T, 6) IMU samples of the whole span.
    The draws from the seeded generator come in that script's order.

    Only the frames in [lo, hi) are rendered and yielded; the draws of the
    others are made all the same (same sizes, same order), so the frames in
    range and the IMU rows are those of the whole clone. workers: views
    rendered ahead on one background thread (the draws stay in order on
    this thread). One thread: OpenBLAS splits the rows of a product that
    several threads call at once otherwise than those of a lone call, and
    rounds a band of the image differently."""
    rng, cam, world, traj = _clone_world(args)
    hi = n_frames if hi is None else min(hi, n_frames)
    H, W = cam.height, cam.width
    frame_shape = np.empty((H, W), np.uint8)     # for the occluder boxes' shapes
    fdt = 1.0 / args.fps
    occ = [{"uv": rng.uniform(0.1, 0.9, 2), "vel": rng.uniform(-0.15, 0.15, 2),
            "wh": rng.uniform(0.06, 0.16, 2), "val": rng.uniform(15, 55)}
           for _ in range(2)]
    pool, ahead = None, {}
    if workers and hi > lo:
        from concurrent.futures import ThreadPoolExecutor
        _render_view(args, cam, world, traj, lo * fdt)      # fills the ray cache once
        pool = ThreadPoolExecutor(1)
    try:
        for i in range(n_frames):
            t = i * fdt
            todo = lo <= i < hi
            img = None
            if todo and pool is not None:
                for k in range(i, min(i + workers, hi)):
                    if k not in ahead:
                        ahead[k] = pool.submit(_render_view, args, cam, world, traj, k * fdt)
                img = ahead.pop(i).result()
            elif todo:
                img = _render_view(args, cam, world, traj, t)
            if args.harden:
                gain = 1.0 + 0.12 * np.sin(2 * np.pi * 0.9 * t + 0.7) + rng.normal(0.0, 0.02)
                noise = rng.normal(0.0, 1.5, (H, W))
                if todo:
                    img = img * gain + noise
                for o in _step_occluders(occ, fdt):
                    u0, v0 = int(o["uv"][0] * W), int(o["uv"][1] * H)
                    w, h = int(o["wh"][0] * W), int(o["wh"][1] * H)
                    box = (slice(max(v0, 0), v0 + h), slice(max(u0, 0), u0 + w))
                    val = o["val"] + rng.normal(0, 3.0, frame_shape[box].shape)
                    if todo:
                        img[box] = val
                if todo:
                    img = np.clip(img, 0, 255).astype(np.uint8)
            if todo:
                P_wb, R_wb = traj.pose(t)
                yield t + T_OFF, img, P_wb, R_wb, traj.velocity(t)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    rows = traj.imu_samples(0.0, n_frames * fdt, rate=200.0, bg=np.asarray(args.bg),
                            ba=np.asarray(args.ba), noise_g=1.7e-4 * args.imu_noise_scale,
                            noise_a=2e-3 * args.imu_noise_scale, rng=rng)
    yield None, rows


def write_clone(args, n_frames):
    """The clone as an ASL folder under args.dataset. Returns the path of
    its ground-truth CSV."""
    from mc_slam_tpu_torch.sim.euroc_writer import EurocWriter
    writer = EurocWriter(args.dataset)
    bg, ba = np.asarray(args.bg), np.asarray(args.ba)
    t0 = time.time()
    for i, item in enumerate(render_clone(args, n_frames)):
        if item[0] is None:
            rows = item[1]
            tt = T_OFF + np.arange(len(rows)) / 200.0
            for k in range(len(rows)):
                writer.add_imu(tt[k], rows[k, 0:3], rows[k, 3:6])
            break
        t, img, P, R, V = item
        writer.add_image(t, img)
        writer.add_gt(t, P, R, V, bg, ba)
        if i % 200 == 0:
            print(f"frame {i}/{n_frames} written ({time.time() - t0:.0f} s)", file=sys.stderr)
    return writer.finish()


def imu_slices(seq):
    """io.euroc's (t, image path, IMU rows) per frame with the native
    loader's dt for the stream's first IMU sample, the IMU rows the JAX
    script's run reads."""
    from mc_slam_tpu_torch.io import euroc
    first = True
    for t, path, rows in euroc.slice_imu_per_frame(seq):
        if first and len(rows):
            rows = rows.copy()
            rows[0, 6] = NATIVE_FIRST_DT
            first = False
        yield t, path, rows


def frames_from_disk(mav0, max_frames):
    """(frames iterator of (t, img uint8, imu rows), t_gt, P_gt) read with
    io.euroc from an ASL folder (`imu_slices`)."""
    from mc_slam_tpu_torch.io import euroc
    seq = euroc.load_sequence(mav0)
    gt = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
                    delimiter=",", comments="#")

    def frames():
        for n, (t, path, rows) in enumerate(imu_slices(seq)):
            if max_frames and n >= max_frames:
                return
            yield t, euroc.load_gray_image(path).astype(np.uint8), rows
    return frames(), gt[:, 0] / 1e9, gt[:, 1:4]


def frames_in_memory(args, n_frames):
    """The same without a disk: every frame rendered up front (the IMU rows
    come last from the generator), then sliced per frame as io.euroc does."""
    from mc_slam_tpu_torch.io import euroc
    items = list(render_clone(args, n_frames))
    rows = items.pop()[1]
    imu = np.concatenate([(T_OFF + np.arange(len(rows)) / 200.0)[:, None], rows[:, :6]], 1)
    times = np.asarray([it[0] for it in items])
    seq = euroc.EurocSequence(image_times=times, image_paths=list(range(len(items))), imu=imu)
    frames = ((t, items[k][1], r) for t, k, r in imu_slices(seq))
    return frames, times, np.asarray([it[2] for it in items])


def frames_span(args, n_all, lo, hi, workers=4):
    """The frames lo .. hi-1 of the whole n_all-frame clone, rendered as the
    run reads them (`workers` views ahead), with their IMU rows; the IMU
    rows of the whole clone come from a first pass that renders nothing.
    Returns (frames iterator of (t, img, rows), t_gt (n_all,), P_gt (n_all, 3)).
    The ground truth is read off the trajectory at every frame's time."""
    from mc_slam_tpu_torch.io import euroc
    rows = list(render_clone(args, n_all, lo=n_all, hi=n_all))[-1][1]
    imu = np.concatenate([(T_OFF + np.arange(len(rows)) / 200.0)[:, None], rows[:, :6]], 1)
    times = T_OFF + np.arange(n_all) / args.fps
    seq = euroc.EurocSequence(image_times=times, image_paths=list(range(n_all)), imu=imu)
    from mc_slam_tpu_torch.sim import MavTrajectory
    traj = MavTrajectory(duration=args.duration / max(args.laps, 1), yaw_scale=args.yaw_scale)
    P_gt = np.asarray([traj.pose(k / args.fps)[0] for k in range(n_all)])

    def frames():
        imgs = render_clone(args, n_all, lo=lo, hi=hi, workers=workers)
        try:
            for t, k, r in imu_slices(seq):
                if k >= hi:
                    return
                if k >= lo:
                    item = next(imgs)
                    yield t, item[1], r
        finally:
            imgs.close()
    return frames(), times, P_gt


def have_png_codec():
    for mod in ("PIL", "imageio"):
        try:
            __import__(mod)
            return True
        except ImportError:
            pass
    return False


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=PROFILES, default="euroc")
    ap.add_argument("--dataset", default="",
                    help="default: _scratch/euroc_clone, or _scratch/euroc_clone_PROFILE "
                         "for loops and hard")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--final-gba", action="store_true")
    ap.add_argument("--no-loops", action="store_true",
                    help="turn loop closing off (relocalization stays on)")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default="", help="default: artifacts/ate_clone_PROFILE_torch.json")
    # the dataset's arguments, as examples/make_euroc_clone.py
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tex-size", type=int, default=2048)
    ap.add_argument("--tex-scale", type=float, default=1.0)
    ap.add_argument("--bg", type=float, nargs=3, default=[0.003, -0.0045, 0.0035])
    ap.add_argument("--ba", type=float, nargs=3, default=[0.035, -0.02, 0.06])
    ap.add_argument("--no-harden", dest="harden", action="store_false", default=True)
    ap.add_argument("--blur-ms", type=float, default=12.0)
    ap.add_argument("--laps", type=int, default=1)
    ap.add_argument("--imu-noise-scale", type=float, default=1.0)
    ap.add_argument("--yaw-scale", type=float, default=1.0)
    ap.add_argument("--tex-contrast", type=float, default=1.0)
    ap.add_argument("--weak-walls", type=int, nargs="*", default=[])
    ap.add_argument("--weak-contrast", type=float, default=0.3)
    # the loop-closure demonstration and the acceptance gate
    ap.add_argument("--inject-drift", action="store_true",
                    help="move everything created after the first injected frame by a small "
                         "step on every frame of --drift-window (see the module's help)")
    ap.add_argument("--drift-window", type=float, nargs=2, default=[20.0, 50.0],
                    metavar=("T0", "T1"))
    ap.add_argument("--drift-step", type=float, nargs=4, default=[3e-4, -2e-4, 2e-4, 1.5e-4],
                    metavar=("DX", "DY", "DZ", "YAW"), help="per frame, m and rad")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when the result breaks the JAX script's acceptance rules")
    ap.add_argument("--gate-ate", type=float, default=0.15, help="max post-init ATE RMSE [m]")
    ap.add_argument("--gate-scale", type=float, default=0.02, help="max |1 - Sim3 scale|")
    ap.add_argument("--gate-fps", type=float, default=20.0,
                    help="min amortized frames/s (on the card only)")
    ap.add_argument("--gate-lost", type=int, default=60, help="max lost frames")
    ap.add_argument("--save-checkpoint", default=None, metavar="PATH",
                    help="save the system (io.checkpoint) at the first keyframe event at or "
                         "after frame --max-frames of the clone, and stop there")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="with --save-checkpoint: also stop and save at the first keyframe "
                         "event after so many seconds of tracking")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="load a checkpoint of --save-checkpoint and go on from the frame "
                         "after it; the result covers the whole run")
    return ap


def _decimal_negatives(argv):
    """argparse reads a negative number written with an exponent ("-5e-4")
    as an option; such tokens are rewritten in decimal ("-0.0005") first."""
    out = []
    for tok in argv:
        if tok.startswith("-") and not _NEG_DECIMAL.match(tok):
            try:
                v = float(tok)
            except ValueError:
                v = None
            if v is not None and np.isfinite(v):
                tok = np.format_float_positional(v, trim="-")
        out.append(tok)
    return out


_NEG_DECIMAL = re.compile(r"^-\d+$|^-\d*\.\d+$")      # what argparse takes for a number


def parse_args(argv=None):
    """The command line with the profile applied: its dataset arguments go
    in front of the caller's (which win), its duration replaces a default
    --duration of 120 s, its dataset folder and artifact name fill in what
    was not given. A negative number may be written with an exponent."""
    ap = build_parser()
    argv = _decimal_negatives(sys.argv[1:] if argv is None else argv)
    profile = ap.parse_known_args(argv)[0].profile
    args = ap.parse_args(PROFILE_GEN.get(profile, []) + argv)
    if args.duration == 120.0 and profile in PROFILE_DURATION:
        args.duration = PROFILE_DURATION[profile]
    args.dataset = args.dataset or PROFILE_DATASET.get(profile, DEFAULT_DATASET)
    args.out = args.out or f"artifacts/ate_clone_{profile}_torch.json"
    return args


def side_path(out, kind, profile):
    """Where a side file of the result `out` goes: its folder, named after
    its stem (ate_clone_X.json -> KIND_clone_X.EXT), else after the profile."""
    base = os.path.basename(out)
    stem = base[len("ate_clone_"):-len(".json")] if base.startswith("ate_clone_") \
        and base.endswith(".json") else f"{profile}_torch"
    ext = "png" if kind == "map" else "npz"
    return os.path.join(os.path.dirname(os.path.abspath(out)), f"{kind}_clone_{stem}.{ext}")


def main(argv=None):
    args = parse_args(argv)

    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.io import checkpoint
    from mc_slam_tpu_torch.pipeline.pipebase import LOST, OK
    from mc_slam_tpu_torch.pipeline.system import SlamSystem
    from mc_slam_tpu_torch.tools import probes

    dev = resolve(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("eval_clone: no GPU (pass --device cpu to run on the host)")
        card = probes.card_line()
    print(card, flush=True)

    cfg = profile_config(args.profile)
    slam = SlamSystem(euroc_camera(device=dev), cfg, Tbc=TBC, device=dev)
    slam.enable_loop_closing = not args.no_loops

    n_all = int(args.duration * args.fps)
    # a run that spans calls: frame numbers count from the clone's first frame
    start, prior, load_s = 0, {"calls": [], "times_ms": [], "events": [], "lost_frames": 0,
                               "culled": 0, "vi_init_frame": None, "stage_samples_s": {},
                               "drift": {}, "lc_diag": [], "evictions": {}}, None
    if args.resume:
        t1 = time.perf_counter()
        checkpoint.load_system(args.resume, slam)
        load_s = time.perf_counter() - t1
        start = slam.frame_id
        if os.path.exists(args.resume + ".run.json"):
            with open(args.resume + ".run.json") as f:
                prior.update(json.load(f))
        if prior.get("profile", args.profile) != args.profile:
            raise SystemExit(f"eval_clone: {args.resume} is of profile {prior['profile']}")
        print(f"resumed at frame {start} from {args.resume} ({load_s:.2f} s)", file=sys.stderr)
    inject = None
    if args.inject_drift:
        inject = DriftInjector(args.drift_window, args.drift_step, dev,
                               prior["drift"].get("t_start"), prior["drift"].get("cutoff"))
    t0 = time.time()
    mav0, ds_hash = None, None
    if args.save_checkpoint or args.resume:
        # the whole clone's draws, so frames and IMU are those of the full run;
        # a save needs frames past --max-frames until the next keyframe
        stop = n_all
        if args.save_checkpoint and args.max_frames:
            stop = min(n_all, args.max_frames + 4 * cfg.kf_max_gap)
        elif args.max_frames:
            stop = min(n_all, args.max_frames)
        frames, t_gt, P_gt = frames_span(args, n_all, start, stop)
    else:
        n_frames = min(n_all, args.max_frames) if args.max_frames else n_all
        mav0 = os.path.join(args.dataset, "mav0")
        if have_png_codec():
            if not os.path.exists(os.path.join(mav0, "cam0", "data.csv")):
                # a shortened run writes only the frames it will read
                print(f"writing {n_frames} frames of the clone to {args.dataset}",
                      file=sys.stderr)
                write_clone(args, n_frames)
            frames, t_gt, P_gt = frames_from_disk(mav0, args.max_frames)
            ds_hash = dataset_hash(mav0)
        else:
            print("no PNG codec: rendering the clone in memory", file=sys.stderr)
            frames, t_gt, P_gt = frames_in_memory(args, n_frames)
    t_data = time.time() - t0

    times, n, i_vi = [], 0, prior["vi_init_frame"]
    state = {"save": False}
    t_track0 = time.perf_counter()

    def run_frame(item):
        nonlocal n, i_vi
        t_frame, buf, rows = item
        n_kf = slam.n_kf
        t1 = time.perf_counter()
        slam.track(buf, t_frame, imu=rows)
        if inject is not None:
            inject(slam, t_frame)
        times.append(time.perf_counter() - t1)
        n += 1
        if i_vi is None and slam.vi_inited:
            i_vi = start + n - 1
        if n % 100 == 0:
            print(f"frame {start + n}: state={slam.state} kf={len(slam.kf_slots)} "
                  f"vi={slam.vi_inited} lost={slam.n_lost_frames} "
                  f"loops={slam.n_loops_closed} "
                  f"median={np.median(times) * 1e3:.0f} ms", file=sys.stderr)
        # a checkpoint is taken right after a keyframe event, where tracking
        # was reseated at the newest keyframe as a load reseats it
        due = (args.max_frames and start + n >= args.max_frames) or (
            args.max_seconds and time.perf_counter() - t_track0 >= args.max_seconds)
        state["save"] = bool(args.save_checkpoint and due and slam.n_kf > n_kf)

    # one frame of lookahead: the NEXT frame's upload is started before the
    # current frame is tracked
    t0 = time.time()
    pending = None
    with eviction_watch() as watch:
        for t_frame, img, rows in frames:
            buf = slam.upload(img)
            if pending is not None:
                run_frame(pending)
                if state["save"]:
                    pending = None
                    break
            pending = (t_frame, buf, rows)
        if pending is not None:
            run_frame(pending)
        slam.flush()                # the frames still in flight in the loop decided
    frames.close()
    t_run = time.time() - t0

    ms_call = np.asarray(times) * 1e3
    call = {"frames": [start, start + n], "run_s": t_run, "dataset_s": t_data, "load_s": load_s,
            "card": card, "frame_ms_median": float(np.median(ms_call)) if n else None,
            "lost_frames": int(slam.n_lost_frames)}
    events = prior["events"] + [e for e in slam.events if e[1] not in ("kf_culled", "lc_diag")]
    culled = prior["culled"] + sum(len(e[2]["slots"]) for e in slam.events
                                   if e[1] == "kf_culled")
    n_lost = prior["lost_frames"] + int(slam.n_lost_frames)
    passes = [e for e in watch["mp"] if e["evicted"] > 0]
    ev0 = prior["evictions"]
    evictions = {"keyframes": ev0.get("keyframes", 0) + len(watch["kf"]),
                 "keyframes_after_vi": ev0.get("keyframes_after_vi", 0)
                 + sum(e["vi"] for e in watch["kf"]),
                 "point_passes": ev0.get("point_passes", 0) + len(passes),
                 "points": ev0.get("points", 0) + sum(e["evicted"] for e in passes)}
    lc_diag = prior["lc_diag"] + [(f, d["best_noncovis"], d["n_cands"])
                                  for f, k, d in slam.events if k == "lc_diag"]
    samples = {k: list(v) for k, v in prior["stage_samples_s"].items()}
    for k, v in slam.timers.samples.items():
        samples.setdefault(k, []).extend(v)
    drift_state = {"t_start": inject.t_start, "cutoff": inject.cutoff,
                   "n_injected": prior["drift"].get("n_injected", 0) + inject.n_injected} \
        if inject is not None else {}
    if args.save_checkpoint:
        ckdir = os.path.dirname(os.path.abspath(args.save_checkpoint))
        os.makedirs(ckdir, exist_ok=True)
        t1 = time.perf_counter()
        checkpoint.save_system(args.save_checkpoint, slam)
        call["save_s"] = time.perf_counter() - t1
        call["saved_at_keyframe"] = state["save"]
        call["checkpoint_bytes"] = sum(
            os.path.getsize(args.save_checkpoint + ext) for ext in ("", ".bow.npz", ".traj.npz")
            if os.path.exists(args.save_checkpoint + ext))
        with open(args.save_checkpoint + ".run.json", "w") as f:
            json.dump({"calls": prior["calls"] + [call], "events": events,
                       "times_ms": prior["times_ms"] + ms_call.tolist(), "lost_frames": n_lost,
                       "culled": culled, "vi_init_frame": i_vi, "profile": args.profile,
                       "stage_samples_s": samples, "drift": drift_state, "lc_diag": lc_diag,
                       "evictions": evictions},
                      f, default=_plain)
        print(f"saved at frame {start + n} to {args.save_checkpoint} "
              f"({call['save_s']:.2f} s, {call['checkpoint_bytes']} bytes)", file=sys.stderr)

    gba_s = None
    if args.final_gba:
        t1 = time.perf_counter()
        slam.global_refine()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        gba_s = time.perf_counter() - t1
    calls = prior["calls"] + [call]
    traj = slam.get_trajectory()
    stats, stats_post, seams = score(traj, t_gt, P_gt, calls, events)
    ms = np.asarray(prior["times_ms"] + ms_call.tolist())
    n_done = start + n
    # the longest span from a lost frame to the next relocalization
    lost_ev = [f for f, k, _ in events if k == "lost"]
    reloc_ev = [f for f, k, _ in events if k == "reloc"]
    streaks = [min([r for r in reloc_ev if r >= f], default=n_done) - f for f in lost_ev]
    stage_detail = stage_summary(samples)
    wall = float(ms.sum() * 1e-3)
    attributed = sum(v["total_s"] for k, v in stage_detail.items() if k in TOP_STAGES)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    drift = {}
    t_est = np.asarray([x[0] for x in traj], np.float64)
    P_est = np.asarray([x[1] for x in traj], np.float64).reshape(-1, 3)
    if len(traj) > 3:
        try:
            drift, te, err_t = drift_diagnostics(t_est, P_est, t_gt, P_gt)
            np.savez(side_path(args.out, "drift", args.profile), te=te, err_t=err_t)
        except Exception as e:          # a diagnostic must never fail the run
            print(f"drift diagnostics failed: {e}", file=sys.stderr)
    # which keyframe each frame composed through (-1: its anchor is gone and
    # it kept its track-time pose)
    kf_id = slam.m.kf_id.cpu().numpy()
    kf_act = slam.m.kf_active.cpu().numpy()
    anchor_kid = np.asarray([kd if (k >= 0 and kf_act[k] and kf_id[k] == kd) else -1
                             for _, k, kd in slam.traj.meta], np.int64)
    np.savez(side_path(args.out, "traj", args.profile), t_est=t_est, P_est=P_est,
             t_gt=t_gt, P_gt=P_gt, anchor_kid=anchor_kid)
    try:
        from mc_slam_tpu_torch.viz import save_map_snapshot
        save_map_snapshot(slam.m, traj, side_path(args.out, "map", args.profile),
                          title=f"clone/{args.profile} (torch): {n_done} frames, "
                                f"{len(slam.kf_slots)} KFs, {slam.n_loops_closed} loops")
    except Exception as e:              # a picture must never fail the run
        print(f"map snapshot failed: {e}", file=sys.stderr)
    result = {
        "card": card, "torch": torch.__version__, "lag_max": slam.LAG_MAX, "pair": slam.PAIR,
        "profile": args.profile, "duration_s": args.duration, "config": PROFILE_CONFIG[
            args.profile], "dataset_args": PROFILE_GEN.get(args.profile, []),
        "frames": n_done, "tracked_rows": len(slam.traj),
        "lost_frames": n_lost, "lost": slam.state == LOST,
        "n_lost": n_lost, "n_relocs": len(reloc_ev),
        "max_lost_streak": int(max(streaks, default=0)),
        "tracking_finished_ok": bool(slam.state == OK),
        "loops_closed": int(slam.n_loops_closed),
        "vi_inited": bool(slam.vi_inited), "vi_init_frame": i_vi,
        "keyframes": len(slam.kf_slots),
        "keyframes_inserted": slam.n_kf, "keyframes_active": len(slam.kf_slots),
        "keyframes_culled": culled,
        # capacity evictions (`eviction_watch`): keyframes freed by the
        # allocator, and the event maintenances that evicted points
        "evictions": evictions,
        "map_points": int(slam.m.mp_active.sum()),
        "ate_rmse_m": stats.get("rmse"), "scale": stats.get("scale"),
        "scale_error": abs(stats["scale"] - 1.0) if stats else None,
        "ate_post_rmse_m": stats_post.get("rmse"), "scale_post": stats_post.get("scale"),
        # the JAX script's names of the same figures
        "ate_rmse": stats.get("rmse", -1.0), "ate_scale": stats.get("scale", -1.0),
        "abs_scale_err": abs(stats["scale"] - 1.0) if stats else float("inf"),
        "ate_rmse_post_init": stats_post.get("rmse", -1.0),
        "ate_scale_post_init": stats_post.get("scale", -1.0),
        "frame_ms_median": float(np.median(ms)) if len(ms) else None,
        "frame_ms_mean": float(ms.mean()) if len(ms) else None,
        "frame_ms_visual_median": float(np.median(ms[:i_vi])) if i_vi else None,
        "frame_ms_vi_median": float(np.median(ms[i_vi:])) if i_vi is not None
        and i_vi < len(ms) else None,
        "median_track_ms": float(np.median(ms)) if len(ms) else None,
        "mean_track_ms": float(ms.mean()) if len(ms) else None,
        # frames over the wall time of `track` in all calls (events, loop
        # closing and warm-up included), and the same past the first 100 frames
        "e2e_fps_amortized": float(n_done / max(wall, 1e-9)),
        "e2e_fps_warm": float((n_done - 100) / max(ms[100:].sum() * 1e-3, 1e-9))
        if n_done > 200 else -1.0,
        "wall_s": wall,
        "wall_attributed_s": round(attributed, 1),
        "wall_unattributed_s": round(wall - attributed, 1),
        "run_s": sum(c["run_s"] for c in calls), "dataset_s": t_data, "final_gba_s": gba_s,
        "final_gba": bool(args.final_gba), "loops": not args.no_loops,
        "loop_closing_enabled": not args.no_loops,
        "dataset": os.path.abspath(args.dataset) if mav0 else None,
        "dataset_hash": ds_hash,
        "drift_injected": bool(args.inject_drift),
        "drift_params": ({"window_s": args.drift_window, "step": args.drift_step,
                          "cutoff_fid": drift_state["cutoff"],
                          "t_start": drift_state["t_start"],
                          "frames_injected": drift_state["n_injected"]}
                         if args.inject_drift else None),
        "drift": drift,
        "calls": calls, "seams": seams,
        "events": events[:50],
        "loop_events": [e for e in events if e[1] in ("sim3_result", "verify_result", "loop")],
        "lc_diag": lc_diag,
        "stage_detail": stage_detail,
        "stages": slam.timers.summary()}
    if args.gate:
        result["gate_failures"] = gate(result, dev.type == "cuda", args.gate_ate,
                                       args.gate_scale, args.gate_fps, args.gate_lost)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=_plain)
    print(slam.timers.report(), file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("stages", "events", "stage_detail", "drift", "loop_events")},
                     default=_plain), flush=True)
    if args.gate:
        if result["gate_failures"]:
            print("GATE FAILED: " + "; ".join(result["gate_failures"]), file=sys.stderr)
            sys.exit(1)
        print("GATE PASSED", file=sys.stderr)
    return result


def _plain(o):
    """numpy values in the event details, for json."""
    return o.tolist() if hasattr(o, "tolist") else str(o)


def score(traj, t_gt, P_gt, calls, events):
    """ATE stats of the whole trajectory and after its first 20 s, and, at
    each seam between two calls of a run, the aligned error of the frames on
    either side, whether either was lost, the run's median frame error, and
    the run's one-frame error steps away from the seams (median, 99th
    percentile, max, and how many of them are at least the seam's step)."""
    from mc_slam_tpu_torch.eval.ate import associate, horn_align, ate_rmse
    if len(traj) <= 3:
        return {}, {}, []
    t_est = np.asarray([x[0] for x in traj])
    P_est = np.asarray([x[1] for x in traj])
    stats = ate_rmse(t_est, P_est, t_gt, P_gt, with_scale=True)
    post = t_est > t_est[0] + 20.0
    stats_post = (ate_rmse(t_est[post], P_est[post], t_gt, P_gt, with_scale=True)
                  if post.sum() > 10 else {})
    seams = []
    if len(calls) > 1:
        pairs = np.asarray(associate(t_est, t_gt))
        s, R, t = horn_align(P_est[pairs[:, 0]], P_gt[pairs[:, 1]], True)
        err = np.full(len(t_gt), np.nan)
        err[pairs[:, 1]] = np.linalg.norm((s * (R @ P_est[pairs[:, 0]].T)).T + t
                                          - P_gt[pairs[:, 1]], axis=1)
        lost = {f for f, k, _ in events if k == "lost"}
        med = float(np.nanmedian(err))
        seam_frames = [c["frames"][0] for c in calls[1:]]
        step = np.abs(np.diff(err))                 # step[f - 1]: frame f - 1 -> f
        away = np.isfinite(step)
        away[[f - 1 for f in seam_frames]] = False
        steps = step[away]
        for f in seam_frames:
            e0, e1 = float(err[f - 1]), float(err[f])
            seams.append({"frame": f, "err_before_m": e0, "err_after_m": e1,
                          "step_m": abs(e1 - e0), "median_err_m": med,
                          "frame_step_median_m": float(np.median(steps)),
                          "frame_step_p99_m": float(np.percentile(steps, 99)),
                          "frame_step_max_m": float(steps.max()),
                          "frame_steps_at_least": int((steps >= abs(e1 - e0)).sum()),
                          "frame_steps": int(steps.size),
                          "lost": bool({f - 1, f} & lost)})
    return stats, stats_post, seams


if __name__ == "__main__":
    main()
