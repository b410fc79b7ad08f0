#!/usr/bin/env python3
"""Drive the port's Mono+IMU bootstrap, tracking and mapping on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failed check raises, so the exit code is not 0):
 1. environment: the card's name and power limit (nvidia-smi), CUDA version;
    a missing GPU is an error, never a CPU run;
 2. kernel: builds csrc/hamming_top2_windowed.cu with nvcc and holds the
    kernel against its plain PyTorch twin at the tracking shapes
    (M=16384 map points x N=1024 features, and a ragged 16001 x 1000) at
    radii 4, 15 and 40 px, random data plus planted exact ties; all three
    outputs must be exactly equal. Times both with CUDA events (launches
    queued behind a device-side sleep, so host time is hidden; and the kernel
    once more with a cold L2), and computes the kernel's bound from the
    bytes and operations these inputs need;
 3. path 1, localization: renders the EuRoC-profile clone (752x480, EuRoC
    camera, Tbc, IMU noise and biases; seed 0; no photometric hardening),
    seeds a 16384-point map in localization-mode fashion (a keyframe every
    10th frame at the ground-truth pose, points from the rendered depth),
    then runs `tracking.frame_pipeline_vi` on 40 frames on cuda, with the
    state carried synchronously. Checks the kernel's launch count, the
    inliers of every frame, the position RMSE against ground truth, and
    kernel == twin on the real search inputs of the first frames;
 4. path 2, track and map: the same clone, but only keyframe 0 is seeded
    (ground-truth pose, points from the rendered depth). Frames 1-40 are
    tracked against the live map; every 10th tracked frame becomes a
    keyframe (its tracked NavState and associations, the preintegration of
    the IMU rows since the last keyframe) and runs one keyframe event:
    `mapping.kf_event_pre` (cull, neighbours, triangulation, fusion),
    `ba_vi_idp.window_vi_ba_map` (inverse-depth window VI BA, window padded
    to 24 slots, Pw = 4096, 8 iterations), `mapping.kf_event_post`; tracking
    then continues from the optimised keyframe. One line per event, one
    summary line. Checks: every BA cost finite and not rising, points
    triangulated in at least half of the events, no landmark overflow, no
    frame under fb_min_inliers, position RMSE under RMSE_LIMIT_MAP, kernel
    == twin on real searches of this path;
 5. path 3, bootstrap: the same clone from raw frames, nothing seeded from
    ground truth (no depth, pose, bias or gravity). Frame 0 is the two-view
    reference; `system.try_initialize` on every next frame until it builds
    keyframes 0 and 1 and the first points (median depth 1) and runs the
    two-view BA; then `tracking_ctl.track_visual` per frame
    (`tracking.frame_pipeline_visual`, `need_new_kf` -> `create_keyframe`
    -> the visual `keyframe_event`, `viinit_ctl.maybe_vi_init` with
    vi_init_time = 5 s); after the accepted VI initialization (whole-map
    visual BA, scale / gravity / bias solve, re-preintegration, rescale,
    whole-map VI BA) 20 frames of `tracking_ctl.track_vi`. One line for the
    two-view init, one per event, one per VI-init attempt, two summary
    lines. Fails when: two-view init is not accepted by frame 20, a frame is
    LOST, VI init is not accepted by frame 160, a BA cost is not finite or
    rises, the kernel launched fewer than twice a tracked frame, kernel !=
    twin on a recorded visual and VI frame, or the result leaves the gates
    of the JAX package's own ~5 s initialization test (gyro bias of keyframe
    0, gravity direction, post-init ATE and alignment scale against ground
    truth).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from mc_slam_tpu_torch import camera as tcam
from mc_slam_tpu_torch.frontend import extractor, match_cuda
from mc_slam_tpu_torch.frontend.match_cuda import (BIG, hamming_top2_windowed,
                                                   hamming_top2_windowed_ref)
from mc_slam_tpu_torch.frontend.orb import pack_bits
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise
from mc_slam_tpu_torch.eval.ate import ate_rmse, horn_align
from mc_slam_tpu_torch.pipeline import (mapping, mapping_ctl, system, tracking,
                                        tracking_ctl)
from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
from mc_slam_tpu_torch.slam_map.mapstate import empty_map
from mc_slam_tpu_torch.solver import ba_vi, factors

# the reference's EuRoC Tbc (config/euroc.yaml:40-44)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
TRUE_BG = np.array([0.003, -0.0045, 0.0035])    # examples/make_euroc_clone.py
TRUE_BA = np.array([0.035, -0.02, 0.06])
KERNEL_SOURCE = "mc_slam_tpu_torch/csrc/hamming_top2_windowed.cu"
KERNEL_REPLACES = "mc_slam_tpu/frontend/match_pallas.py:100"
RADII = (4.0, 15.0, 40.0)
RMSE_LIMIT_LOC = 0.02       # m, path 1 (tracking against a ground-truth map)
RMSE_LIMIT_MAP = 0.03       # m, path 2 (tracking against the live map)
# Published peaks of one H100 SXM at 700 W: 3.35 TB/s of HBM; 67 TFLOP/s of
# float32 outside the tensor cores counts a fused multiply-add as two, so
# compares, subtracts, XORs and popcounts issue at half of it at most.
HBM_BYTES_PER_S = 3.35e12
SIMPLE_OPS_PER_S = 67e12 / 2
GATE_OPS_PER_PAIR = 8       # 2 subtracts, 2 |.|<r compares, level subtract, |.|, compare, and
POPC_OPS_PER_PASS = 24      # 8 xor + 8 popcount + 8 adds / top-2 update


@dataclasses.dataclass(frozen=True)
class Profile:
    """Sizes of one run. EUROC is examples/eval_clone.py's euroc profile."""
    width: int = 752
    height: int = 480
    n_feat: int = 1024
    n_levels: int = 8
    max_mp: int = 16384
    max_kf: int = 512
    iters: int = 20
    n_frames: int = 41          # frame 0 seeds the state; 40 are tracked
    kf_every: int = 10
    fps: float = 20.0
    tex_size: int = 2048
    fb_min_inliers: int = 20
    local_window: int = 20      # BA window padded to local_window + 4 slots
    max_new: int = 256          # new points per neighbour pair
    ba_Pw: int = 4096           # landmark slots of the window BA
    # path 3 (bootstrap): SlamConfig's defaults but for the init time
    vi_init_time: float = 5.0   # s; examples/run_euroc.py:55 (config/euroc.yaml: 15)
    init_max_frame: int = 20    # two-view init must be accepted by this frame
    boot_max_frame: int = 160   # VI init must be accepted by this frame
    n_vi_frames: int = 20       # frames tracked with the IMU after VI init


EUROC = Profile()
EUROC_BOOT_FRAMES = EUROC.boot_max_frame + EUROC.n_vi_frames + 1
ATE_LIMIT_BOOT = 0.08       # m, path 3: post-init ATE after similarity alignment
SCALE_TOL_BOOT = 0.35       # path 3: |alignment scale - 1| of the post-init positions
GRAVITY_COS_BOOT = 0.995    # path 3: cosine between estimated and true gravity
BG_TOL_BOOT = (8e-3, 8e-3, 2.5e-2)   # path 3: gyro bias of keyframe 0, per axis


def profile_camera(p: Profile, device=None):
    """The EuRoC camera, its intrinsics scaled to the profile's image size."""
    sx, sy = p.width / 752.0, p.height / 480.0
    return tcam.make_camera(458.654 * sx, 457.296 * sy, 367.215 * sx, 248.375 * sy,
                            k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                            p2=1.76187114e-05, width=p.width, height=p.height,
                            device=device)


@dataclasses.dataclass
class Sequence:
    imgs: list          # (H, W) uint8 per frame
    depths: list        # (H, W) float32 camera z per frame
    P: np.ndarray       # (F, 3) ground-truth body positions
    R: np.ndarray       # (F, 3, 3) ground-truth body rotations
    V: np.ndarray       # (F, 3) ground-truth velocities
    imu: list           # (rows, 7) float32 IMU rows between frame i-1 and i
    times: np.ndarray   # (F,)


def make_sequence(p: Profile, seed: int = 0) -> Sequence:
    """Render the clone as examples/make_euroc_clone.py does (tex_scale 1.0,
    EuRoC Tbc, true biases, EuRoC IMU noise), minus the hardening passes."""
    rng = np.random.default_rng(seed)
    cam = profile_camera(p, "cpu")      # the renderer runs on the host
    world = RoomWorld(rng, tex_size=p.tex_size, tex_scale=1.0)
    traj = MavTrajectory(duration=120.0)
    Rbc, pbc = TBC[:3, :3], TBC[:3, 3]
    fdt = 1.0 / p.fps
    imgs, depths, Ps, Rs, Vs = [], [], [], [], []
    for i in range(p.n_frames):
        P, R = traj.pose(i * fdt)
        img, depth = world.render(cam, R @ Rbc, P + R @ pbc, with_depth=True)
        imgs.append(img)
        depths.append(depth)
        Ps.append(P)
        Rs.append(R)
        Vs.append(traj.velocity(i * fdt))
    rows = traj.imu_samples(0.0, p.n_frames * fdt, rate=200.0, bg=TRUE_BG,
                            ba=TRUE_BA, noise_g=1.7e-4, noise_a=2e-3, rng=rng)
    per = int(round(200.0 * fdt))
    imu = [rows[:0]] + [rows[(i - 1) * per:i * per] for i in range(1, p.n_frames)]
    return Sequence(imgs, depths, np.asarray(Ps), np.asarray(Rs), np.asarray(Vs),
                    imu, np.arange(p.n_frames) * fdt)


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def build_map(seq: Sequence, p: Profile, cam, ext, device):
    """Localization-mode map: a keyframe every `kf_every` frames at the
    ground-truth pose (mapping.write_keyframe), its features' depth points
    (system._depth_to_world + _alloc_points). Returns (m, n_keyframes)."""
    m = empty_map(p.max_kf, p.max_mp, p.n_feat, device=device)
    slot = 0
    for i in range(0, p.n_frames, p.kf_every):
        f = extractor.extract(torch.from_numpy(seq.imgs[i]).to(device),
                              n_features=p.n_feat, n_levels=p.n_levels)
        uv = tcam.undistort_points(cam, f.xy)
        xy = f.xy.cpu().numpy()
        xs = np.clip(xy[:, 0].astype(int), 0, p.width - 1)
        ys = np.clip(xy[:, 1].astype(int), 0, p.height - 1)
        d = seq.depths[i][ys, xs]
        d = np.where(d > 1e-3, d, -1.0).astype(np.float32)
        P, R = _t(seq.P[i], device), _t(seq.R[i], device)
        m = mapping.write_keyframe(
            m, slot, P, R, _t(seq.V[i], device), _t(TRUE_BG, device),
            _t(TRUE_BA, device), _t(seq.times[i], device), _t(i, device, torch.int32),
            uv, f.level, f.angle, torch.full((p.n_feat,), -1.0, device=device),
            f.desc, f.desc_pm1, f.valid)
        Xw = system._depth_to_world(cam, ext, uv, _t(d, device), P, R)
        good = f.valid.cpu().numpy() & (d > 1e-3)
        m, _, _ = system._alloc_points(m, Xw, f.desc, f.desc_pm1, f.level, slot,
                                       good, p.n_levels, i, angle=f.angle)
        slot += 1
    return m, slot


class SearchRecorder:
    """Stands in for match_cuda.hamming_top2_windowed during a slice run:
    calls the real wrapper, brackets every call with CUDA events (kernel
    time inside the run) and keeps copies of the inputs of the first
    `keep_frames` frames for the kernel-vs-twin check on real data."""

    def __init__(self, keep_frames, timed: bool):
        """keep_frames: an int (the first so many frames) or a collection of
        frame indices."""
        self.keep_frames = (set(range(keep_frames)) if isinstance(keep_frames, int)
                            else set(keep_frames))
        self.timed = timed
        self.frame = 0
        self.calls = []          # (frame, args, kwargs)
        self.events = []         # (frame, start, end)

    def __call__(self, *args, **kwargs):
        if self.frame in self.keep_frames:
            self.calls.append((self.frame, [a.clone() if isinstance(a, torch.Tensor)
                                            else a for a in args], dict(kwargs)))
        if self.timed:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = hamming_top2_windowed(*args, **kwargs)
            e.record()
            self.events.append((self.frame, s, e))
            return out
        return hamming_top2_windowed(*args, **kwargs)


def run_slice(m, seq: Sequence, p: Profile, cam, ext, device, recorder=None,
              timed=False):
    """Track frames 1..n_frames-1 through tracking.frame_pipeline_vi with the
    synchronous state carry of SlamSystem._dispatch_frame_vi. Returns a dict
    of per-frame positions, summaries and (timed) milliseconds."""
    ns = NavState(P=_t(seq.P[0], device), V=_t(seq.V[0], device),
                  R=_t(seq.R[0], device), bg=_t(TRUE_BG, device),
                  ba=_t(TRUE_BA, device), dbg=torch.zeros(3, device=device),
                  dba=torch.zeros(3, device=device))
    gw = torch.tensor([0.0, 0.0, -9.81], device=device)
    noise = euroc_noise(device=device)
    sigma_bg, sigma_ba = float(noise.sigma_bg), float(noise.sigma_ba)
    c0 = torch.zeros((), dtype=torch.int64, device=device)
    c1 = torch.ones((), device=device)
    fresh_fb = _t(system._fresh_prior_info(1e2), device)
    prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=_t(system._fresh_prior_info(1e3),
                                                        device), valid=c1)
    pfm = torch.full((p.n_feat,), -1, dtype=torch.int32, device=device)
    pan = torch.zeros(p.n_feat, device=device)
    has_prev = False
    imgs = [torch.from_numpy(im).to(device) for im in seq.imgs]
    imus = [torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in seq.imu]
    Ps, Rs, fmps, summaries, ms = [], [], [], [], []
    orig = match_cuda.hamming_top2_windowed
    if recorder is not None:
        match_cuda.hamming_top2_windowed = recorder
    try:
        for i in range(1, p.n_frames):
            if recorder is not None:
                recorder.frame = i - 1
            anchor = i // p.kf_every      # the newest keyframe at or before i
            if timed:
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
            (feats, _, ns, fmp, H_prior, mp_found, mp_vis, _,
             summary) = tracking.frame_pipeline_vi(
                m, imgs[i], imus[i], cam, ext, noise, ns, gw, prior, pfm, pan,
                anchor, float(seq.times[i] - seq.times[i - 1]), fresh_fb,
                sigma_bg=sigma_bg, sigma_ba=sigma_ba,
                n_features=p.n_feat, n_levels=p.n_levels, iters=p.iters,
                has_prev=has_prev, fb_min_inliers=p.fb_min_inliers)
            if timed:
                e.record()
                ms.append((s, e))
            # SlamSystem._dispatch_frame_vi's state carry
            prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=H_prior, valid=c1)
            pfm, pan, has_prev = fmp, feats.angle, True
            m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
            Ps.append(ns.P)
            Rs.append(ns.R)
            fmps.append(fmp)
            summaries.append(summary)
    finally:
        match_cuda.hamming_top2_windowed = orig
    if timed:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ms]
    P = torch.stack(Ps).cpu().numpy()
    err = np.linalg.norm(P - seq.P[1:p.n_frames], axis=1)
    return dict(P=P, R=torch.stack(Rs).cpu().numpy(),
                feat_mp=torch.stack(fmps).cpu().numpy(),
                summary=torch.stack(summaries).cpu().numpy(), ms=ms,
                rmse=float(np.sqrt(np.mean(err ** 2))), m=m)


def seed_keyframe0(seq: Sequence, p: Profile, cam, ext, noise, device):
    """Path 2's seed: keyframe slot 0 is frame 0 at its ground-truth NavState,
    its points from the rendered depth (SlamSystem._initialize_from_depth).
    Returns (m, MappingState)."""
    m = empty_map(p.max_kf, p.max_mp, p.n_feat, device=device)
    st = mapping_ctl.MappingState(vi_inited=True)
    f = extractor.extract(torch.from_numpy(seq.imgs[0]).to(device),
                          n_features=p.n_feat, n_levels=p.n_levels)
    uv = tcam.undistort_points(cam, f.xy)
    ns0 = NavState(P=_t(seq.P[0], device), V=_t(seq.V[0], device),
                   R=_t(seq.R[0], device), bg=_t(TRUE_BG, device),
                   ba=_t(TRUE_BA, device), dbg=torch.zeros(3, device=device),
                   dba=torch.zeros(3, device=device))
    m = mapping_ctl.insert_keyframe(m, st, 0, ns0, f, uv, seq.times[0], 0, None, noise)
    xy = f.xy.cpu().numpy()
    xs = np.clip(xy[:, 0].astype(int), 0, p.width - 1)
    ys = np.clip(xy[:, 1].astype(int), 0, p.height - 1)
    d = seq.depths[0][ys, xs]
    d = np.where(d > 1e-3, d, -1.0).astype(np.float32)
    Xw = system._depth_to_world(cam, ext, uv, _t(d, device), ns0.P, ns0.R)
    good = f.valid.cpu().numpy() & (d > 1e-3)
    m, _, _ = system._alloc_points(m, Xw, f.desc, f.desc_pm1, f.level, 0, good,
                                   p.n_levels, 0, angle=f.angle)
    return m, st


def count_syncs(caught):
    return sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def sync_watch(cuda: bool):
    """Record the warnings of torch.cuda.set_sync_debug_mode("warn") (one for
    every call that makes the host wait for the device); yields their list."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")


class EventTimer:
    """CUDA-event marks of one keyframe event: ms between "pre", "ba", "post"
    and "end". On a CPU run the marks are host clock readings."""

    def __init__(self, cuda: bool, caught=None):
        """caught: the list of a `sync_watch`; a mark then also notes how many
        synchronizing calls were flagged so far."""
        self.cuda = cuda
        self.marks = []
        self.caught = caught
        self.flagged = []

    def __call__(self, name):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.marks.append((name, e))
        if self.caught is not None:
            self.flagged.append(count_syncs(self.caught))

    def syncs(self):
        """Flagged synchronizing calls between consecutive marks."""
        return {a: n1 - n0 for (a, _), n0, n1 in
                zip(self.marks, self.flagged, self.flagged[1:])}

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return {a: ea.elapsed_time(eb)
                    for (a, ea), (_, eb) in zip(self.marks, self.marks[1:])}
        return {a: (eb - ea) * 1e3 for (a, ea), (_, eb) in zip(self.marks, self.marks[1:])}


def run_track_and_map(seq: Sequence, p: Profile, cam, ext, device, recorder=None,
                      on_event=None):
    """Path 2: seed keyframe 0, then track frames 1..n_frames-1 against the
    LIVE map through tracking.frame_pipeline_vi; every `kf_every`-th tracked
    frame is inserted as a keyframe (its tracked NavState and associations,
    the preintegration of all IMU rows since the last keyframe) and runs
    mapping_ctl.keyframe_event; tracking then continues from the optimised
    keyframe with a fresh prior (SlamSystem._local_mapping's state carry).

    on_event(m, st, frame_index): optional hook called after the insertion and
    before the event (tests capture the MapState there).
    Returns a dict: per-frame positions and summaries, per-event records."""
    cuda = torch.device(device).type == "cuda"
    noise = euroc_noise(device=device)
    cfg = mapping_ctl.MappingConfig(n_levels=p.n_levels, local_window=p.local_window,
                                    max_new=p.max_new, ba_Pw=p.ba_Pw)
    m, st = seed_keyframe0(seq, p, cam, ext, noise, device)
    ns = mapping_ctl.keyframe_navstate(m, 0)
    gw = torch.tensor([0.0, 0.0, -9.81], device=device)
    sigma_bg, sigma_ba = float(noise.sigma_bg), float(noise.sigma_ba)
    c0 = torch.zeros((), dtype=torch.int64, device=device)
    c1 = torch.ones((), device=device)
    fresh_fb = _t(system._fresh_prior_info(1e2), device)
    fresh_1e3 = _t(system._fresh_prior_info(1e3), device)
    prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=fresh_1e3, valid=c1)
    pfm = torch.full((p.n_feat,), -1, dtype=torch.int32, device=device)
    pan = torch.zeros(p.n_feat, device=device)
    has_prev = False
    imgs = [torch.from_numpy(im).to(device) for im in seq.imgs]
    imus = [torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in seq.imu]
    imu_since_kf = []
    Ps, summaries, events, frame_ms = [], [], [], []
    orig = match_cuda.hamming_top2_windowed
    if recorder is not None:
        match_cuda.hamming_top2_windowed = recorder
    try:
        for i in range(1, p.n_frames):
            if recorder is not None:
                recorder.frame = i - 1
            t0 = time.perf_counter()
            (feats, uv, ns, fmp, H_prior, mp_found, mp_vis, _,
             summary) = tracking.frame_pipeline_vi(
                m, imgs[i], imus[i], cam, ext, noise, ns, gw, prior, pfm, pan,
                st.last_kf_slot, float(seq.times[i] - seq.times[i - 1]), fresh_fb,
                sigma_bg=sigma_bg, sigma_ba=sigma_ba,
                n_features=p.n_feat, n_levels=p.n_levels, iters=p.iters,
                has_prev=has_prev, fb_min_inliers=p.fb_min_inliers)
            prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=H_prior, valid=c1)
            pfm, pan, has_prev = fmp, feats.angle, True
            m = m._replace(mp_found=mp_found, mp_visible=mp_vis)
            imu_since_kf.append(imus[i])
            Ps.append(ns.P)
            summaries.append(summary)
            if cuda:
                torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if i % p.kf_every:
                continue
            # ---- the tracked frame becomes a keyframe and runs one event ----
            slot = len(st.kf_slots)
            m = mapping_ctl.insert_keyframe(m, st, slot, ns, feats, uv, seq.times[i], i,
                                            torch.cat(imu_since_kf), noise, feat_mp=fmp)
            imu_since_kf = []
            if on_event is not None:
                on_event(m, st, i)
            with sync_watch(cuda) as caught:
                timer = EventTimer(cuda, caught)
                m, res = mapping_ctl.keyframe_event(m, st, cfg, i, cam, ext, gw,
                                                    noise, timer=timer)
            # after the event: its counters, and the covisibility row and
            # well-observed count that the next event's choices use
            events.append(_event_record(i, slot, res, timer))
            mapping_ctl.note_event_stats(st, res.stats[0].cpu().numpy(), res.stats[4])
            ns = mapping_ctl.keyframe_navstate(m, slot)
            prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=fresh_1e3, valid=c1)
    finally:
        match_cuda.hamming_top2_windowed = orig
    P = torch.stack(Ps).cpu().numpy()
    err = np.linalg.norm(P - seq.P[1:p.n_frames], axis=1)
    return dict(P=P, summary=torch.stack(summaries).cpu().numpy(), events=events,
                rmse=float(np.sqrt(np.mean(err ** 2))), m=m, st=st, frame_ms=frame_ms)


def check_track_and_map(res, p: Profile):
    """Path 2's checks; raises on the first that fails."""
    ev, summ = res["events"], res["summary"]
    for e in ev:
        if not (np.isfinite(e["cost0"]) and np.isfinite(e["cost"])) \
                or e["cost"] > e["cost0"]:
            raise AssertionError(f"event at frame {e['frame']}: BA cost "
                                 f"{e['cost0']} -> {e['cost']}")
        if e["overflow"] != 0:
            raise AssertionError(f"event at frame {e['frame']}: {e['overflow']} "
                                 f"landmarks past Pw were dropped from the window BA")
    if 2 * sum(e["n_created"] > 0 for e in ev) < len(ev):
        raise AssertionError(f"points triangulated in only "
                             f"{sum(e['n_created'] > 0 for e in ev)} of {len(ev)} events")
    if summ[:, 0].min() < p.fb_min_inliers:
        raise AssertionError(f"a frame kept {summ[:, 0].min():.0f} inliers "
                             f"(< {p.fb_min_inliers})")
    if not np.isfinite(res["P"]).all() or res["rmse"] >= RMSE_LIMIT_MAP:
        raise AssertionError(f"position RMSE {res['rmse']} m (limit {RMSE_LIMIT_MAP} m)")


def _event_record(frame, slot, res, timer):
    """An event's numbers on the host (one copy) with its stage times."""
    host = torch.stack([x.to(torch.float32) for x in (
        res.n_created, res.n_fused, res.n_culled, res.ba.cost0, res.ba.cost,
        res.ba.n_landmarks, res.ba.overflow, res.stats[3])]).cpu().numpy()
    ms, syncs = timer.ms(), timer.syncs()
    return dict(frame=frame, slot=slot, n_created=int(host[0]), n_fused=int(host[1]),
                n_culled=int(host[2]), cost0=float(host[3]), cost=float(host[4]),
                n_landmarks=int(host[5]), overflow=int(host[6]), n_active=int(host[7]),
                pre_ms=ms["pre"], ba_ms=ms["ba"], post_ms=ms["post"],
                syncs=sum(syncs.get(k, 0) for k in ("pre", "ba", "post")),
                costs=res.ba.costs.cpu().numpy())


def _ba_record(stats, ms):
    """A whole-map BA's numbers on the host."""
    host = torch.stack([stats.cost0, stats.cost, stats.n_landmarks.to(torch.float32)
                        ]).cpu().numpy()
    return dict(cost0=float(host[0]), cost=float(host[1]), n_landmarks=int(host[2]),
                ms=ms)


def run_bootstrap(seq: Sequence, p: Profile, cam, ext, device, recorder=None):
    """Path 3: the port started from raw frames. Nothing comes from ground
    truth: frame 0 is the two-view reference, every next frame calls
    `system.try_initialize` (200 8-point samples from a seeded generator)
    until it builds the first two keyframes; then `tracking_ctl.track_visual`
    per frame (visual tracking, keyframe decisions, visual keyframe events,
    the VI-init attempt with `vi_init_time` = p.vi_init_time) until VI init is
    accepted, and `tracking_ctl.track_vi` for p.n_vi_frames more frames.
    Returns a dict: the init record, per-frame summaries, per-event and
    per-attempt records, the composed trajectory, the final map and states.
    Raises when a frame is LOST or an acceptance deadline passes."""
    cuda = torch.device(device).type == "cuda"
    noise = euroc_noise(device=device)
    cfg = mapping_ctl.MappingConfig(
        n_levels=p.n_levels, local_window=p.local_window, max_new=p.max_new,
        ba_Pw=p.ba_Pw, vi_init_time=p.vi_init_time)
    m = empty_map(p.max_kf, p.max_mp, p.n_feat, device=device)
    st = mapping_ctl.MappingState()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    img = lambda i: torch.from_numpy(seq.imgs[i]).to(device)
    imu = lambda i: torch.from_numpy(np.ascontiguousarray(seq.imu[i])).to(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    orig = match_cuda.hamming_top2_windowed
    if recorder is not None:
        match_cuda.hamming_top2_windowed = recorder
    try:
        # ---- monocular initialization ----
        def extract(i):
            f = extractor.extract(img(i), n_features=p.n_feat, n_levels=p.n_levels)
            return f, tcam.undistort_points(cam, f.xy)

        f0, uv0 = extract(0)
        ref, rows, i, init = (f0, uv0, float(seq.times[0])), [], 0, None
        while init is None:
            i += 1
            if i > p.init_max_frame:
                raise AssertionError(f"two-view initialization not accepted by frame "
                                     f"{p.init_max_frame}")
            f1, uv1 = extract(i)
            rows.append(imu(i))
            sync()
            t0 = time.perf_counter()
            with sync_watch(cuda) as caught:
                m, att = system.try_initialize(m, st, cfg, cam, ext, noise, ref, f1, uv1,
                                               float(seq.times[i]), i, torch.cat(rows),
                                               generator=gen)
                sync()
            if att.reset_ref:
                ref, rows = (f1, uv1, float(seq.times[i])), []
            if att.ok:
                tv = att.two_view
                host = torch.stack([x.to(torch.float32) for x in (
                    tv.used_h, tv.n_good, tv.score_h, tv.score_f)]).cpu().numpy()
                init = dict(frame=i, n_matches=att.n_matches, used_h=bool(host[0]),
                            n_good=int(host[1]), score_h=float(host[2]),
                            score_f=float(host[3]), ms=(time.perf_counter() - t0) * 1e3,
                            syncs=count_syncs(caught),
                            ba=_ba_record(att.ba, float("nan")))
        ts = tracking_ctl.start_tracking(m, st, cfg.g_mag, float(seq.times[i]))
        ts.traj.append(tracking._traj_row(m, ts.P, ts.R, st.last_kf_slot),
                       float(seq.times[i]), st.last_kf_slot, st.kf_id_host[st.last_kf_slot])

        # ---- visual tracking and mapping until VI init, then VI frames ----
        frames, events, attempts = [], [], []
        n_vi = 0
        i_accept = None
        while n_vi < p.n_vi_frames:
            i += 1
            if i_accept is None and i > p.boot_max_frame:
                raise AssertionError(f"VI initialization not accepted by frame "
                                     f"{p.boot_max_frame}; attempts: {attempts}")
            if recorder is not None:
                recorder.frame = i
                if not frames or (st.vi_inited and n_vi == 0):
                    recorder.keep_frames.add(i)   # the first visual, the first VI frame
            t_i = float(seq.times[i])
            was_vi = st.vi_inited
            sync()
            t0 = time.perf_counter()
            with sync_watch(cuda) as caught:
                ev_timer = EventTimer(cuda, caught)
                vi_timer = EventTimer(cuda, caught)
                if was_vi:
                    m, out = tracking_ctl.track_vi(
                        m, st, cfg, ts, img(i), t_i, i, imu(i), cam, ext, noise,
                        n_features=p.n_feat, iters=p.iters,
                        fb_min_inliers=p.fb_min_inliers, event_timer=ev_timer)
                    n_vi += 1
                else:
                    m, out = tracking_ctl.track_visual(
                        m, st, cfg, ts, img(i), t_i, i, imu(i), cam, ext, noise,
                        n_features=p.n_feat, iters=p.iters, event_timer=ev_timer,
                        vi_mark=vi_timer)
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            if out.state != tracking_ctl.OK:
                raise AssertionError(f"frame {i} LOST with {out.n_inliers} inliers "
                                     f"({'VI' if was_vi else 'visual'} tracking)")
            attempted = out.vi is not None and out.vi.attempted
            frames.append(dict(frame=i, vi=was_vi, n_inliers=out.n_inliers,
                               used_fb=out.used_fallback, ms=ms, syncs=count_syncs(caught),
                               plain=out.keyframe is None and not attempted))
            if out.event is not None:
                e = _event_record(i, out.keyframe, out.event, ev_timer)
                e["vi"] = was_vi
                events.append(e)
            if attempted:
                v = out.vi
                vms, vsy = vi_timer.ms(), vi_timer.syncs()
                a = dict(frame=i, t=t_i, n_kf=v.n_kf, scale=v.scale,
                         scale_star=v.scale_star, cond=v.cond, accepted=v.accepted,
                         reason=v.reason, bg=v.bg.tolist(), ba=v.ba.tolist(), ms=vms,
                         syncs=vsy, total_ms=sum(vms.values()),
                         total_syncs=sum(vsy.values()),
                         ba_visual=_ba_record(v.ba_visual, vms.get("gba_visual")))
                if v.accepted:
                    a["ba_vi"] = _ba_record(v.ba_vi, vms.get("gba_vi"))
                    a["gw"] = v.gw.cpu().numpy().tolist()
                    i_accept = i
                attempts.append(a)
    finally:
        match_cuda.hamming_top2_windowed = orig
    traj = tracking_ctl.trajectory(m, ts)
    return dict(init=init, frames=frames, events=events, attempts=attempts,
                i_accept=i_accept, last_frame=i, traj=traj, m=m, st=st, ts=ts,
                gw=ts.gw.cpu().numpy(), bg0=m.kf_ns.bg[st.kf_slots[0]].cpu().numpy(),
                bg0_full=(m.kf_ns.bg + m.kf_ns.dbg)[st.kf_slots[0]].cpu().numpy())


@contextlib.contextmanager
def capture_bootstrap_states():
    """While active, record the states a bootstrap run hands to its stages
    (for the parity tests and tools/profile_event.py, which replay single
    stages on them). Yields a dict: "events" holds (MapState, MappingState,
    frame) right after each keyframe's insertion, before its event;
    "vi_attempts" the (MapState, MappingState, t, TrajStore) of every
    maybe_vi_init call past its time gate; "need_kf" one (MappingState fields
    before, frame, inliers, decision, reference count after, MapState or
    None) per keyframe decision, the MapState kept where the reference count
    was read from the device."""
    import copy
    from mc_slam_tpu_torch.pipeline import viinit_ctl
    captured = dict(events=[], vi_attempts=[], need_kf=[])
    orig = (mapping_ctl.keyframe_event, viinit_ctl.maybe_vi_init, tracking_ctl.need_new_kf)

    def spy_event(m, st, cfg, frame_id, *a, **k):
        captured["events"].append((m, copy.deepcopy(st), frame_id))
        return orig[0](m, st, cfg, frame_id, *a, **k)

    def spy_vi(m, st, cfg, t, *a, traj=None, **k):
        if st.first_kf_time is not None and t - st.first_kf_time >= cfg.vi_init_time:
            captured["vi_attempts"].append((m, copy.deepcopy(st), t, copy.deepcopy(traj)))
        return orig[1](m, st, cfg, t, *a, traj=traj, **k)

    def spy_need(m, st, cfg, fid, n_in):
        before = dict(last_kf_frame=st.last_kf_frame, ref_tracked=st.ref_tracked,
                      kf_slots=list(st.kf_slots), last_kf_slot=st.last_kf_slot)
        out = orig[2](m, st, cfg, fid, n_in)
        captured["need_kf"].append((before, fid, n_in, out, st.ref_tracked,
                                    m if before["ref_tracked"] is None else None))
        return out

    mapping_ctl.keyframe_event, viinit_ctl.maybe_vi_init, tracking_ctl.need_new_kf = (
        spy_event, spy_vi, spy_need)
    try:
        yield captured
    finally:
        mapping_ctl.keyframe_event, viinit_ctl.maybe_vi_init, tracking_ctl.need_new_kf = orig


def check_bootstrap(res, seq: Sequence, p: Profile):
    """Path 3's checks against ground truth, by the gates of the JAX
    package's own ~5 s initialization test (tests/test_e2e_vi.py); raises on
    the first that fails. Returns the measured values."""
    bas = [("two-view BA", res["init"]["ba"])]
    bas += [(f"event at frame {e['frame']}", e) for e in res["events"]]
    for a in res["attempts"]:
        bas.append((f"whole-map visual BA at frame {a['frame']}", a["ba_visual"]))
        if "ba_vi" in a:
            bas.append((f"whole-map VI BA at frame {a['frame']}", a["ba_vi"]))
    for name, b in bas:
        if not (np.isfinite(b["cost0"]) and np.isfinite(b["cost"])) or b["cost"] > b["cost0"]:
            raise AssertionError(f"{name}: BA cost {b['cost0']} -> {b['cost']}")
    for e in res["events"]:
        if e["overflow"] != 0:
            raise AssertionError(f"event at frame {e['frame']}: {e['overflow']} "
                                 f"landmarks past Pw were dropped from the window BA")
    bg_err = np.abs(res["bg0"] - TRUE_BG)
    if not (bg_err <= np.asarray(BG_TOL_BOOT)).all():
        raise AssertionError(f"gyro bias of keyframe 0 {res['bg0']} (true {TRUE_BG})")
    t_est = np.asarray([x[0] for x in res["traj"]])
    P_est = np.asarray([x[1] for x in res["traj"]])
    post = t_est > seq.times[res["i_accept"]] - 1e-6
    stats = ate_rmse(t_est[post], P_est[post], seq.times, seq.P, with_scale=True)
    full = ate_rmse(t_est, P_est, seq.times, seq.P, with_scale=True)
    if not stats["rmse"] < ATE_LIMIT_BOOT:
        raise AssertionError(f"post-init ATE {stats}")
    if not abs(stats["scale"] - 1.0) < SCALE_TOL_BOOT:
        raise AssertionError(f"metric scale off: alignment scale {stats['scale']}")
    # gravity: the bootstrap world is keyframe 0's camera frame; the rotation
    # that aligns the WHOLE estimated trajectory with ground truth maps it
    idx = [int(round(t * p.fps)) for t in t_est]
    _, R_align, _ = horn_align(P_est, seq.P[idx], with_scale=True)
    g = R_align @ res["gw"]
    cos = float(-g[2] / np.linalg.norm(g))
    if not cos > GRAVITY_COS_BOOT:
        raise AssertionError(f"gravity misaligned: cos {cos}")
    return dict(bg_err=bg_err.tolist(), ate_post_m=stats["rmse"], scale_post=stats["scale"],
                n_post=stats["n"], ate_all_m=full["rmse"], scale_all=full["scale"],
                gravity_cos=cos)


def event_line(e):
    return (f"frame {e['frame']} -> keyframe {e['slot']}: {e['n_created']} points "
            f"triangulated, {e['n_fused']} associations fused, {e['n_culled']} points "
            f"culled, {e['n_active']} active; BA cost {e['cost0']:.1f} -> "
            f"{e['cost']:.1f}, {e['n_landmarks']} landmarks, overflow {e['overflow']}; "
            f"ms pre {e['pre_ms']:.1f} BA {e['ba_ms']:.1f} post {e['post_ms']:.1f}; "
            f"host syncs {e['syncs']}")


def planted_inputs(M, N, rng, device, width=752, height=480):
    """Random search inputs at the tracking shapes with exact ties planted:
    duplicated candidate descriptors (equal best at two columns), and queries
    that copy a candidate's descriptor and position (distance 0)."""
    b_bits = rng.integers(0, 2, (N, 256))
    dup = rng.choice(N, size=N // 8, replace=False)
    b_bits[dup] = b_bits[rng.choice(N, size=N // 8)]
    a_bits = rng.integers(0, 2, (M, 256))
    copy = rng.choice(M, size=M // 4, replace=False)
    src = rng.integers(0, N, size=M // 4)
    a_bits[copy] = b_bits[src]
    b_uv = np.stack([rng.uniform(0, width, N), rng.uniform(0, height, N)], -1)
    a_uv = np.stack([rng.uniform(0, width, M), rng.uniform(0, height, M)], -1)
    a_uv[copy] = b_uv[src] + rng.uniform(-2.0, 2.0, (M // 4, 2))
    b_uv[dup] = b_uv[rng.choice(N, size=N // 8)]
    a_lvl = rng.integers(0, 8, M)
    b_lvl = rng.integers(0, 8, N)
    a_lvl[copy] = b_lvl[src]
    out = {}
    for pre, bits, uv, lvl, valid in (
            ("a", a_bits, a_uv, a_lvl, rng.random(M) < 0.9),
            ("b", b_bits, b_uv, b_lvl, rng.random(N) < 0.95)):
        bt = torch.as_tensor(bits, dtype=torch.int32)
        out[pre + "_desc"] = pack_bits(bt).to(device)
        out[pre + "_pm1"] = (bt * 2 - 1).to(torch.int8).to(device)
        out[pre + "_uv"] = torch.as_tensor(uv, dtype=torch.float32, device=device)
        out[pre + "_lvl"] = torch.as_tensor(lvl, dtype=torch.int32, device=device)
        out[pre + "_valid"] = torch.as_tensor(valid, device=device)
    return out


def check_pack(desc, pm1):
    """The packed words and the +/-1 rows must describe the same bits."""
    bits = (pm1 > 0).to(torch.int32)
    if not torch.equal(pack_bits(bits), desc):
        raise AssertionError("packed descriptor words disagree with the +/-1 rows")


def compare_kernel(inp, radius, level_tol=1):
    """Run hamming_top2_windowed (the kernel for CUDA inputs, the twin for CPU
    inputs) and its twin on the same inputs; `best` must be equal everywhere,
    `idx` and `second` where best < BIG (as tests/test_match_pallas.py).
    Returns (max_abs_err over the compared entries, n_rows_with_a_match)."""
    k = hamming_top2_windowed(inp["a_desc"], inp["a_pm1"], inp["a_uv"], inp["a_lvl"],
                              inp["a_valid"], inp["b_desc"], inp["b_pm1"],
                              inp["b_uv"], inp["b_lvl"], inp["b_valid"], radius,
                              level_tol)
    if inp["a_desc"].is_cuda:
        torch.cuda.synchronize()
    r = hamming_top2_windowed_ref(inp["a_pm1"], inp["a_uv"], inp["a_lvl"],
                                  inp["a_valid"], inp["b_pm1"], inp["b_uv"],
                                  inp["b_lvl"], inp["b_valid"], radius, level_tol)
    best, second, idx = (t.cpu().numpy().astype(np.int64) for t in k)
    rbest, rsecond, ridx = (t.cpu().numpy().astype(np.int64) for t in r)
    has = rbest < BIG
    err = max(np.abs(best - rbest).max(initial=0),
              np.abs(second - rsecond)[has].max(initial=0),
              np.abs(idx - ridx)[has].max(initial=0))
    if err != 0:
        raise AssertionError(
            f"kernel != twin at radius {radius}: {(best != rbest).sum()} best, "
            f"{(second != rsecond)[has].sum()} second, {(idx != ridx)[has].sum()} "
            f"idx rows differ")
    return int(err), int(has.sum())


def time_cuda(fn, n=50, warmup=3, rounds=5):
    """Median over `rounds` of the milliseconds of one `fn()`: n calls are
    queued behind a device-side sleep, so the host's enqueue time is hidden
    and the card runs them back to back; CUDA events around the batch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def time_cuda_cold(fn, flush, n=20):
    """Median milliseconds of one `fn()` that finds the L2 cold: a pass over
    the 256 MB `flush` buffer evicts the 50 MB cache before each call."""
    fn()
    times = []
    for _ in range(n):
        flush.add_(1)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_bound(inp, radius, level_tol=1):
    """The least milliseconds the card could take for this search: the larger
    of bytes over the memory rate (each input read once, each output written
    once) and operations over the issue rate (the gate for every valid pair,
    the popcount for the pairs of these inputs that pass it).
    Returns (bound_ms, bound_by, detail dict)."""
    from mc_slam_tpu_torch.frontend.matching import window_mask
    M, N = inp["a_desc"].shape[0], inp["b_desc"].shape[0]
    gate = window_mask(inp["a_uv"], inp["b_uv"], radius, inp["a_lvl"], inp["b_lvl"],
                       level_tol) & inp["a_valid"][:, None] & inp["b_valid"][None, :]
    n_pass = int(gate.sum())
    pairs = int(inp["a_valid"].sum()) * int(inp["b_valid"].sum())
    n_bytes = (M + N) * (32 + 8 + 4 + 1) + 3 * 4 * M
    ops = pairs * GATE_OPS_PER_PAIR + n_pass * POPC_OPS_PER_PASS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SIMPLE_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            dict(bytes=n_bytes, pairs=pairs, passing_pairs=n_pass, operations=ops,
                 bytes_ms=t_bytes, operations_ms=t_ops))


def _phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def _real_search_check(rec):
    """kernel == twin on the searches a path recorded; returns (max_err, count)."""
    max_err = 0
    for _, args, kw in rec.calls:
        inp = dict(zip(("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid", "b_desc",
                        "b_pm1", "b_uv", "b_lvl", "b_valid"), args[:10]))
        err, _ = compare_kernel(inp, args[10] if len(args) > 10 else kw["radius"])
        max_err = max(max_err, err)
    return max_err, len(rec.calls)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script measures the port on a GPU only")
    dev = torch.device("cuda", 0)
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _phase("env", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- phase 2: the kernel against its twin at the tracking shapes ----
    t0 = time.time()
    lib = match_cuda.build_library()
    log = (lib.parent / "nvcc.log").read_text().strip().replace("\n", " | ")
    _phase("build", f"{lib.name} in {time.time() - t0:.1f} s; ptxas: {log[-400:]}")
    rng = np.random.default_rng(0)
    max_err = 0
    kernel_ms, plain_ms, cold_ms, bounds = {}, {}, {}, {}
    flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    for (M, N) in ((16384, 1024), (16001, 1000)):
        inp = planted_inputs(M, N, rng, dev)
        check_pack(inp["a_desc"], inp["a_pm1"])
        check_pack(inp["b_desc"], inp["b_pm1"])
        for radius in RADII:
            err, n_has = compare_kernel(inp, radius)
            max_err = max(max_err, err)
            if (M, N) == (16384, 1024):
                args = [inp[k] for k in ("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid",
                                         "b_desc", "b_pm1", "b_uv", "b_lvl", "b_valid")]
                ref_args = [inp[k] for k in ("a_pm1", "a_uv", "a_lvl", "a_valid",
                                             "b_pm1", "b_uv", "b_lvl", "b_valid")]
                kernel_ms[radius] = time_cuda(lambda: hamming_top2_windowed(*args, radius))
                cold_ms[radius] = time_cuda_cold(
                    lambda: hamming_top2_windowed(*args, radius), flush)
                plain_ms[radius] = time_cuda(
                    lambda: hamming_top2_windowed_ref(*ref_args, radius), n=10)
                bounds[radius] = kernel_bound(inp, radius)
                _phase("kernel", f"M={M} N={N} r={radius:g}: exact ({n_has} rows "
                                 f"matched); kernel {kernel_ms[radius] * 1e3:.1f} us "
                                 f"(cold L2 {cold_ms[radius] * 1e3:.1f} us), twin "
                                 f"{plain_ms[radius] * 1e3:.1f} us, bound "
                                 f"{bounds[radius][0] * 1e3:.2f} us by {bounds[radius][1]} "
                                 f"({bounds[radius][2]['passing_pairs']} of "
                                 f"{bounds[radius][2]['pairs']} pairs pass the gate)")
            else:
                _phase("kernel", f"M={M} N={N} r={radius:g}: exact ({n_has} rows matched)")
    del flush

    # ---- phase 3: path 1, localization against a ground-truth map ----
    p = EUROC
    t0 = time.time()
    seq_boot = make_sequence(dataclasses.replace(p, n_frames=EUROC_BOOT_FRAMES), seed=0)
    seq = dataclasses.replace(seq_boot, imgs=seq_boot.imgs[:p.n_frames],
                              depths=seq_boot.depths[:p.n_frames],
                              imu=seq_boot.imu[:p.n_frames])
    cam = profile_camera(p, dev)
    ext = factors.extrinsics_from_Tbc(TBC, device=dev)
    m, n_kf = build_map(seq, p, cam, ext, dev)
    n_pts = int(m.mp_active.sum())
    check_pack(m.mp_desc, m.mp_pm1)
    check_pack(m.kf_desc.reshape(-1, 8), m.kf_pm1.reshape(-1, 256))
    _phase("map", f"{EUROC_BOOT_FRAMES} frames {p.width}x{p.height} rendered, the first "
                  f"{p.n_frames} of them for paths 1 and 2; {n_kf} "
                  f"keyframes, {n_pts}/{p.max_mp} map points "
                  f"({time.time() - t0:.1f} s)")
    # warm-up pass (allocator, cuBLAS/cuSOLVER handles) on a copy of the map,
    # then the measured run with every count set to 0
    run_slice(m, dataclasses.replace(seq, imgs=seq.imgs[:3], imu=seq.imu[:3]),
              dataclasses.replace(p, n_frames=3), cam, ext, dev)
    rec = SearchRecorder(keep_frames=3, timed=True)
    hamming_top2_windowed.launches = 0
    t0 = time.time()
    res = run_slice(m, seq, p, cam, ext, dev, recorder=rec, timed=True)
    launches_loc = hamming_top2_windowed.launches
    wall = time.time() - t0
    n_tracked = p.n_frames - 1
    summ = res["summary"]
    ms = np.asarray(res["ms"])
    k_ms = sum(s.elapsed_time(e) for _, s, e in rec.events)
    n_fb = int(summ[:, 2].sum())
    _phase("path1", f"{n_tracked} frames tracked in {wall:.1f} s; launches "
                    f"{launches_loc}; fallbacks {n_fb}; inliers min {summ[:, 0].min():.0f} "
                    f"median {np.median(summ[:, 0]):.0f}; position RMSE "
                    f"{res['rmse'] * 1e3:.2f} mm")
    _phase("path1", f"ms/frame median {np.median(ms):.2f} p90 "
                    f"{np.percentile(ms, 90):.2f}; kernel share "
                    f"{100.0 * k_ms / ms.sum():.3f}% ({k_ms:.2f} ms of {ms.sum():.1f} ms)")
    if launches_loc < 2 * n_tracked:
        raise AssertionError(f"kernel launched {launches_loc} times for {n_tracked} frames")
    if summ[:, 0].min() < p.fb_min_inliers:
        raise AssertionError(f"a frame kept {summ[:, 0].min():.0f} inliers "
                             f"(< {p.fb_min_inliers})")
    if not np.isfinite(res["P"]).all() or res["rmse"] >= RMSE_LIMIT_LOC:
        raise AssertionError(f"position RMSE {res['rmse']} m (limit {RMSE_LIMIT_LOC} m)")
    err, n_real = _real_search_check(rec)
    max_err = max(max_err, err)
    _phase("path1", f"kernel == twin on the {n_real} real searches of the first 3 frames")
    rmse_loc = res["rmse"]
    del m, res, rec

    # ---- phase 4: path 2, track and map ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec2 = SearchRecorder(keep_frames={0, 19, 39}, timed=False)
    hamming_top2_windowed.launches = 0
    t0 = time.time()
    res2 = run_track_and_map(seq, p, cam, ext, dev, recorder=rec2)
    launches_map = hamming_top2_windowed.launches
    wall2 = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for e in res2["events"]:
        _phase("event", event_line(e))
    summ2 = res2["summary"]
    ev = res2["events"]
    ev_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] for e in ev]
    n_fb2 = int(summ2[:, 2].sum())
    _phase("path2", f"{n_tracked} frames tracked and {len(ev)} keyframe events in "
                    f"{wall2:.1f} s; launches {launches_map}; inliers min "
                    f"{summ2[:, 0].min():.0f} median {np.median(summ2[:, 0]):.0f}; "
                    f"fallbacks {n_fb2}; active map points {ev[-1]['n_active']}; position "
                    f"RMSE {res2['rmse'] * 1e3:.2f} mm (limit {RMSE_LIMIT_MAP * 1e3:.0f}); "
                    f"ms/event median {np.median(ev_ms):.1f}; ms/frame median "
                    f"{np.median(res2['frame_ms']):.1f}; peak device memory {peak_mb:.0f} MiB")
    if len(ev) != (p.n_frames - 1) // p.kf_every:
        raise AssertionError(f"{len(ev)} keyframe events ran")
    if launches_map < 2 * n_tracked:
        raise AssertionError(f"kernel launched {launches_map} times for {n_tracked} frames")
    check_track_and_map(res2, p)
    err, n_real2 = _real_search_check(rec2)
    max_err = max(max_err, err)
    _phase("path2", f"kernel == twin on the {n_real2} real searches of frames 1, 20 and 40")

    del res2["m"], rec2

    # ---- phase 5: path 3, bootstrap from raw frames to VI tracking ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec3 = SearchRecorder(keep_frames=(), timed=False)
    hamming_top2_windowed.launches = 0
    t0 = time.time()
    res3 = run_bootstrap(seq_boot, p, cam, ext, dev, recorder=rec3)
    launches_boot = hamming_top2_windowed.launches
    wall3 = time.time() - t0
    peak3_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    ini = res3["init"]
    _phase("init", f"two-view initialization accepted at frame {ini['frame']}: "
                   f"{ini['n_matches']} matches, model {'H' if ini['used_h'] else 'F'} "
                   f"(scores H {ini['score_h']:.0f} F {ini['score_f']:.0f}), {ini['n_good']} "
                   f"points; two-view BA cost {ini['ba']['cost0']:.1f} -> "
                   f"{ini['ba']['cost']:.1f}; {ini['ms']:.0f} ms, {ini['syncs']} flagged syncs")
    for e in res3["events"]:
        _phase("event", ("VI " if e["vi"] else "visual ") + event_line(e))
    for a in res3["attempts"]:
        _phase("vi-init", f"frame {a['frame']} t {a['t']:.2f} s, {a['n_kf']} keyframes: scale "
                          f"{a['scale']:.4f} scale* {a['scale_star']:.4f} cond {a['cond']:.0f} "
                          f"-> {a['reason']}; bg {np.round(a['bg'], 5).tolist()} ba "
                          f"{np.round(a['ba'], 4).tolist()}; ms "
                          f"{ {k: round(v, 1) for k, v in a['ms'].items()} }; flagged syncs "
                          f"{a['total_syncs']}; whole-map visual BA cost "
                          f"{a['ba_visual']['cost0']:.1f} -> {a['ba_visual']['cost']:.1f}"
                          + (f"; whole-map VI BA cost {a['ba_vi']['cost0']:.1f} -> "
                             f"{a['ba_vi']['cost']:.1f}" if "ba_vi" in a else ""))
    fr = res3["frames"]
    vis_ms = [f["ms"] for f in fr if not f["vi"] and f["plain"]]
    vi_ms = [f["ms"] for f in fr if f["vi"] and f["plain"]]
    n_boot = len(fr)
    ev3 = res3["events"]
    ev3_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] for e in ev3 if not e["vi"]]
    measured = check_bootstrap(res3, seq_boot, p)
    _phase("path3", f"{n_boot} frames tracked from raw frames in {wall3:.1f} s: VI init "
                    f"accepted at frame {res3['i_accept']}, {len(res3['st'].kf_slots)} "
                    f"keyframes, {len(ev3)} events, {len(res3['attempts'])} VI-init attempts; "
                    f"launches {launches_boot}; inliers min "
                    f"{min(f['n_inliers'] for f in fr)}; fallbacks "
                    f"{sum(f['used_fb'] for f in fr)}; ms/frame visual median "
                    f"{np.median(vis_ms):.1f} p90 {np.percentile(vis_ms, 90):.1f}, VI median "
                    f"{np.median(vi_ms):.1f}; ms/visual event median {np.median(ev3_ms):.1f}; "
                    f"peak device memory {peak3_mb:.0f} MiB")
    _phase("path3", f"gyro bias error of keyframe 0 {np.round(measured['bg_err'], 5).tolist()} "
                    f"(limits {list(BG_TOL_BOOT)}); gravity cos {measured['gravity_cos']:.5f} "
                    f"(> {GRAVITY_COS_BOOT}); post-init ATE {measured['ate_post_m'] * 1e3:.2f} mm "
                    f"over {measured['n_post']} frames (< {ATE_LIMIT_BOOT * 1e3:.0f}), alignment "
                    f"scale {measured['scale_post']:.4f} (within {SCALE_TOL_BOOT} of 1); whole "
                    f"trajectory ATE {measured['ate_all_m'] * 1e3:.2f} mm, scale "
                    f"{measured['scale_all']:.4f}")
    if launches_boot < 2 * n_boot:
        raise AssertionError(f"kernel launched {launches_boot} times for {n_boot} frames")
    err, n_real3 = _real_search_check(rec3)
    max_err = max(max_err, err)
    _phase("path3", f"kernel == twin on the {n_real3} real searches of one visual frame "
                    f"and one VI frame")

    bound_ms, bound_by, bound_detail = bounds[15.0]
    record = {"kernels": [{
        "name": "hamming_top2_windowed", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches_loc + launches_map + launches_boot,
        "max_abs_err": max_err, "ms": kernel_ms[15.0], "plain_ms": plain_ms[15.0],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}
    strip = lambda e: {k: v for k, v in e.items() if k != "costs"}
    detail = {"card": smi, "kernel_ms_by_radius": {f"{r:g}": kernel_ms[r] for r in RADII},
              "kernel_cold_ms_by_radius": {f"{r:g}": cold_ms[r] for r in RADII},
              "plain_ms_by_radius": {f"{r:g}": plain_ms[r] for r in RADII},
              "bound_ms_by_radius": {f"{r:g}": bounds[r][0] for r in RADII},
              "bound_detail_r15": bound_detail,
              "path1": {"frames": n_tracked, "launches": launches_loc,
                        "frame_ms_median": float(np.median(ms)),
                        "frame_ms_p90": float(np.percentile(ms, 90)),
                        "kernel_share": k_ms / float(ms.sum()), "rmse_m": rmse_loc,
                        "fallbacks": n_fb,
                        "min_inliers": float(summ[:, 0].min())},
              "path2": {"frames": n_tracked, "launches": launches_map,
                        "events": [strip(e) for e in ev], "rmse_m": res2["rmse"],
                        "fallbacks": n_fb2, "min_inliers": float(summ2[:, 0].min()),
                        "median_inliers": float(np.median(summ2[:, 0])),
                        "event_ms_median": float(np.median(ev_ms)),
                        "frame_ms_median": float(np.median(res2["frame_ms"])),
                        "peak_device_MiB": peak_mb},
              "path3": {"frames": n_boot, "launches": launches_boot, "init": ini,
                        "events": [strip(e) for e in ev3], "attempts": res3["attempts"],
                        "accepted_at_frame": res3["i_accept"], "measured": measured,
                        "frame_ms_visual_median": float(np.median(vis_ms)),
                        "frame_ms_visual_p90": float(np.percentile(vis_ms, 90)),
                        "frame_ms_vi_median": float(np.median(vi_ms)),
                        "event_ms_visual_median": float(np.median(ev3_ms)),
                        "frame_syncs_median": float(np.median(
                            [f["syncs"] for f in fr if f["plain"]])),
                        "peak_device_MiB": peak3_mb, "seconds": wall3},
              "seconds": time.time() - t_start}
    print(json.dumps(detail), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
