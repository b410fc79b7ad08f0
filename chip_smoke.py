#!/usr/bin/env python3
"""Drive the port's Mono+IMU bootstrap, tracking, mapping, relocalization,
loop closing, the mesh-sharded whole-map solvers, checkpoint and resume,
the asynchronous frame loop against the synchronous mode, depth sensors
(RGB-D, stereo + IMU), capacity eviction of keyframes and points, the
batched multi-sequence step and the multi-host Schur solve on one NVIDIA
GPU.

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
    then runs `tracking.frame_pipeline_vi` on 20 frames on cuda, with the
    state carried synchronously. Checks the kernel's launch count, the
    inliers of every frame, the position RMSE against ground truth, and
    kernel == twin on the real search inputs of the first frames;
 4. path 2, track and map: the same clone, but only keyframe 0 is seeded
    (ground-truth pose, points from the rendered depth). Frames 1-20 are
    tracked against the live map; every 10th tracked frame becomes a
    keyframe (its tracked NavState and associations, the preintegration of
    the IMU rows since the last keyframe) and runs one keyframe event:
    `mapping.kf_event_pre` (cull, neighbours, triangulation, fusion),
    `ba_vi_idp.window_vi_ba_map` (inverse-depth window VI BA, window padded
    to 24 slots, Pw = 4096, 8 iterations), `mapping.kf_event_post`, the stats
    copy and keyframe culling; tracking then continues from the optimised
    keyframe. One line per event, one summary line. Checks: every BA cost
    finite and not rising, points triangulated in at least half of the
    events, no landmark overflow, no frame under fb_min_inliers, position
    RMSE under RMSE_LIMIT_MAP, kernel == twin on real searches of this path;
 5. path 3, bootstrap: the same clone from raw frames, nothing seeded from
    ground truth (no depth, pose, bias or gravity), through the port's entry
    point: a `SlamSystem` at the euroc profile with vi_init_time = 5 s, and
    `track(img, t, imu)` per frame. Frame 0 is the two-view reference; the
    next frames try the two-view initialization until it builds keyframes 0
    and 1 and the first points (median depth 1) and runs the two-view BA;
    then visual tracking (`tracking.frame_pipeline_visual`, keyframe
    decisions, visual keyframe events with keyframe culling, the VI-init
    attempt); after the accepted VI initialization (whole-map visual BA,
    scale / gravity / bias solve, re-preintegration, rescale, whole-map VI
    BA) 5 frames of VI tracking. One line for the two-view init, one per
    event, one per VI-init attempt, two summary lines. Fails when: two-view
    init is not accepted by frame 20, a frame is LOST, VI init is not
    accepted by frame 160, a BA cost is not finite or rises, the trajectory
    lacks a row of a tracked frame, the kernel launched fewer than twice a
    tracked frame, kernel != twin on a recorded visual and VI frame, or the
    result leaves the gates of the JAX package's own ~5 s initialization test
    (gyro bias of keyframe 0, gravity direction, post-init ATE and alignment
    scale against ground truth);
 6. path 4, the system at the published configuration: the same as path 3
    with vi_init_time = 15 s (config/euroc.yaml:6), so ~300 visual frames
    with keyframe events and culling before VI init (deadline: frame 340),
    then 20 VI frames, then `global_refine()` (ATE before and after), under
    path 3's gates;
 7. phase "chunked": from path 4's map as it was before `global_refine`, the
    landmark-chunked whole-map VI BA (16 chunks of 1024 landmarks, keyframes
    padded to 32) against the dense one: keyframe positions within 5 mm,
    final costs within 1 %, both cost curves never rising; ms, kernels
    launched and peak memory of each. Then the system's stage timers;
 8. phase "mesh", the whole-map BA: on path 4's map, its landmarks spread
    over the table so that both shards hold some and every free keyframe and
    landmark moved by a seeded 3 cm draw, the pipeline's chunked VI BA with a
    two-shard mesh on the card (`SlamSystem.enable_mesh`'s route:
    `dist_gba.vi_gba_chunked_sharded`, the chunks split over the shards, one
    reduction of the camera system an iteration) against the unsharded
    `ba_chunked.vi_gba_chunked`: the unsharded BA moves a keyframe by 25 mm
    or more, the two agree on keyframe positions within 1.5 mm and on final
    costs within 0.002 %, no cost curve rising; distance, move, costs and ms;
 9. path 5, "euroc-revisit", on path 4's system (loop closing on since frame
    0, so every keyframe has its BoW histogram): 3 blank frames with IMU rows
    lose the camera (three "lost" events); the carried pose and gyro bias are
    corrupted (5 m away, bias off by 0.05 / 0.04 / 0.03 rad/s); frames 200-264
    of the same run are fed again, wall clock and IMU rows continuing. Fails
    unless: a "reloc" event within 5 frames, within 5 cm of the pose the system
    estimated at that source frame; the 20-frame bias window completes; the
    gyro bias error falls under 0.4 of the corruption on every axis; at least
    20 VI frames follow with none lost; a keyframe inserted after the
    relocalization starts a new IMU chain; loop detection ran ("lc_diag"
    events; each is printed, no closure is expected of a camera that tracks
    the old landmarks);
10. phase "loop", a planted seam at full table width: the keyframes inserted
    since frame 264 get their own copies of the landmarks they observe and a
    drift of 0.2 m / 3 degrees that grows along the chain (`plant_seam`); then
    `loopctl.try_close_loop` on the revisit keyframes in turn until one closes.
    Fails unless: a keyframe older than the seam reaches Sim3; the measured
    Sim3 equals the relative pose before the drift to 2 cm / 0.5 degrees; at
    least 40 guided matches; exactly one loop closed; the revisit keyframes
    come back within 3 cm; seam covisibility of at least 10; no cost curve
    rises; kernel == twin on the guided verification's search. Prints ms and
    flagged syncs of detect, Sim3 batch, verify, pose graph, both fusion
    rounds and the whole-map BA, and the kernels each launches when run alone;
11. phase "mesh", the essential graph: that closure's pose graph again,
    edge-sharded over two shards (`close_loop(mesh=)`,
    `dist_posegraph.optimize_pose_graph_dist`) against the unsharded one:
    keyframes within 2 mm, no cost curve rising; distance, costs and ms;
12. phase "checkpoint", on the system path 5 left (loop edges, a broken IMU
    chain, histogram ids): `io.checkpoint.save_system` to a temporary
    directory, `load_system` into a fresh `SlamSystem` on the card; every
    MapState table bit-equal, the host state and the trajectory equal; then
    the resumed system tracks the 5 clone frames after the replayed stretch
    (the first carries the IMU rows since the keyframe it resumed at). Fails
    on any difference, a lost frame, no kernel launch, or an ATE over those
    frames of 5 cm or more; prints save / load ms and the bytes written;
    phase "async": those files loaded into two fresh systems that track the
    20 clone frames after the replayed stretch, A synchronous (LAG_MAX =
    PAIR = 1) and B the frame loop at the JAX package's defaults (LAG_MAX
    12, PAIR 2). Prints for each ms per `track` (median, p90), the wall time
    with the final `flush()` and frames/s, matcher launches, flagged syncs
    a frame, the harvest pulls, the deepest queue, `ev_chain_drain`,
    keyframes, events harvested deferred, lost frames, ATE and peak memory;
    at the very end of the script (the profiler slows what runs after it)
    the device-busy share of 5 more frames of each. Fails on a lost frame,
    an ATE of 5 cm or more, B without a trajectory row per frame or with an
    entry pending after `flush()`, fewer than 10 pairs or no event harvested
    deferred, B more than 2 cm from A on a frame, or kernel != twin on the
    searches of B's first pair. Then C, the path from the frame loop through
    the synchronous relocalization and back (`run_transition`): the files
    loaded into a third system at LAG_MAX 12 / PAIR 2 with every entry
    harvested at the depth limit, a blank frame and 23 clone frames in
    flight, LOST at the blank pair's harvest, relocalization on path 5's
    first replayed frame, the 20-frame bias window and 2 x 12 pairs back in
    the loop. Fails unless: one loss, one relocalization, a keyframe closing
    the window and one decided at harvest after it, no frame lost after the
    relocalization, nothing pending after `flush()`, and every one of C's
    searches equal to the twin's;
13. path 6, "euroc-rgbd": a new `SlamSystem` (IMU off, cull_min_obs 2, loop
    closing on) fed the first 120 clone frames with their rendered depth
    through `track(img, t, depth=)`: the map starts metric from frame 0's
    depth, every pose solve and window BA carries the u_right row, every
    keyframe adds its nearest unmatched depth points. Fails unless:
    initialized from depth at frame 0 with at least 50 points, no frame
    LOST, every BA cost finite and not rising, u_right rows in every window
    BA, landmark overflow 0, ATE under 2 cm and the alignment scale within
    0.05 of 1 (tests/test_e2e_depth.py's metric gate), kernel == twin on the
    real searches of 3 frames;
14. path 7, "euroc-stereo-vi": the same clone frames with a rectified right
    image (`render_right`: the left camera moved 0.11 m along its x axis),
    `track(img, t, imu, img_right=)` with the IMU and VI init at 5 s, then 20
    VI frames: `stereo_depth`, the 3-row residual in the visual and VI pose
    solves, the visual window BA with u_right rows, VI init on a metric
    map, and the XYZ window VI BA at every event after it. Fails unless: no
    frame LOST, VI init accepted by frame 160, at least one XYZ window VI BA,
    costs finite and not rising, u_right rows in every window BA, the
    alignment scale within 0.2 of 1. Both paths print ms per frame (median,
    p90), ms per event, the stereo extraction + matching ms, launches and
    flagged syncs;
    phase "evict": a new `SlamSystem` at examples/eval_clone.py's small
    profile's widths (752x480, 512 features, 3 levels, window 8) with its
    tables cut to 10 keyframes and 768 points (`EVICT`), from raw clone
    frames with VI init at 5 s and 40 VI frames after it, under
    `eviction_watch` (the allocator's evictions and the tables before and
    after each event's landmark maintenance). Fails unless at least 2
    keyframes are evicted at capacity, 1 of them after VI init (its IMU
    rows spliced into its successor), at least one point-eviction pass
    deactivates points, the keyframe table never holds more than its size,
    no frame is lost, every BA cost curve is non-increasing with no
    landmark overflow, the post-init ATE is under path 3's 8 cm, and the
    kernel equals its twin on the phase's real searches (N = 512);
15. phase "multiseq" (BASELINE.json config #4, parallel/multiseq.py): 11
    windows of the clone (starting at frames 0, 10, ..., 100), each with its
    own map seeded as path 1's over its own frames, tracked as ONE batch:
    10 `make_batched_step` steps (752x480, 1024 features, 8 levels, 16384
    map points a map, 10 LM iterations), the projection-search kernel taking
    all 11 problems in one launch a round. Fails unless: every window's
    position RMSE against ground truth is under path 1's 2 cm; the same
    windows tracked one at a time by the unbatched `track_frame_visual` agree
    within 1e-3 m and 2 inliers (tests/test_multiseq.py's tolerances); the
    kernel launched exactly 2 times a batched step (22 unbatched), and so did
    the pose LM kernel (`solver/pose_lm_cuda.py`); the batched kernel equals
    the batched twin exactly on the step's real searches and on planted
    inputs at B=11 x 16384 x 1024, r = 4 / 15 / 40 px; the pose LM kernel
    keeps to its twin (`ba.pose_only_visual_ref`) on the step's two recorded
    solves within pose_lm_cuda's POSE_LM_* tolerances (position, rotation, each row's
    chi2, inliers), one launch a solve; 10 of the windows over a two-shard
    "seq" mesh on cuda:0 agree with the unsharded step as above. Prints ms per batched step (median, p90),
    aggregate frames/s against the sequential run's, launches of all kernels
    a batched step against an unbatched frame's, peak memory, the
    batched kernel's warm / cold times beside 11 x the single problem's and
    its bound, and the pose LM kernel's warm / cold times beside its twin's
    and its bound;
16. phase "multihost" (BASELINE.json config #5): tools/run_multihost_ba.py
    --demo 2 (two ranks on cuda:0 over gloo, 4 shards a rank) and --demo 1
    with nccl (one rank: the NCCL all_reduce runs on the card), both on the
    JAX demo's problem and on one at the map's scale (132 keyframes, 16384
    landmarks). Fails unless every rank's camera update is bit-equal to rank
    0's and within 5e-4 of the single-process Schur solve; prints ms per
    solve. Two ranks on two cards (NCCL across cards) need a second card;
17. phase "bench" (the JAX repo's bench.py, `tools/bench.py`): its workloads
    1-5 in this process at full size, 3 timed calls each (the tool times
    20): the fused frame step (752x480 noise, 1024 features, 8 levels,
    `track_frame_visual` with 10 LM iterations against a 16384-point random
    map), the extraction alone, the XYZ and inverse-depth window VI BAs (20
    keyframes, 2048 points, 10 iterations), 8 sequences in one batched step,
    the plain 1024 x 16384 Hamming matrix and the kernel on the frame step's
    first search; then `tools/bench_scaling.py`'s part A (the chunked
    whole-map VI BA at 128 keyframes, 12288 points, 96 chunks) at 2
    iterations. Fails unless the kernel equals its twin on the searches of
    the first frame step and the first batched step that the workloads
    timed (`probes.search_recorder` in front of the wrapper), the kernel
    launched 2 times a frame step and 2 times a batched step, and so did the
    pose LM kernel, and every BA cost curve is finite and non-increasing;
    prints each workload's time and the launches a frame.
Every path and phase that tracks frames also counts the pose LM kernel's
launches from 0 and, where it knows how many frames it tracked visually,
fails unless there were at least 2 a frame; the line "[launches]" gives
them by path, with no timing or check launch among them, and their sum is
the kernel's "launches" in the record. The same paths and phases count the
VI pose LM kernel's launches (`solver/pose_vi_lm_cuda.py`) and the VI
frame programs they ran, and fail unless there were exactly 2 a VI frame
(none where no frame used the IMU); path 3 holds that kernel to its twin
(`ba_vi.pose_only_vi_ref`) on its first 10 VI solves and path 7 on its
first 10 stereo ones, within pose_vi_lm_cuda's POSE_VI_LM_* tolerances (state, chi2,
inliers, marginal), and path 3 prints its warm / cold times beside its
twin's and its bound; a second "[launches]" line gives them by path, and
their sum is that kernel's "launches" in the record.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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
from mc_slam_tpu_torch.geometry.sim3solver import Sim3Result
from mc_slam_tpu_torch.io import checkpoint
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.pipeline import (loopclosing, loopctl, mapping, mapping_ctl, system,
                                        tracking, tracking_ctl)
from mc_slam_tpu_torch.parallel import dist_ba
from mc_slam_tpu_torch.pipeline.pipebase import LOST, OK
from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
from mc_slam_tpu_torch.slam_map.mapstate import (_set_drop, covisibility_matrix, empty_map,
                                                 observation_counts)
from mc_slam_tpu_torch.solver import ba, ba_vi, factors, pose_lm_cuda, pose_vi_lm_cuda
from mc_slam_tpu_torch.tools.eval_clone import PROFILE_CONFIG, eviction_watch
from mc_slam_tpu_torch.tools import probes
from mc_slam_tpu_torch.tools.probes import time_cuda, time_cuda_cold

# the reference's EuRoC Tbc (config/euroc.yaml:40-44)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
TRUE_BG = np.array([0.003, -0.0045, 0.0035])    # examples/make_euroc_clone.py
TRUE_BA = np.array([0.035, -0.02, 0.06])
KERNEL_REPLACES = "mc_slam_tpu/frontend/match_pallas.py:100"
RADII = (4.0, 15.0, 40.0)
RMSE_LIMIT_LOC = 0.02       # m, path 1 (tracking against a ground-truth map)
PATH1_FRAMES = 10           # frames path 1 tracks
RMSE_LIMIT_MAP = 0.03       # m, path 2 (tracking against the live map)


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
    n_frames: int = 21          # frame 0 seeds the state; 20 are tracked
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
    n_vi_frames: int = 5        # frames tracked with the IMU after VI init


EUROC = Profile()
# path 4: the published configuration (config/euroc.yaml:6, 15 s before VI init)
EUROC_SYSTEM = dataclasses.replace(EUROC, vi_init_time=15.0, boot_max_frame=340,
                                   n_vi_frames=20)
EUROC_SYSTEM_FRAMES = EUROC_SYSTEM.boot_max_frame + EUROC_SYSTEM.n_vi_frames + 1
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


def make_sequence(p: Profile, seed: int = 0, n_depth: int | None = None) -> Sequence:
    """Render the clone as examples/make_euroc_clone.py does (tex_scale 1.0,
    EuRoC Tbc, true biases, EuRoC IMU noise), minus the hardening passes.
    n_depth: keep the rendered depth of the first so many frames only (the
    paths that start from raw frames read none)."""
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
        depths.append(depth if n_depth is None or i < n_depth else None)
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
    (mapping_ctl.depth_to_world + alloc_points). Returns (m, n_keyframes)."""
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
        Xw = mapping_ctl.depth_to_world(cam, ext, uv, _t(d, device), P, R)
        good = f.valid.cpu().numpy() & (d > 1e-3)
        m, _, _ = mapping_ctl.alloc_points(m, Xw, f.desc, f.desc_pm1, f.level, slot,
                                       good, p.n_levels, i, angle=f.angle)
        slot += 1
    return m, slot


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
    fresh_fb = _t(tracking_ctl.fresh_prior_info(1e2), device)
    prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=_t(tracking_ctl.fresh_prior_info(1e3),
                                                        device), valid=c1)
    pfm = torch.full((p.n_feat,), -1, dtype=torch.int32, device=device)
    pan = torch.zeros(p.n_feat, device=device)
    has_prev = False
    imgs = [torch.from_numpy(im).to(device) for im in seq.imgs]
    imus = [torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in seq.imu]
    Ps, Rs, fmps, summaries, ms = [], [], [], [], []
    with recorder or contextlib.nullcontext():
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
    if timed:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ms]
    P = torch.stack(Ps).cpu().numpy()
    err = np.linalg.norm(P - seq.P[1:p.n_frames], axis=1)
    return dict(P=P, R=torch.stack(Rs).cpu().numpy(),
                feat_mp=torch.stack(fmps).cpu().numpy(),
                summary=torch.stack(summaries).cpu().numpy(), ms=ms,
                rmse=float(np.sqrt(np.mean(err ** 2))), m=m)


def seed_keyframe0(seq: Sequence, p: Profile, cfg, cam, ext, noise, device):
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
    m, _ = mapping_ctl.insert_keyframe(m, st, cfg, ns0, f, uv, seq.times[0], 0, None, noise)
    xy = f.xy.cpu().numpy()
    xs = np.clip(xy[:, 0].astype(int), 0, p.width - 1)
    ys = np.clip(xy[:, 1].astype(int), 0, p.height - 1)
    d = seq.depths[0][ys, xs]
    d = np.where(d > 1e-3, d, -1.0).astype(np.float32)
    Xw = mapping_ctl.depth_to_world(cam, ext, uv, _t(d, device), ns0.P, ns0.R)
    good = f.valid.cpu().numpy() & (d > 1e-3)
    m, _, _ = mapping_ctl.alloc_points(m, Xw, f.desc, f.desc_pm1, f.level, 0, good,
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
    mapping_ctl.keyframe_event (which ends with keyframe culling); tracking
    then continues from the optimised keyframe with a fresh prior
    (SlamSystem._local_mapping's state carry).

    on_event(m, st, frame_index): optional hook called after the insertion and
    before the event (tests capture the MapState there).
    Returns a dict: per-frame positions and summaries, per-event records."""
    cuda = torch.device(device).type == "cuda"
    noise = euroc_noise(device=device)
    cfg = slam_config(p)
    m, st = seed_keyframe0(seq, p, cfg, cam, ext, noise, device)
    ns = mapping_ctl.keyframe_navstate(m, 0)
    gw = torch.tensor([0.0, 0.0, -9.81], device=device)
    sigma_bg, sigma_ba = float(noise.sigma_bg), float(noise.sigma_ba)
    c0 = torch.zeros((), dtype=torch.int64, device=device)
    c1 = torch.ones((), device=device)
    fresh_fb = _t(tracking_ctl.fresh_prior_info(1e2), device)
    fresh_1e3 = _t(tracking_ctl.fresh_prior_info(1e3), device)
    prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=fresh_1e3, valid=c1)
    pfm = torch.full((p.n_feat,), -1, dtype=torch.int32, device=device)
    pan = torch.zeros(p.n_feat, device=device)
    has_prev = False
    imgs = [torch.from_numpy(im).to(device) for im in seq.imgs]
    imus = [torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in seq.imu]
    imu_since_kf = []
    Ps, summaries, events, frame_ms = [], [], [], []
    with recorder or contextlib.nullcontext():
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
            m, slot = mapping_ctl.insert_keyframe(m, st, cfg, ns, feats, uv, seq.times[i], i,
                                                  torch.cat(imu_since_kf), noise, feat_mp=fmp)
            imu_since_kf = []
            if on_event is not None:
                on_event(m, st, i)
            with sync_watch(cuda) as caught:
                timer = EventTimer(cuda, caught)
                m, res = mapping_ctl.keyframe_event(m, st, cfg, i, cam, ext, gw, noise,
                                                    timer=timer, max_new=p.max_new,
                                                    ba_Pw=p.ba_Pw)
            # the event has kept the covisibility row and the well-observed
            # count that the next event's choices use, and culled keyframes
            events.append(_event_record(i, slot, res, timer))
            ns = mapping_ctl.keyframe_navstate(m, slot)
            prior = ba_vi.PriorFactor(cam=c0, ns0=ns, info=fresh_1e3, valid=c1)
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
                pre_ms=ms["pre"], ba_ms=ms["ba"], post_ms=ms["post"], cull_ms=ms["cull"],
                syncs=sum(syncs.get(k, 0) for k in ("pre", "ba", "post")),
                removed=list(res.removed), costs=res.ba.costs.cpu().numpy())


def _ba_record(stats, ms):
    """A whole-map BA's numbers on the host."""
    host = torch.stack([stats.cost0, stats.cost, stats.n_landmarks.to(torch.float32)
                        ]).cpu().numpy()
    return dict(cost0=float(host[0]), cost=float(host[1]), n_landmarks=int(host[2]),
                ms=ms)


def slam_config(p: Profile):
    """The euroc profile of examples/eval_clone.py at the sizes of `p`."""
    return system.SlamConfig(max_kf=p.max_kf, max_mp=p.max_mp, n_feat=p.n_feat,
                             n_levels=p.n_levels, local_window=p.local_window,
                             use_imu=True, vi_init_time=p.vi_init_time, g_mag=9.81)


def run_bootstrap(seq: Sequence, p: Profile, cam, device, recorder=None):
    """Paths 3 and 4: the port started from raw frames, through its entry
    point. A `SlamSystem` is built at the sizes of `p` and every frame goes
    through `track(img, t, imu)`: frame 0 is the two-view reference, the next
    frames try the two-view initialization (200 8-point samples from the
    system's seeded generator) until it builds the first two keyframes; then
    visual tracking with keyframe decisions, visual keyframe events, keyframe
    culling and the VI-init attempt (`vi_init_time` = p.vi_init_time) until VI
    init is accepted, and p.n_vi_frames more frames with the IMU. Nothing
    comes from ground truth.
    Returns a dict: the init record, per-frame summaries, per-event and
    per-attempt records, the composed trajectory, the system and its final
    map and states. Raises when a frame is LOST or an acceptance deadline
    passes."""
    cuda = torch.device(device).type == "cuda"
    slam = system.SlamSystem(cam, slam_config(p), Tbc=TBC, device=device)
    slam.event_kw = dict(max_new=p.max_new, ba_Pw=p.ba_Pw)
    st = slam.st

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with recorder or contextlib.nullcontext():
        # ---- monocular initialization ----
        i, init = -1, None
        while init is None:
            i += 1
            if i > p.init_max_frame:
                raise AssertionError(f"two-view initialization not accepted by frame "
                                     f"{p.init_max_frame}")
            sync()
            t0 = time.perf_counter()
            with sync_watch(cuda) as caught:
                ok = slam.track(seq.imgs[i], float(seq.times[i]), seq.imu[i])
                sync()
            if ok:
                att = slam.last_init
                tv = att.two_view
                host = torch.stack([x.to(torch.float32) for x in (
                    tv.used_h, tv.n_good, tv.score_h, tv.score_f)]).cpu().numpy()
                init = dict(frame=i, n_matches=att.n_matches, used_h=bool(host[0]),
                            n_good=int(host[1]), score_h=float(host[2]),
                            score_f=float(host[3]), ms=(time.perf_counter() - t0) * 1e3,
                            syncs=count_syncs(caught),
                            ba=_ba_record(att.ba, float("nan")))

        # ---- visual tracking and mapping until VI init, then VI frames ----
        frames, events, attempts = [], [], []
        n_vi = 0
        i_accept = None
        seen_slots, n_reused = set(st.kf_slots), 0
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
                slam.event_probe = ev_timer = EventTimer(cuda, caught)
                slam.vi_probe = vi_timer = EventTimer(cuda, caught)
                ok = slam.track(seq.imgs[i], t_i, seq.imu[i])
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            out = slam.last_outcome
            if not ok:
                raise AssertionError(f"frame {i} LOST with {out.n_inliers} inliers "
                                     f"({'VI' if was_vi else 'visual'} tracking)")
            n_vi += was_vi
            attempted = out.vi is not None and out.vi.attempted
            frames.append(dict(frame=i, vi=was_vi, n_inliers=out.n_inliers,
                               used_fb=out.used_fallback, ms=ms, syncs=count_syncs(caught),
                               plain=out.keyframe is None and not attempted))
            if out.event is not None:
                e = _event_record(i, out.keyframe, out.event, ev_timer)
                e["vi"] = was_vi
                events.append(e)
                n_reused += out.keyframe in seen_slots
                seen_slots.add(out.keyframe)
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
    slam.event_probe = slam.vi_probe = None
    traj = slam.get_trajectory()
    m = slam.m
    return dict(init=init, frames=frames, events=events, attempts=attempts,
                i_accept=i_accept, last_frame=i, traj=traj, slam=slam, m=m, st=st,
                ts=slam.ts, n_reused=n_reused,
                n_culled_kf=sum(len(e["removed"]) for e in events),
                gw=slam.gw.cpu().numpy(), bg0=m.kf_ns.bg[st.kf_slots[0]].cpu().numpy(),
                bg0_full=(m.kf_ns.bg + m.kf_ns.dbg)[st.kf_slots[0]].cpu().numpy())


def count_kernels(fn):
    """Run fn() under torch.profiler; returns (its result, the number of
    kernels and copies the card ran for it). Device activity only, read from
    the raw records (`device_busy_ms`): tracing the host side as well and
    building `prof.events()` took ~45 s over the chunked BA's 72k kernels."""
    torch.cuda.synchronize()
    out, _, _, n = device_busy_ms(fn)
    return out, n


def run_refine_and_chunked(res, seq: Sequence, p: Profile):
    """Path 4's tail on the system `run_bootstrap` left: ATE before and after
    `global_refine()`, and the phase "chunked": from the map as it was BEFORE
    the refinement, the landmark-chunked whole-map VI BA
    (`mapping_ctl.global_ba_chunked`, max_mp / 1024 chunks, keyframes padded to
    32) against the dense one (`mapping_ctl.local_ba(force_all=True)`), both
    without the association prune, as `global_refine` runs them.
    Returns a dict of the measured values; raises when the two disagree by
    more than 5 mm in a keyframe position or 1 % in the final cost."""
    slam = res["slam"]
    cuda = slam.device.type == "cuda"
    m0, st, cfg = slam.m, slam.st, slam.cfg
    act = list(st.kf_slots)

    def ate():
        tr = slam.get_trajectory()
        return ate_rmse(np.asarray([x[0] for x in tr]), np.asarray([x[1] for x in tr]),
                        seq.times, seq.P, with_scale=True), len(tr)

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, (torch.cuda.max_memory_allocated() / 2 ** 20 if cuda else 0.0)

    before, n_rows = ate()
    _, refine_ms, _ = timed(slam.global_refine)
    after, _ = ate()
    gba = _ba_record(slam.last_gba, refine_ms)
    gba["costs"] = slam.last_gba.costs.cpu().numpy()

    args = (st, cfg, slam.cam, slam.ext, slam.gw, slam.noise)
    chunked = lambda: mapping_ctl.global_ba_chunked(m0, *args, act, prune=False)

    def dense():
        # the dense form is the yardstick here whatever the map's size; the
        # system itself takes the chunked form above GBA_MAX_KF keyframes
        limit = mapping_ctl.GBA_MAX_KF
        mapping_ctl.GBA_MAX_KF = max(limit, len(act))
        try:
            return mapping_ctl.local_ba(m0, *args, force_all=True, prune=False)
        finally:
            mapping_ctl.GBA_MAX_KF = limit
    out = {}
    for name, fn in (("dense", dense), ("chunked", chunked)):
        fn()                                            # warm-up
        (m2, stats), ms, peak = timed(fn)
        launches = count_kernels(fn)[1] if cuda else 0
        h = torch.cat([stats.costs, m2.kf_ns.P[act].reshape(-1)]).cpu().numpy()
        n_c = stats.costs.shape[0]
        out[name] = dict(ms=ms, launches=launches, peak_MiB=peak, costs=h[:n_c],
                         cost0=float(h[0]), cost=float(h[n_c - 1]),
                         P=h[n_c:].reshape(-1, 3))
    dP = float(np.abs(out["chunked"]["P"] - out["dense"]["P"]).max())
    dcost = abs(out["chunked"]["cost"] - out["dense"]["cost"]) / out["dense"]["cost"]
    for name in ("dense", "chunked"):
        c = out[name]["costs"]
        if not np.isfinite(c).all() or np.any(np.diff(c) > 0):
            raise AssertionError(f"{name} whole-map BA: cost curve {c}")
    if not (dP < 5e-3 and dcost < 1e-2):
        raise AssertionError(f"chunked whole-map BA against dense: keyframe positions differ "
                             f"by {dP} m, final costs by {dcost}")
    n_chunks = max(1, m0.P // 1024)
    return dict(ate_before=before, ate_after=after, n_rows=n_rows, refine_ms=refine_ms,
                gba=gba, n_kf=len(act), n_chunks=n_chunks, dP_m=dP, dcost_rel=dcost,
                dense={k: v for k, v in out["dense"].items() if k != "P"},
                chunked={k: v for k, v in out["chunked"].items() if k != "P"})


# ---------------------------------------------------------------------------
# Path 5, "euroc-revisit": kidnap, relocalization, the bias window, live loop
# detection, and the phase "loop" on a planted seam
# ---------------------------------------------------------------------------

BG_CORRUPTION = np.array([0.05, -0.04, 0.03], np.float32)   # tests/test_e2e_reloc.py:85
RELOC_MAX_FRAMES = 5        # a "reloc" event within so many replayed frames
# PnP hypotheses a relocalization candidate on path 5 (SlamConfig.pnp_iters is
# the JAX package's 256, at which this scene relocalizes in 9 of 40 attempts)
PATH5_PNP_ITERS = 2048
RELOC_POS_TOL = 0.05        # m, against the system's own pose at the same source frame
SEAM_ROT_DEG = 3.0          # the planted drift: a rotation about a skew axis through the
SEAM_T = (0.16, -0.10, 0.07)   # newest revisit keyframe, and a translation of 0.20 m
SEAM_SIM3_T_TOL = 0.02      # m, measured Sim3 against the planted relative pose
SEAM_SIM3_R_TOL = 0.5       # degrees
SEAM_POSE_TOL = 0.03        # m, revisit keyframes after the closure against before the drift


def run_revisit(res, seq: Sequence, p: Profile, src_start: int, n_replay: int,
                n_blank: int = 3, recorder=None, pnp_iters: int = PATH5_PNP_ITERS):
    """Path 5 up to the live detection, on the system `run_bootstrap` left:
    `n_blank` blank frames (with IMU rows) lose the camera; the carried pose
    and gyro bias are then corrupted as tests/test_e2e_reloc.py does (pose far
    away, bias off by BG_CORRUPTION), so that only place recognition can
    re-acquire; then the rendered frames src_start .. src_start + n_replay - 1
    of the same run are fed again, wall clock and IMU rows continuing.
    Returns a dict of what happened (frames, events, the source frame of the
    relocalization, keyframes inserted after it); raises on the gates: LOST
    after the blank frames with one "lost" event each, a "reloc" event within
    RELOC_MAX_FRAMES, the bias window completed, no frame lost afterwards.
    The system draws `pnp_iters` PnP hypotheses a candidate from here on."""
    slam = res["slam"]
    slam.cfg.pnp_iters = pnp_iters
    st = slam.st
    dev = slam.device
    cuda = dev.type == "cuda"
    fdt = 1.0 / p.fps
    t = float(seq.times[res["last_frame"]])
    n_ev0 = len(slam.events)
    kf_before = list(st.kf_slots)
    traj_before = {round(float(x[0]), 6): np.asarray(x[1]) for x in slam.get_trajectory()}
    blank = np.full((p.height, p.width), 40, np.uint8)
    frames = []

    def step(img, rows, src):
        nonlocal t
        t += fdt
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_watch(cuda) as caught:
            ok = slam.track(img, t, rows)
            if cuda:
                torch.cuda.synchronize()
        frames.append(dict(src=src, t=t, ok=ok, state=slam.state,
                           ms=(time.perf_counter() - t0) * 1e3, syncs=count_syncs(caught),
                           window=slam.reloc_buf is not None,
                           mode=slam.last_outcome.mode if ok else "lost",
                           keyframe=slam.last_outcome.keyframe if ok else None))
        return ok

    with recorder or contextlib.nullcontext():
        for j in range(n_blank):
            step(blank, seq.imu[src_start - n_blank + j], None)
        lost = [e for e in slam.events[n_ev0:] if e[1] == "lost"]
        if slam.state != LOST or len(lost) != n_blank:
            raise AssertionError(f"after {n_blank} blank frames: state {slam.state}, "
                                 f"{len(lost)} lost events")
        far = torch.tensor([5.0, 5.0, -3.0], device=dev)
        bg_corrupt = torch.as_tensor(TRUE_BG.astype(np.float32) + BG_CORRUPTION, device=dev)
        slam.last_ns = slam.last_ns._replace(P=far, R=torch.eye(3, device=dev), bg=bg_corrupt,
                                             dbg=torch.zeros(3, device=dev))
        slam.last_pose = (far, torch.eye(3, device=dev))
        slam.velocity = (torch.zeros(3, device=dev), torch.eye(3, device=dev))
        i_reloc = None
        for k in range(n_replay):
            src = src_start + k
            if recorder is not None:
                recorder.frame = src
                if i_reloc is None:
                    recorder.keep_frames.add(src)     # the relocalizing frame's searches
            ok = step(seq.imgs[src], seq.imu[src], src)
            if ok and i_reloc is None:
                i_reloc = k
                if slam.reloc_buf is None:
                    raise AssertionError("relocalized after VI init, but no bias window opened")
                P_reloc = slam.last_pose[0].cpu().numpy()
            if i_reloc is None and k + 1 >= RELOC_MAX_FRAMES:
                raise AssertionError(f"no relocalization within {RELOC_MAX_FRAMES} frames: "
                                     f"{[e[2] for e in slam.events[n_ev0:]]}")
            if i_reloc is not None and not ok:
                raise AssertionError(f"replayed frame {src} lost after the relocalization "
                                     f"({frames[-1]})")
    if slam.reloc_buf is not None:
        raise AssertionError("the bias window did not complete")
    events = slam.events[n_ev0:]
    reloc = [e for e in events if e[1] == "reloc"]
    src_reloc = src_start + i_reloc
    P_then = traj_before[round(float(seq.times[src_reloc]), 6)]
    new_kf = [s_ for s_ in st.kf_slots if s_ not in kf_before]
    n_window = sum(f["mode"] == "reloc_window" for f in frames)
    after = [f for f in frames if f["src"] is not None and f["mode"] == ""]
    bg = slam.last_ns.bg_full.cpu().numpy()
    return dict(frames=frames, events=events, reloc=reloc[0][2], src_reloc=src_reloc,
                i_reloc=i_reloc, reloc_pos_err=float(np.linalg.norm(P_reloc - P_then)),
                new_kf=new_kf, kf_before=kf_before, n_window=n_window, n_vi_after=len(after),
                bg=bg, bg_err=np.abs(bg - TRUE_BG),
                chain_break=bool(new_kf) and new_kf[0] in st.broken_chain_slots,
                diags=[e for e in events if e[1] == "lc_diag"],
                sim3=[e for e in events if e[1] in ("sim3_result", "verify_result", "loop")])


def check_revisit(rv, p: Profile, n_vi_min: int = 20):
    """Path 5's gates on what `run_revisit` returns; raises on the first that
    fails."""
    if rv["reloc_pos_err"] >= RELOC_POS_TOL:
        raise AssertionError(f"relocalized {rv['reloc_pos_err']} m from the pose estimated at "
                             f"source frame {rv['src_reloc']}")
    if not np.all(rv["bg_err"] < 0.4 * np.abs(BG_CORRUPTION)):
        raise AssertionError(f"gyro bias after the window {rv['bg']} (true {TRUE_BG}, corrupted "
                             f"by {BG_CORRUPTION})")
    if rv["n_window"] < 19 or rv["n_vi_after"] < n_vi_min:
        raise AssertionError(f"{rv['n_window']} window frames, {rv['n_vi_after']} VI frames "
                             f"after them")
    if not rv["new_kf"] or not rv["chain_break"]:
        raise AssertionError(f"keyframes after the relocalization {rv['new_kf']}; the first "
                             f"starts a new IMU chain: {rv['chain_break']}")
    if not rv["diags"]:
        raise AssertionError("no loop detection ran (no lc_diag event)")


def _se3_pow(R, t, alpha, c):
    """A fraction of the rigid motion x -> R x + t, taken about the point c:
    the rotation Exp(alpha Log R) about c, and alpha of c's displacement."""
    Ra = tlie.so3_exp(alpha * tlie.so3_log(R))
    return Ra, alpha * (R @ c + t - c) + c - Ra @ c


def plant_seam(m, st, revisit, spread, R_d, t_d):
    """Turn a revisit into an open loop with a known drift. The keyframes of
    the NEW side, `spread` + `revisit` (slots; `spread` are the keyframes
    inserted between the place revisited and the revisit, oldest first), get
    their OWN copies of the landmarks they observe (the point rows copied to
    free slots, those keyframes' associations redirected, originals that
    nobody observes any more deactivated), so they share no landmark with the
    older keyframes. Then keyframes and points are moved by a drift that grows
    along the chain as real drift does: the `spread` keyframes by the
    fractions 1/(n+1) .. n/(n+1) of the rigid motion (R_d, t_d), the revisit
    keyframes by all of it; every copy that a revisit keyframe observes with
    them, every other point with the keyframe nearest its creation (the rule
    by which `loopclosing.close_loop` moves points back).
    Returns (m, dict of the poses before the drift and the copy count)."""
    dev = m.mp_pos.device
    P = m.P

    def seen_by(slots):
        ks = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        mp = m.kf_mp[ks]
        held = (mp >= 0) & m.kf_feat_valid[ks]
        mask = _set_drop(torch.zeros(P, dtype=torch.bool, device=dev),
                         torch.where(held, mp, P).reshape(-1).to(torch.int64), True)
        return ks, mp, held, mask & m.mp_active

    new_side = list(spread) + list(revisit)
    ks_new, mp_new, held, seen = seen_by(new_side)
    rev, _, _, seen_rev = seen_by(revisit)
    src = torch.nonzero(seen)[:, 0]
    free = torch.nonzero(~m.mp_active)[:, 0]
    if free.shape[0] < src.shape[0]:
        raise AssertionError(f"{src.shape[0]} landmarks to copy, {free.shape[0]} free slots")
    dst = free[:src.shape[0]]
    remap = torch.arange(P, dtype=torch.int32, device=dev)
    remap[src] = dst.to(torch.int32)
    fields = {f: getattr(m, f).clone() for f in m._fields if f.startswith("mp_")}
    for f in fields.values():
        f[dst] = f[src]
    # a copy is created, for the purposes of drift and correction, on the new
    # side: with the first revisit keyframe when one of them observes it
    first_new = m.kf_id[ks_new[0]]
    fields["mp_first_kf"][dst] = torch.where(
        seen_rev[src], m.kf_id[rev[0]], torch.clamp(m.mp_first_kf[src], min=first_new))
    fields["mp_ref_kf"][dst] = torch.where(seen_rev[src], rev[0], ks_new[0]).to(torch.int32)
    kf_mp = m.kf_mp.clone()
    kf_mp[ks_new] = torch.where(held, remap[torch.clamp(mp_new, 0, P - 1).to(torch.int64)],
                                mp_new)
    m = m._replace(kf_mp=kf_mp, **fields)
    m = m._replace(mp_active=m.mp_active & ~(seen & (observation_counts(m) < 0.5)))

    # the drift of every keyframe slot (identity where none is planted)
    K = m.K
    Rk = torch.eye(3, device=dev).repeat(K, 1, 1)
    tk = torch.zeros((K, 3), device=dev)
    n = len(spread)
    centre = m.kf_ns.P[rev[-1]]
    for j, s_ in enumerate(spread):
        Rk[s_], tk[s_] = _se3_pow(R_d, t_d, (j + 1) / (n + 1), centre)
    Rk[rev], tk[rev] = R_d, t_d
    before = dict(P=m.kf_ns.P.clone(), R=m.kf_ns.R.clone(), n_copied=int(src.shape[0]))
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    ns = m.kf_ns._replace(P=mv(Rk, m.kf_ns.P) + tk, R=Rk @ m.kf_ns.R, V=mv(Rk, m.kf_ns.V))
    # each point with the active keyframe nearest its creation
    act = torch.as_tensor(list(st.kf_slots), dtype=torch.int64, device=dev)
    ids_sorted, order = torch.sort(m.kf_id[act].to(torch.int64), stable=True)
    tid = m.mp_first_kf.to(torch.int64)
    Ka = act.shape[0]
    pos = torch.clamp(torch.searchsorted(ids_sorted, tid), 0, Ka - 1)
    left = torch.clamp(pos - 1, 0, Ka - 1)
    use_left = torch.abs(ids_sorted[left] - tid) <= torch.abs(ids_sorted[pos] - tid)
    owner = act[order[torch.where(use_left, left, pos)]]
    m = m._replace(kf_ns=ns, mp_pos=mv(Rk[owner], m.mp_pos) + tk[owner],
                   mp_normal=mv(Rk[owner], m.mp_normal))
    return m, before


def _angle_deg(R):
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def run_loop_phase(slam, revisit, spread, recorder=None, idx=None):
    """The phase "loop": plant a seam on the system's map (`plant_seam`, the
    drift SEAM_ROT_DEG / SEAM_T), run `loopctl.try_close_loop` on the revisit
    keyframes in turn, oldest first, with a stage probe, until one closes the
    loop, and hold the result against the planted drift. Returns a dict of the measured values; raises on a gate:
    a candidate older than the revisit reaches Sim3, the measured Sim3 equals
    the relative pose before the drift, at least 40 guided matches, one loop
    closed, the revisit keyframes back within SEAM_POSE_TOL, seam covisibility
    of at least 10, no cost curve rising."""
    st, ts, cfg = slam.st, slam.ts, slam.cfg
    dev = slam.device
    cuda = dev.type == "cuda"
    axis = torch.tensor([0.3, 0.2, 0.93], device=dev)
    R_d = tlie.so3_exp(axis / torch.linalg.norm(axis) * float(np.radians(SEAM_ROT_DEG)))
    m0 = slam.m
    c = m0.kf_ns.P[revisit[-1]]                 # the rotation's centre
    t_d = torch.tensor(SEAM_T, device=dev) + c - R_d @ c
    m1, before = plant_seam(m0, st, revisit, spread, R_d, t_d)
    W0 = covisibility_matrix(m1).cpu().numpy()
    old = [s_ for s_ in st.kf_slots if s_ not in revisit and s_ not in spread]
    if W0[np.ix_(list(spread) + list(revisit), old)].max() > 0:
        raise AssertionError("the new side still shares landmarks with the older keyframes")
    moved = (m1.kf_ns.P[revisit[-1]] - before["P"][revisit[-1]]).norm().item()
    loop = slam._loopctx
    loop.detector.consistent_groups = []
    n_closed0, n_ev0 = st.n_loops_closed, len(slam.events)
    # the revisit keyframes in the order of their events, as the live system
    # would have met the seam: the consistency streak builds from one to the
    # next, and the first closure ends the phase
    attempts = []
    with recorder or contextlib.nullcontext():
        for cur in revisit:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sync_watch(cuda) as caught:
                loop.probe = timer = EventTimer(cuda, caught)
                m2, out = loopctl.try_close_loop(m1, st, cfg, ts, loop, cur, slam.frame_id,
                                                 slam.cam, slam.ext, slam.noise, idx=idx)
                if cuda:
                    torch.cuda.synchronize()
            if out is not None:
                attempts.append(dict(cur=cur, cands=out.cands, sim3=out.sim3,
                                     verify=out.verify, diag=dict(loop.detector.last_diag)))
            if out is None or out.closed is not None:
                break
    loop.probe = None
    total_ms = (time.perf_counter() - t0) * 1e3
    if out is None:
        raise AssertionError("the loop gates are shut")
    slam.m = m2
    events = slam.events[n_ev0:]
    if out.sim3 is None or not any(c in old for c in out.sim3["cands"]):
        raise AssertionError(f"no older keyframe reached Sim3: {attempts}")
    if out.closed is None or st.n_loops_closed != n_closed0 + 1:
        raise AssertionError(f"no loop closed: {attempts}")
    cand = out.closed["cand"]
    ver = [v for v in out.verify if v["cand"] == cand][-1]
    if ver["n_guided"] < loopctl.MIN_GUIDED:
        raise AssertionError(f"guided matches {ver}")
    # the measured Sim3 (loop camera -> current camera) against the relative
    # camera pose of the two keyframes BEFORE the drift
    row = out.sim3["cands"].index(cand)
    res_ev = [e for e in events if e[1] == "sim3_result"][-1][2]
    Rbc = slam.ext.Rcb.T.cpu().numpy()
    pbc = -(Rbc @ slam.ext.tcb.cpu().numpy())
    Pb, Rb = before["P"].cpu().numpy(), before["R"].cpu().numpy()
    cam_pose = lambda k: (Rb[k] @ Rbc, Pb[k] + Rb[k] @ pbc)
    (Rc_cur, C_cur), (Rc_loop, C_loop) = cam_pose(cur), cam_pose(cand)
    R_exp, t_exp = Rc_cur.T @ Rc_loop, Rc_cur.T @ (C_loop - C_cur)
    meas = out.measured[cand]
    dt = float(np.linalg.norm(meas["t"] - t_exp))
    dr = _angle_deg(meas["R"].T @ R_exp)
    if not (dt < SEAM_SIM3_T_TOL and dr < SEAM_SIM3_R_TOL and abs(meas["s"] - 1.0) < 1e-6):
        raise AssertionError(f"measured Sim3 off the planted relative pose by {dt} m, {dr} "
                             f"degrees (s {meas['s']})")
    P_after = m2.kf_ns.P.cpu().numpy()
    back = float(np.linalg.norm(P_after[revisit] - Pb[revisit], axis=1).max())
    if back >= SEAM_POSE_TOL:
        raise AssertionError(f"revisit keyframes {back} m from where they stood before the "
                             f"drift of {moved} m")
    W2 = covisibility_matrix(m2).cpu().numpy()
    seam = float(W2[np.ix_(revisit, old)].max())
    if seam < 10:
        raise AssertionError(f"seam covisibility {seam}")
    curves = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
              for k, v in out.curves.items() if v is not None}
    for name, c in curves.items():
        c = c.reshape(len(c), -1)
        if not np.isfinite(c).all() or np.any(np.diff(c, axis=0) > 1e-6 * np.abs(c[:-1])):
            raise AssertionError(f"{name}: cost curve {c.T}")
    return dict(cur=cur, cand=cand, cands=out.cands, sim3=res_ev, verify=out.verify,
                closed=out.closed, diag=dict(loop.detector.last_diag), attempts=attempts,
                n_copied=before["n_copied"], drift_m=moved, sim3_dt_m=dt, sim3_dr_deg=dr,
                back_m=back, seam_covis=seam, total_ms=total_ms, stage_ms=timer.ms(),
                measured=meas,
                stage_syncs=timer.syncs(), m_planted=m1,
                costs={k: [float(np.ravel(v[0])[0]), float(np.ravel(v[-1])[0])]
                       for k, v in curves.items()})


def closure_args(slam, lp):
    """What the loop event of `run_loop_phase` handed to `close_loop`: (the
    verified Sim3 as a dict, the same as a body-frame Sim3Result, the active
    slots when the loop closed, the earlier loop edges)."""
    st, ext, dev = slam.st, slam.ext, slam.device
    cur, cand, meas = lp["cur"], lp["cand"], lp["measured"]
    cv = dict(c=cand, s=meas["s"], R=meas["R"], t=meas["t"], n_in=lp["closed"]["n_inliers"])
    s_c, R_c, t_c = loopctl._sim3_tensors(cv, dev)
    body = Sim3Result(True, *loopctl.body_sim3(ext, s_c, R_c, t_c), None, cv["n_in"])
    # the keyframes as they were when the loop closed (the closure added none)
    edges = [e for e in st.loop_edges if set(e[:2]) != {cur, cand}]
    return cv, body, list(st.kf_slots), edges


def loop_stage_replays(slam, lp):
    """The stages of the loop event that `run_loop_phase` closed, as closures
    that run each ALONE on the planted map (pure functions of the map; the
    host state is read, not changed), chained in the event's order:
    [(name, fn)]. For the kernel counts of chip_smoke.py and the stage table
    of tools/profile_event.py."""
    st, cfg, dev = slam.st, slam.cfg, slam.device
    cam, ext, loop = slam.cam, slam.ext, slam._loopctx
    m1, cur, cand = lp["m_planted"], lp["cur"], lp["cand"]
    cv, body, slots, edges = closure_args(slam, lp)
    cands = torch.as_tensor([cand] * loopctl.N_CAND, dtype=torch.int64, device=dev)
    bars = torch.as_tensor([loopctl.BAR_STREAKED] * loopctl.N_CAND, device=dev)
    grp = torch.as_tensor(loopctl.verify_group(st, cfg, loop, cand), dtype=torch.int64,
                          device=dev)
    s_c, R_c, t_c = loopctl._sim3_tensors(cv, dev)
    state = {}

    def posegraph():
        state["pg"] = loopclosing.close_loop(m1, slots, cur, cand, body, cam, fix_scale=True,
                                             loop_edges=edges, kf_ids=st.kf_id_host)
        return state["pg"]

    def fuse(key_in, key_out, n):
        def run():
            m = state[key_in]
            cur_side, loop_side, _ = loopctl.seam_sides(m, st, cfg, cur, cand)
            state[key_out] = loopctl.fuse_seam(m, loop_side, cur_side, n, cam, ext)
            return state[key_out]
        return run

    def gba():
        state["gba"] = mapping_ctl.local_ba(state["f1"], st, cfg, cam, ext, slam.gw, slam.noise,
                                            force_all=True, prune=False)[0]
        return state["gba"]

    return [
        ("detect (BoW scores of every keyframe + covisibility matrix)",
         lambda: loop.detector.detect_dispatch(m1, cur)),
        (f"sim3 batch ({loopctl.N_CAND} candidates: mutual match, 300 hypotheses, refit, "
         f"10 LM iterations)",
         lambda: loopclosing.sim3_ransac_batch(m1, None, cur, cands, bars, cam, ext=ext,
                                               fix_scale=True, generator=loop.generator)),
        ("verify (guided search of the whole map at 8 px)",
         lambda: loopclosing.guided_match_count(m1, cur, cand, grp, s_c, R_c, t_c, cam,
                                                ext=ext)),
        (f"pose graph ({len(slots)} keyframes, 40 LM iterations) + point correction",
         posegraph),
        ("fusion round 1 (3 x 3 keyframes, both ways, 4 px)", fuse("pg", "f1", 3)),
        ("whole-map BA (force_all, no prune)", gba),
        ("fusion round 2 (2 x 2 keyframes)", fuse("gba", "f2", 2)),
    ]


# ---------------------------------------------------------------------------
# The phases "mesh" and "checkpoint"
# ---------------------------------------------------------------------------

MESH_PERTURB = 0.03         # m, the seeded offsets that move path 4's map off its optimum
MESH_DP_TOL = 1.5e-3        # m, sharded against unsharded keyframe positions: ~10 x the
                            # largest gap an H100 has shown here (0.113 mm)
MESH_DCOST_TOL = 2e-5       # relative final cost, sharded against unsharded (~10 x 1.8e-6)
MESH_MOVE_MIN = 2.5e-2      # m, the least keyframe move of the unsharded BA (~17 x MESH_DP_TOL)
MESH_PG_TOL = 2e-3          # m, the sharded pose graph's keyframes (the loop event's parity)
CKPT_FRAMES = 5             # clone frames the resumed system tracks


def two_shard_mesh(device, axis="mp"):
    """A mesh of two shards on one device (how one card exercises the
    sharding: each shard's partial system, the one reduction, the local
    back-substitution)."""
    return dist_ba.make_mesh(axis=axis, devices=[device, device])


def _timed_ms(fn, cuda):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def perturbed_map(m, act, seed=0, scale=MESH_PERTURB):
    """`m` with every keyframe of `act` but the first (the whole-map BA's
    gauge) and every active landmark moved by a seeded normal draw of `scale`
    m a coordinate: the BA then has millimetres to centimetres to undo, where
    a converged map leaves it micrometres."""
    g = torch.Generator().manual_seed(seed)
    dev = m.mp_pos.device
    kf = torch.zeros(m.K, 1)
    kf[list(act)[1:]] = 1.0
    dP = (torch.randn(m.K, 3, generator=g) * scale * kf).to(dev)
    dX = (torch.randn(m.P, 3, generator=g) * scale).to(dev) * m.mp_active[:, None].to(dP.dtype)
    return m._replace(kf_ns=m.kf_ns._replace(P=m.kf_ns.P + dP), mp_pos=m.mp_pos + dX)


def spread_landmarks(m):
    """`m` with its active landmarks moved to slots spread evenly over the
    table (the j-th of n to slot j * P // n; the keyframes' `kf_mp` follow):
    the same map under other landmark ids. New landmarks take the lowest
    free slots, so a map that has not filled half its table keeps the upper
    half of the landmark range empty, and the whole-map BA's shards, which
    own equal ranges of the table, would leave all but the first with
    nothing to reduce."""
    act = m.mp_active.cpu().numpy()
    old = np.concatenate([np.nonzero(act)[0], np.nonzero(~act)[0]])
    n, P = int(act.sum()), m.P
    spots = (np.arange(n, dtype=np.int64) * P) // max(n, 1)
    rest = np.setdiff1d(np.arange(P), spots)
    new_of_old = np.empty(P, np.int64)
    new_of_old[old] = np.concatenate([spots, rest])
    dev = m.mp_pos.device
    inv = torch.as_tensor(np.argsort(new_of_old), device=dev)      # old slot of each new one
    remap = torch.as_tensor(new_of_old, dtype=torch.int32, device=dev)
    kf_mp = torch.where(m.kf_mp >= 0, remap[m.kf_mp.clamp(min=0).to(torch.int64)], m.kf_mp)
    return m._replace(kf_mp=kf_mp, **{f: getattr(m, f)[inv] for f in m._fields
                                      if f.startswith("mp_")})


def run_mesh_gba(slam, mesh):
    """Phase "mesh", the whole-map BA: the pipeline's landmark-chunked VI BA
    (`mapping_ctl.global_ba_chunked`, no prune) on the system's map with its
    landmarks spread over the shards (`spread_landmarks`) and moved off its
    optimum (`perturbed_map`), with the mesh set, as `enable_mesh` sets
    it (`dist_gba.vi_gba_chunked_sharded`), against the same call without it
    (`ba_chunked.vi_gba_chunked`), each warmed up once and then timed.
    Returns a dict; raises when they differ past MESH_DP_TOL in a keyframe
    position or MESH_DCOST_TOL in the final cost, when the unsharded BA moves
    no keyframe by MESH_MOVE_MIN (the comparison would not see a shard's
    missing share), a shard holds no landmark, or a cost curve rises."""
    cuda = slam.device.type == "cuda"
    act = list(slam.st.kf_slots)
    m0 = perturbed_map(spread_landmarks(slam.m), act)
    per_shard = [int(x) for x in m0.mp_active.reshape(mesh.size, -1).sum(1).cpu()]
    if min(per_shard) == 0:
        raise AssertionError(f"active landmarks per shard {per_shard}")
    out = {}
    for name, st in (("single", slam.st), ("sharded", dataclasses.replace(slam.st, mesh=mesh))):
        args = (m0, st, slam.cfg, slam.cam, slam.ext, slam.gw, slam.noise, act)
        fn = lambda: mapping_ctl.global_ba_chunked(*args, prune=False)
        fn()
        (m2, stats), ms = _timed_ms(fn, cuda)
        h = torch.cat([stats.costs, m2.kf_ns.P[act].reshape(-1)]).cpu().numpy()
        n_c = stats.costs.shape[0]
        if not np.isfinite(h[:n_c]).all() or np.any(np.diff(h[:n_c]) > 0):
            raise AssertionError(f"{name} whole-map BA: cost curve {h[:n_c]}")
        out[name] = dict(ms=ms, cost0=float(h[0]), cost=float(h[n_c - 1]),
                         P=h[n_c:].reshape(-1, 3), pts=m2.mp_pos)
    move = float(np.abs(out["single"]["P"] - m0.kf_ns.P[act].cpu().numpy()).max())
    dP = float(np.abs(out["sharded"]["P"] - out["single"]["P"]).max())
    act_pts = m0.mp_active
    dX = float((out["sharded"]["pts"] - out["single"]["pts"])[act_pts].abs().max())
    dcost = abs(out["sharded"]["cost"] - out["single"]["cost"]) / out["single"]["cost"]
    if not move >= MESH_MOVE_MIN:
        raise AssertionError(f"the unsharded whole-map BA moved the keyframes by {move} m only")
    if not (dP < MESH_DP_TOL and dcost < MESH_DCOST_TOL):
        raise AssertionError(f"sharded whole-map BA against unsharded: keyframe positions "
                             f"{dP} m, final costs {dcost}")
    strip = lambda d: {k: v for k, v in d.items() if k not in ("P", "pts")}
    return dict(n_kf=len(act), shards=mesh.size, shard_landmarks=per_shard, move_m=move, dP_m=dP, dX_m=dX,
                dcost_rel=dcost, single=strip(out["single"]), sharded=strip(out["sharded"]))


def run_mesh_posegraph(slam, lp, mesh_e):
    """Phase "mesh", the essential graph: the pose-graph correction of the
    loop phase's closure (`close_loop` on the planted map, as the event ran
    it) with the edge-sharded `dist_posegraph.optimize_pose_graph_dist`
    (`mesh=`) against `posegraph.optimize_pose_graph`. Returns a dict; raises
    when a keyframe differs by MESH_PG_TOL or more, or a cost curve rises."""
    cuda = slam.device.type == "cuda"
    cv, body, slots, edges = closure_args(slam, lp)
    out = {}
    for name, mesh in (("single", None), ("sharded", mesh_e)):
        (m2, costs), ms = _timed_ms(lambda: loopclosing.close_loop(
            lp["m_planted"], slots, lp["cur"], lp["cand"], body, slam.cam, fix_scale=True,
            loop_edges=edges, mesh=mesh, kf_ids=slam.st.kf_id_host, curve=True), cuda)
        c = costs.cpu().numpy()
        if not np.isfinite(c).all() or np.any(np.diff(c) > 1e-6 * np.abs(c[:-1])):
            raise AssertionError(f"{name} pose graph: cost curve {c}")
        out[name] = dict(ms=ms, cost0=float(c[0]), cost=float(c[-1]), P=m2.kf_ns.P[slots])
    dP = float((out["sharded"]["P"] - out["single"]["P"]).abs().max())
    if not dP < MESH_PG_TOL:
        raise AssertionError(f"sharded pose graph against unsharded: keyframes {dP} m apart")
    strip = lambda d: {k: v for k, v in d.items() if k != "P"}
    return dict(n_kf=len(slots), shards=mesh_e.size, dP_m=dP, single=strip(out["single"]),
                sharded=strip(out["sharded"]))


def _flat_map(m):
    out = {}
    for f, v in m._asdict().items():
        if isinstance(v, torch.Tensor):
            out[f] = v
        else:
            out.update({f"{f}.{g}": x for g, x in v._asdict().items()})
    return out


def resume_feed(st, rv, seq: Sequence, first: int, n_frames: int):
    """What a system resumed from a checkpoint of path 5's system is fed: the
    source frame of its newest keyframe (from `run_revisit`'s frames), the
    `n_frames` source frames from `first` on, their times (continuing the
    keyframe's clock) and IMU rows (the first frame's carry every row since
    that keyframe's frame: the frames in between are dropped, as a stream
    that resumes drops them). Returns (src_kf, srcs, times, rows)."""
    t_kf = st.kf_time_host[st.last_kf_slot]
    src_kf = next(f["src"] for f in rv["frames"]
                  if f["src"] is not None and abs(f["t"] - t_kf) < 1e-4)
    fdt = float(seq.times[1] - seq.times[0])
    srcs = list(range(first, first + n_frames))
    times = [t_kf + (i - src_kf) * fdt for i in srcs]
    rows = [np.concatenate([seq.imu[x] for x in range(src_kf + 1, i + 1)]) if j == 0
            else seq.imu[i] for j, i in enumerate(srcs)]
    return src_kf, srcs, times, rows


def run_checkpoint_phase(slam, seq: Sequence, rv, first: int, n_frames: int = CKPT_FRAMES,
                         keep_dir=None):
    """The phase "checkpoint" on the system path 5 left (loop edges, a broken
    IMU chain, histogram ids): `io.checkpoint.save_system` into a temporary
    directory, `load_system` into a fresh SlamSystem on the same device, every
    MapState table bit-equal and every host field equal, the trajectory
    unchanged; then the resumed system tracks the `n_frames` clone frames from
    `first` on (the frame after the replayed stretch). The load reseats tracking at the newest keyframe, so
    the first of them carries the IMU rows since that keyframe's frame (the
    frames in between are dropped, as a stream that resumes drops them).
    keep_dir: a directory to write the files into and leave them in (the
    phase "async" loads them), else a temporary one.
    Returns a dict; raises on any difference, a lost frame, no kernel launch,
    or an ATE over those frames of RELOC_POS_TOL or more."""
    dev = slam.device
    cuda = dev.type == "cuda"
    with (contextlib.nullcontext(keep_dir) if keep_dir is not None
          else tempfile.TemporaryDirectory()) as d:
        path = os.path.join(d, "slam.npz")
        _, save_ms = _timed_ms(lambda: checkpoint.save_system(path, slam), cuda)
        size = sum(os.path.getsize(path + ext) for ext in ("", ".bow.npz", ".traj.npz",
                                                           ".track.npz")
                   if os.path.exists(path + ext))
        new, new_ms = _timed_ms(lambda: system.SlamSystem(
            slam.cam, dataclasses.replace(slam.cfg), Tbc=TBC, device=dev), cuda)
        _, load_ms = _timed_ms(lambda: checkpoint.load_system(path, new), cuda)
    a, b = _flat_map(slam.m), _flat_map(new.m)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if bad:
        raise AssertionError(f"tables not bit-equal after the round trip: {bad}")
    st, st2 = slam.st, new.st
    fields = ("kf_slots", "last_kf_slot", "last_kf_frame", "n_kf", "vi_inited", "first_kf_time",
              "free_slots", "next_fresh_slot", "broken_chain_slots", "loop_edges",
              "n_loops_closed", "kf_id_host")
    bad = [f for f in fields if getattr(st, f) != getattr(st2, f)]
    bad += [f"kf_imu_raw[{k}]" for k in st.kf_imu_raw
            if k not in st2.kf_imu_raw or not torch.equal(st.kf_imu_raw[k], st2.kf_imu_raw[k])]
    if new.frame_id != slam.frame_id or new.state != slam.state:
        bad.append("frame_id / state")
    if new.loop.hist_ids != slam.loop.hist_ids or not torch.equal(new.loop.hists,
                                                                  slam.loop.hists):
        bad.append("loop detector")
    if not torch.equal(new.gw, slam.gw):
        bad.append("gw")
    tr_a, tr_b = slam.get_trajectory(), new.get_trajectory()
    if len(tr_a) != len(tr_b) or any(x[0] != y[0] or not np.array_equal(x[1], y[1])
                                     for x, y in zip(tr_a, tr_b)):
        bad.append("trajectory")
    if bad:
        raise AssertionError(f"host state differs after the round trip: {bad}")
    # the resumed system goes on from the newest keyframe's frame
    k = st2.last_kf_slot
    src_kf, srcs, times, rows = resume_feed(st2, rv, seq, first, n_frames)
    frame_ms, n_ok = [], 0
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    with vi_lm_watch() as vw:
        for j, i in enumerate(srcs):
            ok, ms = _timed_ms(lambda: new.track(seq.imgs[i], times[j], rows[j]), cuda)
            frame_ms.append(ms)
            n_ok += int(ok)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    tr = [x for x in new.get_trajectory() if x[0] >= times[0] - 1e-6]
    ate = ate_rmse(np.asarray([x[0] for x in tr]), np.asarray([x[1] for x in tr]),
                   np.asarray(times), seq.P[first:first + n_frames], with_scale=True)
    if n_ok != n_frames or new.n_lost_frames:
        raise AssertionError(f"the resumed system tracked {n_ok} of {n_frames} frames, "
                             f"{new.n_lost_frames} lost")
    if cuda and launches < 2 * n_frames:     # the CPU runs the twin: nothing launches
        raise AssertionError(f"kernel launched {launches} times for {n_frames} frames")
    check_vi_lm_launches("checkpoint", vw, cuda)
    if not ate["rmse"] < RELOC_POS_TOL:
        raise AssertionError(f"ATE over the resumed frames {ate}")
    return dict(path=path if keep_dir is not None else None, save_ms=save_ms, load_ms=load_ms,
                new_system_ms=new_ms, bytes=size,
                n_tables=len(a), kf_slots=len(st.kf_slots), loop_edges=list(st.loop_edges),
                broken_chain_slots=sorted(st.broken_chain_slots), free_slots=list(st.free_slots),
                n_hist_ids=len(slam.loop.hist_ids), traj_rows=len(tr_b), resume_kf=k,
                resume_src=src_kf, frames=srcs, n_tracked=n_ok, launches=launches,
                lm_launches=lm_launches, vi_lm_launches=vw["launches"], vi_frames=vw["frames"],
                frame_ms_median=float(np.median(frame_ms)), ate=ate,
                keyframes_after=new.n_kf - slam.n_kf)


ASYNC_FRAMES = 20           # clone frames each mode of the phase "async" tracks (40 took the
                            # script past 900 s on one host, 30 to 965 s)
ASYNC_PROFILE_FRAMES = 2    # the window after them that torch.profiler traces
ASYNC_LAG_MAX, ASYNC_PAIR = 12, 2   # mode B: the JAX package's defaults (mode A: 1, 1)
ASYNC_POS_TOL = 0.02        # m, B's positions against A's, frame by frame
ASYNC_MIN_PAIRS = ASYNC_FRAMES // 2   # pairs B must dispatch: every frame in a pair


def device_busy_ms(fn):
    """Run fn under torch.profiler (device activity only). Returns (fn's
    result, the wall ms of the call, the summed device ms of its kernels and
    copies, their count); the device ms is 0 on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ns, n = 0, 0
    # the raw kineto records: building prof.events() takes ~40 s per 300k kernels;
    # a StageTimer stage's shadow on the device is no kernel
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
            dev_ns += ev.duration_ns()
            n += 1
    return out, wall_ms, dev_ns / 1e6, n


def _feed(slam, seq: Sequence, srcs, times, rows, recorder=None, frame_ms=None):
    """track() on the frames, uploading frame j+1 before tracking frame j;
    then flush(). Returns the calls' results."""
    oks = []
    nxt = slam.upload(seq.imgs[srcs[0]])
    for j in range(len(srcs)):
        cur = nxt
        if j + 1 < len(srcs):
            nxt = slam.upload(seq.imgs[srcs[j + 1]])
        if recorder is not None:
            recorder.frame = j
        t0 = time.perf_counter()
        oks.append(slam.track(cur, times[j], rows[j]))
        if frame_ms is not None:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    slam.flush()
    return oks


def run_async_mode(path, cam, cfg, event_kw, seq: Sequence, srcs, times, rows, device,
                   lag_max: int, pair: int, recorder=None):
    """One mode of the phase "async": a fresh SlamSystem loads the checkpoint
    at `path`, takes LAG_MAX / PAIR, and tracks the frames (`_feed`: one
    frame of upload lookahead, flush() at the end), the matcher's launches
    counted from 0. Returns (a dict of what it measured, the system)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    slam = system.SlamSystem(cam, dataclasses.replace(cfg), Tbc=TBC, device=dev)
    checkpoint.load_system(path, slam)
    slam.event_kw = dict(event_kw)
    slam.LAG_MAX, slam.PAIR = lag_max, pair
    n_kf0, frame_ms = slam.n_kf, []
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    with recorder or contextlib.nullcontext():
        with sync_watch(cuda) as caught, vi_lm_watch() as vw:
            t0 = time.perf_counter()
            oks = _feed(slam, seq, srcs, times, rows, recorder, frame_ms)
            sync()
            wall = time.perf_counter() - t0
            n_sync = count_syncs(caught)
    check_vi_lm_launches(f"async {lag_max}/{pair}", vw, cuda)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 if cuda else float("nan")
    fl, n = slam.fl, len(srcs)
    traj = [x for x in slam.get_trajectory() if x[0] >= times[0] - 1e-6]
    ate = ate_rmse(np.asarray([x[0] for x in traj]), np.asarray([x[1] for x in traj]),
                   np.asarray(times), seq.P[srcs[0]:srcs[-1] + 1], with_scale=True)
    smp = slam.timers.samples
    pulls = {k: dict(n=len(smp.get(k, [])), ms=1e3 * float(np.sum(smp.get(k, [0.0]))))
             for k in ("harvest_pull", "harvest_pull_block")}
    out = dict(lag_max=lag_max, pair=pair, frames=n, tracked=int(sum(oks)),
               frame_ms_median=float(np.median(frame_ms)),
               frame_ms_p90=float(np.percentile(frame_ms, 90)), wall_s=wall, fps=n / wall,
               launches=launches, launches_per_frame=launches / n, lm_launches=lm_launches,
               vi_lm_launches=vw["launches"], vi_frames=vw["frames"],
               syncs_per_frame=n_sync / n,
               pulls=pulls, max_depth=fl.max_depth, dispatched=dict(fl.n_dispatched),
               ev_chain_drain_ms=[1e3 * x for x in smp.get("ev_chain_drain", [])],
               keyframes=slam.n_kf - n_kf0, events_deferred=fl.n_events_deferred,
               events_forced=fl.n_events_forced, lost=slam.n_lost_frames,
               pending_after_flush=len(fl.pendings), rows=len(traj), ate=ate,
               peak_device_MiB=peak_mb,
               pos={round(float(t), 6): np.asarray(P) for t, P, _ in traj},
               last_src=srcs[-1], last_t=times[-1])
    return out, slam


TRANSITION_PAIRS = 2 * ASYNC_LAG_MAX    # pairs the transition feeds after the bias window


def run_transition(path, cam, cfg, event_kw, seq: Sequence, srcs, times, rows, src_reloc: int,
                   device, lag_max: int = ASYNC_LAG_MAX, pair: int = ASYNC_PAIR,
                   n_pairs: int = TRANSITION_PAIRS):
    """The phase "async"'s transition out of the frame loop and back: the
    checkpoint at `path` loaded into a fresh system at LAG_MAX / PAIR whose
    summaries are never ready (each entry harvested at the depth limit, as
    the JAX package's TPU runs harvested; the rule set on this instance, as
    the README's command line sets it); a blank frame, then the clone frames
    `srcs` (times, rows) up to the call that harvests the blank's pair: LOST
    there, and that call's frame is source frame `src_reloc`, the next ones
    its successors until one relocalizes (at most RELOC_MAX_FRAMES); the bias
    window's frames after it, then `n_pairs` pairs back in the loop; flush().
    Every search is recorded and held against the twin after the run
    (`twin_check`), the kernel's launches counted from 0. Returns (dict,
    system); raises on the gates: the blank's pair lost at its harvest,
    exactly one "lost" event and one "reloc" event, the bias window closed
    by a keyframe, a keyframe decided at harvest after it, no frame lost and
    nothing pending after the loss."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    slam = system.SlamSystem(cam, dataclasses.replace(cfg), Tbc=TBC, device=dev)
    checkpoint.load_system(path, slam)
    slam.event_kw = dict(event_kw)
    slam.LAG_MAX, slam.PAIR = lag_max, pair
    slam._summary_ready = lambda p: False
    n_ev0 = len(slam.events)
    fdt = float(seq.times[1] - seq.times[0])
    blank = np.full_like(seq.imgs[srcs[0]], 40)
    rec = probes.search_recorder(keep_frames=None)
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.perf_counter()
    with vi_lm_watch() as vw, rec:
        fid_blank, j = slam.frame_id, 0
        while not (slam.fl.pendings
                   and slam.fl.pendings[0].frames[0]["frame_id"] == fid_blank
                   and len(slam.fl.pendings) >= slam.LAG_MAX):
            slam.track(blank if j == 0 else seq.imgs[srcs[j]], times[j], rows[j])
            j += 1
        n_before, t = j, times[j - 1]
        k, i_reloc, n_after = 0, None, slam.reloc_window + pair * n_pairs
        while i_reloc is None or k <= i_reloc + n_after:
            t += fdt
            slam.track(seq.imgs[src_reloc + k], t, seq.imu[src_reloc + k])
            if i_reloc is None and slam.reloc_buf is not None:
                i_reloc, lost_after = k, slam.n_lost_frames
            elif i_reloc is None and k + 1 >= RELOC_MAX_FRAMES:
                raise AssertionError(f"transition: no relocalization within "
                                     f"{RELOC_MAX_FRAMES} frames from source frame "
                                     f"{src_reloc}")
            k += 1
        slam.flush()
        if cuda:
            torch.cuda.synchronize()
    check_vi_lm_launches("transition", vw, cuda)
    wall = time.perf_counter() - t0
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    twin_max_err, twin_checked = _real_search_check(rec)
    ev = [e for e in slam.events[n_ev0:] if e[1] != "kf_culled"]
    # the loss of the blank's pair (not the failed relocalization attempts after it)
    lost = [e for e in ev if e[1] == "lost" and e[2].get("mode") != "lost"]
    reloc = [e for e in ev if e[1] == "reloc"]
    ids = sorted(slam.st.kf_id_host[s] for s in slam.st.kf_slots)
    closing = reloc[0][0] + slam.reloc_window if len(reloc) == 1 else None
    out = dict(frames_before=n_before, reloc_attempts=i_reloc + 1, frames_after=k,
               lost_events=len(lost), lost_mode=lost[0][2].get("mode") if lost else None,
               lost_frames=slam.n_lost_frames, lost_after_reloc=slam.n_lost_frames - lost_after,
               reloc=reloc[0][2] if reloc else None, reloc_frame=reloc[0][0] if reloc else None,
               closing_kf=closing, closing_is_kf=closing in ids,
               kf_after=[f for f in ids if closing is not None and f > closing],
               epoch=slam.fl.map_epoch, pending_after_flush=len(slam.fl.pendings),
               dispatched=dict(slam.fl.n_dispatched), launches=launches,
               lm_launches=lm_launches, vi_lm_launches=vw["launches"], vi_frames=vw["frames"],
               twin_checked=twin_checked, twin_max_err=twin_max_err, wall_s=wall)
    if len(lost) != 1 or out["lost_mode"] != "vi2" or len(reloc) != 1:
        raise AssertionError(f"transition: {len(lost)} lost events ({out['lost_mode']}), "
                             f"{len(reloc)} relocalizations: {[e[:2] for e in ev]}")
    if not out["closing_is_kf"] or not out["kf_after"]:
        raise AssertionError(f"transition: keyframes {ids}; the window closes at {closing}")
    if out["lost_after_reloc"] or out["pending_after_flush"] or slam.state != OK:
        raise AssertionError(f"transition: {out['lost_after_reloc']} frames lost after the "
                             f"relocalization, {out['pending_after_flush']} pending, state "
                             f"{slam.state}")
    if rec.n == 0 or (cuda and rec.n != launches):
        raise AssertionError(f"transition: {launches} launches, {rec.n} held to the twin")
    return out, slam


def profile_async_mode(slam, r, seq: Sequence, n_profile: int = ASYNC_PROFILE_FRAMES):
    """The device-busy share of a system of the phase "async" over the next
    `n_profile` clone frames after its timed run (`r`, its dict, gets the
    numbers), under torch.profiler. The profiler slows the launches of what
    runs after it in the process, so the script runs this last."""
    first = r["last_src"] + 1
    src2 = list(range(first, min(first + n_profile, len(seq.imgs))))
    fdt = float(seq.times[1] - seq.times[0])
    times2 = [r["last_t"] + (k + 1) * fdt for k in range(len(src2))]
    _, wall_ms, dev_ms, n_dev = device_busy_ms(
        lambda: _feed(slam, seq, src2, times2, [seq.imu[i] for i in src2]))
    r.update(profile_frames=len(src2), profile_wall_ms=wall_ms, profile_device_ms=dev_ms,
             profile_device_events=n_dev, device_busy_share=dev_ms / wall_ms)
    return r


def run_async_phase(path, slam, rv, seq: Sequence, first: int, n_frames: int = ASYNC_FRAMES):
    """The phase "async": the checkpoint at `path` (of path 5's system `slam`,
    whose camera, configuration, event sizes and device it takes; `rv` what
    `run_revisit` returned) loaded into two fresh systems, which track the
    same `n_frames` clone frames from `first` on: A in the synchronous mode
    (LAG_MAX = PAIR = 1), B in the frame loop with the JAX package's defaults
    (LAG_MAX 12, PAIR 2). Returns ((A's dict, A), (B's dict, B), the
    recorder of B's first pair's searches); raises on the gates: a lost
    frame, an ATE of RELOC_POS_TOL or more, B without a trajectory row for
    each frame or with an entry pending after flush(), fewer than
    ASYNC_MIN_PAIRS pairs or no event harvested after its copy landed, a
    position of B more than ASYNC_POS_TOL from A's."""
    _, srcs, times, rows = resume_feed(slam.st, rv, seq, first, n_frames)
    args = (path, slam.cam, slam.cfg, slam.event_kw, seq, srcs, times, rows, slam.device)
    a, sys_a = run_async_mode(*args, 1, 1)
    rec = probes.search_recorder(keep_frames={1})   # B's first pair goes out at frame 1
    b, sys_b = run_async_mode(*args, ASYNC_LAG_MAX, ASYNC_PAIR, recorder=rec)
    dpos = [float(np.linalg.norm(b["pos"][k] - a["pos"][k])) for k in a["pos"]
            if k in b["pos"]]
    a["dpos_max_m"] = b["dpos_max_m"] = max(dpos) if dpos else float("inf")
    for name, r in (("A", a), ("B", b)):
        if r["lost"] or r["tracked"] != n_frames:
            raise AssertionError(f"mode {name}: {r['lost']} frames lost, {r['tracked']} of "
                                 f"{n_frames} tracked")
        if not r["ate"]["rmse"] < RELOC_POS_TOL:
            raise AssertionError(f"mode {name}: ATE {r['ate']}")
    if b["rows"] != n_frames or b["pending_after_flush"]:
        raise AssertionError(f"mode B: {b['rows']} trajectory rows for {n_frames} frames, "
                             f"{b['pending_after_flush']} entries pending after flush()")
    if b["dispatched"]["vi2"] < ASYNC_MIN_PAIRS or b["events_deferred"] < 1:
        raise AssertionError(f"mode B: {b['dispatched']} dispatched, "
                             f"{b['events_deferred']} events harvested deferred")
    if len(dpos) != n_frames or max(dpos) >= ASYNC_POS_TOL:
        raise AssertionError(f"mode B against mode A: {len(dpos)} frames compared, "
                             f"positions up to {max(dpos, default=float('inf'))} m apart")
    return (a, sys_a), (b, sys_b), rec


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

    def spy_need(m, st, cfg, fid, n_in, *a):
        before = dict(last_kf_frame=st.last_kf_frame, ref_tracked=st.ref_tracked,
                      kf_slots=list(st.kf_slots), last_kf_slot=st.last_kf_slot)
        out = orig[2](m, st, cfg, fid, n_in, *a)
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
    check_ba_curves(res, whole_curves=False)
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


# ---------------------------------------------------------------------------
# The phase "evict": capacity eviction of keyframes and points
# ---------------------------------------------------------------------------

# examples/eval_clone.py's "small" profile (752x480, 512 features, 3 levels,
# window 8) with its tables cut so that both fill within 160 frames (its own
# 64 / 4096 fill only over a whole run), VI init at 5 s. A trial of cuts on
# the card (10 or 11 keyframes with 1024 points, 12 with 1536) evicted 3-5
# keyframes but no point: the orphan sweep above 90 % holds those tables
# under the 95 % at which point eviction starts; 768 points reach it (at
# frames 96, 101 and 120). 40 VI frames (60 until the script took 1237 s on
# a slow host) keep 2-3 of the 4 keyframe evictions that 60 gave (on the CPU
# at the events of frames 104, 119, 139 and 159) and the phase near 1.5
# minutes
EVICT = dataclasses.replace(EUROC, n_feat=512, n_levels=3, local_window=8, max_kf=10,
                            max_mp=768, vi_init_time=5.0, boot_max_frame=160,
                            n_vi_frames=28)
EVICT_MIN_KF = 2            # keyframes evicted at capacity through the allocator, at least
EVICT_MIN_KF_VI = 1         # ... of them after VI init (the IMU chain spliced)
EVICT_MIN_MP = 1            # point-eviction passes that deactivated a point, at least


def check_cost_curve(name, costs):
    """A BA's cost curve is not empty, finite and never rises; raises
    otherwise."""
    c = np.asarray(costs, np.float64)
    if not c.size or not np.isfinite(c).all() or np.any(np.diff(c) > 0):
        raise AssertionError(f"{name}: BA cost curve not finite and non-increasing "
                             f"{c.tolist()}")


def check_ba_curves(res, whole_curves=True):
    """Every BA of a bootstrap run (the two-view BA, each event's window BA,
    each whole-map BA of a VI-init attempt) ends at a finite cost no higher
    than its first, with whole_curves every point of an event's cost curve
    too, and no event dropped a landmark past Pw (F2). Raises on the first
    that fails."""
    bas = [("two-view BA", res["init"]["ba"])]
    bas += [(f"event at frame {e['frame']}", e) for e in res["events"]]
    for a in res["attempts"]:
        bas.append((f"whole-map visual BA at frame {a['frame']}", a["ba_visual"]))
        if "ba_vi" in a:
            bas.append((f"whole-map VI BA at frame {a['frame']}", a["ba_vi"]))
    for name, b in bas:
        if not (np.isfinite(b["cost0"]) and np.isfinite(b["cost"])) or b["cost"] > b["cost0"]:
            raise AssertionError(f"{name}: BA cost {b['cost0']} -> {b['cost']}")
        if whole_curves and len(b.get("costs", [])):
            check_cost_curve(name, b["costs"])
    for e in res["events"]:
        if e["overflow"] != 0:
            raise AssertionError(f"event at frame {e['frame']}: {e['overflow']} "
                                 f"landmarks past Pw were dropped from the window BA")


def check_evict(res, watch, seq: Sequence, p: Profile, min_kf=EVICT_MIN_KF,
                min_kf_vi=EVICT_MIN_KF_VI, min_mp=EVICT_MIN_MP):
    """The phase "evict"'s checks on a `run_bootstrap` result and the
    `eviction_watch` record; raises on the first that fails. Returns the
    measured values."""
    slam = res["slam"]
    kf, mp = watch["kf"], watch["mp"]
    n_kf_vi = sum(e["vi"] for e in kf)
    passes = [e for e in mp if e["evicted"] > 0]
    if len(kf) < min_kf or n_kf_vi < min_kf_vi:
        raise AssertionError(f"{len(kf)} keyframes evicted at capacity ({n_kf_vi} after VI "
                             f"init); at least {min_kf} ({min_kf_vi}) wanted")
    if len(passes) < min_mp:
        raise AssertionError(f"{len(passes)} point-eviction passes deactivated a point; at "
                             f"least {min_mp} wanted")
    most = max([e["n_active"] for e in kf] + [len(slam.kf_slots)])
    n_act = int(slam.m.kf_active.sum())
    if most > p.max_kf or n_act != len(slam.kf_slots):
        raise AssertionError(f"keyframe table over capacity: {most} active of {p.max_kf} "
                             f"({n_act} flagged active, {len(slam.kf_slots)} listed)")
    if slam.n_lost_frames:
        raise AssertionError(f"{slam.n_lost_frames} frames lost")
    check_ba_curves(res)
    t_est = np.asarray([x[0] for x in res["traj"]])
    P_est = np.asarray([x[1] for x in res["traj"]])
    post = t_est > seq.times[res["i_accept"]] - 1e-6
    stats = ate_rmse(t_est[post], P_est[post], seq.times, seq.P, with_scale=True)
    if not stats["rmse"] < ATE_LIMIT_BOOT:
        raise AssertionError(f"post-init ATE {stats}")
    return dict(kf_evicted=len(kf), kf_evicted_after_vi=n_kf_vi, mp_passes=len(passes),
                mp_evicted=sum(e["evicted"] for e in passes), most_active_kf=most,
                ate_post_m=stats["rmse"], scale_post=stats["scale"], n_post=stats["n"])


def run_evict(seq: Sequence, p: Profile, cam, device, recorder=None):
    """The phase "evict"'s run: `run_bootstrap` at the sizes of `p` under
    `eviction_watch`. Returns (run_bootstrap's dict, the watch record)."""
    with eviction_watch() as watch:
        res = run_bootstrap(seq, p, cam, device, recorder=recorder)
    return res, watch


# ---------------------------------------------------------------------------
# Paths 6 and 7: the depth sensors (RGB-D, rectified stereo + IMU)
# ---------------------------------------------------------------------------

DEPTH_FRAMES = 60           # clone frames of path 6
STEREO_FRAMES = 125         # right images path 7 renders at once (its run took 122 frames)
ATE_LIMIT_RGBD = 0.02       # m, path 6
SCALE_TOL_RGBD = 0.05       # path 6: tests/test_e2e_depth.py::test_rgbd_mode_metric's gate
SCALE_TOL_STEREO = 0.2      # path 7: tests/test_e2e_depth.py::test_stereo_mode_metric's gate
STEREO_VI_FRAMES = 20       # path 7: VI frames after the accepted VI initialization, at least
STEREO_VI_MAX = 60          # ... and at most, while no XYZ window VI BA has run yet


def depth_config(p: Profile, use_imu: bool):
    """The euroc profile at the sizes of `p` for a depth sensor: cull_min_obs 2
    (the reference's nThObs for stereo / RGB-D), the IMU on or off."""
    return dataclasses.replace(slam_config(p), use_imu=use_imu, cull_min_obs=2)


def render_right(seq: Sequence, p: Profile, frames, seed: int = 0):
    """Right images of a rectified stereo rig on the clone: the left camera
    (world-from-camera Rwc = R Rbc at Cw = P + R pbc) moved by
    SlamConfig.stereo_baseline along its own x axis, rendered by the same
    RoomWorld (as tests/render.py's render_stereo does for the dot world).
    Returns {frame: (H, W) uint8}. The frames render one after another:
    the renderer's products go through numpy's OpenBLAS, whose thread pool
    gives wrong rows when several threads call it at once (on 8 threads, 1
    or 2 of 32 frames came out with patches of wrong pixels)."""
    cam = profile_camera(p, "cpu")
    world = RoomWorld(np.random.default_rng(seed), tex_size=p.tex_size, tex_scale=1.0)
    Rbc, pbc = TBC[:3, :3], TBC[:3, 3]
    b = system.SlamConfig().stereo_baseline

    def one(i):
        Rwc = seq.R[i] @ Rbc
        return world.render(cam, Rwc, seq.P[i] + seq.R[i] @ pbc + Rwc @ np.array([b, 0.0, 0.0]))

    return {i: one(i) for i in frames}


@contextlib.contextmanager
def window_ba_probe():
    """While active, record every XYZ BA call of the keyframe events and the
    whole-map BAs: (solver, window or whole map, VI initialized, the count of
    valid u_right rows as a device tensor, read after the run)."""
    from mc_slam_tpu_torch.solver import ba as tba
    calls = []
    orig = (tba.visual_ba, ba_vi.vi_ba)

    def spy(name, fn):
        def wrapped(*a, **k):
            obs = a[3] if name == "visual_ba" else a[2]
            n_ur = (None if obs.ur is None
                    else torch.sum((obs.ur >= 0) & (obs.valid > 0)))
            if not k.get("fix_points", False):
                calls.append(dict(solver=name, window=k.get("two_phase", True), n_ur=n_ur))
            return fn(*a, **k)
        return wrapped

    tba.visual_ba, ba_vi.vi_ba = spy("visual_ba", orig[0]), spy("vi_ba", orig[1])
    try:
        yield calls
    finally:
        tba.visual_ba, ba_vi.vi_ba = orig


def run_depth(seq: Sequence, p: Profile, cam, device, right=None, recorder=None):
    """Paths 6 and 7 through the port's entry point. RGB-D (right is None):
    `track(img, t, depth=)` on the first DEPTH_FRAMES frames, the IMU off.
    Stereo (right: frame -> right image, or a callable): `track(img, t, imu,
    img_right=)` with the IMU and VI init at p.vi_init_time, until
    STEREO_VI_FRAMES frames after the accepted VI initialization (deadline
    p.boot_max_frame) and an event with the XYZ window VI BA (at most
    STEREO_VI_MAX VI frames). Loop closing on, as by default. Nothing comes from
    ground truth: the map starts from the first frame's depth.
    Returns a dict: per-frame records, event and VI-attempt records, the BA
    calls of `window_ba_probe`, the trajectory, the system. Raises when a
    frame is LOST or the VI deadline passes."""
    cuda = torch.device(device).type == "cuda"
    stereo = right is not None
    slam = system.SlamSystem(cam, depth_config(p, use_imu=stereo), Tbc=TBC, device=device)
    slam.event_kw = dict(max_new=p.max_new, ba_Pw=p.ba_Pw)
    st = slam.st
    get_right = right if callable(right) else (lambda i: right[i])
    frames, events, attempts = [], [], []
    n_vi, i_accept, i = 0, None, -1
    with recorder or contextlib.nullcontext():
        with window_ba_probe() as ba_calls:
            xyz_vi = lambda: any(c["window"] and c["solver"] == "vi_ba" for c in ba_calls)
            while ((n_vi < STEREO_VI_FRAMES or (not xyz_vi() and n_vi < STEREO_VI_MAX))
                   if stereo else i + 1 < p.n_frames):
                i += 1
                if stereo and i_accept is None and i > p.boot_max_frame:
                    raise AssertionError(f"VI initialization not accepted by frame "
                                         f"{p.boot_max_frame}; attempts: {attempts}")
                if recorder is not None:
                    recorder.frame = i
                    if stereo and (i == 1 or (st.vi_inited and n_vi == 0)):
                        recorder.keep_frames.add(i)     # the first frame, the first VI frame
                kw = dict(img_right=get_right(i)) if stereo else dict(depth=seq.depths[i])
                was_vi = st.vi_inited
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                with sync_watch(cuda) as caught:
                    slam.event_probe = ev_timer = EventTimer(cuda, caught)
                    slam.vi_probe = vi_timer = EventTimer(cuda, caught)
                    ok = slam.track(seq.imgs[i], float(seq.times[i]),
                                    seq.imu[i] if stereo else None, **kw)
                    if cuda:
                        torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if not ok:
                    raise AssertionError(f"frame {i} not tracked (state {slam.state}; events "
                                         f"{slam.events[-3:]})")
                out = slam.last_outcome
                n_vi += was_vi
                attempted = out is not None and out.vi is not None and out.vi.attempted
                frames.append(dict(frame=i, vi=was_vi, n_inliers=out.n_inliers if out else 0,
                                   ms=ms, syncs=count_syncs(caught),
                                   plain=out is not None and out.keyframe is None
                                   and not attempted))
                if out is not None and out.event is not None:
                    e = _event_record(i, out.keyframe, out.event, ev_timer)
                    e["vi"] = was_vi
                    events.append(e)
                if attempted:
                    v = out.vi
                    vms = vi_timer.ms()
                    a = dict(frame=i, t=float(seq.times[i]), n_kf=v.n_kf, scale=v.scale,
                             accepted=v.accepted, reason=v.reason, ms=sum(vms.values()),
                             ba_visual=_ba_record(v.ba_visual, vms.get("gba_visual")))
                    if v.accepted:
                        a["ba_vi"] = _ba_record(v.ba_vi, vms.get("gba_vi"))
                        i_accept = i
                    attempts.append(a)
    slam.event_probe = slam.vi_probe = None
    for c in ba_calls:
        c["n_ur"] = None if c["n_ur"] is None else int(c["n_ur"])
    return dict(frames=frames, events=events, attempts=attempts, ba_calls=ba_calls,
                i_accept=i_accept, last_frame=i, traj=slam.get_trajectory(), slam=slam,
                init=slam.events[0])


def check_depth(res, seq: Sequence, stereo: bool):
    """Paths 6 and 7's gates; raises on the first that fails. Returns the
    measured values."""
    slam = res["slam"]
    fid, kind, detail = res["init"]
    if (fid, kind) != (0, "init") or detail["n_points"] < 50:
        raise AssertionError(f"not initialized from depth at frame 0: {res['init']}")
    if slam.n_lost_frames or len(res["traj"]) != len(res["frames"]):
        raise AssertionError(f"{slam.n_lost_frames} frames lost; {len(res['traj'])} trajectory "
                             f"rows for {len(res['frames'])} frames")
    bas = [(f"event at frame {e['frame']}", e) for e in res["events"]]
    for a in res["attempts"]:
        bas.append((f"whole-map visual BA at frame {a['frame']}", a["ba_visual"]))
        if "ba_vi" in a:
            bas.append((f"whole-map VI BA at frame {a['frame']}", a["ba_vi"]))
    for name, b in bas:
        if not (np.isfinite(b["cost0"]) and np.isfinite(b["cost"])) or b["cost"] > b["cost0"]:
            raise AssertionError(f"{name}: BA cost {b['cost0']} -> {b['cost']}")
    for e in res["events"]:
        if e["overflow"] != 0:
            raise AssertionError(f"event at frame {e['frame']}: landmark overflow {e['overflow']}")
    windows = [c for c in res["ba_calls"] if c["window"]]
    if not windows or any(not c["n_ur"] for c in windows):
        raise AssertionError(f"a window BA without u_right rows: {windows}")
    xyz_vi = [c for c in windows if c["solver"] == "vi_ba"]
    if stereo:
        if res["i_accept"] is None:
            raise AssertionError("VI initialization not accepted")
        if not xyz_vi:
            raise AssertionError("no XYZ window VI BA ran after VI init")
    t_est = np.asarray([x[0] for x in res["traj"]])
    P_est = np.asarray([x[1] for x in res["traj"]])
    stats = ate_rmse(t_est, P_est, seq.times, seq.P, with_scale=True)
    tol = SCALE_TOL_STEREO if stereo else SCALE_TOL_RGBD
    if not abs(stats["scale"] - 1.0) < tol:
        raise AssertionError(f"alignment scale {stats['scale']} (not within {tol} of 1)")
    if not stereo and not stats["rmse"] < ATE_LIMIT_RGBD:
        raise AssertionError(f"ATE {stats['rmse']} m (limit {ATE_LIMIT_RGBD} m)")
    return dict(ate_m=stats["rmse"], scale=stats["scale"], n=stats["n"],
                n_window_ba=len(windows), n_xyz_vi_window_ba=len(xyz_vi),
                min_ur_rows=min(c["n_ur"] for c in windows))


def evict_phase(seq: Sequence, cam, dev, p: Profile = EVICT, check=True):
    """The phase "evict" on the card: a new `SlamSystem` at `p` (`run_evict`)
    from raw clone frames, with its report lines and `check_evict` (skipped
    with check=False, for trying other cuts). Returns (detail dict, kernel
    launches of the run, max kernel-vs-twin error on the recorded searches)."""
    full = PROFILE_CONFIG["small"]
    _phase("evict", f"examples/eval_clone.py's small profile ({p.width}x{p.height}, "
                    f"{p.n_feat} features, {p.n_levels} levels, window {p.local_window}) with "
                    f"its tables cut: max_kf {full['max_kf']} -> {p.max_kf}, max_mp "
                    f"{full['max_mp']} -> {p.max_mp}; VI init at {p.vi_init_time:g} s, "
                    f"{p.n_vi_frames} VI frames after it")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = probes.search_recorder(keep_frames={110, 120, 130})
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    with vi_lm_watch() as vw:
        res, watch = run_evict(seq, p, cam, dev, recorder=rec)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    wall = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    slam = res["slam"]
    for e in watch["kf"]:
        _phase("evict", f"keyframe slot {e['slot']} (frame {e['kf_frame']}) evicted at capacity "
                        f"{'after' if e['vi'] else 'before'} VI init; {e['n_active']} of "
                        f"{e['K']} active after the new keyframe")
    for e in watch["mp"]:
        if e["evicted"]:
            _phase("evict", f"event at frame {e['kf_frame']}: point eviction {e['before']} -> "
                            f"{e['after']} active of {e['P']} ({e['evicted']} evicted)")
    fr = res["frames"]
    vi_ms = [f["ms"] for f in fr if f["vi"] and f["plain"]]
    vis_ms = [f["ms"] for f in fr if not f["vi"] and f["plain"]]
    ev_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] + e["cull_ms"] for e in res["events"]]
    n_pass = sum(e["evicted"] > 0 for e in watch["mp"])
    _phase("evict", f"{len(fr)} frames through SlamSystem.track in {wall:.1f} s: VI init "
                    f"accepted at frame {res['i_accept']}, {slam.n_kf} keyframes inserted, "
                    f"{res['n_culled_kf']} culled, {len(watch['kf'])} evicted at capacity "
                    f"({sum(e['vi'] for e in watch['kf'])} after VI init), {len(slam.kf_slots)} "
                    f"active; {n_pass} of {len(watch['mp'])} event maintenances evicted points; "
                    f"lost frames {slam.n_lost_frames}; launches {launches}; ms/frame visual "
                    f"median {np.median(vis_ms):.1f}, VI median "
                    f"{np.median(vi_ms) if vi_ms else float('nan'):.1f}; ms/event median "
                    f"{np.median(ev_ms):.1f}; peak device memory {peak_mb:.0f} MiB")
    detail = {"profile": {k: getattr(p, k) for k in ("n_feat", "n_levels", "local_window",
                                                     "max_kf", "max_mp", "vi_init_time",
                                                     "n_vi_frames")},
              "frames": len(fr), "launches": launches, "lm_launches": lm_launches,
              "vi_lm_launches": vw["launches"], "vi_frames": vw["frames"],
              "accepted_at_frame": res["i_accept"],
              "kf_evictions": watch["kf"], "mp_evictions": watch["mp"],
              "keyframes_inserted": slam.n_kf, "keyframes_culled": res["n_culled_kf"],
              "lost_frames": slam.n_lost_frames, "frame_ms_vi_median":
              float(np.median(vi_ms)) if vi_ms else None, "event_ms_median":
              float(np.median(ev_ms)), "peak_device_MiB": peak_mb, "seconds": wall}
    err = 0
    if check:
        check_lm_launches("evict", lm_launches, sum(not f["vi"] for f in fr))
        check_vi_lm_launches("evict", vw, True)
        measured = check_evict(res, watch, seq, p)
        detail["measured"] = measured
        err, n_real = _real_search_check(rec)
        _phase("evict", f"checks passed: {measured['kf_evicted']} keyframes evicted (>= "
                        f"{EVICT_MIN_KF}, {measured['kf_evicted_after_vi']} after VI init, >= "
                        f"{EVICT_MIN_KF_VI}), {measured['mp_passes']} point-eviction passes "
                        f"({measured['mp_evicted']} points; >= {EVICT_MIN_MP}), at most "
                        f"{measured['most_active_kf']} of {p.max_kf} keyframes active, 0 lost, "
                        f"BA curves non-increasing with overflow 0; post-init ATE "
                        f"{measured['ate_post_m'] * 1e3:.2f} mm over {measured['n_post']} frames "
                        f"(< {ATE_LIMIT_BOOT * 1e3:.0f}), alignment scale "
                        f"{measured['scale_post']:.4f}; kernel == twin on the {n_real} real "
                        f"searches (N = {p.n_feat})")
    return detail, launches, err


def depth_phase(name, seq: Sequence, p: Profile, cam, dev, right=None):
    """One run of `run_depth` on the card with its report lines and checks
    (paths 6 and 7). Returns (detail dict, kernel launches of the run, max
    kernel-vs-twin error on the recorded searches)."""
    stereo = right is not None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = probes.search_recorder(
        keep_frames=() if stereo else {1, p.n_frames // 2, p.n_frames - 1})
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    with vi_lm_watch(keep=VI_LM_CHECK_SOLVES if stereo else 0) as vw:
        res = run_depth(seq, p, cam, dev, right=right, recorder=rec)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    wall = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for e in res["events"]:
        _phase("event", ("VI " if e["vi"] else "visual ") + event_line(e))
    for a in res["attempts"]:
        _phase("vi-init", f"frame {a['frame']} t {a['t']:.2f} s, {a['n_kf']} keyframes: scale "
                          f"{a['scale']:.4f} -> {a['reason']}; {a['ms']:.0f} ms")
    measured = check_depth(res, seq, stereo)
    slam = res["slam"]
    fr = res["frames"]
    vis_ms = [f["ms"] for f in fr if not f["vi"] and f["plain"]]
    vi_ms = [f["ms"] for f in fr if f["vi"] and f["plain"]]
    ev_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] + e["cull_ms"] for e in res["events"]]
    ev_vi_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] + e["cull_ms"] for e in res["events"]
                if e["vi"]]
    timers = slam.timers.summary()
    stereo_ms = timers.get("stereo", {}).get("median_ms", float("nan"))
    _phase(name, f"{len(fr)} frames through SlamSystem.track({'img_right' if stereo else 'depth'}"
                 f"=) in {wall:.1f} s: initialized from depth at frame 0 with "
                 f"{res['init'][2]['n_points']} points; {slam.n_kf} keyframes, "
                 f"{len(res['events'])} events, lost frames {slam.n_lost_frames}; launches "
                 f"{launches}; ms/frame median {np.median(vis_ms):.1f} p90 "
                 f"{np.percentile(vis_ms, 90):.1f}"
                 + (f", VI median {np.median(vi_ms):.1f}" if vi_ms else "")
                 + f"; ms/event median {np.median(ev_ms):.1f}"
                 + (f" (XYZ VI window events {np.median(ev_vi_ms):.1f})" if ev_vi_ms else "")
                 + (f"; stereo extraction + matching median {stereo_ms:.1f} ms" if stereo else "")
                 + f"; flagged syncs per plain frame median "
                 f"{np.median([f['syncs'] for f in fr if f['plain']]):.0f}; peak device memory "
                 f"{peak_mb:.0f} MiB")
    _phase(name, f"ATE {measured['ate_m'] * 1e3:.2f} mm over {measured['n']} frames, alignment "
                 f"scale {measured['scale']:.4f} (within "
                 f"{SCALE_TOL_STEREO if stereo else SCALE_TOL_RGBD} of 1)"
                 + ("" if stereo else f", ATE limit {ATE_LIMIT_RGBD * 1e3:.0f} mm")
                 + f"; {measured['n_window_ba']} window BAs, all with u_right rows (at least "
                 f"{measured['min_ur_rows']})"
                 + (f"; VI init accepted at frame {res['i_accept']}, "
                    f"{measured['n_xyz_vi_window_ba']} XYZ window VI BAs after it"
                    if stereo else ""))
    if launches < 2 * len(fr) - 2:
        raise AssertionError(f"kernel launched {launches} times for {len(fr)} frames")
    # frame 0 initializes from depth and is not tracked
    check_lm_launches(name, lm_launches, sum(not f["vi"] for f in fr[1:]))
    check_vi_lm_launches(name, vw, True)
    vi_check = vi_lm_phase_check(name, vw["calls"]) if vw["calls"] else None
    err, n_real = _real_search_check(rec)
    _phase(name, f"kernel == twin on the {n_real} real searches of "
                 + ("the first frame and the first VI frame" if stereo else "3 frames"))
    strip = lambda e: {k: v for k, v in e.items() if k != "costs"}
    detail = {"frames": len(fr), "launches": launches, "lm_launches": lm_launches,
              "vi_lm_launches": vw["launches"], "vi_frames": vw["frames"],
              "vi_lm_check": vi_check, "measured": measured,
              "events": [strip(e) for e in res["events"]], "attempts": res["attempts"],
              "accepted_at_frame": res["i_accept"], "keyframes_inserted": slam.n_kf,
              "frame_ms_median": float(np.median(vis_ms)),
              "frame_ms_p90": float(np.percentile(vis_ms, 90)),
              "frame_ms_vi_median": float(np.median(vi_ms)) if vi_ms else None,
              "event_ms_median": float(np.median(ev_ms)),
              "event_ms_xyz_vi_median": float(np.median(ev_vi_ms)) if ev_vi_ms else None,
              "stereo_ms_median": stereo_ms if stereo else None,
              "frame_syncs_median": float(np.median([f["syncs"] for f in fr if f["plain"]])),
              "peak_device_MiB": peak_mb, "seconds": wall, "timers": timers}
    return detail, launches, err


def event_line(e):
    return (f"frame {e['frame']} -> keyframe {e['slot']}: {e['n_created']} points "
            f"triangulated, {e['n_fused']} associations fused, {e['n_culled']} points "
            f"culled, {e['n_active']} active; BA cost {e['cost0']:.1f} -> "
            f"{e['cost']:.1f}, {e['n_landmarks']} landmarks, overflow {e['overflow']}; "
            f"ms pre {e['pre_ms']:.1f} BA {e['ba_ms']:.1f} post {e['post_ms']:.1f} "
            f"stats+cull {e['cull_ms']:.1f}; host syncs before the stats copy {e['syncs']}"
            + (f"; keyframes culled {e['removed']}" if e["removed"] else ""))


def planted_inputs(M, N, rng, device, width=752, height=480, batch=None):
    """Random search inputs at the tracking shapes with exact ties planted:
    duplicated candidate descriptors (equal best at two columns), and queries
    that copy a candidate's descriptor and position (distance 0). With
    `batch` = B, B such problems drawn in turn and stacked ((B, M, .))."""
    if batch is not None:
        probs = [planted_inputs(M, N, rng, device, width, height) for _ in range(batch)]
        return {k: torch.stack([q[k] for q in probs]) for k in probs[0]}
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


SEARCH_KEYS = ("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid",
               "b_desc", "b_pm1", "b_uv", "b_lvl", "b_valid")   # the wrapper's inputs


def search_args(inp):
    """The wrapper's inputs from a dict of `planted_inputs`, in order."""
    return [inp[k] for k in SEARCH_KEYS]


def search_twin(*args, **kw):
    """The search's twin on the wrapper's arguments (it reads the +/-1 rows,
    not the packed words)."""
    return hamming_top2_windowed_ref(*args[1:5], *args[6:10], *args[10:], **kw)


def twin_check(kind, calls):
    """The one check of a hand kernel against its plain twin: each recorded
    call (frame, args, kwargs) goes through the program's dispatcher (the
    kernel on CUDA tensors, the twin on CPU ones) and through the twin, and
    the gaps of the two answers are taken over their tolerances (the
    kernel's module's `twin_gaps`): kind "search" (the wrapper
    match_cuda.hamming_top2_windowed; exact, a tolerance of 0), "pose"
    (ba.pose_only_visual; pose_lm_cuda.POSE_LM_*) or "vi"
    (ba_vi.pose_only_vi; pose_vi_lm_cuda.POSE_VI_LM_*). Raises where a gap
    passes 1 or, on the card, unless the kernel launched once a call.
    Returns (the largest gap of each name over its tolerance, the launches
    the check made)."""
    run, twin, gaps, lib = {
        "search": (match_cuda._WRAPPER, search_twin, match_cuda.twin_gaps, match_cuda.LIB),
        "pose": (ba.pose_only_visual, ba.pose_only_visual_ref, pose_lm_cuda.twin_gaps,
                 pose_lm_cuda.LIB),
        "vi": (ba_vi.pose_only_vi, ba_vi.pose_only_vi_ref, pose_vi_lm_cuda.twin_gaps,
               pose_vi_lm_cuda.LIB)}[kind]
    n0, worst, cuda = lib.launches, {}, False
    for _, args, kw in calls:
        out = run(*args, **kw)
        cuda = out[1].is_cuda              # every kind's second output is a tensor
        g = gaps(out, twin(*args, **kw))
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in g.items()}
    launches = lib.launches - n0
    if any(v > 1 for v in worst.values()) or launches != (len(calls) if cuda else 0):
        raise AssertionError(f"{kind} kernel against its twin (gap / tolerance): {worst}, "
                             f"{launches} launches for {len(calls)} calls")
    return worst, launches


def compare_kernel(inp, radius, level_tol=1):
    """The search on a dict of `planted_inputs` (batched or not: a leading B
    on every input, one launch) held to its twin (`twin_check`).
    Returns (the largest gap, 0 where exact; the rows with a match)."""
    args = search_args(inp) + [radius, level_tol]
    gaps, _ = twin_check("search", [(0, args, {})])
    return max(gaps.values()), int((search_twin(*args)[0] < BIG).sum())


def search_bound(inp, radius):
    """The search's bound (`probes.bound_ms` of `match_cuda.work`) on a dict
    of `planted_inputs`: (bound_ms, bound_by, detail)."""
    return probes.bound_ms(*match_cuda.work(*search_args(inp), radius),
                           rate=probes.SIMPLE_OPS_PER_S)


def _phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def _real_search_check(rec):
    """The searches a recorder kept held to the twin; returns (the largest
    gap, 0 where exact; their count)."""
    gaps, _ = twin_check("search", rec.calls)
    return max(gaps.values(), default=0.0), len(rec.calls)


def bootstrap_phase(name, seq: Sequence, p: Profile, cam, dev, refine=False, vi_check=False):
    """One run of `run_bootstrap` on the card with its report lines and
    checks (paths 3 and 4); with `refine` also `run_refine_and_chunked`;
    with `vi_check` the VI pose LM kernel held to its twin on the run's
    first VI solves, and timed (`vi_lm_phase_check`).
    Returns (detail dict, kernel launches of the run, max kernel-vs-twin
    error on the recorded searches, `run_bootstrap`'s dict with the system)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = probes.search_recorder(keep_frames=())
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    with vi_lm_watch(keep=VI_LM_CHECK_SOLVES if vi_check else 0) as vw:
        res = run_bootstrap(seq, p, cam, dev, recorder=rec)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    wall = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    ini = res["init"]
    _phase("init", f"two-view initialization accepted at frame {ini['frame']}: "
                   f"{ini['n_matches']} matches, model {'H' if ini['used_h'] else 'F'} "
                   f"(scores H {ini['score_h']:.0f} F {ini['score_f']:.0f}), {ini['n_good']} "
                   f"points; two-view BA cost {ini['ba']['cost0']:.1f} -> "
                   f"{ini['ba']['cost']:.1f}; {ini['ms']:.0f} ms, {ini['syncs']} flagged syncs")
    for e in res["events"]:
        _phase("event", ("VI " if e["vi"] else "visual ") + event_line(e))
    for a in res["attempts"]:
        _phase("vi-init", f"frame {a['frame']} t {a['t']:.2f} s, {a['n_kf']} keyframes: scale "
                          f"{a['scale']:.4f} scale* {a['scale_star']:.4f} cond {a['cond']:.0f} "
                          f"-> {a['reason']}; bg {np.round(a['bg'], 5).tolist()} ba "
                          f"{np.round(a['ba'], 4).tolist()}; ms "
                          f"{ {k: round(v, 1) for k, v in a['ms'].items()} }; flagged syncs "
                          f"{a['total_syncs']}; whole-map visual BA cost "
                          f"{a['ba_visual']['cost0']:.1f} -> {a['ba_visual']['cost']:.1f}"
                          + (f"; whole-map VI BA cost {a['ba_vi']['cost0']:.1f} -> "
                             f"{a['ba_vi']['cost']:.1f}" if "ba_vi" in a else ""))
    fr = res["frames"]
    vis_ms = [f["ms"] for f in fr if not f["vi"] and f["plain"]]
    vi_ms = [f["ms"] for f in fr if f["vi"] and f["plain"]]
    n_boot = len(fr)
    ev = res["events"]
    ev_ms = [e["pre_ms"] + e["ba_ms"] + e["post_ms"] + e["cull_ms"] for e in ev
             if not e["vi"]]
    measured = check_bootstrap(res, seq, p)
    slam = res["slam"]
    _phase(name, f"{n_boot} frames tracked from raw frames through SlamSystem.track in "
                 f"{wall:.1f} s: VI init (vi_init_time {p.vi_init_time:g} s) accepted at frame "
                 f"{res['i_accept']}, {slam.n_kf} keyframes inserted, {res['n_culled_kf']} "
                 f"culled, {res['n_reused']} slots reused, {len(slam.kf_slots)} active; "
                 f"{len(ev)} events, {len(res['attempts'])} VI-init attempts; lost frames "
                 f"{slam.n_lost_frames}; launches {launches}; inliers min "
                 f"{min(f['n_inliers'] for f in fr)}; fallbacks "
                 f"{sum(f['used_fb'] for f in fr)}; ms/frame visual median "
                 f"{np.median(vis_ms):.1f} p90 {np.percentile(vis_ms, 90):.1f}, VI median "
                 f"{np.median(vi_ms):.1f}; ms/visual event median {np.median(ev_ms):.1f}; "
                 f"peak device memory {peak_mb:.0f} MiB")
    _phase(name, f"gyro bias error of keyframe 0 {np.round(measured['bg_err'], 5).tolist()} "
                 f"(limits {list(BG_TOL_BOOT)}); gravity cos {measured['gravity_cos']:.5f} "
                 f"(> {GRAVITY_COS_BOOT}); post-init ATE {measured['ate_post_m'] * 1e3:.2f} mm "
                 f"over {measured['n_post']} frames (< {ATE_LIMIT_BOOT * 1e3:.0f}), alignment "
                 f"scale {measured['scale_post']:.4f} (within {SCALE_TOL_BOOT} of 1); whole "
                 f"trajectory ATE {measured['ate_all_m'] * 1e3:.2f} mm, scale "
                 f"{measured['scale_all']:.4f}")
    if slam.n_lost_frames or len(res["traj"]) != n_boot + 1:
        raise AssertionError(f"{slam.n_lost_frames} frames lost; {len(res['traj'])} trajectory "
                             f"rows for {n_boot + 1} tracked frames")
    if launches < 2 * n_boot:
        raise AssertionError(f"kernel launched {launches} times for {n_boot} frames")
    check_lm_launches(name, lm_launches, sum(not f["vi"] for f in res["frames"]))
    check_vi_lm_launches(name, vw, True)
    vi_lm = vi_lm_phase_check(name, vw["calls"], time_it=True) if vi_check else None
    err, n_real = _real_search_check(rec)
    _phase(name, f"kernel == twin on the {n_real} real searches of one visual frame "
                 f"and one VI frame")
    strip = lambda e: {k: v for k, v in e.items() if k != "costs"}
    detail = {"frames": n_boot, "launches": launches, "lm_launches": lm_launches,
              "vi_lm_launches": vw["launches"], "vi_frames": vw["frames"], "vi_lm_check": vi_lm,
              "init": ini,
              "events": [strip(e) for e in ev], "attempts": res["attempts"],
              "accepted_at_frame": res["i_accept"], "measured": measured,
              "keyframes_inserted": slam.n_kf, "keyframes_culled": res["n_culled_kf"],
              "slots_reused": res["n_reused"], "keyframes_active": len(slam.kf_slots),
              "frame_ms_visual_median": float(np.median(vis_ms)),
              "frame_ms_visual_p90": float(np.percentile(vis_ms, 90)),
              "frame_ms_vi_median": float(np.median(vi_ms)),
              "event_ms_visual_median": float(np.median(ev_ms)),
              "frame_syncs_median": float(np.median([f["syncs"] for f in fr if f["plain"]])),
              "peak_device_MiB": peak_mb, "seconds": wall}
    if refine:
        t0 = time.time()
        r = run_refine_and_chunked(res, seq, p)
        b, a, g = r["ate_before"], r["ate_after"], r["gba"]
        _phase(name, f"global_refine over {r['n_kf']} keyframes: {r['refine_ms']:.0f} ms, cost "
                     f"{g['cost0']:.1f} -> {g['cost']:.1f}, {g['n_landmarks']} landmarks; whole "
                     f"trajectory ATE {b['rmse'] * 1e3:.2f} mm (scale {b['scale']:.4f}) -> "
                     f"{a['rmse'] * 1e3:.2f} mm (scale {a['scale']:.4f}) over {r['n_rows']} rows")
        if not np.isfinite(g["costs"]).all() or np.any(np.diff(g["costs"]) > 0):
            raise AssertionError(f"global_refine: cost curve {g['costs']}")
        if not a["rmse"] < ATE_LIMIT_BOOT:
            raise AssertionError(f"ATE after global_refine {a}")
        for k in ("dense", "chunked"):
            c = r[k]
            _phase("chunked", f"{k} whole-map VI BA, {r['n_kf']} keyframes"
                              + (f" padded to 32, {r['n_chunks']} chunks of 1024 landmarks"
                                 if k == "chunked" else " padded to a multiple of 8")
                              + f": cost {c['cost0']:.1f} -> {c['cost']:.1f}; {c['ms']:.0f} ms, "
                              f"{c['launches']} kernels and copies, peak device memory "
                              f"{c['peak_MiB']:.0f} MiB")
        _phase("chunked", f"chunked against dense: keyframe positions within "
                          f"{r['dP_m'] * 1e3:.3f} mm (< 5), final costs within "
                          f"{r['dcost_rel'] * 100:.4f} % (< 1); phase took "
                          f"{time.time() - t0:.1f} s")
        _phase(name, "stage timers (host clock; device = between the stage's two CUDA "
                     "events; nested stages are reported, not summed):")
        print(slam.timers.report(), flush=True)
        tolist = lambda d: {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                            for k, v in d.items()}
        detail["refine"] = {"ms": r["refine_ms"], "gba": tolist(g), "ate_before": b,
                            "ate_after": a, "rows": r["n_rows"]}
        detail["chunked"] = {"n_kf": r["n_kf"], "n_chunks": r["n_chunks"],
                             "dP_m": r["dP_m"], "dcost_rel": r["dcost_rel"],
                             "dense": tolist(r["dense"]), "chunked": tolist(r["chunked"])}
        detail["timers"] = slam.timers.summary()
    return detail, launches, err, res


REVISIT_SRC, REVISIT_FRAMES = 200, 65   # path 5 feeds frames 200 .. 264 again


def revisit_phase(res, seq: Sequence, p: Profile):
    """Path 5 on the card, on the system path 4 left: `run_revisit` and its
    gates, the live detections, then the phase "loop" (`run_loop_phase`) with
    the kernel counts of its stages run alone. Returns (detail dict, kernel
    launches of the path, max kernel-vs-twin error on the recorded searches,
    `run_revisit`'s and `run_loop_phase`'s dicts)."""
    slam = res["slam"]
    st = slam.st
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = probes.search_recorder(keep_frames=set())
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    with vi_lm_watch() as vw:
        rv = run_revisit(res, seq, p, REVISIT_SRC, REVISIT_FRAMES, recorder=rec)
    wall = time.time() - t0
    fr = rv["frames"]
    lost_ms = [f["ms"] for f in fr if not f["ok"]]
    win_ms = [f["ms"] for f in fr if f["mode"] == "reloc_window" and f["keyframe"] is None]
    vi_ms = [f["ms"] for f in fr if f["mode"] == "" and f["keyframe"] is None]
    f_reloc = next(f for f in fr if f["mode"] == "reloc")
    _phase("path5", f"kidnap: 3 blank frames -> LOST, 3 lost events (a failed attempt "
                    f"{np.median(lost_ms):.1f} ms, {fr[1]['syncs']} flagged syncs); frames "
                    f"{REVISIT_SRC}..{REVISIT_SRC + REVISIT_FRAMES - 1} fed again: relocalized "
                    f"at replayed frame {rv['i_reloc']} (source frame {rv['src_reloc']}) against "
                    f"keyframe {rv['reloc']['kf']} with {rv['reloc']['n_in']} inliers "
                    f"({slam.cfg.pnp_iters} PnP hypotheses a candidate), "
                    f"{f_reloc['ms']:.1f} ms, {f_reloc['syncs']} flagged syncs, "
                    f"{rv['reloc_pos_err'] * 1e3:.1f} mm from the pose estimated there "
                    f"(< {RELOC_POS_TOL * 1e3:.0f})")
    _phase("path5", f"bias window: {rv['n_window']} visual frames (median "
                    f"{np.median(win_ms):.1f} ms), then the 20-frame solve; gyro bias "
                    f"{[round(float(x), 5) for x in rv['bg']]} (true {TRUE_BG.tolist()}, corrupted "
                    f"by {[round(float(x), 3) for x in BG_CORRUPTION]}): error {np.round(rv['bg_err'], 5).tolist()} "
                    f"(< 0.4 of the corruption on every axis); {rv['n_vi_after']} VI frames "
                    f"after it, none lost (median {np.median(vi_ms):.1f} ms); keyframes "
                    f"inserted after the relocalization {rv['new_kf']}, the first starts a "
                    f"new IMU chain: {rv['chain_break']}")
    check_revisit(rv, p)
    for fid, _, d in rv["diags"]:
        _phase("path5", f"live detection at frame {fid}: best non-covisible score "
                        f"{d['best_noncovis']}, minimum covisible score {d['min_score']}, "
                        f"{d['n_cands']} candidates")
    for fid, kind, d in rv["sim3"]:
        _phase("path5", f"live {kind} at frame {fid}: {d}")
    launches_track = match_cuda.LIB.launches

    # ---- phase "loop": a planted seam at full table width ----
    src_end = REVISIT_SRC + REVISIT_FRAMES - 1
    spread = [s_ for s_ in rv["kf_before"] if st.kf_id_host[s_] > src_end]
    rec.frame = -1
    rec.keep_frames.add(-1)          # the guided verification's search
    t1 = time.time()
    lp = run_loop_phase(slam, rv["new_kf"], spread, recorder=rec)
    launches = match_cuda.LIB.launches
    lm_launches = pose_lm_cuda.LIB.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    err, n_real = _real_search_check(rec)
    v = [x for x in lp["verify"] if x["cand"] == lp["cand"]][-1]
    _phase("loop", f"seam planted: {lp['n_copied']} landmarks copied for keyframes "
                   f"{spread} + {rv['new_kf']}, drift {lp['drift_m']:.3f} m / {SEAM_ROT_DEG:g} "
                   f"degrees growing over {len(spread)} keyframes; attempts "
                   f"{[(a['cur'], a['cands'], a['sim3']) for a in lp['attempts']]}")
    _phase("loop", f"closed at keyframe {lp['cur']} against {lp['cand']} (frames "
                   f"{lp['closed']['cur_fid']} / {lp['closed']['cand_fid']}): best "
                   f"non-covisible score {lp['diag']['best_noncovis']}, "
                   f"{lp['closed']['n_inliers']} Sim3 inliers, {v['n_guided']} guided matches "
                   f"(>= {loopctl.MIN_GUIDED}); measured Sim3 off the planted relative pose by "
                   f"{lp['sim3_dt_m'] * 1e3:.1f} mm (< {SEAM_SIM3_T_TOL * 1e3:.0f}) and "
                   f"{lp['sim3_dr_deg']:.3f} degrees (< {SEAM_SIM3_R_TOL}); implied correction "
                   f"{lp['closed']['corr_m']} m; revisit keyframes back within "
                   f"{lp['back_m'] * 1e3:.1f} mm (< {SEAM_POSE_TOL * 1e3:.0f}); seam "
                   f"covisibility {lp['seam_covis']:.0f} (>= 10); costs first -> last "
                   f"{ {k: [round(x, 4) for x in c] for k, c in lp['costs'].items()} }; "
                   f"loops closed {st.n_loops_closed}")
    kernels = {}
    for name, fn in loop_stage_replays(slam, lp):
        kernels[name] = count_kernels(fn)[1]
    ms, sy = lp["stage_ms"], lp["stage_syncs"]
    _phase("loop", f"the closing event {lp['total_ms']:.0f} ms; ms / flagged syncs by stage: "
                   + ", ".join(f"{k} {ms[k]:.1f} / {sy[k]}" for k in ms)
                   + f"; kernels and copies of each stage run alone: {kernels}; phase took "
                   f"{time.time() - t1:.1f} s")
    _phase("path5", f"{len(fr)} frames in {wall:.1f} s; launches {launches} "
                    f"({launches_track} before the phase \"loop\"); kernel == twin on the "
                    f"{n_real} recorded searches (the relocalizing frame's and the guided "
                    f"verification's); peak device memory {peak_mb:.0f} MiB")
    if launches <= launches_track or n_real < 3:
        raise AssertionError(f"the guided verification did not reach the kernel "
                             f"({launches_track} -> {launches} launches, {n_real} recorded)")
    check_lm_launches("path5", lm_launches, rv["n_window"])
    check_vi_lm_launches("path5", vw, True)
    strip = lambda d: {k: (v_.tolist() if isinstance(v_, np.ndarray) else v_)
                       for k, v_ in d.items()
                       if k not in ("m_planted", "frames", "events", "measured")}
    detail = {"frames": len(fr), "launches": launches, "launches_before_loop": launches_track,
              "lm_launches": lm_launches, "vi_lm_launches": vw["launches"],
              "vi_frames": vw["frames"],
              "revisit": strip(rv), "loop": strip(lp), "loop_stage_kernels": kernels,
              "attempt_lost_ms": float(np.median(lost_ms)), "reloc_ms": f_reloc["ms"],
              "window_frame_ms": float(np.median(win_ms)),
              "vi_frame_ms": float(np.median(vi_ms)), "peak_device_MiB": peak_mb,
              "seconds": time.time() - t0, "timers": slam.timers.summary()}
    return detail, launches, err, rv, lp


# ---------------------------------------------------------------------------
# phase "multiseq": B windows of the clone as one batched step
# (parallel/multiseq.py, BASELINE.json config #4)

MULTISEQ_STARTS = tuple(range(0, 101, 10))   # 11 windows: config #4's "all 11" sequences
MULTISEQ_STEPS = 5          # frames tracked in each window after its seed frame
MULTISEQ_ITERS = 10         # make_batched_step's default
MULTISEQ_POS_TOL = 1e-3     # m, batched against unbatched (tests/test_multiseq.py)
MULTISEQ_INLIER_TOL = 2     # inliers, the same test's tolerance
MULTISEQ_MESH_B = 10        # windows over the two-shard "seq" mesh (B divides evenly)


VI_LM_CHECK_SOLVES = 10         # recorded VI solves a path holds to the twin (5 frames)


@contextlib.contextmanager
def vi_lm_watch(keep=0):
    """While entered: the VI pose LM kernel's launches counted from 0, the
    VI frame programs run (pipeline/tracking._vi_frame_body, two
    ba_vi.pose_only_vi solves each) and the arguments of the first `keep`
    solves, kept by reference. Yields a dict (launches, frames, calls);
    launches and frames are read on exit."""
    frames = probes.Recorder(tracking, "_vi_frame_body", keep=0)
    solves = probes.Recorder(ba_vi, "pose_only_vi", keep=keep)
    w = dict(launches=0, frames=0, calls=solves.calls)
    pose_vi_lm_cuda.LIB.launches = 0
    with frames, solves:
        yield w
    w.update(launches=pose_vi_lm_cuda.LIB.launches, frames=frames.n)


def check_vi_lm_launches(name, w, cuda):
    """Raises unless the VI pose LM kernel launched exactly twice a VI frame
    program on the card (`vi_lm_watch`), and never on the CPU (the twin)."""
    want = 2 * w["frames"] if cuda else 0
    if w["launches"] != want:
        raise AssertionError(f"{name}: the VI pose LM kernel launched {w['launches']} times "
                             f"for {w['frames']} VI frames")


def vi_lm_phase_check(name, calls, time_it=False):
    """The VI pose LM kernel against its twin on a path's recorded solves
    (`twin_check`), with a report line; with `time_it`, the first solve
    with the marginal timed (one launch warm and with a cold L2, the twin,
    the bound). Returns a dict of what it measured."""
    gaps, launches = twin_check("vi", calls)
    out = dict(solves=len(calls), gaps_over_tol=gaps, check_launches=launches)
    line = (f"VI pose LM kernel against its twin on the {len(calls)} recorded solves (gap / "
            f"tolerance: {', '.join(f'{k} {v:.3g}' for k, v in gaps.items())})")
    if time_it:
        _, args, kw = next(c for c in calls if c[2].get("compute_marg", True))
        obs = args[4]
        flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=args[3].device)
        ms = time_cuda(lambda: ba_vi.pose_only_vi(*args, **kw))
        cold = time_cuda_cold(lambda: ba_vi.pose_only_vi(*args, **kw), flush)
        twin = time_cuda(lambda: ba_vi.pose_only_vi_ref(*args, **kw), n=3, warmup=1, rounds=3)
        bound, by, bd = probes.bound_ms(
            *pose_vi_lm_cuda.work(obs.pt.shape[-1], kw["iters"], True, obs.ur is not None),
            rate=probes.FLOAT_OPS_PER_S)
        del flush
        out.update(O=obs.pt.shape[-1], Np=args[3].shape[0], iters=kw["iters"], ms=ms,
                   cold_ms=cold, twin_ms=twin, bound_ms=bound, bound_by=by, bound_detail=bd)
        line += (f"; O={out['O']} Np={out['Np']}, {kw['iters']} iterations with the marginal: "
                 f"one launch {ms * 1e3:.1f} us (cold L2 {cold * 1e3:.1f} us), twin "
                 f"{twin * 1e3:.1f} us, bound {bound * 1e3:.3f} us by {by}")
    _phase(name, line)
    return out


def check_lm_launches(name, lm_launches, n_visual):
    """Raises unless the pose LM kernel launched at least twice for each of
    the n_visual frames a path tracked visually (`track_frame_visual`'s two
    rounds, one `ba.pose_only_visual` each; the wide retry adds two more)."""
    if lm_launches < 2 * n_visual:
        raise AssertionError(f"{name}: the pose LM kernel launched {lm_launches} times for "
                             f"{n_visual} visually tracked frames")


def window(seq: Sequence, s: int, n: int) -> Sequence:
    """Frames s .. s+n-1 of `seq`."""
    return Sequence(imgs=seq.imgs[s:s + n], depths=seq.depths[s:s + n], P=seq.P[s:s + n],
                    R=seq.R[s:s + n], V=seq.V[s:s + n], imu=seq.imu[s:s + n],
                    times=seq.times[s:s + n])


def multiseq_maps(seq: Sequence, p: Profile, cam, ext, device, starts=MULTISEQ_STARTS,
                  n_steps=MULTISEQ_STEPS):
    """One localization map a window, seeded as path 1's (`build_map`) over
    the window's own frames (keyframes at its frames 0 and kf_every, ...)."""
    pw = dataclasses.replace(p, n_frames=n_steps + 1)
    return [build_map(window(seq, s, n_steps + 1), pw, cam, ext, device)[0] for s in starts]


def track_windows(step, ms, seq: Sequence, starts, device, batched=True,
                  n_steps=MULTISEQ_STEPS, timed=False):
    """Track frames s+1 .. s+n_steps of the windows `starts` with `step`
    (make_batched_step's signature): batched, one call a frame for all
    windows; else `starts` is one window and `ms` its own map. The first
    prediction is the window's ground-truth pose at frame s moved by its
    ground-truth velocity (what the IMU gives a live system), then the
    velocity model (TrackWithMotionModel). Returns dict(P (n_steps, B, 3),
    n_in (n_steps, B), ms per call)."""
    sel = list(starts) if batched else starts[0]
    P = _t(seq.P[sel], device)
    R = _t(seq.R[sel], device)
    dt = float(seq.times[1] - seq.times[0])
    P0, R0 = P + _t(seq.V[sel], device) * dt, R
    frames = {s + j: torch.from_numpy(seq.imgs[s + j]).to(device)
              for s in starts for j in range(1, n_steps + 1)}
    Ps, ns, ms_list = [], [], []
    for j in range(1, n_steps + 1):
        imgs = (torch.stack([frames[s + j] for s in starts]) if batched
                else frames[starts[0] + j])
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        Pn, Rn, _, n_in = step(ms, imgs, P0, R0)
        if timed:
            torch.cuda.synchronize()
            ms_list.append((time.perf_counter() - t0) * 1e3)
        RT = R.transpose(-1, -2)
        dP = (RT @ (Pn - P)[..., None])[..., 0]
        dR = RT @ Rn
        P, R = Pn, Rn
        P0, R0 = P + (R @ dP[..., None])[..., 0], R @ dR
        Ps.append(Pn)
        ns.append(n_in)
    P_all = torch.stack(Ps).cpu().numpy()
    n_all = torch.stack(ns).cpu().numpy()
    if not batched:
        P_all, n_all = P_all[:, None], n_all[:, None]
    return dict(P=P_all, n_in=n_all, ms=ms_list)


def run_multiseq_phase(seq: Sequence, p: Profile, cam, ext, dev, single_ms, single_bound):
    """The phase "multiseq" (see the module docstring). single_ms /
    single_bound: phase 2's single-problem kernel times and bounds by radius,
    for the batched kernel's comparison. Returns (detail dict, the batched
    kernel's record fields, max kernel-vs-twin error)."""
    from mc_slam_tpu_torch.parallel import multiseq
    starts = MULTISEQ_STARTS
    B = len(starts)
    t0 = time.time()
    maps = multiseq_maps(seq, p, cam, ext, dev)
    ms = multiseq.stack_maps(maps)
    n_pts = [int(m.mp_active.sum()) for m in maps]
    _phase("multiseq", f"{B} windows (start frames {starts[0]}..{starts[-1]}), maps of "
                       f"{min(n_pts)}..{max(n_pts)} / {p.max_mp} points stacked "
                       f"({time.time() - t0:.1f} s)")
    step = multiseq.make_batched_step(cam, ext, n_features=p.n_feat, n_levels=p.n_levels,
                                      iters=MULTISEQ_ITERS)

    def single_step(m, img, P0, R0):
        f = extractor.extract(img, n_features=p.n_feat, n_levels=p.n_levels)
        r = tracking.track_frame_visual(m, f, tcam.undistort_points(cam, f.xy), cam, ext,
                                        P0, R0, iters=MULTISEQ_ITERS)
        return r.P, r.R, r.feat_mp, r.n_inliers

    # warm-up (allocator, cuBLAS / cuSOLVER handles at these shapes), then
    # the measured batched run with every count set to 0
    track_windows(step, ms, seq, starts, dev, n_steps=1)
    track_windows(single_step, maps[0], seq, starts[:1], dev, batched=False, n_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    bat = track_windows(step, ms, seq, starts, dev, timed=True)
    launches_batched = match_cuda.LIB.launches
    lm_batched = pose_lm_cuda.LIB.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # the same windows one at a time through the unbatched program
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t1 = time.perf_counter()
    seqs = [track_windows(single_step, maps[b], seq, [s], dev, batched=False, timed=True)
            for b, s in enumerate(starts)]
    seq_s = time.perf_counter() - t1
    launches_single = match_cuda.LIB.launches
    lm_single = pose_lm_cuda.LIB.launches
    gt = np.stack([seq.P[s + 1:s + 1 + MULTISEQ_STEPS] for s in starts], axis=1)
    rmse = np.sqrt(np.mean(np.sum((bat["P"] - gt) ** 2, axis=-1), axis=0))
    P_single = np.concatenate([r["P"] for r in seqs], axis=1)
    n_single = np.concatenate([r["n_in"] for r in seqs], axis=1)
    dP = float(np.abs(bat["P"] - P_single).max())
    dn = int(np.abs(bat["n_in"].astype(np.int64) - n_single.astype(np.int64)).max())
    step_ms = np.asarray(bat["ms"])
    single_frame_ms = np.concatenate([r["ms"] for r in seqs])
    fps_batched = B * MULTISEQ_STEPS / (step_ms.sum() / 1e3)
    fps_seq = B * MULTISEQ_STEPS / seq_s
    _phase("multiseq", f"{MULTISEQ_STEPS} batched steps of {B} windows: position RMSE per "
                       f"window {np.round(rmse * 1e3, 2).tolist()} mm (< "
                       f"{RMSE_LIMIT_LOC * 1e3:g}); inliers min {bat['n_in'].min()} median "
                       f"{np.median(bat['n_in']):.0f}; against the unbatched runs: positions "
                       f"within {dP * 1e3:.4f} mm (< {MULTISEQ_POS_TOL * 1e3:g}), inliers "
                       f"within {dn} (<= {MULTISEQ_INLIER_TOL})")
    _phase("multiseq", f"kernel launches {launches_batched} ({launches_batched / MULTISEQ_STEPS:g}"
                       f" a batched step) against {launches_single} unbatched "
                       f"({launches_single / MULTISEQ_STEPS:g} a step of {B} frames); ms per "
                       f"batched step median {np.median(step_ms):.2f} p90 "
                       f"{np.percentile(step_ms, 90):.2f}; ms per unbatched frame median "
                       f"{np.median(single_frame_ms):.2f}; aggregate {fps_batched:.1f} frames/s "
                       f"batched against {fps_seq:.1f} sequential ({fps_batched / fps_seq:.2f}x); "
                       f"peak device memory {peak_mb:.0f} MiB")
    if not np.isfinite(bat["P"]).all() or rmse.max() >= RMSE_LIMIT_LOC:
        raise AssertionError(f"multiseq position RMSE {rmse.tolist()} m (limit "
                             f"{RMSE_LIMIT_LOC} m)")
    if dP >= MULTISEQ_POS_TOL or dn > MULTISEQ_INLIER_TOL:
        raise AssertionError(f"batched against unbatched: {dP} m, {dn} inliers")
    if launches_batched != 2 * MULTISEQ_STEPS or launches_single != 2 * MULTISEQ_STEPS * B:
        raise AssertionError(f"kernel launches {launches_batched} batched, "
                             f"{launches_single} unbatched")
    _phase("multiseq", f"pose LM kernel launches {lm_batched} batched "
                       f"({lm_batched / MULTISEQ_STEPS:g} a step) against {lm_single} unbatched")
    if lm_batched != 2 * MULTISEQ_STEPS or lm_single != 2 * MULTISEQ_STEPS * B:
        raise AssertionError(f"pose LM kernel launches {lm_batched} batched, {lm_single} "
                             "unbatched")
    # launches of every kernel: one batched step against one unbatched frame
    f1 = {s: torch.from_numpy(seq.imgs[s + 1]).to(dev) for s in starts}
    P0 = _t(seq.P[list(starts)], dev)
    R0 = _t(seq.R[list(starts)], dev)
    imgs1 = torch.stack([f1[s] for s in starts])
    _, k_batched = count_kernels(lambda: step(ms, imgs1, P0, R0))
    _, k_single = count_kernels(lambda: single_step(maps[0], f1[starts[0]], P0[0], R0[0]))
    _phase("multiseq", f"kernels and copies the card ran: {k_batched} for one batched step "
                       f"of {B} windows, {k_single} for one unbatched frame")
    # the batched kernel on the step's real searches
    with probes.search_recorder(keep_frames=1) as rec:
        step(ms, imgs1, P0, R0)
    err_real, n_real = _real_search_check(rec)
    shapes = sorted({tuple(c[1][0].shape) for c in rec.calls})
    del rec
    _phase("multiseq", f"batched kernel == batched twin on the {n_real} real searches of one "
                       f"step (a_desc {shapes})")
    # the pose LM kernel on the step's two recorded solves
    with probes.Recorder(ba, "pose_only_visual") as srec:
        step(ms, imgs1, P0, R0)
    gaps, lm_launches = twin_check("pose", srec.calls)
    lm_gaps = dict(dP_m=gaps["dP"] * pose_lm_cuda.POSE_LM_POS_TOL,
                   dR_rad=gaps["dR"] * pose_lm_cuda.POSE_LM_ROT_TOL, dchi2_of_tol=gaps["dchi2"],
                   dn=round(gaps["dn"] * pose_lm_cuda.POSE_LM_INLIER_TOL))
    _, args, kw = srec.calls[0]
    flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    lm_ms = time_cuda(lambda: ba.pose_only_visual(*args, **kw))
    lm_cold = time_cuda_cold(lambda: ba.pose_only_visual(*args, **kw), flush)
    lm_twin = time_cuda(lambda: ba.pose_only_visual_ref(*args, **kw), n=3, warmup=1, rounds=3)
    obs = args[3]
    lm_bound, lm_by, lm_detail = probes.bound_ms(
        *pose_lm_cuda.work(args[0].shape[0], obs.pt.shape[-1], kw["iters"], obs.ur is not None),
        rate=probes.FLOAT_OPS_PER_S)
    del flush
    _phase("multiseq", f"pose LM kernel against its twin on the {len(srec.calls)} solves of one "
                       f"step (B={args[0].shape[0]} O={obs.pt.shape[-1]} "
                       f"Np={args[2].shape[-2]}, {kw['iters']} iterations): positions within "
                       f"{lm_gaps['dP_m']:.3g} m (< {pose_lm_cuda.POSE_LM_POS_TOL:g}), rotations "
                       f"within {lm_gaps['dR_rad']:.3g} rad (< {pose_lm_cuda.POSE_LM_ROT_TOL:g}), "
                       f"chi2 within {lm_gaps['dchi2_of_tol']:.3g} of its tolerance, inliers "
                       f"within {lm_gaps['dn']} (<= {pose_lm_cuda.POSE_LM_INLIER_TOL}); "
                       f"{lm_launches} launches for {len(srec.calls)} calls; "
                       f"one launch {lm_ms * 1e3:.1f} us (cold L2 {lm_cold * 1e3:.1f} us), twin "
                       f"{lm_twin * 1e3:.1f} us, bound {lm_bound * 1e3:.2f} us by {lm_by}")
    del srec, args, kw, obs
    # the batched kernel at B x the tracking shapes, planted ties
    rng = np.random.default_rng(11)
    inp = planted_inputs(16384, 1024, rng, dev, batch=B)
    args = search_args(inp)
    flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    k_ms, k_cold, k_plain, k_bound = {}, {}, {}, {}
    max_err = err_real
    for radius in RADII:
        err, n_has = compare_kernel(inp, radius)
        max_err = max(max_err, err)
        k_ms[radius] = time_cuda(lambda: hamming_top2_windowed(*args, radius))
        k_cold[radius] = time_cuda_cold(lambda: hamming_top2_windowed(*args, radius), flush)
        k_plain[radius] = time_cuda(lambda: search_twin(*args, radius), n=3, warmup=1, rounds=3)
        k_bound[radius] = search_bound(inp, radius)
        _phase("multiseq", f"B={B} M=16384 N=1024 r={radius:g}: exact ({n_has} rows matched); "
                           f"one launch {k_ms[radius] * 1e3:.1f} us (cold L2 "
                           f"{k_cold[radius] * 1e3:.1f} us) against {B} x single "
                           f"{B * single_ms[radius] * 1e3:.1f} us; twin "
                           f"{k_plain[radius] * 1e3:.1f} us; bound "
                           f"{k_bound[radius][0] * 1e3:.2f} us by {k_bound[radius][1]} ({B} x "
                           f"single {B * single_bound[radius][0] * 1e3:.2f} us)")
    del flush, inp, args
    # 10 of the windows over a two-shard "seq" mesh on one card
    sub = slice(0, MULTISEQ_MESH_B)
    ms_sub = multiseq.batch_rows(ms, sub)
    mesh = multiseq.make_seq_mesh(devices=[dev, dev])
    mstep = multiseq.make_batched_step(cam, ext, n_features=p.n_feat, n_levels=p.n_levels,
                                       iters=MULTISEQ_ITERS, mesh=mesh)
    out_mesh = mstep(ms_sub, imgs1[sub], P0[sub], R0[sub])
    out_one = step(ms_sub, imgs1[sub], P0[sub], R0[sub])
    dP_mesh = float((out_mesh[0] - out_one[0]).abs().max())
    dn_mesh = int((out_mesh[3] - out_one[3]).abs().max())
    exact = all(torch.equal(a, b) for a, b in zip(out_mesh, out_one))
    _phase("multiseq", f"{MULTISEQ_MESH_B} windows over a {mesh.size}-shard seq mesh on {dev} "
                       f"against the unsharded step: positions within {dP_mesh * 1e3:.4f} mm, "
                       f"inliers within {dn_mesh}, bit-equal {exact} ({time.time() - t0:.1f} s)")
    if dP_mesh >= MULTISEQ_POS_TOL or dn_mesh > MULTISEQ_INLIER_TOL:
        raise AssertionError(f"seq mesh against unsharded: {dP_mesh} m, {dn_mesh} inliers")
    detail = dict(windows=list(starts), steps=MULTISEQ_STEPS, rmse_m=rmse.tolist(),
                  dP_vs_unbatched_m=dP, dn_vs_unbatched=dn, launches=launches_batched,
                  launches_unbatched=launches_single, step_ms=bat["ms"],
                  step_ms_median=float(np.median(step_ms)),
                  step_ms_p90=float(np.percentile(step_ms, 90)),
                  unbatched_frame_ms_median=float(np.median(single_frame_ms)),
                  fps_batched=fps_batched, fps_sequential=fps_seq, peak_device_MiB=peak_mb,
                  kernels_per_batched_step=k_batched, kernels_per_unbatched_frame=k_single,
                  real_searches=n_real, pose_lm_launches=lm_batched,
                  pose_lm_launches_unbatched=lm_single, pose_lm_gaps=lm_gaps,
                  pose_lm_ms=lm_ms, pose_lm_cold_ms=lm_cold, pose_lm_twin_ms=lm_twin,
                  pose_lm_bound_ms=lm_bound, pose_lm_bound_by=lm_by,
                  pose_lm_bound_detail=lm_detail,
                  kernel_ms_by_radius={f"{r:g}": k_ms[r] for r in RADII},
                  kernel_cold_ms_by_radius={f"{r:g}": k_cold[r] for r in RADII},
                  plain_ms_by_radius={f"{r:g}": k_plain[r] for r in RADII},
                  bound_ms_by_radius={f"{r:g}": k_bound[r][0] for r in RADII},
                  mesh=dict(windows=MULTISEQ_MESH_B, shards=mesh.size, dP_m=dP_mesh,
                            dn=dn_mesh, bit_equal=exact),
                  seconds=time.time() - t0)
    record = dict(launches=launches_batched, ms=k_ms[15.0], plain_ms=k_plain[15.0],
                  bound_ms=k_bound[15.0][0], bound_by=k_bound[15.0][1],
                  pose_lm=dict(max_abs_err=lm_gaps["dP_m"], ms=lm_ms, plain_ms=lm_twin,
                               bound_ms=lm_bound, bound_by=lm_by))
    return detail, record, max_err


# ---------------------------------------------------------------------------
# phase "multihost": the process-group Schur solve (tools/run_multihost_ba.py,
# BASELINE.json config #5)

MULTIHOST_RUNS = (("gloo", 2), ("nccl", 1))   # (backend, ranks) on this card
MULTIHOST_TIMEOUT = 240     # s, each --demo run (its ranks are waited on with it)


def run_multihost_phase():
    """Spawn tools/run_multihost_ba.py --demo for each of MULTIHOST_RUNS on
    both problems; every rank's JSON line must say ok. Returns the reports."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    out = {}
    for backend, n in MULTIHOST_RUNS:
        t0 = time.time()
        cmd = [sys.executable, "-m", "mc_slam_tpu_torch.tools.run_multihost_ba",
               "--demo", str(n), "--device", "cuda", "--backend", backend,
               "--shards-per-proc", "4", "--problem", "demo,map",
               "--timeout", str(MULTIHOST_TIMEOUT)]
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=MULTIHOST_TIMEOUT + 30)
        reports = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
        for l in proc.stdout.splitlines():
            if not l.startswith("{"):
                _phase("multihost", l)
        if proc.returncode != 0 or len(reports) != n or not all(r["ok"] for r in reports):
            raise AssertionError(f"run_multihost_ba --demo {n} --backend {backend}: rc "
                                 f"{proc.returncode}\n{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        r0 = next(r for r in reports if r["rank"] == 0)
        for kind, e in r0["problems"].items():
            _phase("multihost", f"{backend}, {n} rank(s) x 4 shards, {kind}: every rank "
                                f"bit-equal to rank 0, max err vs single-process "
                                f"{e['max_err_vs_single']:.3e} (< 5e-4), ms/solve median "
                                f"{e['ms_median']:.3f} (rank 0)")
        out[f"{backend}x{n}"] = dict(reports=reports, seconds=time.time() - t0)
    _phase("multihost", "two ranks on two cards (NCCL across cards) not measured: one card")
    return out


BENCH_CALLS = 3             # timed calls a workload in the phase "bench" (tools/bench.py: 20)
BENCH_GBA_ITERS = 2         # part A's LM iterations in the phase "bench" (bench_scaling: 8)


def bench_phase(dev):
    """The phase "bench" (see the module docstring). Returns (detail dict,
    launches of the frame steps, launches of the batched steps, max
    kernel-vs-twin error on their real searches); the detail's lm_launches
    counts the pose LM kernel's, two a frame step and two a batched step."""
    from mc_slam_tpu_torch.tools import bench, bench_scaling
    t0 = time.time()
    sz = bench.FULL
    n = BENCH_CALLS
    pose_lm_cuda.LIB.launches = 0
    sub, det = bench.run_workloads(sz, dev, n_frame=n, n_ex=n, n_ba=n, n_batched=n, n_hm=n,
                                   profile=False)
    launches = det["launches"]
    lm_launches = pose_lm_cuda.LIB.launches
    _phase("bench", f"frame step ({sz['W']}x{sz['H']}, {sz['n_feat']} features, "
                    f"{sz['n_levels']} levels, {sz['n_mp']}-point map): "
                    f"{sub['frame_tracking_ms']:.2f} ms ({sub['frame_tracking_fps']:.2f} "
                    f"frames/s); hamming_top2_windowed {launches['frame_step']} in {n + 2} steps")
    _phase("bench", f"extraction {sub['extraction_ms']:.2f} ms; window VI BA "
                    f"{sub['vi_ba_20kf_ms']:.2f} ms, IDP {sub['vi_ba_idp_20kf_ms']:.2f} ms "
                    f"({sz['ba_kf']} keyframes, {sz['ba_pts']} points, {bench.BA_ITERS} "
                    f"iterations)")
    _phase("bench", f"{sz['batch']} sequences in one batched step: "
                    f"{sub['batched8_fps_aggregate']:.2f} frames/s aggregate, "
                    f"hamming_top2_windowed {launches['batched_step']} in {n + 2} steps; Hamming "
                    f"{sz['n_feat']}x{sz['n_mp']} {sub['hamming_gpairs_s']:.1f} Gpairs/s; the "
                    f"kernel on the first search {sub['kernel_gpairs_s']:.1f} Gpairs/s gated")
    _phase("bench", f"speed of light: {json.dumps(sub['speed_of_light'])}")
    if launches["frame_step"] != 2 * (n + 2) or launches["batched_step"] != 2 * (n + 2):
        raise AssertionError(f"kernel launches {launches}")
    if lm_launches != 4 * (n + 2):
        raise AssertionError(f"pose LM kernel launches {lm_launches} in {n + 2} frame steps "
                             f"and {n + 2} batched steps")
    check_cost_curve("window VI BA", det["vi_ba_costs"])
    check_cost_curve("IDP window BA", det["vi_ba_idp_costs"])
    # the kernel on the searches the first frame step and the first batched step made
    err, n_real = _real_search_check(det.pop("recorder"))
    if n_real != 4:
        raise AssertionError(f"{n_real} searches recorded (2 single, 2 batched)")
    _phase("bench", f"kernel == twin on the {n_real} real searches of a frame step and a "
                    f"batched step of {sz['batch']}")
    # tools/bench_scaling.py's part A
    prob, meta = bench_scaling.synthetic_problem(**bench_scaling.SYNTH, device=dev)
    a = bench_scaling.part_a(prob, meta, BENCH_GBA_ITERS, dev, n=1, warm=0, profile=False)
    check_cost_curve("chunked whole-map VI BA", a["costs"])
    _phase("bench", f"chunked whole-map VI BA ({meta['n_kf']} keyframes, {meta['n_pts']} "
                    f"points, {meta['n_obs']} observations, {meta['chunks']} chunks): "
                    f"{a['measured_iter_ms_1dev']:.1f} ms an iteration (one cold call), peak "
                    f"{a['peak_device_MiB']:.0f} MiB; cost {a['costs'][0]:.1f} -> "
                    f"{a['costs'][-1]:.1f} ({time.time() - t0:.1f} s)")
    detail = {"sub": sub, "launches": launches, "lm_launches": lm_launches, "part_a": a}
    return detail, launches["frame_step"], launches["batched_step"], err


def _async_line(name, r):
    pl = r["pulls"]
    drain = r["ev_chain_drain_ms"]
    return (f"{name} (LAG_MAX {r['lag_max']}, PAIR {r['pair']}): {r['frames']} frames, "
            f"ms per track median {r['frame_ms_median']:.1f} p90 {r['frame_ms_p90']:.1f}; "
            f"{r['wall_s']:.2f} s with the final flush ({r['fps']:.3f} frames/s); matcher "
            f"launches {r['launches']} ({r['launches_per_frame']:.2f} a frame); flagged syncs "
            f"{r['syncs_per_frame']:.2f} a frame; harvest_pull {pl['harvest_pull']['n']} / "
            f"{pl['harvest_pull']['ms']:.2f} ms, harvest_pull_block "
            f"{pl['harvest_pull_block']['n']} / {pl['harvest_pull_block']['ms']:.2f} ms; "
            f"deepest queue {r['max_depth']}; dispatched {r['dispatched']}; ev_chain_drain ms "
            f"{[round(x, 1) for x in drain]}; keyframes {r['keyframes']}, events harvested "
            f"deferred {r['events_deferred']} / forced {r['events_forced']}; lost {r['lost']}; "
            f"ATE {r['ate']['rmse'] * 1e3:.2f} mm (< {RELOC_POS_TOL * 1e3:.0f}); peak device "
            f"memory {r['peak_device_MiB']:.0f} MiB")


def async_phase(path, slam, rv, seq: Sequence):
    """The phase "async" on the card (`run_async_phase`) with its lines.
    Returns (detail dict, (A's, B's) kernel launches, max kernel-vs-twin
    error on B's first pair's searches, [(A's dict, A), (B's dict, B)] for
    `async_profile_phase`)."""
    t0 = time.time()
    (a, sys_a), (b, sys_b), rec = run_async_phase(path, slam, rv, seq,
                                                  REVISIT_SRC + REVISIT_FRAMES)
    for name, r in (("A", a), ("B", b)):
        _phase("async", _async_line(name, r))
    err, n_real = _real_search_check(rec)
    if n_real < 4:
        raise AssertionError(f"{n_real} searches recorded at B's first pair")
    _phase("async", f"B against A: positions within {b['dpos_max_m'] * 1e3:.2f} mm frame by "
                    f"frame (< {ASYNC_POS_TOL * 1e3:.0f}); B is {a['wall_s'] / b['wall_s']:.3f} x "
                    f"A's frame rate; kernel == twin on the {n_real} real searches of B's first "
                    f"pair ({time.time() - t0:.1f} s)")
    c = transition_phase(path, slam, rv, seq)
    strip = lambda r: {k: v for k, v in r.items() if k != "pos"}
    return ({"A": strip(a), "B": strip(b), "C": c}, (a["launches"], b["launches"],
                                                    c["launches"]), max(err, c["twin_max_err"]),
            [(a, sys_a), (b, sys_b)])


def transition_phase(path, slam, rv, seq: Sequence):
    """The phase "async"'s mode C (`run_transition`) on the card: the
    checkpoint of path 5's system, a blank frame at the first frame after path
    5's, LOST at depth 12, relocalization on path 5's first replayed frame, the
    bias window and 2 x 12 pairs back in the loop. Returns its dict."""
    t0 = time.time()
    _, srcs, times, rows = resume_feed(slam.st, rv, seq, REVISIT_SRC + REVISIT_FRAMES,
                                       2 * ASYNC_LAG_MAX)
    c, _ = run_transition(path, slam.cam, slam.cfg, slam.event_kw, seq, srcs, times, rows,
                          REVISIT_SRC, slam.device)
    _phase("async", f"C (LAG_MAX {ASYNC_LAG_MAX}, PAIR {ASYNC_PAIR}, harvest at the depth "
                    f"limit): a blank frame and {c['frames_before'] - 1} more in flight, the "
                    f"blank's pair LOST at its harvest ({c['lost_frames']} frames); relocalized "
                    f"on source frame {REVISIT_SRC + c['reloc_attempts'] - 1} "
                    f"({c['reloc_attempts']} attempt(s), keyframe {c['reloc']['kf']}, "
                    f"{c['reloc']['n_in']} inliers); the bias window closed by keyframe "
                    f"{c['closing_kf']}; {TRANSITION_PAIRS} pairs back in the loop, keyframes "
                    f"decided at harvest {c['kf_after']}; 0 frames lost after the "
                    f"relocalization, 0 pending after flush(); map epoch {c['epoch']}; "
                    f"dispatched {c['dispatched']}; matcher launches {c['launches']}, each "
                    f"== twin ({c['twin_checked']} searches) ({time.time() - t0:.1f} s)")
    return c


def async_profile_phase(modes, seq: Sequence, detail):
    """The device-busy share of the phase "async"'s two systems over the
    ASYNC_PROFILE_FRAMES clone frames after their timed runs, last in the
    script."""
    t0 = time.time()
    for r, s in modes:
        profile_async_mode(s, r, seq)
    (a, _), (b, _) = modes
    _phase("async", f"device busy over {a['profile_frames']} more frames (torch.profiler, apart "
                    f"from the timed run, after every other phase): A "
                    f"{100 * a['device_busy_share']:.2f} % ({a['profile_device_ms']:.1f} of "
                    f"{a['profile_wall_ms']:.1f} ms, {a['profile_device_events']} kernels and "
                    f"copies), B {100 * b['device_busy_share']:.2f} % "
                    f"({b['profile_device_ms']:.1f} of {b['profile_wall_ms']:.1f} ms, "
                    f"{b['profile_device_events']}) ({time.time() - t0:.1f} s)")
    for name, r in (("A", a), ("B", b)):
        detail[name].update({k: r[k] for k in ("profile_frames", "profile_wall_ms",
                                               "profile_device_ms", "profile_device_events",
                                               "device_busy_share")})


def _source(lib):
    """A kernel's source, relative to the repository's root."""
    return os.path.relpath(lib.source, os.path.dirname(os.path.abspath(__file__)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script measures the port on a GPU only")
    dev = torch.device("cuda", 0)
    t_start = time.time()
    laps = {}

    def lap(name):
        # the seconds since the previous phase ended (the script's time budget)
        laps[name] = time.time() - t_start - sum(laps.values())
    smi = probes.card_line()
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
                args = search_args(inp)
                kernel_ms[radius] = time_cuda(lambda: hamming_top2_windowed(*args, radius))
                cold_ms[radius] = time_cuda_cold(
                    lambda: hamming_top2_windowed(*args, radius), flush)
                plain_ms[radius] = time_cuda(lambda: search_twin(*args, radius), n=10)
                bounds[radius] = search_bound(inp, radius)
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

    lap("build and kernel")
    # ---- phase 3: path 1, localization against a ground-truth map ----
    p = EUROC
    t0 = time.time()
    # depth kept for path 6 and the multiseq windows' seed maps
    n_depth = max(DEPTH_FRAMES, MULTISEQ_STARTS[-1] + MULTISEQ_STEPS + 1)
    seq_boot = make_sequence(dataclasses.replace(p, n_frames=EUROC_SYSTEM_FRAMES), seed=0,
                             n_depth=n_depth)
    seq = dataclasses.replace(seq_boot, imgs=seq_boot.imgs[:p.n_frames],
                              depths=seq_boot.depths[:p.n_frames],
                              imu=seq_boot.imu[:p.n_frames])
    cam = profile_camera(p, dev)
    ext = factors.extrinsics_from_Tbc(TBC, device=dev)
    m, n_kf = build_map(seq, p, cam, ext, dev)
    n_pts = int(m.mp_active.sum())
    check_pack(m.mp_desc, m.mp_pm1)
    check_pack(m.kf_desc.reshape(-1, 8), m.kf_pm1.reshape(-1, 256))
    _phase("map", f"{EUROC_SYSTEM_FRAMES} frames {p.width}x{p.height} rendered, the first "
                  f"{p.n_frames} of them for paths 1 and 2, the depth of the first "
                  f"{n_depth} kept for path 6 and the phase \"multiseq\"; {n_kf} "
                  f"keyframes, {n_pts}/{p.max_mp} map points "
                  f"({time.time() - t0:.1f} s)")
    # warm-up pass (allocator, cuBLAS/cuSOLVER handles) on a copy of the map,
    # then the measured run with every count set to 0
    run_slice(m, dataclasses.replace(seq, imgs=seq.imgs[:3], imu=seq.imu[:3]),
              dataclasses.replace(p, n_frames=3), cam, ext, dev)
    rec = probes.search_recorder(keep_frames=3, timed=True)
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    res = run_slice(m, seq, dataclasses.replace(p, n_frames=PATH1_FRAMES + 1), cam, ext, dev,
                    recorder=rec, timed=True)
    launches_loc = match_cuda.LIB.launches
    lm_loc = pose_lm_cuda.LIB.launches
    wall = time.time() - t0
    n_loc = PATH1_FRAMES
    summ = res["summary"]
    ms = np.asarray(res["ms"])
    k_ms = sum(s.elapsed_time(e) for _, s, e in rec.events)
    n_fb = int(summ[:, 2].sum())
    _phase("path1", f"{n_loc} frames tracked in {wall:.1f} s; launches "
                    f"{launches_loc}; fallbacks {n_fb}; inliers min {summ[:, 0].min():.0f} "
                    f"median {np.median(summ[:, 0]):.0f}; position RMSE "
                    f"{res['rmse'] * 1e3:.2f} mm")
    _phase("path1", f"ms/frame median {np.median(ms):.2f} p90 "
                    f"{np.percentile(ms, 90):.2f}; kernel share "
                    f"{100.0 * k_ms / ms.sum():.3f}% ({k_ms:.2f} ms of {ms.sum():.1f} ms)")
    if launches_loc < 2 * n_loc:
        raise AssertionError(f"kernel launched {launches_loc} times for {n_loc} frames")
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

    lap("render and path 1")
    # ---- phase 4: path 2, track and map ----
    n_tracked = p.n_frames - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec2 = probes.search_recorder(keep_frames={0, 9, 19})
    match_cuda.LIB.launches = pose_lm_cuda.LIB.launches = 0
    t0 = time.time()
    res2 = run_track_and_map(seq, p, cam, ext, dev, recorder=rec2)
    launches_map = match_cuda.LIB.launches
    lm_map = pose_lm_cuda.LIB.launches
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
    _phase("path2", f"kernel == twin on the {n_real2} real searches of frames 1, 10 and 20")

    del res2["m"], rec2

    lap("path 2")
    # ---- phase 5: path 3, bootstrap from raw frames to VI tracking (5 s init) ----
    detail3, launches_boot, err, res3 = bootstrap_phase("path3", seq_boot, p, cam, dev,
                                                        vi_check=True)
    max_err = max(max_err, err)
    del res3

    lap("path 3")
    # ---- phase 6: path 4, the system at the published configuration (15 s init) ----
    detail4, launches_sys, err, res4 = bootstrap_phase("path4", seq_boot, EUROC_SYSTEM, cam,
                                                       dev, refine=True)
    max_err = max(max_err, err)
    slam4 = res4["slam"]
    mesh, mesh_e = two_shard_mesh(dev), two_shard_mesh(dev, axis="e")
    t0 = time.time()
    mg = run_mesh_gba(slam4, mesh)
    _phase("mesh", f"whole-map VI BA over {mg['n_kf']} keyframes, chunks split over "
                   f"{mg['shards']} shards on {dev} (dist_gba.vi_gba_chunked_sharded) against "
                   f"ba_chunked.vi_gba_chunked on the spread, perturbed map (landmarks a "
                   f"shard {mg['shard_landmarks']}, the unsharded BA moves a keyframe by "
                   f"{mg['move_m'] * 1e3:.2f} mm >= {MESH_MOVE_MIN * 1e3:g}): keyframe positions "
                   f"within {mg['dP_m'] * 1e3:.4f} mm (< {MESH_DP_TOL * 1e3:g}), landmarks within "
                   f"{mg['dX_m'] * 1e3:.4f} mm, final costs {mg['sharded']['cost']:.3f} / "
                   f"{mg['single']['cost']:.3f} ({mg['dcost_rel'] * 100:.5f} %, < "
                   f"{MESH_DCOST_TOL * 100:g}); {mg['sharded']['ms']:.1f} ms sharded, "
                   f"{mg['single']['ms']:.1f} ms single ({time.time() - t0:.1f} s)")

    lap("path 4, chunked, mesh")
    # ---- phase 7: path 5, kidnap / relocalization / loop closing on path 4's system ----
    detail5, launches_rev, err, rv5, lp5 = revisit_phase(res4, seq_boot, EUROC_SYSTEM)
    max_err = max(max_err, err)
    t0 = time.time()
    mp = run_mesh_posegraph(slam4, lp5, mesh_e)
    _phase("mesh", f"the loop phase's essential graph ({mp['n_kf']} keyframes, 40 LM "
                   f"iterations), edges split over {mp['shards']} shards "
                   f"(dist_posegraph.optimize_pose_graph_dist) against "
                   f"posegraph.optimize_pose_graph: keyframes within {mp['dP_m'] * 1e3:.4f} mm "
                   f"(< {MESH_PG_TOL * 1e3:g}), costs {mp['sharded']['cost0']:.5f} -> "
                   f"{mp['sharded']['cost']:.5f} / {mp['single']['cost0']:.5f} -> "
                   f"{mp['single']['cost']:.5f}; {mp['sharded']['ms']:.1f} ms sharded, "
                   f"{mp['single']['ms']:.1f} ms single ({time.time() - t0:.1f} s)")

    lap("path 5, loop, mesh")
    # ---- phase "checkpoint": save, load into a fresh system, track on ----
    t0 = time.time()
    ck_dir = tempfile.TemporaryDirectory()
    ck = run_checkpoint_phase(slam4, seq_boot, rv5, REVISIT_SRC + REVISIT_FRAMES,
                              keep_dir=ck_dir.name)
    launches_ckpt = ck["launches"]
    _phase("checkpoint", f"save_system {ck['save_ms']:.1f} ms, {ck['bytes']} bytes "
                         f"(map, BoW side file, trajectory side file); a fresh SlamSystem "
                         f"{ck['new_system_ms']:.1f} ms; load_system {ck['load_ms']:.1f} ms; "
                         f"{ck['n_tables']} tables bit-equal, host state equal ("
                         f"{ck['kf_slots']} keyframes, loop edges {ck['loop_edges']}, broken "
                         f"chain slots {ck['broken_chain_slots']}, free slots "
                         f"{ck['free_slots']}, {ck['n_hist_ids']} histogram ids), "
                         f"{ck['traj_rows']} trajectory rows kept")
    _phase("checkpoint", f"resumed at keyframe {ck['resume_kf']} (source frame "
                         f"{ck['resume_src']}): frames {ck['frames'][0]}..{ck['frames'][-1]} "
                         f"tracked {ck['n_tracked']} of {len(ck['frames'])}, 0 lost, "
                         f"{ck['keyframes_after']} keyframes inserted, launches {launches_ckpt}, "
                         f"ms/frame median {ck['frame_ms_median']:.1f}; ATE "
                         f"{ck['ate']['rmse'] * 1e3:.2f} mm over those frames (< "
                         f"{RELOC_POS_TOL * 1e3:.0f}), alignment scale "
                         f"{ck['ate']['scale']:.4f} ({time.time() - t0:.1f} s)")

    lap("checkpoint")
    # ---- phase "async": the saved state through the synchronous mode and the frame loop ----
    detail_as, launches_async, err, async_modes = async_phase(ck["path"], slam4, rv5, seq_boot)
    max_err = max(max_err, err)
    ck_dir.cleanup()
    del res4, slam4, lp5

    lap("async")
    # ---- phase 8: path 6, RGB-D from the clone's rendered depth, no IMU ----
    detail6, launches_rgbd, err = depth_phase(
        "path6", seq_boot, dataclasses.replace(p, n_frames=DEPTH_FRAMES), cam, dev)
    max_err = max(max_err, err)

    lap("path 6")
    # ---- phase 9: path 7, rectified stereo + IMU, VI init at 5 s ----
    t0 = time.time()
    right_imgs = render_right(seq_boot, p, range(STEREO_FRAMES))

    def right(i):
        if i not in right_imgs:
            right_imgs.update(render_right(seq_boot, p, range(i, i + 20)))
        return right_imgs[i]
    _phase("path7", f"{len(right_imgs)} right images rendered ({time.time() - t0:.1f} s)")
    detail7, launches_stereo, err = depth_phase("path7", seq_boot, p, cam, dev, right=right)
    max_err = max(max_err, err)

    lap("path 7")
    # ---- phase "evict": capacity eviction of keyframes and points ----
    detail_ev, launches_evict, err = evict_phase(seq_boot, cam, dev)
    max_err = max(max_err, err)

    lap("evict")
    # ---- phase "multiseq": 11 windows as one batched step ----
    detail_ms, rec_ms, err_ms = run_multiseq_phase(seq_boot, p, cam, ext, dev, kernel_ms,
                                                   bounds)

    lap("multiseq")
    # ---- phase "multihost": the process-group Schur solve ----
    detail_mh = run_multihost_phase()

    lap("multihost")
    # ---- phase "bench": tools/bench.py's workloads 1-5 and bench_scaling's part A ----
    detail_bench, launches_bench, launches_bench_b, err_bench = bench_phase(dev)
    max_err = max(max_err, err_bench)

    lap("bench")
    # ---- the phase "async"'s device-busy windows, last: the profiler slows what follows ----
    async_profile_phase(async_modes, seq_boot, detail_as)
    del async_modes
    lap("async profile")
    _phase("time", ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
           + f" s; {time.time() - t_start:.1f} s in all")

    bound_ms, bound_by, bound_detail = bounds[15.0]
    launches_paths = (launches_loc + launches_map + launches_boot + launches_sys
                      + launches_rev + launches_ckpt + launches_rgbd + launches_stereo)
    _phase("launches", f"paths 1-7 and the phase \"checkpoint\": {launches_loc} + "
                       f"{launches_map} + {launches_boot} + {launches_sys} + {launches_rev} + "
                       f"{launches_ckpt} + {launches_rgbd} + {launches_stereo} = "
                       f"{launches_paths}; phase \"async\": {launches_async[0]} + "
                       f"{launches_async[1]} + {launches_async[2]} (A, B, C); phase \"evict\" (N = {EVICT.n_feat}): "
                       f"{launches_evict}; phase \"multiseq\": {rec_ms['launches']}; phase "
                       f"\"bench\": {launches_bench} (frame steps) + {launches_bench_b} "
                       f"(batched steps)")
    launches_paths += sum(launches_async) + launches_evict + launches_bench
    lm_paths = {"path1": lm_loc, "path2": lm_map, "path3": detail3["lm_launches"],
                "path4": detail4["lm_launches"], "path5": detail5["lm_launches"],
                "checkpoint": ck["lm_launches"], "path6": detail6["lm_launches"],
                "path7": detail7["lm_launches"],
                **{f"async {k}": detail_as[k]["lm_launches"] for k in ("A", "B", "C")},
                "evict": detail_ev["lm_launches"],
                "multiseq": detail_ms["pose_lm_launches"]
                + detail_ms["pose_lm_launches_unbatched"],
                "bench": detail_bench["lm_launches"]}
    _phase("launches", "pose LM kernel by path and phase (no timing or check launches): "
                       + ", ".join(f"{k} {v}" for k, v in lm_paths.items())
                       + f" = {sum(lm_paths.values())}")
    vi_paths = {"path3": detail3, "path4": detail4, "path5": detail5, "checkpoint": ck,
                "path6": detail6, "path7": detail7,
                **{f"async {k}": detail_as[k] for k in ("A", "B", "C")}, "evict": detail_ev}
    _phase("launches", "VI pose LM kernel by path and phase, against 2 a VI frame program "
                       "(no timing or check launches): "
                       + ", ".join(f"{k} {d['vi_lm_launches']} ({d['vi_frames']} VI frames)"
                                   for k, d in vi_paths.items())
                       + f" = {sum(d['vi_lm_launches'] for d in vi_paths.values())}")
    vi3 = detail3["vi_lm_check"]
    record = {"kernels": [{
        "name": "hamming_top2_windowed", "route": "cuda", "source": _source(match_cuda.LIB),
        "replaces": KERNEL_REPLACES,
        "shape": "M=16384 x N=1024 (paths 1-7, phases checkpoint, async and bench); "
                 f"M={EVICT.max_mp} x N={EVICT.n_feat} (phase evict)",
        "launches": launches_paths,
        "max_abs_err": max_err, "ms": kernel_ms[15.0], "plain_ms": plain_ms[15.0],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}, {
        "name": "hamming_top2_windowed (batched)", "route": "cuda", "source": _source(match_cuda.LIB),
        "replaces": KERNEL_REPLACES,
        "shape": f"B={len(MULTISEQ_STARTS)} x M=16384 x N=1024 (phase multiseq); B=8 (phase "
                 "bench)",
        "launches": rec_ms["launches"] + launches_bench_b,
        "max_abs_err": max(err_ms, err_bench), "ms": rec_ms["ms"],
        "plain_ms": rec_ms["plain_ms"], "bound_ms": rec_ms["bound_ms"],
        "bound_by": rec_ms["bound_by"], "library_ms": None}, {
        "name": "pose_only_visual_lm", "route": "cuda", "source": _source(pose_lm_cuda.LIB),
        "replaces": None,
        "shape": f"B={len(MULTISEQ_STARTS)} x O={p.n_feat} x Np={p.max_mp}, "
                 f"{MULTISEQ_ITERS} iterations (phase multiseq's timed solve); every "
                 "path's pose_only_visual on the card",
        "launches": sum(lm_paths.values()),
        "max_abs_err": rec_ms["pose_lm"]["max_abs_err"], "ms": rec_ms["pose_lm"]["ms"],
        "plain_ms": rec_ms["pose_lm"]["plain_ms"], "bound_ms": rec_ms["pose_lm"]["bound_ms"],
        "bound_by": rec_ms["pose_lm"]["bound_by"], "library_ms": None}, {
        "name": "pose_only_vi_lm", "route": "cuda", "source": _source(pose_vi_lm_cuda.LIB),
        "replaces": None,
        "shape": f"O={vi3['O']} x Np={vi3['Np']}, {vi3['iters']} iterations with the marginal "
                 "(path 3's timed solve); every VI frame's two ba_vi.pose_only_vi on the card",
        "launches": sum(d["vi_lm_launches"] for d in vi_paths.values()),
        "max_abs_err": vi3["gaps_over_tol"]["dP"] * pose_vi_lm_cuda.POSE_VI_LM_POS_TOL,
        "ms": vi3["ms"],
        "plain_ms": vi3["twin_ms"], "bound_ms": vi3["bound_ms"], "bound_by": vi3["bound_by"],
        "library_ms": None}]}
    strip = lambda e: {k: v for k, v in e.items() if k != "costs"}
    detail = {"card": smi, "kernel_ms_by_radius": {f"{r:g}": kernel_ms[r] for r in RADII},
              "kernel_cold_ms_by_radius": {f"{r:g}": cold_ms[r] for r in RADII},
              "plain_ms_by_radius": {f"{r:g}": plain_ms[r] for r in RADII},
              "bound_ms_by_radius": {f"{r:g}": bounds[r][0] for r in RADII},
              "bound_detail_r15": bound_detail,
              "path1": {"frames": n_loc, "launches": launches_loc,
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
              "path3": detail3, "path4": detail4, "path5": detail5, "path6": detail6,
              "path7": detail7, "mesh": {"gba": mg, "posegraph": mp}, "checkpoint": ck,
              "async": detail_as, "evict": detail_ev,
              "multiseq": detail_ms, "multihost": detail_mh, "bench": detail_bench,
              "phase_seconds": laps, "seconds": time.time() - t_start}
    print(json.dumps(detail, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)),
          flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
