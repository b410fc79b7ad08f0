"""The SLAM system: configuration, the orchestrator class and map
initialization (port of mc_slam_tpu/pipeline/system.py).

`SlamSystem(cam, cfg, Tbc).track(img, t, imu)` is the port's entry point. Two
modes, chosen at construction by `MC_SLAM_LAG_MAX` and `MC_SLAM_PAIR` (the JAX
package's variables; attributes `LAG_MAX`, `PAIR`):

* both unset or 1, the default: synchronous. A frame is tracked, its summary
  read and its decisions taken (LOST, keyframe -> event -> culling -> loop
  closing, VI-init attempt) before `track` returns: the decisions of the JAX
  package's parity mode (one frame a dispatch, pipeline depth 1), taken at
  the end of the same call rather than at the start of the next;
* otherwise the asynchronous frame loop (pipeline/frameloop.py, the JAX
  package's default with LAG_MAX 12, PAIR 2): a steady frame is dispatched
  and its decisions taken up to LAG_MAX entries later, PAIR VI frames a
  dispatch; the keyframe event's host half and the loop-closing stages are
  harvested when their copies land. Off the steady state (not OK, a depth
  frame, the relocalization window) every entry is drained first and the
  frame takes the synchronous path; after a relocalization a keyframe's
  event there is dispatched as the loop's are, its host half left to the
  loop's harvest (the JAX `_track_sync`). `flush()` (and `get_trajectory`,
  `global_refine`, `set_localization_mode`, `io.checkpoint.save_system`)
  drains.

The class holds the `MappingState` and `TrackState` that the step functions
of mapping_ctl / tracking_ctl / viinit_ctl work on, and the frame loop's
`LoopState` (`fl`), and exposes their fields under the JAX class's attribute
names; it keeps no second copy of them.

Place recognition is on by default, as in the JAX class: the constructor
loads the shipped 32768-word vocabulary and builds the `LoopDetector`; every
keyframe registers its BoW histogram; a LOST system relocalizes against it
(`tracking_ctl.relocalize`), after VI init followed by the 20-frame window
that solves the biases again; every keyframe event past the gates ends in
`loopctl.try_close_loop` (`enable_loop_closing`, True by default).

Depth sensors (System.h's RGBD and STEREO modes): `track(img, t, imu,
depth=)` looks up an RGB-D map at each feature's raw pixel, `track(img, t,
imu, img_right=)` matches a rectified right image (`frontend.stereo`). The
first depth frame with 50 points builds a metric map at once (one keyframe
at the origin, Tracking::StereoInitialization: no two-view RANSAC and no
VI-init scale); from then on every pose solve and BA carries the u_right
row, every keyframe adds its nearest unmatched depth points, and the VI
window BA takes its XYZ form. With and without the IMU.

`enable_mesh` shards the whole-map VI BA and the essential graph over a
device mesh (`parallel/`).

Under `utils.metrics.tracing(T)` every stage the system opens on its
`timers` ("track", "extract", "lm_*", ...) is also a span of `T`, and the
spans of the library code it calls ("tracking.search", "imu.preintegrate",
"mapping.event", "mapping.vi_ba", ...) nest under them; with no timer
active, `timers` records as before and nothing else does. The counters
`n_vi_frames`, `n_vi_fallbacks` (VI frames that took the visual fallback's
answer), `n_kf_events` and `n_lost_frames` count what the calls did.

Also here: the monocular two-view bootstrap `try_initialize`
(SlamSystem._try_initialize), as a module function of explicit state.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera, undistort_points
from mc_slam_tpu_torch.device import resolve
from mc_slam_tpu_torch.frontend import bow, extractor, matching, stereo
from mc_slam_tpu_torch.geometry import init2view
from mc_slam_tpu_torch.imu.navstate import navstate_identity
from mc_slam_tpu_torch.imu.preintegration import IMUNoise, euroc_noise
from mc_slam_tpu_torch.parallel import dist_ba
from mc_slam_tpu_torch.pipeline import (frameloop, loopclosing, loopctl, mapping, mapping_ctl,
                                        tracking, tracking_ctl)
from mc_slam_tpu_torch.pipeline.pipebase import LOST, NO_IMAGES_YET, NOT_INITIALIZED, OK
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import MapState, empty_map
from mc_slam_tpu_torch.solver import factors
from mc_slam_tpu_torch.solver.factors import Extrinsics
from mc_slam_tpu_torch.utils.metrics import StageTimer, span


@dataclasses.dataclass
class SlamConfig:
    """The JAX package's SlamConfig, field by field with its defaults
    (examples/eval_clone.py's euroc profile sets max_kf=512, max_mp=16384,
    n_feat=1024, n_levels=8, local_window=20, use_imu=True)."""
    max_kf: int = 128
    max_mp: int = 4096
    n_feat: int = 512
    n_levels: int = 4
    local_window: int = 10          # VI local window (EuRoC uses 20)
    ba_window: int = 8              # covisible keyframes in the visual local BA
    min_init_matches: int = 60
    min_track_inliers: int = 12
    kf_min_gap: int = 3             # frames
    kf_max_gap: int = 20
    kf_ref_ratio: float = 0.8       # NeedNewKeyFrame ratio (src/Tracking.cpp:1865)
    covis_th: int = 15              # covisibility edge weight (src/KeyFrame.cpp:668)
    # the JAX package integrates IMU rows in fixed pieces of this length; the
    # port's preintegration takes any number of rows and does not read it
    max_imu_per_kf: int = 256
    vi_init_time: float = 15.0      # seconds (config/euroc.yaml:6)
    vi_init_max_cond: float = 5e4   # step-3 condition-number acceptance
    vi_init_scale_tol: float = 0.5  # |s - s_star| / s agreement of steps 2 and 3
    g_mag: float = 9.81
    use_imu: bool = False
    # the VI window BA in its anchored inverse-depth form (LocalBAPRVIDP);
    # False, or a depth sensor, takes the XYZ form
    use_idp_ba: bool = True
    # early exit of the window-BA LM: once an accepted step improves the cost by
    # less than ba_rtol relative, the remaining iterations keep the state.
    # 0 disables; monocular-VI scale is a low-gradient mode, keep 0
    ba_rtol: float = 0.0
    track_rtol: float = 0.0         # the same for the per-frame pose-only LM
    refresh_stats: bool = True      # descriptors, normals, scale bands after fusion
    stereo_baseline: float = 0.11   # metres (EuRoC-like rig): bf = fx * baseline
    cull_min_obs: int = 3           # 3 mono, 2 for depth sensors (nThObs)
    # PnP RANSAC hypotheses a relocalization candidate (and in the
    # reference-keyframe fallback): the JAX package's pnp_ransac default. Its
    # 6-point DLT is near-degenerate on the near-planar point sets of a room's
    # walls, so at 256 few clean samples reach the 12-inlier bar (PERF.md has
    # the success rate by count); the hypotheses are one batch on the card
    pnp_iters: int = 256
    seed: int = 0


class InitAttempt(NamedTuple):
    """What one two-view attempt did (host values; `two_view` stays on the
    device)."""
    ok: bool                   # the map now holds two keyframes and the first points
    reset_ref: bool            # too few matches: make this frame the new reference
    n_matches: int
    two_view: init2view.TwoViewResult | None
    ba: mapping_ctl.BAStats | None


def try_initialize(m: MapState, st: mapping_ctl.MappingState,
                   cfg: SlamConfig, cam: Camera, ext: Extrinsics,
                   noise, ref, feats, uv, t, frame_id: int, imu_rows,
                   generator: torch.Generator | None = None, idx_samples=None,
                   detector=None):
    """Monocular initialization (Tracking::MonocularInitialization): match
    the reference frame against this one, solve the two-view geometry from
    200 8-point samples, rescale so that the median depth is 1, insert
    both frames as keyframes 0 and 1, allocate the triangulated points with
    their scale bands and normals, and run the whole-map visual BA.

    ref: (feats0, uv0, t0) of the reference frame; imu_rows: the (T, 7) IMU
    rows between the reference frame and this one, or None (they become
    keyframe 1's preintegration; the JAX package hands them to keyframe 0 and
    leaves keyframe 1 with none). idx_samples: (200, 8) sample indices; drawn from
    `generator` when not given. detector: the `LoopDetector` that takes both
    keyframes' BoW histograms. The host reads, one copy each:
    the match count, then ok / t / good / Xw of the two-view result.
    Returns (m, InitAttempt)."""
    f0, uv0, t0 = ref
    dev = uv.device
    idx, _, ok = matching.search_for_initialization(
        uv0, f0.desc_pm1, f0.valid, uv, feats.desc_pm1, feats.valid,
        radius=100.0, ratio=0.9, f0_angle=f0.angle, f1_angle=feats.angle)
    n = int(torch.sum(ok))
    if n < cfg.min_init_matches:
        return m, InitAttempt(False, True, n, None, None)
    c = torch.stack([cam.cx, cam.cy])
    f = torch.stack([cam.fx, cam.fy])
    xn0 = (uv0 - c) / f
    xn1 = ((uv - c) / f)[idx]
    w = ok.to(torch.float32)
    if idx_samples is None:
        idx_samples = init2view.draw_samples(w, generator=generator)
    res = init2view.initialize_two_view(idx_samples, xn0, xn1, w, float(cam.fx))
    N = xn0.shape[0]
    host = torch.cat([res.ok.to(torch.float32).reshape(1), res.t, res.R.reshape(-1),
                      res.good.to(torch.float32), res.Xw.reshape(-1),
                      idx.to(torch.float32)]).cpu().numpy()
    if host[0] < 0.5:
        return m, InitAttempt(False, False, n, res, None)
    C1, R1 = host[1:4], host[4:13].reshape(3, 3)
    good = host[13:13 + N] > 0.5
    Xw = host[13 + N:13 + 4 * N].reshape(N, 3)
    idx_h = host[13 + 4 * N:].astype(np.int64)
    # scale: the median depth of the good points -> 1 (CreateInitialMapMonocular)
    med = float(np.median(Xw[good][:, 2])) if good.sum() else 1.0
    if med <= 1e-6:
        return m, InitAttempt(False, False, n, res, None)
    scale = 1.0 / med
    Xw = Xw * scale
    C1 = C1 * scale

    # keyframe 0 at the camera origin, keyframe 1 at (R, C1); stored as body
    # poses through the extrinsics
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ns0 = navstate_identity(device=dev)
    m, slot0 = mapping_ctl.insert_keyframe(m, st, cfg, ns0, f0, uv0, t0, frame_id, None,
                                           noise, cam_frame=True, ext=ext, detector=detector)
    m, slot1 = mapping_ctl.insert_keyframe(m, st, cfg, ns0._replace(P=t32(C1), R=t32(R1)),
                                           feats, uv, t, frame_id, imu_rows, noise,
                                           cam_frame=True, ext=ext, detector=detector)
    # map points and associations, in feature order, into slots 0 .. n_good-1
    good_idx = np.nonzero(good)[0]
    Xg = Xw[good_idx].astype(np.float32)
    dist = np.linalg.norm(Xg, axis=1).astype(np.float32)
    lvl = f0.level.cpu().numpy()[good_idx].astype(np.float32)
    max_d = dist * (1.2 ** lvl)
    min_d = mapping.band_min_dist(max_d, cfg.n_levels)
    k = len(good_idx)
    gi = torch.as_tensor(good_idx, device=dev)
    gi1 = torch.as_tensor(idx_h[good_idx], device=dev)
    slots32 = torch.arange(k, dtype=torch.int32, device=dev)

    def head(field, value):
        out = field.clone()
        out[:k] = value
        return out

    kf_mp = m.kf_mp.clone()
    kf_mp[slot0, gi] = slots32
    kf_mp[slot1, gi1] = slots32
    m = m._replace(
        mp_pos=head(m.mp_pos, t32(Xg)),
        mp_desc=head(m.mp_desc, f0.desc[gi]),
        mp_pm1=head(m.mp_pm1, f0.desc_pm1[gi]),
        mp_normal=head(m.mp_normal, t32(Xg / np.maximum(dist, 1e-9)[:, None])),
        mp_min_dist=head(m.mp_min_dist, t32(min_d)),
        mp_max_dist=head(m.mp_max_dist, t32(max_d)),
        mp_ref_kf=head(m.mp_ref_kf, slot0),
        mp_angle=head(m.mp_angle, f0.angle[gi]),
        mp_first_kf=head(m.mp_first_kf, 0),
        mp_found=head(m.mp_found, 2.0),
        mp_visible=head(m.mp_visible, 2.0),
        mp_active=head(m.mp_active, True),
        kf_mp=kf_mp)
    # the initial visual BA over the two views (GlobalBundleAdjustment(20))
    gw = torch.zeros(3, device=dev)         # no factor reads gravity before VI init
    m, ba_stats = mapping_ctl.local_ba(m, st, cfg, cam, ext, gw, noise, force_all=True)
    return m, InitAttempt(True, False, n, res, ba_stats)


class SlamSystem:
    """Monocular (+IMU) SLAM engine. Feed frames with `track(img, t[, imu])`,
    read the result with `get_trajectory()`.

    Built on `device` (the card when none is given). The public names are the
    JAX class's: `track`, `upload`, `flush`, `get_trajectory`,
    `global_refine`, `reset`, `set_localization_mode`, and the attributes
    `state`, `m`, `vi_inited`, `gw`, `kf_slots`, `n_kf`, `frame_id`,
    `LAG_MIN`, `LAG_MAX`, `PAIR`,
    `n_lost_frames`, `n_vi_frames`, `n_vi_fallbacks`, `n_kf_events`, `events`,
    `timers`, `traj`, `last_ns`, `last_pose`,
    `viinit_log`, `loop`, `enable_loop_closing`, `n_loops_closed`,
    `loop_edges`, `reloc_buf`, `reloc_window`, `sensor_depth`, `mesh`, `mesh_e`;
    `enable_mesh`; `io.checkpoint.save_system` / `load_system` persist and
    restore it. `st` (mapping_ctl.MappingState), `ts`
    (tracking_ctl.TrackState, None until the map is initialized) and `fl`
    (frameloop.LoopState) hold the state itself."""

    def __init__(self, cam: Camera, cfg: SlamConfig | None = None,
                 Tbc: np.ndarray | None = None, noise: IMUNoise | None = None,
                 device=None):
        self.device = resolve(device)
        self.cam = cam
        self.cfg = cfg or SlamConfig()
        self._Tbc = Tbc
        self.ext = (factors.extrinsics_from_Tbc(Tbc, device=self.device) if Tbc is not None
                    else factors.identity_extrinsics(device=self.device))
        self.noise = noise or euroc_noise(device=self.device)
        self.m = empty_map(self.cfg.max_kf, self.cfg.max_mp, self.cfg.n_feat,
                           device=self.device)
        self.state = NO_IMAGES_YET
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed)

        self.st = mapping_ctl.MappingState()
        self.ts: tracking_ctl.TrackState | None = None
        self.traj = TrajStore()
        self.frame_id = 0
        self.last_time = 0.0
        self.n_lost_frames = 0
        self.n_vi_frames = 0            # frames through the VI frame program
        self.n_vi_fallbacks = 0         # ... that took the visual fallback's answer
        self.n_kf_events = 0            # keyframe events
        # diagnostic log: (frame_id, kind, detail) for "init", "vi_init",
        # "kf_culled", "lost", "reloc", "lc_diag", "sim3_dispatch",
        # "sim3_result", "verify_result", "loop"
        self.events: list[tuple] = []
        self.localization_only = False
        self._ref = None                # (feats, uv, t) of the two-view reference frame
        self._init_rows: list = []      # IMU rows since the reference frame
        self.timers = StageTimer(self.device)
        self.viinit_log = None          # set to utils.metrics.VIInitLog(dir) to enable
        # place recognition (loop closing and relocalization): the shipped
        # trained vocabulary when present, else a random one
        vgen = torch.Generator(device=self.device)
        vgen.manual_seed(self.cfg.seed + 1)
        self._loopctx = loopctl.LoopContext(
            detector=loopclosing.LoopDetector(
                bow.load_default_vocab(vgen, device=self.device), self.cfg.max_kf,
                idf=bow.load_default_idf(device=self.device)),
            generator=self._gen, events=self.events, timers=self.timers)
        self.reloc_window = 20          # frames of the bias window after a relocalization
        # constants of the frame programs, staged once
        self._consts = tracking_ctl.frame_constants(self.noise, self.device)
        self._gw0 = torch.tensor([0.0, 0.0, -self.cfg.g_mag], device=self.device)
        self._pinned: list = []         # staging ring of `upload`: [buffer, copy-done event]
        # port-only sizes of the keyframe event (mapping_ctl.keyframe_event)
        self.event_kw = dict(max_new=256, ba_Pw=4096)
        # what the last call did, for callers and measurement scripts
        self.last_init: InitAttempt | None = None
        self.last_outcome: tracking_ctl.FrameOutcome | None = None
        self.last_gba: mapping_ctl.BAStats | None = None
        # optional callables(stage_name) called beside the system's own stage
        # marks of a keyframe event / a VI-init attempt
        self.event_probe = None
        self.vi_probe = None
        # the frame loop: an entry is harvested once its summary has landed
        # and LAG_MIN entries are in flight, at the latest at LAG_MAX; PAIR
        # VI frames a dispatch. 1 / 1 (the default here; the JAX package's is
        # 12 / 2) is the synchronous path
        self.LAG_MIN = 1
        self.LAG_MAX = int(os.environ.get("MC_SLAM_LAG_MAX", "1"))
        self.PAIR = int(os.environ.get("MC_SLAM_PAIR", "1"))
        self.fl = frameloop.LoopState()

    # ---- the state, under the JAX class's names ----
    vi_inited = property(lambda self: self.st.vi_inited)
    sensor_depth = property(lambda self: self.st.sensor_depth)
    kf_slots = property(lambda self: self.st.kf_slots)
    n_kf = property(lambda self: self.st.n_kf)

    @property
    def gw(self):
        return self.ts.gw if self.ts is not None else self._gw0

    @property
    def last_pose(self):
        """Body (P, R), world-from-body, of the last tracked frame."""
        if self.ts is None:
            return (torch.zeros(3, device=self.device), torch.eye(3, device=self.device))
        return (self.ts.P, self.ts.R)

    @last_pose.setter
    def last_pose(self, pose):
        self.ts.P, self.ts.R = (torch.as_tensor(a, dtype=torch.float32, device=self.device)
                                for a in pose)

    @property
    def velocity(self):
        """The constant-velocity model: the last step's relative motion (dP, dR)."""
        return (self.ts.dP, self.ts.dR)

    @velocity.setter
    def velocity(self, vel):
        self.ts.dP, self.ts.dR = (torch.as_tensor(a, dtype=torch.float32, device=self.device)
                                  for a in vel)

    @property
    def last_ns(self):
        if self.ts is None or self.ts.ns is None:
            return navstate_identity(device=self.device)
        return self.ts.ns

    @last_ns.setter
    def last_ns(self, ns):
        self.ts.ns = ns

    @property
    def loop(self):
        """The `LoopDetector` (vocabulary, idf, one histogram per keyframe
        slot); settable, for a vocabulary trained on the scene at hand."""
        return self._loopctx.detector

    @loop.setter
    def loop(self, detector):
        self._loopctx.detector = detector

    n_loops_closed = property(lambda self: self.st.n_loops_closed)
    loop_edges = property(lambda self: self.st.loop_edges)

    @property
    def reloc_buf(self):
        """The frames buffered since a relocalization after VI init; None
        outside that window."""
        return self.ts.reloc_buf if self.ts is not None else None

    @property
    def enable_loop_closing(self):
        return self._loopctx.enabled

    @enable_loop_closing.setter
    def enable_loop_closing(self, on):
        self._loopctx.enabled = bool(on)

    mesh = property(lambda self: self.st.mesh)
    mesh_e = property(lambda self: self.st.mesh_e)

    def enable_mesh(self, mesh=None, mesh_e=None):
        """Route the whole-map optimizations through a device mesh
        (`parallel.dist_ba.Mesh`): the chunked VI GBA becomes landmark-sharded
        (`parallel.dist_gba`: per-shard Schur partials, one reduction of the
        camera system an iteration) and the loop's essential graph
        edge-sharded (`parallel.dist_posegraph`, over `mesh_e`). With no
        arguments: every visible CUDA device, a no-op with one. A mesh may
        name one device twice (`dist_ba.make_mesh(devices=["cuda:0"] * 2)`);
        its first device should be the system's, where the state lives."""
        if mesh is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" else 0
            if n <= 1:
                return
            mesh = dist_ba.make_mesh(n)
            mesh_e = dist_ba.make_mesh(n, axis="e")
        self.st.mesh = mesh
        self.st.mesh_e = mesh_e

    def set_localization_mode(self, on: bool):
        """Activate / DeactivateLocalizationMode: track against the frozen
        map, inserting no keyframe and mapping nothing (the frames in flight
        are decided first)."""
        frameloop.harvest_pending(self, drain=True)
        self.localization_only = bool(on)

    def reset(self):
        """System::Reset: clear the map and start over."""
        self.__init__(self.cam, self.cfg, Tbc=self._Tbc, noise=self.noise,
                      device=self.device)

    # ------------------------------------------------------------------
    def upload(self, img):
        """Stage a frame on the device ahead of `track`, which accepts the
        returned tensor. uint8 stays uint8 (a quarter of the bytes; the
        extractor casts on the device). A numpy image goes through one of two
        pinned staging buffers and an asynchronous copy, so a caller with a
        frame of lookahead overlaps the transfer with tracking."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device, non_blocking=True)
        a = np.asarray(img)
        if a.dtype not in (np.uint8, np.float32):
            a = a.astype(np.float32)
        src = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return src
        if len(self._pinned) < 2 or self._pinned[0][0].shape != src.shape \
                or self._pinned[0][0].dtype != src.dtype:
            self._pinned = [[torch.empty_like(src).pin_memory(), None] for _ in range(2)]
        slot = self._pinned.pop(0)
        self._pinned.append(slot)
        if slot[1] is not None:
            slot[1].synchronize()       # the copy that last read this buffer is done
        slot[0].copy_(src)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out

    def _imu_rows(self, imu):
        if imu is None or len(imu) == 0:
            return None
        if isinstance(imu, torch.Tensor):
            return imu.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(imu, np.float32)).to(self.device)

    @property
    def async_loop(self) -> bool:
        """Whether `track` takes the frame loop on steady frames."""
        return self.LAG_MAX > 1 or self.PAIR > 1

    def _summary_ready(self, p) -> bool:
        """Whether a pending entry's summary copy has landed (the JAX
        method's name; a test may replace it on the instance to pin the
        readiness rule)."""
        return p.summary.ready()

    def track(self, img, t, imu=None, depth=None, img_right=None) -> bool:
        """Process one frame. img: (H, W) uint8 or float32, a host array or a
        tensor staged by `upload`; t: time in seconds; imu: (T, 7) rows
        [gyro, acc, dt] since the previous frame; depth: an (H, W) metric
        depth map (RGB-D); img_right: the rectified right image (stereo).
        Returns whether the frame was tracked (False while the map is not
        initialized, and when LOST). A LOST system tries to relocalize on
        every frame, and so does the frame on which tracking is lost. In the
        frame loop a steady frame returns True at once: its loss shows at a
        later call (state LOST, a "lost" event)."""
        rows = self._imu_rows(imu)
        img = self.upload(img)
        t = float(t)
        if not self.async_loop:
            return self._track_sync(img, t, rows, depth, img_right)
        # the due decisions first, before this frame's rows join: a keyframe
        # cut at an earlier frame takes exactly its own IMU span
        frameloop.harvest_pending(self)
        if self.state == OK and depth is None and img_right is None \
                and self.ts.reloc_buf is None:
            ts = self.ts
            if rows is not None and rows.shape[0]:
                ts.imu_since_kf.append((self.frame_id, rows))
                ts.imu_since_frame.append((self.frame_id, rows))
            with self.timers.stage("track"):
                if not self.st.vi_inited:
                    frameloop.dispatch_frame_visual(self, img, t)
                elif self.PAIR > 1:
                    frameloop.pair_push(self, img, t)
                else:
                    frameloop.dispatch_frame_vi(self, img, t)
            self.last_time = t
            self.frame_id += 1
            return True
        # off the steady state: every frame in flight is decided first
        frameloop.harvest_pending(self, drain=True)
        return self._track_sync(img, t, rows, depth, img_right)

    def _track_sync(self, img, t, rows, depth=None, img_right=None) -> bool:
        """One frame through the synchronous path (see `track`)."""
        cfg = self.cfg
        ok = False
        depth_mode = depth is not None or img_right is not None
        frame = fd = None
        if depth_mode or self.state != OK or self.ts.reloc_buf is not None:
            # off the steady state, and a depth frame, extract first
            with self.timers.stage("extract"):
                feats = extractor.extract(img, n_features=cfg.n_feat, n_levels=cfg.n_levels)
                uv = undistort_points(self.cam, feats.xy)
            frame = (feats, uv)
            if depth_mode:
                fd = self._frame_depth(feats, uv, depth, img_right)
                self.st.sensor_depth = True
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            if fd is not None:
                with self.timers.stage("initialize"):
                    ok = self._initialize_from_depth(feats, uv, fd, t, rows)
            elif self.state == NO_IMAGES_YET:
                self._ref, self._init_rows = (feats, uv, t), []
                self.state = NOT_INITIALIZED
            else:
                with self.timers.stage("initialize"):
                    ok = self._try_initialize(feats, uv, t, rows)
        elif self.state == LOST or self.ts.reloc_buf is not None:
            # once LOST, straight to relocalization (running the trackers from
            # a garbage pose can accept on accidental inliers); while the bias
            # window is open, visual tracking against the map
            self._keep_rows(rows)
            if self.state == LOST:
                ok = self._relocalize(feats, uv, t, fd)
                if not ok:
                    self._note_lost(dict(mode="lost", n_in=0, reloc=self.ts.reloc_diag))
            else:
                with self.timers.stage("track"):
                    ok = self._track_reloc_window(feats, uv, t, fd)
        else:
            with self.timers.stage("track"):
                ok = self._track_frame(img, t, rows, frame, fd)
        self.last_time = t
        self.frame_id += 1
        return ok

    def _frame_depth(self, feats, uv, depth, img_right) -> tracking_ctl.FrameDepth:
        """The depth sensor's per-feature data (SlamSystem._feature_depth and
        _cur_ur): metric depth from an RGB-D map, looked up at each feature's
        RAW pixel (truncated to int, clipped to the image), or from a
        rectified right image (extracted as the left one, stereo-matched;
        only points closer than 35 baselines, the reference's mThDepth);
        -1 where there is none. Then the virtual right-image u = u - bf / z."""
        cfg = self.cfg
        if depth is not None:
            dm = torch.as_tensor(np.asarray(depth, np.float32), device=self.device) \
                if not isinstance(depth, torch.Tensor) else depth.to(self.device, torch.float32)
            xs = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, dm.shape[1] - 1)
            ys = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, dm.shape[0] - 1)
            d = dm[ys, xs]
            d = torch.where(d > 1e-3, d, -1.0)
        else:
            with self.timers.stage("stereo"):
                fR = extractor.extract(self.upload(img_right), n_features=cfg.n_feat,
                                       n_levels=cfg.n_levels)
                uvR = undistort_points(self.cam, fR.xy)
                d, _ = stereo.stereo_depth(uv, feats.desc_pm1, feats.valid, uvR, fR.desc_pm1,
                                           fR.valid, self.cam.fx, cfg.stereo_baseline)
                d = torch.where(d < 35.0 * cfg.stereo_baseline, d, -1.0)
        bf = mapping_ctl.stereo_bf(self.cam, cfg)
        ur = torch.where(d > 1e-3, uv[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0)
        return tracking_ctl.FrameDepth(depth=d, ur=ur, bf=bf)

    def _initialize_from_depth(self, feats, uv, fd, t, rows):
        """Tracking::StereoInitialization: with at least 50 valid features
        with depth, this frame becomes keyframe 0 at the origin (its u_right
        table, the IMU rows since the first frame) with those features'
        points, and tracking starts at once (state OK). One host read."""
        cfg = self.cfg
        if rows is not None:
            self._init_rows.append(rows)
        good = (feats.valid & (fd.depth > 1e-3)).cpu().numpy()
        if good.sum() < 50:
            return False
        imu_rows = torch.cat(self._init_rows) if self._init_rows else None
        ns0 = navstate_identity(device=self.device)
        self.m, slot = mapping_ctl.insert_keyframe(self.m, self.st, cfg, ns0, feats, uv, t,
                                                   self.frame_id, imu_rows, self.noise,
                                                   detector=self.loop, ur=fd.ur)
        Xw = mapping_ctl.depth_to_world(self.cam, self.ext, uv, fd.depth, ns0.P, ns0.R)
        self.m, _, _ = mapping_ctl.alloc_points(self.m, Xw, feats.desc, feats.desc_pm1,
                                                feats.level, slot, good, cfg.n_levels,
                                                self.frame_id, angle=feats.angle)
        self._ref, self._init_rows = None, []
        self.ts = tracking_ctl.start_tracking(self.m, self.st, cfg.g_mag, t, traj=self.traj)
        self.ts.n_inliers = int(good.sum())
        self.traj.append(tracking._traj_row(self.m, self.ts.P, self.ts.R, slot), t, slot,
                         self.st.kf_id_host[slot])
        self.state = OK
        self.events.append((self.frame_id, "init", dict(n_points=int(good.sum()))))
        return True

    def _note_lost(self, detail):
        self.n_lost_frames += 1
        self.events.append((self.frame_id, "lost", detail))

    def _try_initialize(self, feats, uv, t, rows):
        """The two-view attempt of this frame against the reference frame; on
        success tracking starts at keyframe 1. IMU rows given since the
        reference frame become keyframe 1's preintegration."""
        if rows is not None:
            self._init_rows.append(rows)
        imu_rows = torch.cat(self._init_rows) if self._init_rows else None
        self.m, att = try_initialize(self.m, self.st, self.cfg, self.cam, self.ext,
                                     self.noise, self._ref, feats, uv, t, self.frame_id,
                                     imu_rows, generator=self._gen, detector=self.loop)
        self.last_init = att
        if att.reset_ref:
            self._ref, self._init_rows = (feats, uv, t), []
        if not att.ok:
            return False
        self._ref, self._init_rows = None, []
        self.ts = tracking_ctl.start_tracking(self.m, self.st, self.cfg.g_mag, t,
                                              traj=self.traj)
        slot = self.st.last_kf_slot
        self.traj.append(tracking._traj_row(self.m, self.ts.P, self.ts.R, slot), t, slot,
                         self.st.kf_id_host[slot])
        self.state = OK
        self.events.append((self.frame_id, "init", dict(n_matches=att.n_matches)))
        return True

    def _track_frame(self, img, t, rows, frame=None, fd=None):
        """One frame in state OK: the visual or the VI frame program and the
        decisions on its summary (tracking_ctl.track_visual / track_vi);
        frame / fd: a depth frame's (feats, uv) and FrameDepth."""
        cfg, st = self.cfg, self.st
        ev_mark = self._marks("lm_", self.event_probe)
        kw = dict(event_timer=ev_mark, allow_kf=not self.localization_only,
                  event_kw=self.event_kw, loop=self._loopctx, frame=frame, depth=fd)
        if st.vi_inited:
            self.m, out = tracking_ctl.track_vi(
                self.m, st, cfg, self.ts, img, t, self.frame_id, rows, self.cam, self.ext,
                self.noise, self._consts, **kw)
            self.n_vi_frames += 1
            self.n_vi_fallbacks += bool(out.used_fallback)
        else:
            self.m, out = tracking_ctl.track_visual(
                self.m, st, cfg, self.ts, img, t, self.frame_id, rows, self.cam, self.ext,
                self.noise, vi_mark=self._marks("vi_", self.vi_probe),
                vi_log=self.viinit_log, generator=self._gen, **kw)
        self.n_kf_events += out.keyframe is not None
        self.last_outcome = out
        if out.state == LOST:
            self.state = LOST
            # the frame that was lost tries to relocalize at once
            if self._relocalize(out.feats, out.uv, t, fd):
                return True
            self._note_lost(dict(mode="vi" if st.vi_inited else "vis", n_in=out.n_inliers))
            return False
        self._note_event(out)
        return True

    def _note_event(self, out):
        if out.event is not None and out.event.removed:
            self.events.append((self.frame_id, "kf_culled",
                                dict(slots=list(out.event.removed))))
        if out.vi is not None and out.vi.accepted:
            self.events.append((self.frame_id, "vi_init",
                                dict(n_kf=out.vi.n_kf, scale=out.vi.scale, cond=out.vi.cond)))

    def _keep_rows(self, rows):
        """IMU rows of a frame that the trackers do not consume themselves."""
        if rows is not None and rows.shape[0]:
            self.ts.imu_since_kf.append((self.frame_id, rows))
            self.ts.imu_since_frame.append((self.frame_id, rows))

    def _after_sync_frame(self, feats, uv, t, feat_mp, n_in, mode, used_fb=False, fd=None):
        """The tail of a frame tracked off the steady state (relocalized, or
        inside the bias window): its trajectory row and the keyframe decision
        (-> event -> loop closing); never a keyframe while the window is open.
        In the frame loop the keyframe takes `_sync_keyframe_in_loop`, and the
        row is written last, as the JAX `_track_sync` writes it
        (mc_slam_tpu/pipeline/system.py:374-382)."""
        st, ts, in_loop = self.st, self.ts, self.async_loop
        event = None
        if in_loop:
            slot, closed = self._sync_keyframe_in_loop(feats, uv, t, feat_mp, n_in, fd)
        else:
            self._row_now(t)
            self.m, slot, event, closed = tracking_ctl._keyframe_tail(
                self.m, st, self.cfg, ts, feats, uv, t, self.frame_id, feat_mp, n_in, self.cam,
                self.ext, self.noise, self._marks("lm_", self.event_probe),
                not self.localization_only, self.event_kw, self._loopctx, fd)
            self.n_kf_events += slot is not None
        self.m, vi = tracking_ctl.vi_init_tail(
            self.m, st, self.cfg, ts, t, self.cam, self.ext, self.noise,
            self._marks("vi_", self.vi_probe), self.viinit_log)
        if in_loop:
            if vi is not None and vi.accepted:
                frameloop.invalidate(self)
            self._row_now(t)
        self.last_outcome = tracking_ctl.FrameOutcome(OK, n_in, used_fb, slot, event, vi,
                                                      loop=closed, mode=mode)
        self._note_event(self.last_outcome)

    def _row_now(self, t):
        """The trajectory row of the tracking state as it stands."""
        st, ts = self.st, self.ts
        anchor = st.last_kf_slot
        ts.traj.append(tracking._traj_row(self.m, ts.P, ts.R, anchor), t, anchor,
                       st.kf_id_host.get(anchor, -1))

    def _sync_keyframe_in_loop(self, feats, uv, t, feat_mp, n_in, fd=None):
        """The keyframe decision of a frame off the steady state while the
        frame loop is on, as the JAX `_track_sync` takes it
        (mc_slam_tpu/pipeline/system.py:365-373): the event dispatched with its
        host half left to the loop's harvest (`frameloop._local_mapping`), a
        loop-closing attempt with a detection of its own finished in this call
        (`frameloop.close_loop_now`), then the caches dropped and the map
        epoch bumped. Returns (slot or None, LoopOutcome or None)."""
        st, ts, cfg = self.st, self.ts, self.cfg
        if self.localization_only or not tracking_ctl.need_new_kf(
                self.m, st, cfg, self.frame_id, n_in, ts.reloc_buf is not None):
            return None, None
        with span("mapping.event"):
            with self.timers.stage("local_mapping"):
                self.m, slot = tracking_ctl.create_keyframe(
                    self.m, st, cfg, ts, feats, uv, t, self.frame_id, feat_mp, self.noise,
                    detector=self.loop, ur=None if fd is None else fd.ur)
                if fd is not None:
                    self.m = mapping_ctl.add_depth_points(self.m, cfg, self.cam, self.ext,
                                                          slot, feats, uv, fd.depth,
                                                          self.frame_id)
                frameloop._local_mapping(self)
            with self.timers.stage("loop_closing"):
                closed = frameloop.close_loop_now(self, slot)
        frameloop.invalidate(self)
        return slot, closed

    def _relocalize(self, feats, uv, t, fd=None):
        """One relocalization attempt on this frame's features (the refinement
        is monocular, as the JAX package's; a depth frame's u_right rows join
        at its keyframe decision). A success bumps the map epoch
        (mc_slam_tpu/pipeline/system.py:354-356)."""
        with self.timers.stage("relocalize"):
            hit = tracking_ctl.relocalize(self.m, self.st, self.cfg, self.ts, self.loop, feats,
                                          uv, t, self.cam, self.ext, generator=self._gen)
        if hit is None:
            return False
        self.state = OK
        frameloop.invalidate(self)
        self.events.append((self.frame_id, "reloc", dict(kf=hit["kf"], n_in=hit["n_in"])))
        self._after_sync_frame(feats, uv, t, hit["feat_mp"], hit["n_in"], "reloc", fd=fd)
        return True

    def _track_reloc_window(self, feats, uv, t, fd=None):
        """One frame of the bias window after a relocalization; its last frame
        bumps the map epoch (mc_slam_tpu/pipeline/tracking_ctl.py:241-244)."""
        ok, n_in, used_fb = tracking_ctl.track_frame_reloc_window(
            self.m, self.st, self.cfg, self.ts, feats, uv, t, self.cam, self.ext, self.noise,
            reloc_window=self.reloc_window, depth=fd)
        if ok and self.ts.reloc_buf is None:
            frameloop.invalidate(self)
        if not ok:
            self.state = LOST
            self.last_outcome = tracking_ctl.FrameOutcome(LOST, n_in, used_fb, None, None, None,
                                                          mode="reloc_window")
            if self._relocalize(feats, uv, t, fd):
                return True
            self._note_lost(dict(mode="reloc_window", n_in=n_in))
            return False
        self._after_sync_frame(feats, uv, t, self.ts.prev_feat_mp, n_in, "reloc_window", used_fb,
                               fd)
        return True

    def _marks(self, prefix, probe):
        own = self.timers.marks(prefix)
        if probe is None:
            return own

        def both(name):
            own(name)
            probe(name)
        return both

    # ------------------------------------------------------------------
    def flush(self):
        """Bring the recorded state up to date before it is read: every frame
        in flight decided, the last event's host half, the Sim3 batch and its
        verifications harvested (frameloop.flush; nothing is in flight in the
        synchronous mode), the trajectory rows gathered."""
        frameloop.flush(self)

    def global_refine(self):
        """One whole-map bundle adjustment over all active keyframes
        (GlobalBundleAdjustment[NavStatePRV]); tracking then continues from
        the refined newest keyframe. Offline runs call it once at the end
        of a sequence, before the trajectory is saved."""
        self.flush()
        if self.ts is None:
            return
        with self.timers.stage("global_refine"):
            self.m, self.last_gba = mapping_ctl.local_ba(
                self.m, self.st, self.cfg, self.cam, self.ext, self.gw, self.noise,
                force_all=True, prune=False)
        tracking_ctl.reseat_on_newest_keyframe(self.m, self.st, self.ts)
        frameloop.invalidate(self)     # the caches of the map before the BA are stale

    def get_trajectory(self):
        """[(t, P_wb (3,), R_wb (3, 3))] of every tracked frame, composed
        against the CURRENT keyframe poses (System::SaveTrajectoryTUM):
        frames recorded before VI init or a whole-map BA inherit those
        corrections through their reference keyframe, and through its heir
        when that keyframe was culled."""
        self.flush()
        return self.traj.compose(self.m.kf_ns.P, self.m.kf_ns.R, self.m.kf_id,
                                 self.m.kf_active)
