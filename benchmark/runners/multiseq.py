"""Cells of configurations with `"runner": "multiseq"`: B EuRoC-like streams,
each localized against its own prior map, as the port's batched step
(`mc_slam_tpu_torch.parallel.multiseq.make_batched_step`).

Set-up makes everything from the seed on the device. Each stream is one of
the traffic mix's sequences: a room of its own and one closed lap of the
clone's path that lasts as many frames as the sequence. Its map covers the
whole lap (a keyframe every `kf_every` frames at the ground-truth pose, its
features found by the benchmark's plain ORB and lifted by the rendered
depth, `max_mp` of them drawn from the seed as the map's points). The map
is an input: the program and the reference get the same tensors. Each
stream starts at a frame drawn from the seed; `rendered_frames` of its
frames from there wait as uint8 in pinned host memory, and are replayed if
the window outlasts them. Every step uploads one frame a stream and gives
the step a prior pose, the constant-velocity prediction from the two
ground-truth poses before the frame. Steps run back to back (a closed
loop), each ending when its poses are on the host.

`correct` compares a sample of the window's answers, steps of every stream
drawn from the seed, with the plain reference (`benchmark/reference`):
pose, inlier count and the feature-to-map-point table (`gaps`).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import traffic as traffic_gen
from benchmark.harness.trace import traced
from benchmark.reference import orb, track
from benchmark.sim.room import Room, make_textures, pixel_rays
from benchmark.sim.trajectory import TBC, Trajectory

CHUNK = 32          # frames rendered or extracted in one call


def intrinsics(cam):
    return (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["k1"], cam["k2"],
            cam["p1"], cam["p2"], cam["k3"])


class World:
    """The seed's streams on `device`: each stream a room of its own and one
    closed lap of the clone's path that lasts its sequence, and the frame of
    the lap the stream starts at."""

    def __init__(self, cfg, traffic, seed, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        w, cam = cfg["world"], cfg["camera"]
        self.fps = cam["fps"]
        self.lengths, self.starts = traffic_gen.sequence_starts(traffic, self.fps, self.gen)
        self.rooms = [Room(make_textures(self.gen, size=w["tex_size"], device=device),
                           tex_scale=w["tex_scale"]) for _ in self.lengths]
        self.trajs = [Trajectory(duration=n / self.fps) for n in self.lengths]
        self.rays = pixel_rays(intrinsics(cam), cam["width"], cam["height"], device)
        self.H, self.W = cam["height"], cam["width"]
        self.device = device

    def times(self, frames):
        return torch.as_tensor(frames, dtype=torch.float64, device=self.device) / self.fps

    def render(self, b, frames):
        """uint8 images and float32 depths of stream b's frames (a list)."""
        imgs, deps = [], []
        for i in range(0, len(frames), CHUNK):
            Rwc, Cw = self.trajs[b].camera(self.times(frames[i:i + CHUNK]))
            img, dep = self.rooms[b].render(self.rays, Rwc, Cw, self.H, self.W)
            imgs.append(img)
            deps.append(dep)
        return torch.cat(imgs), torch.cat(deps)


def prior_poses(traj, t, dt):
    """Constant-velocity prediction of the body pose at times t from the true
    poses at t - dt and t - 2 dt (TrackWithMotionModel with a perfect past)."""
    P1, R1 = traj.pose(t - dt)
    P2, R2 = traj.pose(t - 2 * dt)
    R2T = R2.transpose(-1, -2)
    dP = (R2T @ (P1 - P2)[..., None])[..., 0]
    dR = R2T @ R1
    return P1 + (R1 @ dP[..., None])[..., 0], R1 @ dR


def stream_map(world, b, cfg, rig):
    """Stream b's whole map: a keyframe every `kf_every` frames of its lap at
    the true pose, its features found by the plain ORB and lifted by the
    rendered depth; of those, `max_mp` drawn from the seed are the map's
    points (in keyframe-major order). Returns (kf, mp) dicts of tensors."""
    m, o = cfg["map"], cfg["orb"]
    frames = list(range(0, world.lengths[b], m["kf_every"]))
    feats, depth = [], []
    for i in range(0, len(frames), CHUNK):
        img, dep = world.render(b, frames[i:i + CHUNK])
        f = orb.extract(img, o["n_features"], o["n_levels"])
        xs = f["xy"][..., 0].to(torch.int64).clamp(0, world.W - 1)
        ys = f["xy"][..., 1].to(torch.int64).clamp(0, world.H - 1)
        depth.append(torch.gather(dep.flatten(1), 1, ys * world.W + xs))
        feats.append(f)
    f = {k: torch.cat([x[k] for x in feats]) for k in feats[0]}
    d = torch.cat(depth)
    P, R = world.trajs[b].pose(world.times(frames))
    P, R = P.to(torch.float32), R.to(torch.float32)
    uv = rig.undistort(f["xy"])
    good = f["valid"] & (d > 1e-3)
    xn = torch.stack([(uv[..., 0] - rig.cx) / rig.fx, (uv[..., 1] - rig.cy) / rig.fy], -1)
    Xc = torch.cat([xn * d[..., None], d[..., None]], -1)
    Rbc = rig.Rcb.T
    Xb = track.mv(Rbc, Xc) + (-track.mv(Rbc, rig.tcb))
    Xw = track.mv(R[:, None], Xb) + P[:, None]
    ray = Xw - P[:, None]
    dist = torch.linalg.norm(ray, dim=-1)
    max_d = dist * (1.2 ** f["level"].to(torch.float32))
    K, F = good.shape
    flat = lambda x: x.reshape((K * F,) + x.shape[2:])
    score = torch.where(good, torch.rand(good.shape, generator=world.gen,
                                         device=world.device), -1.0)
    top = torch.sort(torch.topk(flat(score), min(m["max_mp"], K * F)).indices).values
    pad = m["max_mp"] - top.numel()

    def take(x):
        x = flat(x)[top]
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    active = take(good)
    mp = dict(pos=take(Xw), desc=take(f["desc"]), pm1=take(f["pm1"]), angle=take(f["angle"]),
              normal=take(ray / dist.clamp(min=1e-9)[..., None]), max_dist=take(max_d),
              min_dist=take(max_d / (np.float32(1.2) ** np.float32(max(o["n_levels"], 8) - 1))),
              active=active, kf=take(torch.arange(K, device=P.device)[:, None].expand(K, F)))
    kf_mp = torch.full((K * F,), -1, dtype=torch.int32, device=P.device)
    kept = active[:top.numel()]
    kf_mp[top[kept]] = torch.arange(top.numel(), dtype=torch.int32, device=P.device)[kept]
    kf = dict(P=P, R=R, frame=torch.as_tensor(frames, device=P.device), uv=uv,
              level=f["level"], angle=f["angle"], desc=f["desc"], pm1=f["pm1"],
              valid=f["valid"], mp=kf_mp.reshape(K, F))
    return kf, mp


def pad_stack(xs, value=0):
    """Stack tensors that differ in their first dim, padding it with `value`."""
    n = max(x.shape[0] for x in xs)
    return torch.stack([torch.cat([x, x.new_full((n - x.shape[0],) + x.shape[1:], value)])
                        for x in xs])


def build_maps(world, cfg, rig):
    """Every stream's map, stacked with a leading stream dim; keyframes past
    a stream's own are padding (`kf["active"]` False)."""
    maps = [stream_map(world, b, cfg, rig) for b in range(len(world.lengths))]
    kfs, mps = [k for k, _ in maps], [m for _, m in maps]
    kf = {k: pad_stack([x[k] for x in kfs], -1 if k in ("mp", "frame") else 0) for k in kfs[0]}
    kf["active"] = pad_stack([torch.ones(x["frame"].shape[0], dtype=torch.bool,
                                         device=world.device) for x in kfs], False)
    mp = {k: torch.stack([x[k] for x in mps]) for k in mps[0]}
    return kf, mp


def to_mapstate(kf, mp, device):
    """The maps as the port's stacked MapState (capacities K, max_mp, F)."""
    from mc_slam_tpu_torch.parallel import multiseq
    from mc_slam_tpu_torch.slam_map.mapstate import empty_map
    B, K, F = kf["valid"].shape
    n_mp = mp["active"].shape[1]
    ms = multiseq.stack_maps([empty_map(K, n_mp, F, device=device)] * B)
    kf_frame = kf["frame"].clamp(min=0)
    return ms._replace(
        kf_ns=ms.kf_ns._replace(P=kf["P"], R=kf["R"]),
        kf_time=kf_frame.to(torch.float32), kf_id=kf["frame"].to(torch.int32),
        kf_active=kf["active"], kf_uv=kf["uv"], kf_level=kf["level"],
        kf_angle=kf["angle"], kf_desc=kf["desc"], kf_pm1=kf["pm1"],
        kf_feat_valid=kf["valid"], kf_mp=kf["mp"],
        mp_pos=mp["pos"], mp_desc=mp["desc"], mp_pm1=mp["pm1"], mp_normal=mp["normal"],
        mp_min_dist=mp["min_dist"], mp_max_dist=mp["max_dist"],
        mp_ref_kf=mp["kf"].to(torch.int32), mp_angle=mp["angle"],
        mp_found=mp["active"].to(torch.float32), mp_visible=mp["active"].to(torch.float32),
        mp_first_kf=torch.gather(kf_frame, 1, mp["kf"]).to(torch.int32),
        mp_active=mp["active"])


class Recorder:
    """Stands in front of the port's search wrapper during traced steps and
    keeps (by reference, no copy) what the roofline count needs."""

    def __init__(self, match_cuda):
        self.mc = match_cuda
        self.searches = []

    def __call__(self, a_desc, a_pm1, a_uv, a_lvl, a_valid, b_desc, b_pm1, b_uv, b_lvl,
                 b_valid, radius, level_tol=1):
        self.searches.append((a_uv, a_lvl, a_valid, b_uv, b_lvl, b_valid, float(radius)))
        return self.mc._WRAPPER(a_desc, a_pm1, a_uv, a_lvl, a_valid, b_desc, b_pm1, b_uv,
                                b_lvl, b_valid, radius, level_tol)


class Cell:
    """A multiseq cell made from the seed: the maps as the port's stacked
    MapState, the frames in pinned host memory, the priors and the batched
    step; `step(k)` runs step k of the closed loop."""

    def __init__(self, spec, seed, device, step_wrapper=None):
        from mc_slam_tpu_torch.camera import make_camera
        from mc_slam_tpu_torch.parallel import multiseq
        from mc_slam_tpu_torch.solver import factors
        cfg, tr = spec["config"], spec["traffic"]
        c, o = cfg["camera"], cfg["orb"]
        self.cfg, self.cell, self.device = cfg, spec["cell"], device
        self.cuda = device.type == "cuda"
        world = World(cfg, tr, seed, device)
        self.rig = track.Rig(intrinsics(c), c["width"], c["height"], TBC, device)
        kf, self.mp = build_maps(world, cfg, self.rig)
        self.ms = to_mapstate(kf, self.mp, device)
        B, n_win = len(world.starts), tr["rendered_frames"]
        self.B, self.n_win = B, n_win
        self.frames = torch.empty((n_win, B, world.H, world.W), dtype=torch.uint8,
                                  pin_memory=self.cuda)
        self.P0 = torch.empty((n_win, B, 3), dtype=torch.float32, device=device)
        self.R0 = torch.empty((n_win, B, 3, 3), dtype=torch.float32, device=device)
        for b, s in enumerate(world.starts):
            seq = [(s + j) % world.lengths[b] for j in range(n_win)]
            for i in range(0, n_win, CHUNK):
                self.frames[i:i + CHUNK, b].copy_(world.render(b, seq[i:i + CHUNK])[0])
            P0, R0 = prior_poses(world.trajs[b], world.times(seq), 1.0 / world.fps)
            self.P0[:, b], self.R0[:, b] = P0, R0
        cam = make_camera(*intrinsics(c)[:4], k1=c["k1"], k2=c["k2"], p1=c["p1"],
                          p2=c["p2"], k3=c["k3"], width=c["width"], height=c["height"],
                          device=device)
        self.step_fn = multiseq.make_batched_step(
            cam, factors.extrinsics_from_Tbc(TBC, device=device),
            n_features=o["n_features"], n_levels=o["n_levels"], iters=cfg["pose_iters"])
        if step_wrapper is not None:
            self.step_fn = step_wrapper(self.step_fn)
        self.dev_img = torch.empty((B, world.H, world.W), dtype=torch.uint8, device=device)
        self.host_out = torch.empty((B, 13), dtype=torch.float32, pin_memory=self.cuda)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def step(self, k):
        """Step k: each stream's frame k mod n_win of those rendered. Returns
        (that index, host (B, 13) [P, R, n_inliers], feat_mp on the device)."""
        from torch.profiler import record_function
        j = k % self.n_win
        with record_function("upload"):
            self.dev_img.copy_(self.frames[j], non_blocking=True)
        with record_function("track"):
            P, R, fmp, n_in = self.step_fn(self.ms, self.dev_img, self.P0[j], self.R0[j])
        with record_function("readback"):
            self.host_out.copy_(torch.cat([P, R.reshape(self.B, 9),
                                           n_in[:, None].to(torch.float32)], 1),
                                non_blocking=True)
            self.sync()
        return j, self.host_out.clone(), fmp

    def free_program(self):
        """Drop the program's state (the stacked map and the step)."""
        del self.ms, self.step_fn

    def sample(self, n_steps, seed):
        """(stream, step) pairs of the comparison: `sample_per_stream` steps
        of every stream, drawn from the seed."""
        gen = torch.Generator().manual_seed(seed)
        n = self.cell["sample_per_stream"]
        steps = torch.randint(0, n_steps, (self.B, n), generator=gen).tolist()
        return [(b, k) for b in range(self.B) for k in steps[b]]

    def reference(self, b, j, tf32=False):
        """The plain reference's (P, R, feat_mp, n_inliers) of stream b at
        its rendered frame j, in float32 or, for the control, with TF32 products."""
        o = self.cfg["orb"]
        with reference_precision(tf32):
            return track.localize(self.frames[j, b].to(self.device),
                                  {key: v[b] for key, v in self.mp.items()}, self.rig,
                                  self.P0[j, b], self.R0[j, b], o["n_features"],
                                  o["n_levels"], self.cfg["pose_iters"])


def frame_gaps(answer, ref):
    """One frame's answer (P (3,), R (3, 3), feat_mp (F,), n_inliers)
    against the reference's: (position gap mm, rotation gap deg, feature
    slots whose map point differs, slots either side associates, whether
    the inlier counts differ)."""
    (P, R, fmp, n), (Pr, Rr, fmpr, nr) = answer, ref
    d64 = lambda x: x.detach().cpu().to(torch.float64)
    M = d64(R).T @ d64(Rr)
    w = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    ang = math.atan2(float(torch.linalg.norm(w)), (float(torch.trace(M)) - 1) / 2)
    a, r = fmp.cpu(), fmpr.cpu()
    return (1e3 * float(torch.linalg.norm(d64(P) - d64(Pr))), math.degrees(ang),
            int((a != r).sum()), int(((a >= 0) | (r >= 0)).sum()), int(n) != int(nr))


def gaps(pairs, far_mm):
    """The compared numbers over (answer, reference) pairs: the 90th
    percentile of the frames' position and rotation gaps, the share of
    frames whose position gap exceeds `far_mm`, the share of frames whose
    inlier count differs, and the share of feature slots whose map point
    differs among those either side associates."""
    f = [frame_gaps(a, r) for a, r in pairs]
    p90 = lambda i: float(np.quantile([x[i] for x in f], 0.9))
    return {"pose_gap_mm.p90": p90(0), "rot_gap_deg.p90": p90(1),
            "far_frame_pct": 100.0 * sum(x[0] > far_mm for x in f) / len(f),
            "inlier_diff_pct": 100.0 * sum(x[4] for x in f) / len(f),
            "match_diff_pct": 100.0 * sum(x[2] for x in f) / max(sum(x[3] for x in f), 1)}


def answer(done, b, k):
    """The program's (P, R, feat_mp, n_inliers) of stream b at step k."""
    _, host, fmp = done[k]
    return host[b, :3], host[b, 3:12].reshape(3, 3), fmp[b], int(host[b, 12])


def run(spec, seed, seconds, trace, device, t_start, step_wrapper=None):
    """One run of a multiseq cell. Returns the harness's result dict."""
    from mc_slam_tpu_torch.frontend import match_cuda
    cell = Cell(spec, seed, device, step_wrapper)
    for k in range(cell.cell["warmup_steps"]):
        cell.step(k)
    cell.sync()
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = dict(setup_s=time.perf_counter() - t_start)
    if trace:
        n = cell.cell["trace_steps"]
        rec = Recorder(match_cuda)
        match_cuda.hamming_top2_windowed = rec
        try:
            done, events, window_s, ends = traced(cell.step, n, device, host_ops=False)
        finally:
            match_cuda.hamming_top2_windowed = rec.mc._WRAPPER
        more, host_events, _, host_ends = traced(lambda k: cell.step(n + k), n, device)
        done += more
        out["trace"] = (events, window_s, dict(steps=n, searches=rec.searches,
                                               host_events=host_events))
        out["note"] = (f"traced steps end at {[round(t, 4) for t in ends]} s (device only), "
                       f"{[round(t, 4) for t in host_ends]} s (with host operators)")
    else:
        done = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            done.append(cell.step(len(done)))
        window_s = time.perf_counter() - t0
        out["frames_per_s"] = len(done) * cell.B / window_s
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cell.cuda else 0
    out["attempted"] = len(done) * cell.B
    out["failed"] = sum(int((d[1][:, 12] < spec["traffic"]["min_inliers"]).sum())
                        for d in done)
    out["steps"] = len(done)
    out["window_s"] = window_s
    # the reference, once the window has closed and the program's state is freed
    cell.free_program()
    out["checks"] = gaps([(answer(done, b, k), cell.reference(b, done[k][0]))
                          for b, k in cell.sample(len(done), seed)], cell.cell["far_gap_mm"])
    return out


class reference_precision:
    """TF32 for the reference's float32 products while the block runs (the
    lower-precision control) or left off (the reference proper)."""

    def __init__(self, tf32):
        self.tf32 = tf32

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec) = self.prev
        torch.set_float32_matmul_precision(prec)
