"""End-to-end evaluation of the port on the synthetic EuRoC clone (the
counterpart of examples/eval_clone.py for `mc_slam_tpu_torch`).

    python3 -m mc_slam_tpu_torch.tools.eval_clone [--dataset DIR] [--duration 120]
        [--max-frames N] [--final-gba] [--no-loops] [--out artifacts/...json]
        [--save-checkpoint PATH] [--resume PATH]

Writes the clone dataset (an ASL folder: 752x480 distorted frames at 20 fps,
200 Hz IMU with EuRoC noise densities and non-zero biases, the real EuRoC
Tbc, ground truth; the arguments of examples/make_euroc_clone.py) with
`sim.euroc_writer` if it is not there yet, reads it back with `io.euroc`,
runs `SlamSystem` at the euroc profile (max_kf 512, max_mp 16384, 1024
features, 8 levels, window 20, IMU on, 15 s before VI init) through
`track(img, t, imu)` with one frame of upload lookahead, scores the
trajectory against ground truth with `eval.ate` (similarity alignment, whole
run and after VI init) and writes the result, with the card's name and power
limit, to artifacts/ate_clone_euroc_torch.json.

A run can span several calls (a card call's time limit holds ~800 VI
frames): `--save-checkpoint PATH` stops at the first keyframe event at or
after frame `--max-frames` and saves the system there (`io.checkpoint`; the
load reseats tracking at the newest keyframe, which is then this frame, and
the saved `.track.npz` puts back the rest of the tracker's state, so the
resumed call tracks on as the uninterrupted run would), with the run's
record so far in PATH.run.json; `--resume PATH` loads it and goes on
from the next frame, and its result covers the whole run (the trajectory rows
before the resume included) with the aligned error on either side of each
seam. Both render the clone in memory with the draws of all its frames, so
every call sees the frames and IMU rows of one and the same full-length run,
and render only their own frames (four views ahead on one thread).

Loop closing and relocalization are on, as in the JAX script; `--no-loops`
turns loop closing off (relocalization stays). The result carries the JAX
script's keys `n_lost`, `n_relocs`, `max_lost_streak` and `loops_closed`. (The
JAX script's "loops" dataset profile, which this tool does not generate, is 2
laps at 6 x IMU noise with weak-texture walls, as its PROFILE_GEN table says;
the comment above that table still describes an older 3-lap, 8 x profile.)
Where no PNG codec is installed (neither PIL
nor imageio) the frames are rendered straight into the run and nothing is
written. Needs a GPU unless `--device cpu` is given.
MC_SLAM_LAG_MAX / MC_SLAM_PAIR select the frame loop (pipeline/system.py);
the result's `lag_max` / `pair` say which mode ran.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
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


def frames_from_disk(mav0, max_frames):
    """(frames iterator of (t, img uint8, imu rows), t_gt, P_gt) read with
    io.euroc from an ASL folder."""
    from mc_slam_tpu_torch.io import euroc
    seq = euroc.load_sequence(mav0)
    gt = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
                    delimiter=",", comments="#")

    def frames():
        for n, (t, path, rows) in enumerate(euroc.slice_imu_per_frame(seq)):
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
    frames = ((t, items[k][1], r) for t, k, r in euroc.slice_imu_per_frame(seq))
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
            for t, k, r in euroc.slice_imu_per_frame(seq):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="_scratch/euroc_clone")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--final-gba", action="store_true")
    ap.add_argument("--no-loops", action="store_true",
                    help="turn loop closing off (relocalization stays on)")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default="artifacts/ate_clone_euroc_torch.json")
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
    ap.add_argument("--save-checkpoint", default=None, metavar="PATH",
                    help="save the system (io.checkpoint) at the first keyframe event at or "
                         "after frame --max-frames of the clone, and stop there")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="load a checkpoint of --save-checkpoint and go on from the frame "
                         "after it; the result covers the whole run")
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.io import checkpoint
    from mc_slam_tpu_torch.pipeline.pipebase import LOST
    from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem

    dev = resolve(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("eval_clone: no GPU (pass --device cpu to run on the host)")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    cfg = SlamConfig(max_kf=512, max_mp=16384, n_feat=1024, n_levels=8, local_window=20,
                     use_imu=True, vi_init_time=15.0, g_mag=9.810)
    slam = SlamSystem(euroc_camera(device=dev), cfg, Tbc=TBC, device=dev)
    slam.enable_loop_closing = not args.no_loops

    n_all = int(args.duration * args.fps)
    # a run that spans calls: frame numbers count from the clone's first frame
    start, prior, load_s = 0, {"calls": [], "times_ms": [], "events": [], "lost_frames": 0,
                               "culled": 0, "vi_init_frame": None}, None
    if args.resume:
        t1 = time.perf_counter()
        checkpoint.load_system(args.resume, slam)
        load_s = time.perf_counter() - t1
        start = slam.frame_id
        if os.path.exists(args.resume + ".run.json"):
            with open(args.resume + ".run.json") as f:
                prior = json.load(f)
        print(f"resumed at frame {start} from {args.resume} ({load_s:.2f} s)", file=sys.stderr)
    t0 = time.time()
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
        else:
            print("no PNG codec: rendering the clone in memory", file=sys.stderr)
            frames, t_gt, P_gt = frames_in_memory(args, n_frames)
    t_data = time.time() - t0

    times, n, i_vi = [], 0, prior["vi_init_frame"]
    state = {"save": False}

    def run_frame(item):
        nonlocal n, i_vi
        t_frame, buf, rows = item
        n_kf = slam.n_kf
        t1 = time.perf_counter()
        slam.track(buf, t_frame, imu=rows)
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
        state["save"] = bool(args.save_checkpoint and start + n >= args.max_frames
                             and slam.n_kf > n_kf)

    # one frame of lookahead: the NEXT frame's upload is started before the
    # current frame is tracked
    t0 = time.time()
    pending = None
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
                       "culled": culled, "vi_init_frame": i_vi}, f, default=_plain)
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
    stats, stats_post, seams = score(slam.get_trajectory(), t_gt, P_gt, calls, events)
    ms = np.asarray(prior["times_ms"] + ms_call.tolist())
    n_done = start + n
    # the longest span from a lost frame to the next relocalization
    lost_ev = [f for f, k, _ in events if k == "lost"]
    reloc_ev = [f for f, k, _ in events if k == "reloc"]
    streaks = [min([r for r in reloc_ev if r >= f], default=n_done) - f for f in lost_ev]
    traj_rows = len(slam.traj)
    result = {
        "card": card, "torch": torch.__version__, "lag_max": slam.LAG_MAX, "pair": slam.PAIR,
        "frames": n_done, "tracked_rows": traj_rows,
        "lost_frames": n_lost, "lost": slam.state == LOST,
        "n_lost": n_lost, "n_relocs": len(reloc_ev),
        "max_lost_streak": int(max(streaks, default=0)),
        "loops_closed": int(slam.n_loops_closed),
        "vi_inited": bool(slam.vi_inited), "vi_init_frame": i_vi,
        "keyframes_inserted": slam.n_kf, "keyframes_active": len(slam.kf_slots),
        "keyframes_culled": culled,
        "map_points": int(slam.m.mp_active.sum()),
        "ate_rmse_m": stats.get("rmse"), "scale": stats.get("scale"),
        "scale_error": abs(stats["scale"] - 1.0) if stats else None,
        "ate_post_rmse_m": stats_post.get("rmse"), "scale_post": stats_post.get("scale"),
        "frame_ms_median": float(np.median(ms)) if len(ms) else None,
        "frame_ms_mean": float(ms.mean()) if len(ms) else None,
        "frame_ms_visual_median": float(np.median(ms[:i_vi])) if i_vi else None,
        "frame_ms_vi_median": float(np.median(ms[i_vi:])) if i_vi is not None
        and i_vi < len(ms) else None,
        "run_s": sum(c["run_s"] for c in calls), "dataset_s": t_data, "final_gba_s": gba_s,
        "final_gba": bool(args.final_gba), "loops": not args.no_loops,
        "calls": calls, "seams": seams,
        "events": events[:50],
        "lc_diag": [(f, d["best_noncovis"], d["n_cands"]) for f, k, d in slam.events
                    if k == "lc_diag"],
        "stages": slam.timers.summary()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=_plain)
    print(slam.timers.report(), file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items() if k not in ("stages", "events")},
                     default=_plain), flush=True)
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
