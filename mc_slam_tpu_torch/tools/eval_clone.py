"""End-to-end evaluation of the port on the synthetic EuRoC clone (the
counterpart of examples/eval_clone.py for `mc_slam_tpu_torch`).

    python3 -m mc_slam_tpu_torch.tools.eval_clone [--dataset DIR] [--duration 120]
        [--max-frames N] [--final-gba] [--no-loops] [--out artifacts/...json]

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

Loop closing and relocalization are on, as in the JAX script; `--no-loops`
turns loop closing off (relocalization stays). The result carries the JAX
script's keys `n_lost`, `n_relocs`, `max_lost_streak` and `loops_closed`. (The
JAX script's "loops" dataset profile, which this tool does not generate, is 2
laps at 6 x IMU noise with weak-texture walls, as its PROFILE_GEN table says;
the comment above that table still describes an older 3-lap, 8 x profile.)
Where no PNG codec is installed (neither PIL
nor imageio) the frames are rendered straight into the run and nothing is
written. Needs a GPU unless `--device cpu` is given.
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


def render_clone(args, n_frames):
    """Yield (t, img uint8, P_wb, R_wb, V) for each frame of the clone, as
    examples/make_euroc_clone.py renders it: the textured room along the MAV
    trajectory and, with args.harden, motion blur over the exposure window,
    exposure flicker with sensor noise, and two drifting occluders. Then one
    last item (None, imu_rows) with the (T, 6) IMU samples of the whole span.
    The draws from the seeded generator come in that script's order."""
    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
    rng = np.random.default_rng(args.seed)
    cam = euroc_camera(device="cpu")            # the renderer runs on the host
    world = RoomWorld(rng, tex_size=args.tex_size, tex_scale=args.tex_scale,
                      weak_walls=tuple(args.weak_walls), weak_contrast=args.weak_contrast)
    traj = MavTrajectory(duration=args.duration / max(args.laps, 1),
                         yaw_scale=args.yaw_scale)
    Rbc, pbc = TBC[:3, :3], TBC[:3, 3]
    fdt = 1.0 / args.fps
    occ = [{"uv": rng.uniform(0.1, 0.9, 2), "vel": rng.uniform(-0.15, 0.15, 2),
            "wh": rng.uniform(0.06, 0.16, 2), "val": rng.uniform(15, 55)}
           for _ in range(2)]
    for i in range(n_frames):
        t = i * fdt
        P_wb, R_wb = traj.pose(t)
        img = world.render(cam, R_wb @ Rbc, P_wb + R_wb @ pbc)
        if args.harden:
            P2, R2 = traj.pose(t + args.blur_ms * 1e-3)
            img2 = world.render(cam, R2 @ Rbc, P2 + R2 @ pbc)
            img = 0.5 * img.astype(np.float32) + 0.5 * img2.astype(np.float32)
        if args.tex_contrast != 1.0:
            img = np.clip(118.0 + args.tex_contrast * (np.asarray(img, np.float32) - 118.0),
                          0, 255).astype(np.float32 if args.harden else np.uint8)
        if args.harden:
            gain = 1.0 + 0.12 * np.sin(2 * np.pi * 0.9 * t + 0.7) + rng.normal(0.0, 0.02)
            img = img * gain + rng.normal(0.0, 1.5, img.shape)
            H, W = img.shape
            for o in _step_occluders(occ, fdt):
                u0, v0 = int(o["uv"][0] * W), int(o["uv"][1] * H)
                w, h = int(o["wh"][0] * W), int(o["wh"][1] * H)
                box = img[max(v0, 0):v0 + h, max(u0, 0):u0 + w]
                box[...] = o["val"] + rng.normal(0, 3.0, box.shape)
            img = np.clip(img, 0, 255).astype(np.uint8)
        yield t + T_OFF, img, P_wb, R_wb, traj.velocity(t)
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
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.eval.ate import ate_rmse
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

    n_all = int(args.duration * args.fps)
    n_frames = min(n_all, args.max_frames) if args.max_frames else n_all
    t0 = time.time()
    mav0 = os.path.join(args.dataset, "mav0")
    if have_png_codec():
        if not os.path.exists(os.path.join(mav0, "cam0", "data.csv")):
            # a shortened run writes only the frames it will read
            print(f"writing {n_frames} frames of the clone to {args.dataset}", file=sys.stderr)
            write_clone(args, n_frames)
        frames, t_gt, P_gt = frames_from_disk(mav0, args.max_frames)
    else:
        print("no PNG codec: rendering the clone in memory", file=sys.stderr)
        frames, t_gt, P_gt = frames_in_memory(args, n_frames)
    t_data = time.time() - t0

    cfg = SlamConfig(max_kf=512, max_mp=16384, n_feat=1024, n_levels=8, local_window=20,
                     use_imu=True, vi_init_time=15.0, g_mag=9.810)
    slam = SlamSystem(euroc_camera(device=dev), cfg, Tbc=TBC, device=dev)
    slam.enable_loop_closing = not args.no_loops

    times, n, i_vi = [], 0, None

    def run_frame(item):
        nonlocal n, i_vi
        t_frame, buf, rows = item
        t1 = time.perf_counter()
        slam.track(buf, t_frame, imu=rows)
        times.append(time.perf_counter() - t1)
        n += 1
        if i_vi is None and slam.vi_inited:
            i_vi = n - 1
        if n % 100 == 0:
            print(f"frame {n}: state={slam.state} kf={len(slam.kf_slots)} "
                  f"vi={slam.vi_inited} lost={slam.n_lost_frames} "
                  f"loops={slam.n_loops_closed} "
                  f"median={np.median(times) * 1e3:.0f} ms", file=sys.stderr)

    # one frame of lookahead: the NEXT frame's upload is started before the
    # current frame is tracked
    t0 = time.time()
    pending = None
    for t_frame, img, rows in frames:
        buf = slam.upload(img)
        if pending is not None:
            run_frame(pending)
        pending = (t_frame, buf, rows)
    if pending is not None:
        run_frame(pending)
    t_run = time.time() - t0

    gba_s = None
    if args.final_gba:
        t1 = time.perf_counter()
        slam.global_refine()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        gba_s = time.perf_counter() - t1
    traj = slam.get_trajectory()
    t_est = np.asarray([x[0] for x in traj])
    P_est = np.asarray([x[1] for x in traj])
    stats = ate_rmse(t_est, P_est, t_gt, P_gt, with_scale=True) if len(traj) > 3 else {}
    post = t_est > t_est[0] + 20.0 if len(traj) else np.zeros(0, bool)
    stats_post = (ate_rmse(t_est[post], P_est[post], t_gt, P_gt, with_scale=True)
                  if post.sum() > 10 else {})
    culled = sum(len(e[2]["slots"]) for e in slam.events if e[1] == "kf_culled")
    ms = np.asarray(times) * 1e3
    # the longest span from a lost frame to the next relocalization
    lost_ev = [f for f, k, _ in slam.events if k == "lost"]
    reloc_ev = [f for f, k, _ in slam.events if k == "reloc"]
    streaks = [min([r for r in reloc_ev if r >= f], default=n) - f for f in lost_ev]
    result = {
        "card": card, "torch": torch.__version__, "frames": n, "tracked_rows": len(traj),
        "lost_frames": slam.n_lost_frames, "lost": slam.state == LOST,
        "n_lost": int(slam.n_lost_frames), "n_relocs": len(reloc_ev),
        "max_lost_streak": int(max(streaks, default=0)),
        "loops_closed": int(slam.n_loops_closed),
        "vi_inited": bool(slam.vi_inited), "vi_init_frame": i_vi,
        "keyframes_inserted": slam.n_kf, "keyframes_active": len(slam.kf_slots),
        "keyframes_culled": culled,
        "map_points": int(slam.m.mp_active.sum()),
        "ate_rmse_m": stats.get("rmse"), "scale": stats.get("scale"),
        "scale_error": abs(stats["scale"] - 1.0) if stats else None,
        "ate_post_rmse_m": stats_post.get("rmse"), "scale_post": stats_post.get("scale"),
        "frame_ms_median": float(np.median(ms)) if n else None,
        "frame_ms_mean": float(ms.mean()) if n else None,
        "frame_ms_visual_median": float(np.median(ms[:i_vi])) if i_vi else None,
        "frame_ms_vi_median": float(np.median(ms[i_vi:])) if i_vi is not None and i_vi < n
        else None,
        "run_s": t_run, "dataset_s": t_data, "final_gba_s": gba_s,
        "final_gba": bool(args.final_gba), "loops": not args.no_loops,
        "events": [e for e in slam.events if e[1] not in ("kf_culled", "lc_diag")][:50],
        "lc_diag": [(f, d["best_noncovis"], d["n_cands"]) for f, k, d in slam.events
                    if k == "lc_diag"],
        "stages": slam.timers.summary()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(slam.timers.report(), file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items() if k not in ("stages", "events")}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
