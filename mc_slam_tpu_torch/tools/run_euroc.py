"""EuRoC runner of the port: the mono_EuRoC_vins equivalent
(Examples/Monocular/mono_EuRoC_vins.cc), the counterpart of
examples/run_euroc.py.

    python3 -m mc_slam_tpu_torch.tools.run_euroc /path/to/MH_01_easy/mav0 [--no-imu]
        [--out-dir out/] [--max-frames N] [--gt path/to/state_groundtruth/data.csv]
        [--profile euroc|small] [--device cpu]

Loads the ASL folder (through the native C++ prefetch loader,
`io.native_loader`, when its library is built, else `io.euroc`), slices IMU
strictly before each frame timestamp, feeds `SlamSystem.track` with one frame
of upload lookahead, reports the median / mean track time, writes the frame
and keyframe trajectories (TUM and NavState formats) and, with ground truth,
the Horn-aligned ATE. `tools/eval_clone.py` writes such a folder from the
repo's own simulator. Needs a GPU unless `--device cpu` is given.
MC_SLAM_LAG_MAX / MC_SLAM_PAIR select the frame loop (pipeline/system.py);
the result's `lag_max` / `pair` say which mode ran.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mc_slam_tpu_torch.tools.eval_clone import TBC


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mav0")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--gt", default="")
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--profile", choices=["euroc", "small"], default="euroc",
                    help="small: reduced capacities / levels for CPU smoke runs")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.eval.ate import ate_rmse
    from mc_slam_tpu_torch.io import euroc, native_loader, trajectory
    from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem

    dev = resolve(args.device)
    if args.profile == "small":
        cfg = SlamConfig(max_kf=64, max_mp=4096, n_feat=min(args.n_feat, 512), n_levels=3,
                         local_window=8, use_imu=not args.no_imu, vi_init_time=5.0,
                         g_mag=9.810)
    else:
        cfg = SlamConfig(max_kf=512, max_mp=16384, n_feat=args.n_feat, n_levels=8,
                         local_window=20, use_imu=not args.no_imu, vi_init_time=15.0,
                         g_mag=9.810)
    slam = SlamSystem(euroc_camera(device=dev), cfg, Tbc=None if args.no_imu else TBC,
                      device=dev)

    def frames():
        if native_loader.available():
            print("# using the native C++ prefetch loader", file=sys.stderr)
            yield from native_loader.NativeEurocLoader(args.mav0)
        else:
            seq = euroc.load_sequence(args.mav0)
            for t_frame, path, imu_rows in euroc.slice_imu_per_frame(seq):
                yield t_frame, euroc.load_gray_image(path), imu_rows

    times, n = [], 0

    def run_frame(item):
        nonlocal n
        t_frame, buf, imu_rows = item
        t0 = time.perf_counter()
        slam.track(buf, t_frame, imu=None if args.no_imu else imu_rows)
        times.append(time.perf_counter() - t0)
        n += 1
        if n % 100 == 0:
            print(f"frame {n}: state={slam.state} kf={slam.n_kf} "
                  f"mp={int(slam.m.mp_active.sum())} "
                  f"median_track={np.median(times) * 1e3:.1f}ms", file=sys.stderr)

    # one frame of lookahead: frame n+1's upload starts before frame n is tracked
    pending = None
    for t_frame, img, imu_rows in frames():
        buf = slam.upload(img)
        if pending is not None:
            run_frame(pending)
            if args.max_frames and n >= args.max_frames:
                pending = None
                break
        pending = (t_frame, buf, imu_rows)
    if pending is not None:
        run_frame(pending)

    os.makedirs(args.out_dir, exist_ok=True)
    traj = slam.get_trajectory()
    trajectory.save_tum(os.path.join(args.out_dir, "FrameTrajectory_TUM.txt"), traj)
    ns = [a.cpu().numpy() for a in slam.m.kf_ns]
    kf_time = slam.m.kf_time.cpu().numpy()
    P, V, R, bg, ba, dbg, dba = ns
    kf_entries = [(float(kf_time[s]), P[s], R[s], V[s], bg[s] + dbg[s], ba[s] + dba[s])
                  for s in slam.kf_slots]
    trajectory.save_tum(os.path.join(args.out_dir, "KeyFrameTrajectory_TUM.txt"),
                        [(t, p, r) for t, p, r, *_ in kf_entries])
    trajectory.save_navstate(os.path.join(args.out_dir, "KeyFrameNavStateTrajectory.txt"),
                             kf_entries)
    print(f"median track time: {np.median(times) * 1e3:.2f} ms  "
          f"mean: {np.mean(times) * 1e3:.2f} ms")
    result = {"frames": n, "keyframes": slam.n_kf, "lag_max": slam.LAG_MAX, "pair": slam.PAIR,
              "median_track_ms": float(np.median(times) * 1e3),
              "fps": float(1.0 / np.median(times))}
    if args.gt:
        gt = np.loadtxt(args.gt, delimiter=",", comments="#")
        t_est = np.asarray([x[0] for x in traj])
        P_est = np.asarray([x[1] for x in traj])
        stats = ate_rmse(t_est, P_est, gt[:, 0] / 1e9, gt[:, 1:4],
                         with_scale=args.no_imu or not slam.vi_inited)
        print("ATE:", stats)
        result["ate_rmse"] = stats["rmse"]
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
