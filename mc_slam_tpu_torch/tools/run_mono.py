"""Vision-only runner of the port for TUM-RGBD and KITTI-odometry sequences:
the mono_tum.cc / mono_kitti.cc equivalents (Examples/Monocular/*), the
counterpart of examples/run_mono.py.

    python3 -m mc_slam_tpu_torch.tools.run_mono tum  /data/rgbd_dataset_freiburg1_desk --cam tum1
    python3 -m mc_slam_tpu_torch.tools.run_mono kitti /data/kitti/sequences/00 --cam kitti00-02

`--depth` runs TUM RGB-D (depth.txt, 5000 per metre). Writes
FrameTrajectory_TUM.txt (and FrameTrajectory_KITTI.txt for kitti), prints the
median track time and, with --gt, the ATE RMSE. Needs a GPU unless `--device
cpu` is given.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=["tum", "kitti"])
    ap.add_argument("root")
    ap.add_argument("--cam", default="")
    ap.add_argument("--depth", action="store_true", help="TUM RGB-D mode (uses depth.txt)")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--gt", default="", help="TUM-format groundtruth.txt")
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--n-levels", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.camera import make_camera
    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.eval.ate import ate_rmse
    from mc_slam_tpu_torch.io import euroc, trajectory
    from mc_slam_tpu_torch.io.datasets import (KITTI_CAMERAS, TUM_CAMERAS,
                                               load_kitti_sequence, load_tum_sequence)
    from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem

    dev = resolve(args.device)
    if args.kind == "tum":
        seq = load_tum_sequence(args.root, with_depth=args.depth)
        cam_params = TUM_CAMERAS[args.cam or "tum1"]
    else:
        seq = load_kitti_sequence(args.root)
        cam_params = KITTI_CAMERAS[args.cam or "kitti00-02"]
    cfg = SlamConfig(max_kf=512, max_mp=16384, n_feat=args.n_feat,
                     n_levels=args.n_levels, use_imu=False)
    slam = SlamSystem(make_camera(**cam_params, device=dev), cfg, device=dev)

    times, n = [], 0

    def run_frame(item):
        nonlocal n
        t_frame, buf, dep = item
        t0 = time.perf_counter()
        slam.track(buf, t_frame, depth=dep)
        times.append(time.perf_counter() - t0)
        n += 1
        if n % 100 == 0:
            print(f"frame {n}: state={slam.state} kf={slam.n_kf} "
                  f"median={np.median(times) * 1e3:.1f}ms", file=sys.stderr)

    pending = None
    for row in seq:
        t_frame, img_path = row[0], row[1]
        dep = euroc.load_depth_image(row[2]) if args.depth and len(row) > 2 else None
        buf = slam.upload(euroc.load_gray_image(img_path))
        if pending is not None:
            run_frame(pending)
            if args.max_frames and n >= args.max_frames:
                pending = None
                break
        pending = (t_frame, buf, dep)
    if pending is not None:
        run_frame(pending)

    os.makedirs(args.out_dir, exist_ok=True)
    traj = slam.get_trajectory()
    if args.kind == "kitti":
        trajectory.save_kitti(os.path.join(args.out_dir, "FrameTrajectory_KITTI.txt"), traj)
    trajectory.save_tum(os.path.join(args.out_dir, "FrameTrajectory_TUM.txt"), traj)
    result = {"frames": n, "keyframes": slam.n_kf, "lag_max": slam.LAG_MAX, "pair": slam.PAIR,
              "median_track_ms": float(np.median(times) * 1e3)}
    if args.gt:
        gt = np.loadtxt(args.gt, comments="#")
        t_est = np.asarray([x[0] for x in traj])
        P_est = np.asarray([x[1] for x in traj])
        stats = ate_rmse(t_est, P_est, gt[:, 0], gt[:, 1:4], with_scale=True)
        result["ate_rmse"] = stats["rmse"]
        print("ATE:", stats)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
