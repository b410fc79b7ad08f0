"""Write the synthetic EuRoC clone as an ASL folder (the counterpart of
examples/make_euroc_clone.py, with its command line): 752x480 distorted
frames at 20 fps, 200 Hz IMU with EuRoC noise densities and non-zero
biases, ground truth, the real EuRoC Tbc. The frames and IMU rows are those
of `tools/eval_clone.py`'s `render_clone`, whose draws from the seeded
generator come in the JAX script's order.

    python3 -m mc_slam_tpu_torch.tools.make_euroc_clone --out _scratch/clone --duration 120
    python3 -m mc_slam_tpu_torch.tools.run_euroc _scratch/clone/mav0 \\
        --gt _scratch/clone/mav0/state_groundtruth_estimate0/data.csv

A host tool: it renders on the CPU and writes PNG files, so it needs PIL
(`sim.euroc_writer`). Where no PNG codec is installed, `tools/eval_clone.py`
renders the same clone straight into a run instead.
"""
from __future__ import annotations

import argparse

from mc_slam_tpu_torch.tools import eval_clone


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog="Needs PIL for the PNG frames.")
    ap.add_argument("--out", default=eval_clone.DEFAULT_DATASET)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tex-size", type=int, default=2048)
    ap.add_argument("--tex-scale", type=float, default=1.0,
                    help="1.0 = non-periodic walls (a repeating texture makes the world "
                         "self-aliased)")
    ap.add_argument("--bg", type=float, nargs=3, default=[0.003, -0.0045, 0.0035],
                    help="true gyro bias [rad/s]")
    ap.add_argument("--ba", type=float, nargs=3, default=[0.035, -0.02, 0.06],
                    help="true accel bias [m/s^2]")
    ap.add_argument("--no-harden", dest="harden", action="store_false", default=True,
                    help="no motion blur, exposure flicker, sensor noise or occluders")
    ap.add_argument("--blur-ms", type=float, default=12.0,
                    help="exposure window for motion blur [ms]")
    ap.add_argument("--laps", type=int, default=1,
                    help="laps of the closed path over the duration (motion speed scales "
                         "by N)")
    ap.add_argument("--imu-noise-scale", type=float, default=1.0,
                    help="multiply the EuRoC noise densities")
    ap.add_argument("--yaw-scale", type=float, default=1.0,
                    help="scale the yaw-sweep amplitude")
    ap.add_argument("--tex-contrast", type=float, default=1.0,
                    help="texture contrast multiplier (< 1: low texture)")
    ap.add_argument("--weak-walls", type=int, nargs="*", default=[],
                    help="plane indices (0..5: -x, +x, -y, +y, floor, ceiling) rendered at "
                         "--weak-contrast")
    ap.add_argument("--weak-contrast", type=float, default=0.3)
    args = ap.parse_args(argv)
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise SystemExit("make_euroc_clone: PIL is needed to write the PNG frames")
    args.dataset = args.out
    n_frames = int(args.duration * args.fps)
    gt_path = eval_clone.write_clone(args, n_frames)
    print(f"wrote {n_frames} frames and their IMU rows to {args.out}")
    print(f"gt: {gt_path}")
    return gt_path


if __name__ == "__main__":
    main()
