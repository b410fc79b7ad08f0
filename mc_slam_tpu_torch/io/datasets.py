"""TUM-RGBD and KITTI-odometry sequence readers (the input of the
vision-only example programs; a copy of mc_slam_tpu/io/datasets.py, which
imports numpy only).

The reference ships per-dataset mono example programs
(Examples/Monocular/mono_tum.cc, mono_kitti.cc) whose loaders parse:
  - TUM:   <root>/rgb.txt lines "timestamp path" (+ optional depth.txt for
           the RGB-D mode, associated by nearest timestamp, max diff 0.02 s —
           Examples/RGB-D/associate semantics)
  - KITTI: <root>/times.txt + image_0/%06d.png (mono_kitti.cc LoadImages)

Both yield (t, image_path[, depth_path]) tuples; image decode goes through
io.euroc.load_gray_image (PNG/PGM grayscale).
"""
from __future__ import annotations

import os

import numpy as np


def load_tum_sequence(root, with_depth=False, max_diff=0.02):
    """Parse a TUM-RGBD folder. Returns list of (t, rgb_path) or, with depth,
    (t, rgb_path, depth_path) associated by nearest timestamp (the reference's
    associate.py rule: closest pair within max_diff)."""
    def read_list(name):
        out = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, path = line.split()[:2]
                out.append((float(ts), os.path.join(root, path)))
        return out

    rgb = read_list("rgb.txt")
    if not with_depth:
        return rgb
    depth = read_list("depth.txt")
    dts = np.asarray([t for t, _ in depth])
    out = []
    for t, p in rgb:
        i = int(np.argmin(np.abs(dts - t)))
        if abs(dts[i] - t) <= max_diff:
            out.append((t, p, depth[i][1]))
    return out


def load_kitti_sequence(root, cam="image_0"):
    """Parse a KITTI odometry sequence folder (mono_kitti.cc LoadImages):
    times.txt gives per-frame seconds; frames are <cam>/%06d.png."""
    with open(os.path.join(root, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [(t, os.path.join(root, cam, f"{i:06d}.png"))
            for i, t in enumerate(times)]


# Default intrinsics from the reference's config files, so the example
# programs run the standard sequences without hand-typing calibrations.
TUM_CAMERAS = {
    # TUM1/2/3 from ORB-SLAM2's Examples/Monocular/TUM{1,2,3}.yaml
    "tum1": dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
                 k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
                 k3=1.163314, width=640, height=480),
    "tum2": dict(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
                 k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105,
                 k3=0.917205, width=640, height=480),
    "tum3": dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480),
}

KITTI_CAMERAS = {
    # KITTI00-02.yaml / KITTI03.yaml / KITTI04-12.yaml
    "kitti00-02": dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       width=1241, height=376),
    "kitti03": dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
                    width=1242, height=375),
    "kitti04-12": dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                       width=1226, height=370),
}
