"""ASL-folder (EuRoC MAV format) dataset writer.

Produces the exact on-disk layout mono_EuRoC_vins.cc expects
(Examples/Monocular/mono_EuRoC_vins.cc:274-330):

    mav0/cam0/data.csv            timestamp [ns], filename
    mav0/cam0/data/<ts>.png       grayscale 8-bit
    mav0/imu0/data.csv            ts, gyro xyz [rad/s], accel xyz [m/s^2]
    mav0/state_groundtruth_estimate0/data.csv   ts, pos xyz, quat wxyz, vel, biases

The port's own copy of mc_slam_tpu/sim/euroc_writer.py (numpy only; the port imports nothing of
the JAX package).
"""
from __future__ import annotations

import os

import numpy as np


def _quat_wxyz(R):
    """Rotation matrix -> quaternion (w, x, y, z)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diagonal(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return w, x, y, z


class EurocWriter:
    def __init__(self, out_dir):
        self.root = os.path.join(out_dir, "mav0")
        self.cam_dir = os.path.join(self.root, "cam0", "data")
        os.makedirs(self.cam_dir, exist_ok=True)
        os.makedirs(os.path.join(self.root, "imu0"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "state_groundtruth_estimate0"),
                    exist_ok=True)
        self.cam_rows = []
        self.imu_rows = []
        self.gt_rows = []

    def add_image(self, t, img_u8):
        from PIL import Image
        ns = int(round(t * 1e9))
        name = f"{ns}.png"
        Image.fromarray(img_u8, mode="L").save(os.path.join(self.cam_dir, name))
        self.cam_rows.append((ns, name))

    def add_imu(self, t, gyro, accel):
        ns = int(round(t * 1e9))
        self.imu_rows.append((ns, *gyro, *accel))

    def add_gt(self, t, P, R, V=np.zeros(3), bg=np.zeros(3), ba=np.zeros(3)):
        ns = int(round(t * 1e9))
        w, x, y, z = _quat_wxyz(R)
        self.gt_rows.append((ns, *P, w, x, y, z, *V, *bg, *ba))

    def finish(self):
        with open(os.path.join(self.root, "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, name in self.cam_rows:
                f.write(f"{ns},{name}\n")
        with open(os.path.join(self.root, "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                    "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
            for row in self.imu_rows:
                f.write(",".join(str(v) for v in row) + "\n")
        gt_path = os.path.join(self.root, "state_groundtruth_estimate0", "data.csv")
        with open(gt_path, "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                    "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
                    "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], "
                    "b_w_RS_S_x [rad s^-1], b_w_RS_S_y [rad s^-1], "
                    "b_w_RS_S_z [rad s^-1], b_a_RS_S_x [m s^-2], "
                    "b_a_RS_S_y [m s^-2], b_a_RS_S_z [m s^-2]\n")
            for row in self.gt_rows:
                f.write(",".join(str(v) for v in row) + "\n")
        return gt_path
