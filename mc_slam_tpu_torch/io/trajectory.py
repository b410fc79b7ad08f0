"""Trajectory writers: TUM, KITTI, and NavState formats.

Replaces System::SaveTrajectoryTUM (src/System.cpp:434-491),
SaveKeyFrameTrajectoryTUM (:495-528), SaveTrajectoryKITTI (:532-587) and the
NavState dump with velocity and biases SaveKeyFrameTrajectoryNavState (:35-74).

The port's own copy of mc_slam_tpu/io/trajectory.py (numpy only; the port imports nothing of
the JAX package).
"""
from __future__ import annotations

import numpy as np


def _rot_to_quat(R):
    """(3,3) -> (x, y, z, w) as the TUM format expects."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return np.asarray([x, y, z, w])


def save_tum(path, traj):
    """traj: [(t, P (3,), R (3,3))] world-from-body. TUM: t x y z qx qy qz qw."""
    with open(path, "w") as f:
        for t, P, R in traj:
            q = _rot_to_quat(np.asarray(R))
            f.write("%.6f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n" %
                    (t, P[0], P[1], P[2], q[0], q[1], q[2], q[3]))


def save_kitti(path, traj):
    """KITTI: 12 numbers per row, row-major [R | t]."""
    with open(path, "w") as f:
        for t, P, R in traj:
            R = np.asarray(R)
            f.write(" ".join("%.9e" % v for v in
                             np.concatenate([np.concatenate([R[i], [P[i]]])
                                             for i in range(3)])) + "\n")


def save_navstate(path, entries):
    """entries: [(t, P, q_or_R, V, bg_full, ba_full)] — the reference's
    KeyFrameTrajectoryNavState layout: t P V q bg+dbg ba+dba."""
    with open(path, "w") as f:
        for t, P, R, V, bg, ba in entries:
            q = _rot_to_quat(np.asarray(R))
            row = [t, *P, *V, *q, *bg, *ba]
            f.write(" ".join("%.7f" % v for v in row) + "\n")


def load_tum(path):
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, 4:8]
