"""Analytic MAV trajectories with exact IMU (port of mc_slam_tpu/sim/trajectory.py).

Smooth closed path from sums of sines whose periods divide the duration.
IMU samples follow the reference's conventions: gyro in body, accelerometer
measures specific force R^T (a_w - g_w) + bias + noise. numpy throughout;
the body rate goes through the port's float32 `lie.so3_log`, as the JAX
package's goes through its own.
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch import lie

G = 9.81
GW = np.array([0.0, 0.0, -G])


def _rodrigues(v):
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


class MavTrajectory:
    """MH-like closed path inside a room; `extent` sets the excursions (m)."""

    def __init__(self, duration=120.0, extent=(6.0, 3.0, 0.9), z0=1.6,
                 speed_mix=(1.0, 2.0, 3.0), seed_phase=0.0, yaw_scale=1.0):
        self.T = float(duration)
        self.ex, self.ey, self.ez = extent
        self.z0 = z0
        self.k1, self.k2, self.k3 = speed_mix
        self.ph = seed_phase
        self.yaw_scale = float(yaw_scale)

    def pose(self, t):
        """(P_wb (3,), R_wb (3,3)) body pose; the path closes at t=T."""
        w = 2.0 * np.pi / self.T
        k1, k2, k3 = self.k1, self.k2, self.k3
        p = self.ph
        nd = round(1.3 / w)  # ~1.3 rad/s dither
        P = np.array([
            self.ex * np.sin(k1 * w * t + p) + 0.22 * self.ex * np.sin(k3 * w * t)
            + 0.55 * np.sin(nd * w * t),
            self.ey * np.sin(k2 * w * t + 0.7 + p) + 0.2 * self.ey * np.sin(k3 * w * t + 1.3)
            + 0.45 * np.sin((nd + 1) * w * t + 0.9),
            self.z0 + self.ez * np.sin(k2 * w * t + 1.0)
            + 0.25 * np.sin((nd - 1) * w * t + 0.5),
        ])
        yaw = self.yaw_scale * (0.9 * np.sin(k1 * w * t + 0.3)
                                + 0.45 * np.sin(k2 * w * t + 2.0))
        pitch = 0.10 * np.sin(2.1 * k2 * w * t + 0.5) + 0.06 * np.sin(5.0 * w * t)
        roll = 0.12 * np.sin(1.7 * k2 * w * t + 1.1) + 0.05 * np.sin(4.2 * w * t + 0.4)
        R = _rodrigues([0, 0, yaw]) @ _rodrigues([0, pitch, 0]) @ _rodrigues([roll, 0, 0])
        return P.astype(np.float64), R

    def velocity(self, t, eps=1e-4):
        P1, _ = self.pose(t - eps)
        P2, _ = self.pose(t + eps)
        return (P2 - P1) / (2 * eps)

    def accel(self, t, eps=1e-3):
        P0, _ = self.pose(t - eps)
        P1, _ = self.pose(t)
        P2, _ = self.pose(t + eps)
        return (P2 - 2 * P1 + P0) / (eps * eps)

    def omega_body(self, t, eps=1e-4):
        _, R1 = self.pose(t - eps)
        _, R2 = self.pose(t + eps)
        rel = torch.as_tensor(R1.T @ R2, dtype=torch.float32)
        return lie.so3_log(rel).numpy() / (2 * eps)

    def imu_samples(self, t0, t1, rate=200.0, bg=np.zeros(3), ba=np.zeros(3),
                    noise_g=0.0, noise_a=0.0, rng=None):
        """(T, 7) float32 [gyro, accel, dt] rows covering [t0, t1)."""
        dt = 1.0 / rate
        ts = np.arange(t0, t1 - 1e-9, dt)
        rows = np.zeros((len(ts), 7), np.float64)
        for k, t in enumerate(ts):
            tm = t + 0.5 * dt
            _, R = self.pose(tm)
            rows[k, 0:3] = self.omega_body(tm) + bg
            rows[k, 3:6] = R.T @ (self.accel(tm) - GW) + ba
            rows[k, 6] = dt
        if rng is not None and (noise_g > 0 or noise_a > 0):
            rows[:, 0:3] += rng.normal(size=(len(ts), 3)) * noise_g
            rows[:, 3:6] += rng.normal(size=(len(ts), 3)) * noise_a
        return rows.astype(np.float32)
