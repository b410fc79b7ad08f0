"""The clone's MAV path, its camera poses and its IMU rows, on the device.

The smooth closed path of the port's `sim/trajectory.py` (sums of sines
whose periods divide the duration, yaw-pitch-roll attitude), evaluated for
a whole tensor of times at once in float64. IMU rows follow the reference's
conventions: the gyro measures the body rate, the accelerometer the specific
force R^T (a_w - g_w); biases are added and white noise of the EuRoC
densities (config/euroc.yaml) drawn from the run's generator.
"""
from __future__ import annotations

import math

import torch

G = 9.81
# the reference's EuRoC body-from-camera transform (config/euroc.yaml:40-44)
TBC = ((0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975),
       (0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768),
       (-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949),
       (0.0, 0.0, 0.0, 1.0))
NOISE_G = 1.7e-4      # gyro noise density, rad/s/sqrt(Hz)
NOISE_A = 2.0e-3      # accelerometer noise density, m/s^2/sqrt(Hz)


def rot_axis(angle, axis):
    """(..., 3, 3) rotations by `angle` (...,) about the unit axis 0, 1 or 2."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == 0:
        rows = ((o, z, z), (z, c, -s), (z, s, c))
    elif axis == 1:
        rows = ((c, z, s), (z, o, z), (-s, z, c))
    else:
        rows = ((c, -s, z), (s, c, z), (z, z, o))
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def so3_log(R):
    """(..., 3, 3) -> (..., 3) rotation vectors (angles below pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    th = torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.where(th < 1e-8, 0.5 + th * th / 12, th / (2 * torch.sin(th).clamp(min=1e-30)))
    return s[..., None] * w


class Trajectory:
    """MH-like closed path of `duration` seconds inside the room."""

    def __init__(self, duration=120.0, phase=0.0):
        self.T = float(duration)
        self.ex, self.ey, self.ez = 6.0, 3.0, 0.9      # excursions (m)
        self.z0 = 1.6
        self.k1, self.k2, self.k3 = 1.0, 2.0, 3.0      # speed mix
        self.ph = float(phase)

    def pose(self, t):
        """Body poses at times t (N,) float64: (P_wb (N, 3), R_wb (N, 3, 3))."""
        w = 2.0 * math.pi / self.T
        k1, k2, k3, p = self.k1, self.k2, self.k3, self.ph
        nd = round(1.3 / w)
        ex, ey, ez = self.ex, self.ey, self.ez
        P = torch.stack([
            ex * torch.sin(k1 * w * t + p) + 0.22 * ex * torch.sin(k3 * w * t)
            + 0.55 * torch.sin(nd * w * t),
            ey * torch.sin(k2 * w * t + 0.7 + p) + 0.2 * ey * torch.sin(k3 * w * t + 1.3)
            + 0.45 * torch.sin((nd + 1) * w * t + 0.9),
            self.z0 + ez * torch.sin(k2 * w * t + 1.0)
            + 0.25 * torch.sin((nd - 1) * w * t + 0.5)], -1)
        yaw = 0.9 * torch.sin(k1 * w * t + 0.3) + 0.45 * torch.sin(k2 * w * t + 2.0)
        pitch = 0.10 * torch.sin(2.1 * k2 * w * t + 0.5) + 0.06 * torch.sin(5.0 * w * t)
        roll = 0.12 * torch.sin(1.7 * k2 * w * t + 1.1) + 0.05 * torch.sin(4.2 * w * t + 0.4)
        R = rot_axis(yaw, 2) @ rot_axis(pitch, 1) @ rot_axis(roll, 0)
        return P, R

    def camera(self, t):
        """World-from-camera (R_wc (N, 3, 3), C_w (N, 3)) at times t."""
        P, R = self.pose(t)
        Tbc = torch.tensor(TBC, dtype=torch.float64, device=t.device)
        return R @ Tbc[:3, :3], P + (R @ Tbc[:3, 3:4])[..., 0]

    def imu(self, t0, n_rows, rate=200.0, bg=(0.0, 0.0, 0.0), ba=(0.0, 0.0, 0.0),
            noise_scale=0.0, gen=None, device=None):
        """(n_rows, 7) float32 [gyro, accel, dt] rows from t0 at `rate` Hz,
        each read at the middle of its interval; white noise of the EuRoC
        densities times `noise_scale`, drawn from `gen`."""
        dt = 1.0 / rate
        tm = t0 + (torch.arange(n_rows, dtype=torch.float64, device=device) + 0.5) * dt
        _, R1 = self.pose(tm - 1e-4)
        _, R2 = self.pose(tm + 1e-4)
        gyro = so3_log(R1.transpose(1, 2) @ R2) / 2e-4
        e = 1e-3
        acc_w = (self.pose(tm + e)[0] - 2 * self.pose(tm)[0] + self.pose(tm - e)[0]) / (e * e)
        acc_w = acc_w + torch.tensor([0.0, 0.0, G], dtype=torch.float64, device=device)
        _, R = self.pose(tm)
        acc = (R.transpose(1, 2) @ acc_w[..., None])[..., 0]
        rows = torch.cat([gyro + torch.tensor(bg, dtype=torch.float64, device=device),
                          acc + torch.tensor(ba, dtype=torch.float64, device=device),
                          torch.full((n_rows, 1), dt, dtype=torch.float64, device=device)], 1)
        if noise_scale > 0:
            z = torch.randn((n_rows, 6), generator=gen, device=device, dtype=torch.float64)
            sig = torch.tensor([NOISE_G] * 3 + [NOISE_A] * 3, dtype=torch.float64,
                               device=device)
            rows[:, :6] += z * sig * noise_scale
        return rows.to(torch.float32)
