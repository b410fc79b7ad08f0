"""Pinhole camera with radial-tangential distortion, batched
(port of mc_slam_tpu/camera.py).

Intrinsics are 0-d tensors on the device the camera was made for; width and
height are plain ints, as in the JAX NamedTuple.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.device import resolve


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    width: int
    height: int


def make_camera(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                width=752, height=480, dtype=torch.float32,
                device=None) -> Camera:
    device = resolve(device)
    a = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Camera(a(fx), a(fy), a(cx), a(cy), a(k1), a(k2), a(p1), a(p2), a(k3),
                  int(width), int(height))


def euroc_camera(dtype=torch.float32, device=None) -> Camera:
    """EuRoC cam0 intrinsics as in the reference config (config/euroc.yaml:54-62)."""
    return make_camera(458.654, 457.296, 367.215, 248.375,
                       k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                       p2=1.76187114e-05, width=752, height=480, dtype=dtype,
                       device=device)


def distort(cam: Camera, xn):
    """Apply radtan distortion to normalized coords xn: (..., 2) -> (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    xd = x * radial + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd, iters: int = 8):
    """Invert radtan by fixed-point iteration (OpenCV-style), fixed trip count."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy = x * y
        dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial],
                         dim=-1)
    return xn


def pixel_to_normalized(cam: Camera, uv):
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def normalized_to_pixel(cam: Camera, xn):
    return torch.stack([xn[..., 0] * cam.fx + cam.cx,
                        xn[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Undistort raw pixel keypoints -> ideal pixel coords (Frame::UndistortKeyPoints)."""
    return normalized_to_pixel(
        cam, undistort_normalized(cam, pixel_to_normalized(cam, uv), iters))


def project(cam: Camera, Xc, distortion: bool = False):
    """Project camera-frame points (..., 3) -> pixel (..., 2); also returns z."""
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
    xn = Xc[..., :2] / z_safe[..., None]
    if distortion:
        xn = distort(cam, xn)
    return normalized_to_pixel(cam, xn), z


def project_jacobian(cam: Camera, Xc):
    """d(pixel)/d(Xc): (..., 2, 3) for the ideal pinhole model."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    zr = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * inv_z, zr, -cam.fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zr, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)
