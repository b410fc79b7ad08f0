"""Textured-room renderer (port of mc_slam_tpu/sim/room.py): 6 textured
planes ray-cast per frame through the target camera's radtan distortion.

numpy throughout, as the JAX package's; only the per-pixel ray grid goes
through the port's `camera.undistort_normalized` (on CPU tensors). The same
numpy seed gives the same textures; rendered grey levels may differ by one
where the ray undistortion rounds differently.
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera, undistort_normalized


def _value_noise(rng, size, octaves=5, persistence=0.55):
    """(size, size) float in [0, 1]: summed bilinear-upsampled noise octaves."""
    img = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = max(2, size >> (octaves - 1 - o))
        coarse = rng.random((n, n)).astype(np.float32)
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, n - 1)
        x1 = np.minimum(x0 + 1, n - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
              + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
              + coarse[np.ix_(y1, x1)] * fy * fx)
        img += amp * up
        total += amp
        amp *= persistence
    return img / total


def make_texture(rng, size=1024, n_speckle=4000, n_posters=24):
    """float32 texture in [0, 255] with corners at many scales."""
    base = _value_noise(rng, size) * 140 + 40
    for _ in range(n_speckle):
        y, x = rng.integers(2, size - 6, 2)
        s = int(rng.integers(2, 6))
        base[y:y + s, x:x + s] = rng.uniform(0, 255)
    for _ in range(n_posters):
        y, x = rng.integers(0, size - 160, 2)
        h, w = rng.integers(60, 160, 2)
        kind = rng.integers(0, 2)
        if kind == 0:
            sq = int(rng.integers(6, 18))
            yy, xx = np.mgrid[0:h, 0:w]
            val = (((yy // sq) + (xx // sq)) % 2) * rng.uniform(120, 215) + 30
        else:
            val = rng.uniform(0, 255, size=(h, w))
        base[y:y + h, x:x + w] = val
    return np.clip(base, 0, 255).astype(np.float32)


class RoomWorld:
    """Axis-aligned textured box [xmin,xmax]x[ymin,ymax]x[zmin,zmax]."""

    def __init__(self, rng, bounds=((-10.0, 10.0), (-6.0, 6.0), (0.0, 6.0)),
                 tex_size=1024, tex_scale=0.55, n_speckle=None,
                 weak_walls=(), weak_contrast=0.3):
        (x0, x1), (y0, y1), (z0, z1) = bounds
        self.bounds = bounds
        self.planes = []
        specs = [
            # walls
            (np.array([x0, y0, z0]), np.array([0, y1 - y0, 0]), np.array([0, 0, z1 - z0]), np.array([1.0, 0, 0])),
            (np.array([x1, y0, z0]), np.array([0, y1 - y0, 0]), np.array([0, 0, z1 - z0]), np.array([-1.0, 0, 0])),
            (np.array([x0, y0, z0]), np.array([x1 - x0, 0, 0]), np.array([0, 0, z1 - z0]), np.array([0, 1.0, 0])),
            (np.array([x0, y1, z0]), np.array([x1 - x0, 0, 0]), np.array([0, 0, z1 - z0]), np.array([0, -1.0, 0])),
            # floor + ceiling
            (np.array([x0, y0, z0]), np.array([x1 - x0, 0, 0]), np.array([0, y1 - y0, 0]), np.array([0, 0, 1.0])),
            (np.array([x0, y0, z1]), np.array([x1 - x0, 0, 0]), np.array([0, y1 - y0, 0]), np.array([0, 0, -1.0])),
        ]
        if n_speckle is None:
            n_speckle = int(4000 * (tex_size / 1024) ** 2)
        n_posters = max(24, int(24 * (tex_size / 1024) ** 2))
        for pi, (O, U, V, n) in enumerate(specs):
            tex = make_texture(rng, tex_size, n_speckle=n_speckle,
                               n_posters=n_posters)
            if pi in weak_walls:
                tex = np.clip(118.0 + weak_contrast * (tex - 118.0),
                              0, 255).astype(tex.dtype)
            self.planes.append((O.astype(np.float64), U.astype(np.float64),
                                V.astype(np.float64), n.astype(np.float64), tex))
        self.tex_scale = tex_scale
        self._ray_cache = {}

    def _rays(self, cam: Camera):
        """Per-pixel unit rays in CAMERA frame through the inverse distortion."""
        key = (int(cam.width), int(cam.height), float(cam.k1))
        if key not in self._ray_cache:
            H, W = cam.height, cam.width
            u, v = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                               np.arange(H, dtype=np.float32) + 0.5)
            xd = np.stack([(u - float(cam.cx)) / float(cam.fx),
                           (v - float(cam.cy)) / float(cam.fy)], -1)
            cam_cpu = Camera(*[f.cpu() if isinstance(f, torch.Tensor) else f
                               for f in cam])
            xn = undistort_normalized(cam_cpu, torch.from_numpy(
                np.ascontiguousarray(xd.reshape(-1, 2))), iters=20).numpy()
            rays = np.concatenate([xn, np.ones((xn.shape[0], 1), np.float32)], 1)
            self._ray_cache[key] = rays.reshape(H, W, 3).astype(np.float32)
        return self._ray_cache[key]

    def render(self, cam: Camera, Rwc, Cw, with_depth=False):
        """Grayscale uint8 (H, W) image seen by a camera at world-from-camera
        (Rwc, Cw); optionally also the camera z-depth map (float32)."""
        H, W = cam.height, cam.width
        rays_c = self._rays(cam).reshape(-1, 3)
        d = rays_c @ np.asarray(Rwc, np.float32).T
        C = np.asarray(Cw, np.float32)
        n_pix = d.shape[0]
        ts = self.tex_scale
        t_all = np.full((len(self.planes), n_pix), np.inf, np.float32)
        for pi, (O, U, Vv, n, tex) in enumerate(self.planes):
            n32 = n.astype(np.float32)
            denom = d @ n32
            tt = float((O - C) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            t_all[pi] = np.where(tt > 0.05, tt, np.inf)
        winner = np.argmin(t_all, axis=0)
        best_t = t_all[winner, np.arange(n_pix)]
        img = np.zeros(n_pix, np.float32)
        for pi, (O, U, Vv, n, tex) in enumerate(self.planes):
            hit = winner == pi
            if not hit.any():
                continue
            X = C + d[hit] * best_t[hit, None]
            lu = np.linalg.norm(U)
            lv = np.linalg.norm(Vv)
            a = ((X - O.astype(np.float32)) @ (U / lu).astype(np.float32)) / (lu * ts)
            b = ((X - O.astype(np.float32)) @ (Vv / lv).astype(np.float32)) / (lv * ts)
            Ht, Wt = tex.shape
            ui = (a % 1.0) * (Wt - 1)
            vi = (b % 1.0) * (Ht - 1)
            u0 = ui.astype(int)
            v0 = vi.astype(int)
            u1 = np.minimum(u0 + 1, Wt - 1)
            v1 = np.minimum(v0 + 1, Ht - 1)
            fu = ui - u0
            fv = vi - v0
            val = (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u1] * (1 - fv) * fu
                   + tex[v1, u0] * fv * (1 - fu) + tex[v1, u1] * fv * fu)
            img[hit] = val
        img = img.reshape(H, W)
        if with_depth:
            z = (best_t * (rays_c[:, 2])).reshape(H, W).astype(np.float32)
            return np.clip(img, 0, 255).astype(np.uint8), z
        return np.clip(img, 0, 255).astype(np.uint8)
