"""The clone's textured room, made and rendered on the device.

Six textured planes of an axis-aligned box, ray-cast through the EuRoC
camera's radial-tangential distortion: the world of the euroc clone
(`mc_slam_tpu_torch/sim/room.py`, `tools/eval_clone.py`), written here in
torch so that a run makes its world and its frames on the card in a few
large calls. The textures come from a `torch.Generator` seeded by the run;
the rendering follows the port's numpy renderer step for step, so the same
textures give the same grey levels to within one level
(`benchmark/tests/test_bench_sim.py`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BOUNDS = ((-10.0, 10.0), (-6.0, 6.0), (0.0, 6.0))


def _planes():
    """(O, U, V, n) of the four walls, the floor and the ceiling, float64."""
    (x0, x1), (y0, y1), (z0, z1) = BOUNDS
    rows = [
        ((x0, y0, z0), (0, y1 - y0, 0), (0, 0, z1 - z0), (1.0, 0, 0)),
        ((x1, y0, z0), (0, y1 - y0, 0), (0, 0, z1 - z0), (-1.0, 0, 0)),
        ((x0, y0, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), (0, 1.0, 0)),
        ((x0, y1, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), (0, -1.0, 0)),
        ((x0, y0, z0), (x1 - x0, 0, 0), (0, y1 - y0, 0), (0, 0, 1.0)),
        ((x0, y0, z1), (x1 - x0, 0, 0), (0, y1 - y0, 0), (0, 0, -1.0)),
    ]
    return [torch.tensor([r[i] for r in rows], dtype=torch.float64) for i in range(4)]


def make_textures(gen, size=1024, device=None):
    """(n, size, size) float32 textures in [0, 255]: value noise over five
    octaves, small speckles and checker or noise posters, with the numbers
    and sizes of the port's `make_texture`. Every draw comes from `gen`."""
    n, octaves, persistence = 6, 5, 0.55
    dev = device if device is not None else gen.device
    img = torch.zeros((n, size, size), dtype=torch.float32, device=dev)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        k = max(2, size >> (octaves - 1 - o))
        coarse = torch.rand((n, 1, k, k), generator=gen, device=dev)
        img += amp * F.interpolate(coarse, size=(size, size), mode="bilinear",
                                   align_corners=True)[:, 0]
        total += amp
        amp *= persistence
    tex = img / total * 140 + 40

    # speckles: squares of 2-5 texels; a later one covers an earlier one
    n_sp = int(4000 * (size / 1024) ** 2)
    yx = torch.randint(2, size - 6, (n, n_sp, 2), generator=gen, device=dev)
    side = torch.randint(2, 6, (n, n_sp), generator=gen, device=dev)
    val = torch.rand((n, n_sp), generator=gen, device=dev) * 255
    off = torch.arange(5, device=dev)
    dy, dx = off[:, None].expand(5, 5).reshape(-1), off[None, :].expand(5, 5).reshape(-1)
    inside = (dy[None, None] < side[..., None]) & (dx[None, None] < side[..., None])
    flat = ((torch.arange(n, device=dev)[:, None, None] * size
             + yx[..., 0:1] + dy) * size + yx[..., 1:2] + dx)
    ids = torch.arange(n_sp, device=dev)[None, :, None].expand(n, n_sp, 25)
    ids = torch.where(inside, ids, -1)
    top = torch.full((n * size * size,), -1, dtype=torch.int64, device=dev)
    top = top.scatter_reduce(0, flat.reshape(-1), ids.reshape(-1), reduce="amax")
    got = top >= 0
    plane = torch.arange(n * size * size, device=dev) // (size * size)
    spv = val.reshape(-1)[(plane * n_sp + top.clamp(min=0))]
    tex = torch.where(got, spv, tex.reshape(-1)).reshape(n, size, size)

    # posters: checkerboards and noise patches, pasted in order
    n_po = max(24, int(24 * (size / 1024) ** 2))
    p = torch.cat([torch.randint(0, size - 160, (n, n_po, 2), generator=gen, device=dev),
                   torch.randint(60, 160, (n, n_po, 2), generator=gen, device=dev),
                   torch.randint(0, 2, (n, n_po, 1), generator=gen, device=dev),
                   torch.randint(6, 18, (n, n_po, 1), generator=gen, device=dev)], -1)
    shade = (torch.rand((n, n_po), generator=gen, device=dev) * 95 + 120).tolist()
    noise = torch.rand((n, 160, 160), generator=gen, device=dev) * 255
    ar = torch.arange(160, device=dev)
    for i, rows in enumerate(p.tolist()):
        for j, (y, x, h, w, kind, sq) in enumerate(rows):
            if kind == 0:
                chk = ((ar[:h, None] // sq + ar[None, :w] // sq) % 2).to(torch.float32)
                tex[i, y:y + h, x:x + w] = chk * shade[i][j] + 30
            else:
                tex[i, y:y + h, x:x + w] = noise[i, :h, :w]
    return tex.clamp(0, 255)


def undistort_normalized(k, xd, iters=20):
    """Invert radtan distortion (k = (k1, k2, p1, p2, k3)) by fixed-point
    iteration, as the port's camera does for its ray grid."""
    k1, k2, p1, p2, k3 = k
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = x * y
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], -1)
    return xn


def pixel_rays(intr, width, height, device):
    """(H*W, 3) float32 camera-frame rays (z = 1) through pixel centres;
    intr = (fx, fy, cx, cy, k1, k2, p1, p2, k3)."""
    fx, fy, cx, cy = intr[:4]
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device) + 0.5,
                          torch.arange(width, dtype=torch.float32, device=device) + 0.5,
                          indexing="ij")
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    xd = torch.stack([(u - f32(cx)) / f32(fx), (v - f32(cy)) / f32(fy)], -1).reshape(-1, 2)
    k = [f32(a) for a in intr[4:]]
    xn = undistort_normalized(k, xd)
    return torch.cat([xn, torch.ones_like(xn[:, :1])], 1)


class Room:
    """The box with its six textures (n = 6, T, T) float32 on one device."""

    def __init__(self, textures, tex_scale=1.0):
        self.tex = textures
        dev = textures.device
        O, U, V, n = _planes()
        self.O64, self.n64 = O.to(dev), n.to(dev)
        self.O, self.n = O.to(dev, torch.float32), n.to(dev, torch.float32)
        lu, lv = U.norm(dim=1), V.norm(dim=1)
        self.Uh, self.Vh = (U / lu[:, None]).to(dev, torch.float32), \
            (V / lv[:, None]).to(dev, torch.float32)
        self.su = (lu * tex_scale).to(dev, torch.float32)
        self.sv = (lv * tex_scale).to(dev, torch.float32)

    def render(self, rays, Rwc, Cw, height, width):
        """Grey uint8 images (N, H, W) and z-depths (N, H, W) float32 of
        cameras at world-from-camera rotations Rwc (N, 3, 3) and centres
        Cw (N, 3); rays from `pixel_rays`."""
        N = Rwc.shape[0]
        d = rays[None] @ Rwc.to(torch.float32).transpose(1, 2)          # (N, HW, 3)
        C = Cw.to(torch.float32)
        denom = d @ self.n.T                                           # (N, HW, 6)
        num = ((self.O64[None] - C.to(torch.float64)[:, None]) * self.n64[None]).sum(-1)
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        tt = num.to(torch.float32)[:, None, :] / denom
        tt = torch.where(tt > 0.05, tt, math.inf)
        best_t, win = torch.min(tt, dim=-1)
        X = C[:, None] + d * best_t[..., None]
        rel = X - self.O[win]
        a = (rel * self.Uh[win]).sum(-1) / self.su[win]
        b = (rel * self.Vh[win]).sum(-1) / self.sv[win]
        T = self.tex.shape[-1]
        ui = torch.remainder(a, 1.0) * (T - 1)
        vi = torch.remainder(b, 1.0) * (T - 1)
        u0, v0 = ui.to(torch.int64), vi.to(torch.int64)
        u1, v1 = (u0 + 1).clamp(max=T - 1), (v0 + 1).clamp(max=T - 1)
        fu, fv = ui - u0, vi - v0
        flat = self.tex.reshape(-1)
        base = win * (T * T)
        at = lambda v, u: flat[base + v * T + u]
        val = (at(v0, u0) * (1 - fv) * (1 - fu) + at(v0, u1) * (1 - fv) * fu
               + at(v1, u0) * fv * (1 - fu) + at(v1, u1) * fv * fu)
        img = val.clamp(0, 255).to(torch.uint8).reshape(N, height, width)
        return img, best_t.reshape(N, height, width)
