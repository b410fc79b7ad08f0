"""Plain ORB extraction: the benchmark's reference for the port's
`frontend/extractor.extract`.

A frozen, plain PyTorch statement of what the port's extractor computes,
written from its description and the reference's ORBextractor: an
8-level pyramid at scale 1.2 (antialiased triangle-kernel resize, the JAX
package's `jax.image.resize`), dual-threshold FAST-9 (20 / 7) with 3x3
non-max suppression and one corner per 32-pixel cell, per-level quotas, a
1-D parabola refinement of each corner, the IC angle on the raw level and
steered BRIEF (256 seeded Gaussian pairs, 32 rotation bins) on the
7x7-Gaussian-blurred level. It imports nothing of the port; images may
carry leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

RING = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
PATCH_R, BRIEF_R, NBINS = 15, 13, 32
PATCH_W = 2 * PATCH_R + 1


# ----------------------------------------------------------------- pyramid

def resize_weights(n_in, n_out):
    """(n_in, n_out) float32 weights of an antialiased linear resize
    (triangle kernel widened by 1/scale, rows normalized), with the sample
    position and the kernel scale rounded as XLA computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(img, h, w):
    """(..., H, W) -> (..., h, w): rows then columns, each a matrix product
    (batched images side by side in one product)."""
    H, W = img.shape[-2:]
    out = img
    if H != h:
        Rt = torch.from_numpy(resize_weights(H, h)).to(img.device).T
        lead = out.shape[:-2]
        side = out.reshape(-1, H, W).permute(1, 0, 2).reshape(H, -1)
        out = (Rt @ side).reshape(h, -1, W).permute(1, 0, 2).reshape(lead + (h, W))
    if W != w:
        out = out @ torch.from_numpy(resize_weights(W, w)).to(img.device)
    return out


def pyramid(img, n_levels, scale):
    H, W = img.shape[-2:]
    levels = [img]
    for i in range(1, n_levels):
        levels.append(resize(levels[-1], int(round(H / scale ** i)), int(round(W / scale ** i))))
    return levels


def pad(img, p, mode):
    """Pad the last two dims by p = (left, right, top, bottom)."""
    x = img.reshape((-1, 1) + img.shape[-2:])
    out = F.pad(x, p, mode=mode)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def blur(img, sigma=2.0, radius=3):
    """Separable 7x7 Gaussian, reflect padding, one shifted add per tap."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    k = [float(v) for v in (k / np.sum(k, dtype=np.float32)).astype(np.float32)]
    H, W = img.shape[-2:]
    p = pad(img, (0, 0, radius, radius), "reflect")
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * p[..., i:i + H, :]
    p = pad(out, (radius, radius, 0, 0), "reflect")
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * p[..., :, i:i + W]
    return out


# -------------------------------------------------------------------- FAST

def arc9(flags):
    """Whether 9 cyclically consecutive ring flags are set, per pixel."""
    bits = torch.zeros(flags[0].shape, dtype=torch.int32, device=flags[0].device)
    for i, f in enumerate(flags):
        bits = bits | (f.to(torch.int32) << i)
    x = bits | (bits << 16)
    r2 = x & (x >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    return ((r8 & (x >> 8)) & 0xFFFF) > 0


def inside(H, W, border, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)


def fast(img, th_hi, th_lo):
    """(corner at th_hi, corner at th_lo, score at th_lo) per pixel."""
    H, W = img.shape[-2:]
    p = pad(img, (3, 3, 3, 3), "replicate")
    d = [p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img for dx, dy in RING]
    hi = arc9([e > th_hi for e in d]) | arc9([e < -th_hi for e in d])
    lo = arc9([e > th_lo for e in d]) | arc9([e < -th_lo for e in d])
    pos, neg = torch.zeros_like(img), torch.zeros_like(img)
    for e in d:
        pos = pos + torch.clamp(e - th_lo, min=0.0)
        neg = neg + torch.clamp(-e - th_lo, min=0.0)
    inb = inside(H, W, 3, img.device)
    return hi & inb, lo & inb, torch.where(inb, torch.maximum(pos, neg), 0.0)


def detect(img, quota, th_hi, th_lo, cell=32, border=16):
    """Best corner of each cell (cells with a th_hi corner prefer those),
    the `quota` strongest cells in a stable order, parabola-refined.
    Returns xy (..., quota, 2), score (..., quota), valid (..., quota)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    c_hi, c_lo, score = fast(img, th_hi, th_lo)
    s_lo = torch.where(c_lo, score, 0.0)
    mx = F.max_pool2d(s_lo.reshape((-1, 1, H, W)), 3, 1, 1).reshape(s_lo.shape)
    keep = (s_lo >= mx) & (s_lo > 0) & inside(H, W, border, img.device)
    s_hi = torch.where(keep & c_hi, score, 0.0)
    s_lo = torch.where(keep, s_lo, 0.0)
    gh, gw = -(-H // cell), -(-W // cell)

    def cells(a):
        a = F.pad(a, (0, gw * cell - W, 0, gh * cell - H))
        return a.reshape(lead + (gh, cell, gw, cell)).transpose(-3, -2).reshape(
            lead + (gh * gw, cell * cell))

    ch, cl = cells(s_hi), cells(s_lo)
    use = torch.where((ch.amax(-1) > 0)[..., None], ch, cl)
    best, idx = torch.max(use, dim=-1)
    k = torch.arange(gh * gw, device=img.device)
    cy, cx = idx // cell + (k // gw) * cell, idx % cell + (k % gw) * cell
    n = min(quota, gh * gw)
    top, order = torch.sort(best, descending=True, stable=True)
    top, order = top[..., :n], order[..., :n]
    xi, yi = torch.gather(cx, -1, order), torch.gather(cy, -1, order)
    sp = F.pad(score, (1, 1, 1, 1)).flatten(-2)
    at = lambda y, x: torch.gather(sp, -1, y * (W + 2) + x)
    s0 = at(yi + 1, xi + 1)
    sxm, sxp = at(yi + 1, xi), at(yi + 1, xi + 2)
    sym, syp = at(yi, xi + 1), at(yi + 2, xi + 1)
    den_x, den_y = sxm - 2.0 * s0 + sxp, sym - 2.0 * s0 + syp
    dx = torch.where(den_x.abs() > 1e-6, 0.5 * (sxm - sxp) / den_x, 0.0).clamp(-0.5, 0.5)
    dy = torch.where(den_y.abs() > 1e-6, 0.5 * (sym - syp) / den_y, 0.0).clamp(-0.5, 0.5)
    xy = torch.stack([xi.to(torch.float32) + dx, yi.to(torch.float32) + dy], -1)
    valid = top > 0
    if n < quota:
        xy, top, valid = (F.pad(xy, (0, 0, 0, quota - n)), F.pad(top, (0, quota - n)),
                          F.pad(valid, (0, quota - n)))
    return xy, top, valid


# -------------------------------------------------------------------- BRIEF

def brief_pattern(seed=42, n=256, sigma=5.2):
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(0.0, sigma, size=(n, 4))), -BRIEF_R, BRIEF_R)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -BRIEF_R, BRIEF_R)
    return pts.astype(np.float32)


def steered_tables():
    """(NBINS, 256) flat patch indices of each test's two points at every
    quantized rotation."""
    pat = brief_pattern()
    I1 = np.zeros((NBINS, 256), np.int64)
    I2 = np.zeros((NBINS, 256), np.int64)
    for b in range(NBINS):
        th = 2.0 * np.pi * b / NBINS
        ca, sa = np.cos(th), np.sin(th)
        for s in range(256):
            x1, y1, x2, y2 = pat[s]
            for x, y, T in ((x1, y1, I1), (x2, y2, I2)):
                rx = int(np.clip(np.round(ca * x - sa * y), -PATCH_R, PATCH_R))
                ry = int(np.clip(np.round(sa * x + ca * y), -PATCH_R, PATCH_R))
                T[b, s] = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)
    return I1, I2


_TABLES = steered_tables()
_d = np.arange(-PATCH_R, PATCH_R + 1)
_disc = (_d[None, :] ** 2 + _d[:, None] ** 2) <= PATCH_R * PATCH_R
MOMENTS = np.stack([(_disc * _d[None, :]).reshape(-1),
                    (_disc * _d[:, None]).reshape(-1)], 1).astype(np.float32)


def patches(img, xy):
    """(..., K, 31, 31) windows around the rounded keypoints, clamped inside."""
    H, W = img.shape[-2:]
    xi = torch.round(xy).to(torch.int64)
    y0 = torch.clamp(xi[..., 1] - PATCH_R, 0, H - PATCH_W)
    x0 = torch.clamp(xi[..., 0] - PATCH_R, 0, W - PATCH_W)
    off = torch.arange(PATCH_W, device=img.device)
    rows = (y0[..., None] + off)[..., :, None]
    cols = (x0[..., None] + off)[..., None, :]
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def ic_angle(p):
    m = p.reshape(-1, PATCH_W * PATCH_W) @ torch.from_numpy(MOMENTS).to(p.device)
    m = m.reshape(p.shape[:-2] + (2,))
    return torch.atan2(m[..., 1], m[..., 0])


def brief(p_blur, angle):
    """(..., K, 256) {0, 1} bits: sign of I(second) - I(first) at the
    keypoint's rotation bin, with each intensity split into its integer part
    and a bfloat16 remainder (the JAX package's exact two-term product)."""
    i1, i2 = (torch.from_numpy(t).to(p_blur.device) for t in _TABLES)
    flat = p_blur.flatten(-2)
    hi = torch.round(flat)
    lo = (flat - hi).to(torch.bfloat16).to(torch.float32)
    b = torch.remainder(torch.round(torch.remainder(angle, 2 * np.pi)
                                    * (NBINS / (2 * np.pi))).to(torch.int64), NBINS)
    s1, s2 = i1[b], i2[b]
    d = (torch.gather(hi, -1, s2) - torch.gather(hi, -1, s1)) \
        + (torch.gather(lo, -1, s2) - torch.gather(lo, -1, s1))
    return (d > 0).to(torch.int32)


def pack(bits):
    """(..., K, 256) bits -> (..., K, 8) int32 words, bit j of word w is bit 32w + j."""
    v = torch.sum(bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
                  << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def quotas(n_features, n_levels, scale):
    inv = [(1.0 / scale) ** i for i in range(n_levels)]
    q = [int(round(n_features * v / sum(inv))) for v in inv]
    q[0] += n_features - sum(q)
    return q


def extract(img, n_features=1024, n_levels=8, scale=1.2, th_hi=20.0, th_lo=7.0):
    """ORB features of (..., H, W) images: dict of xy (level-0 pixels,
    distorted), level, angle, desc (packed words), pm1 (+/-1 int8), valid;
    exactly n_features rows, level by level."""
    img = img.to(torch.float32)
    lead = img.shape[:-2]
    xys, lvls, valids, raw, blurred = [], [], [], [], []
    for li, (lv, q) in enumerate(zip(pyramid(img, n_levels, scale),
                                     quotas(n_features, n_levels, scale))):
        if q == 0:
            continue
        xy, _, valid = detect(lv, q, th_hi, th_lo)
        raw.append(patches(lv, xy))
        blurred.append(patches(blur(lv), xy))
        xys.append(xy * scale ** li)
        lvls.append(torch.full(lead + (q,), li, dtype=torch.int32, device=img.device))
        valids.append(valid)
    valid = torch.cat(valids, -1)
    angle = ic_angle(torch.cat(raw, -3))
    bits = brief(torch.cat(blurred, -3), angle) * valid[..., None].to(torch.int32)
    return dict(xy=torch.cat(xys, -2), level=torch.cat(lvls, -1), angle=angle,
                desc=pack(bits), pm1=(bits.to(torch.int8) * 2 - 1), valid=valid)
