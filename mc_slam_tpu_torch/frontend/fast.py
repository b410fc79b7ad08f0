"""FAST-16/9 corner detection as dense tensor ops (port of mc_slam_tpu/frontend/fast.py).

Per-pixel 16-point Bresenham ring test with the dual-threshold scheme
(ini=20, min=7), 3x3 non-max suppression, one best keypoint per grid cell
and a global top-k. Ties follow the JAX package: the per-cell argmax takes
the first maximum and the top-k keeps equal scores in ascending index order
(a stable descending sort, not `torch.topk`, which promises no tie order).
Every function takes (H, W) images or a batch (B, H, W) of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mc_slam_tpu_torch.frontend.pyramid import pad2d

# Bresenham circle of radius 3, (dx, dy), starting at top and going clockwise
RING_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def _ring_views(img):
    """The 16 ring-neighbour intensity maps via an edge-padded image."""
    H, W = img.shape[-2:]
    p = pad2d(img, (3, 3, 3, 3), "replicate")
    return [p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for (dx, dy) in RING_OFFSETS]


def _contiguous_arc(flags):
    """flags: 16 (H, W) bool maps. True where 9 consecutive ring positions
    (cyclic) are all set: pack into int32, duplicate the low 16 bits, then a
    log-doubling AND-shift finds runs of >= 9."""
    bits = torch.zeros(flags[0].shape, dtype=torch.int32, device=flags[0].device)
    for i in range(16):
        bits = bits | (flags[i].to(torch.int32) << i)
    x = bits | (bits << 16)
    r2 = x & (x >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (x >> 8)
    return (r9 & 0xFFFF) > 0


def fast_response_dual(img, th_hi, th_lo):
    """Dense FAST over BOTH thresholds in one ring pass.
    Returns (corner_hi, corner_lo, score); score is at the low threshold."""
    d = [r - img for r in _ring_views(img)]
    corner_hi = (_contiguous_arc([di > th_hi for di in d])
                 | _contiguous_arc([di < -th_hi for di in d]))
    corner_lo = (_contiguous_arc([di > th_lo for di in d])
                 | _contiguous_arc([di < -th_lo for di in d]))
    pos = torch.zeros_like(img)
    neg = torch.zeros_like(img)
    for di in d:           # ring order, as the reduction over the ring axis
        pos = pos + torch.clamp(di - th_lo, min=0.0)
        neg = neg + torch.clamp(-di - th_lo, min=0.0)
    score = torch.maximum(pos, neg)
    inb = _inside(img.shape[-2:], 3, img.device)
    return corner_hi & inb, corner_lo & inb, torch.where(inb, score, 0.0)


def _inside(shape, border, device):
    H, W = shape
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)


def nms3(score):
    """3x3 non-max suppression: keep pixels that equal their neighbourhood max."""
    x = score.reshape((-1, 1) + score.shape[-2:])
    m = F.max_pool2d(x, 3, stride=1, padding=1).reshape(score.shape)
    return (score >= m) & (score > 0)


def detect_grid(img, th_hi=20.0, th_lo=7.0, cell=32, max_kp=512, border=16):
    """Grid-distributed FAST detection with dual thresholds.

    Returns (xy (max_kp, 2) float32, score (max_kp,) f32, valid (max_kp,) bool),
    each with img's leading batch dims; coordinates are (x, y) at this
    image's resolution."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    dev = img.device
    c_hi, c_lo, score = fast_response_dual(img, th_hi, th_lo)
    s_hi = torch.where(c_hi, score, 0.0)
    s_lo = torch.where(c_lo, score, 0.0)
    keep = nms3(s_lo)
    inb = _inside((H, W), border, dev) & keep
    s_hi = torch.where(inb, s_hi, 0.0)
    s_lo = torch.where(inb, s_lo, 0.0)

    gh, gw = -(-H // cell), -(-W // cell)
    ph, pw = gh * cell, gw * cell

    def cellify(a):
        a = F.pad(a, (0, pw - W, 0, ph - H))
        return a.reshape(lead + (gh, cell, gw, cell)).transpose(-3, -2).reshape(
            lead + (gh * gw, cell * cell))

    ch, cl = cellify(s_hi), cellify(s_lo)
    hi_has = torch.amax(ch, dim=-1) > 0
    use = torch.where(hi_has[..., None], ch, cl)
    best, idx = torch.max(use, dim=-1)     # first maximum per cell
    cells = torch.arange(gh * gw, device=dev)
    cy = idx // cell + (cells // gw) * cell
    cx = idx % cell + (cells % gw) * cell

    k = min(max_kp, gh * gw)
    top, ti = torch.sort(best, descending=True, stable=True)
    top, ti = top[..., :k], ti[..., :k]
    xi = torch.gather(cx, -1, ti)
    yi = torch.gather(cy, -1, ti)
    # subpixel refinement: 1-D parabola fits on the RAW dense response
    sp = F.pad(score, (1, 1, 1, 1)).flatten(-2)
    wp = W + 2
    at = lambda y, x: torch.gather(sp, -1, y * wp + x)
    yc = yi + 1
    xc = xi + 1
    s0 = at(yc, xc)
    sxm = at(yc, xc - 1)
    sxp = at(yc, xc + 1)
    sym = at(yc - 1, xc)
    syp = at(yc + 1, xc)
    den_x = sxm - 2.0 * s0 + sxp
    den_y = sym - 2.0 * s0 + syp
    dx = torch.where(torch.abs(den_x) > 1e-6, 0.5 * (sxm - sxp) / den_x, 0.0)
    dy = torch.where(torch.abs(den_y) > 1e-6, 0.5 * (sym - syp) / den_y, 0.0)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    xy = torch.stack([xi.to(torch.float32) + dx, yi.to(torch.float32) + dy], dim=-1)
    valid = top > 0
    if k < max_kp:
        xy = F.pad(xy, (0, 0, 0, max_kp - k))
        top = F.pad(top, (0, max_kp - k))
        valid = F.pad(valid, (0, max_kp - k))
    return xy, top, valid
