"""Oriented BRIEF: IC-angle orientation + steered binary tests
(port of mc_slam_tpu/frontend/orb.py).

The 256 sampling pairs are the JAX package's seeded Gaussian pattern, made
by the same numpy code, so both packages produce the same bits. The rotation
is quantized into NBINS=32 steps; the JAX package samples every bin with a
one-hot selection matmul and picks each keypoint's bin, this port gathers the
two sample pixels of the keypoint's own bin directly (same values).

Packed descriptors are (N, 8) int32 holding the bits of the JAX package's
(N, 8) uint32 words: torch.uint32 has few operators, on CUDA least of all.
Every function takes keypoint tables with or without a leading batch dim B
(images (B, H, W), keypoints (B, K, 2)).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_R = 15          # patch radius (31x31), as the reference
PATCH_W = 2 * PATCH_R + 1
BRIEF_R = 13          # max test-point radius so rotated points stay in-patch
NBINS = 32            # rotation quantization for the steered pattern


def _make_pattern(seed=42, n=256, sigma=5.2, rmax=BRIEF_R):
    """(n, 4) pattern [x1, y1, x2, y2], Gaussian-distributed, clipped."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n, 4))
    pts = np.clip(np.round(pts), -rmax, rmax)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -rmax, rmax)
    return pts.astype(np.float32)


PATTERN = _make_pattern()                     # (256, 4) numpy


def _sample_index_tables():
    """(NBINS, 256) flat patch indices of the two test points of every bit,
    rotated to each bin's angle and rounded (the JAX selection tables)."""
    I1 = np.zeros((NBINS, 256), np.int64)
    I2 = np.zeros((NBINS, 256), np.int64)
    for b in range(NBINS):
        th = 2.0 * np.pi * b / NBINS
        ca, sa = np.cos(th), np.sin(th)
        for s in range(256):
            x1, y1, x2, y2 = PATTERN[s]
            for (x, y, T) in ((x1, y1, I1), (x2, y2, I2)):
                rx = int(np.clip(np.round(ca * x - sa * y), -PATCH_R, PATCH_R))
                ry = int(np.clip(np.round(sa * x + ca * y), -PATCH_R, PATCH_R))
                T[b, s] = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)
    return I1, I2


SAMPLE_I1, SAMPLE_I2 = _sample_index_tables()

# circular-patch mask + moment weights for the IC angle
_d = np.arange(-PATCH_R, PATCH_R + 1)
_mask = (_d[None, :] ** 2 + _d[:, None] ** 2) <= PATCH_R * PATCH_R
MOMENT_W = np.stack([
    (_mask * _d[None, :]).reshape(-1),        # m10 weights (x)
    (_mask * _d[:, None]).reshape(-1),        # m01 weights (y)
], axis=1).astype(np.float32)                 # (961, 2)


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device):
    return (torch.from_numpy(SAMPLE_I1).to(device),
            torch.from_numpy(SAMPLE_I2).to(device),
            torch.from_numpy(MOMENT_W).to(device))


def extract_patches(img, xy, r=PATCH_R):
    """(..., K, 2r+1, 2r+1) patches around rounded keypoints; border
    keypoints clamp the window inside the image. img (H, W) with xy (K, 2),
    or (B, H, W) with (B, K, 2)."""
    H, W = img.shape[-2:]
    xi = torch.round(xy).to(torch.int64) if xy.is_floating_point() else xy.to(torch.int64)
    y0 = torch.clamp(xi[..., 1] - r, 0, H - (2 * r + 1))
    x0 = torch.clamp(xi[..., 0] - r, 0, W - (2 * r + 1))
    off = torch.arange(2 * r + 1, device=img.device)
    rows = (y0[..., None] + off)[..., :, None]
    cols = (x0[..., None] + off)[..., None, :]
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def ic_angle_from_patches(patches):
    """(..., K, 31, 31) -> (..., K) IC angle: one (K, 961) @ (961, 2)
    product; a batch stacks its rows into the same product (which may round
    a row's moments differently from its image's own product: the angles of
    a batched extraction agree with per-image ones to float32 rounding)."""
    mw = _device_tables(patches.device)[2]
    m = (patches.reshape(-1, PATCH_W * PATCH_W) @ mw).reshape(patches.shape[:-2] + (2,))
    return torch.atan2(m[..., 1], m[..., 0])


def brief_from_patches(patches_blur, angle):
    """Steered BRIEF from blurred patches: (K, 31, 31), (K,) rad ->
    (K, 256) int32 bits {0, 1}.

    Each bit is sign(I2 - I1). The JAX package evaluates it with a bf16
    product split into hi = round(I) (exact) and lo = I - hi rounded to bf16;
    the same split is taken here, so the bits agree."""
    i1, i2, _ = _device_tables(patches_blur.device)
    flat = patches_blur.flatten(-2)
    hi = torch.round(flat)
    lo = (flat - hi).to(torch.bfloat16).to(torch.float32)
    two_pi = 2.0 * np.pi
    b = torch.remainder(
        torch.round(torch.remainder(angle, two_pi) * (NBINS / two_pi)).to(torch.int64),
        NBINS)
    s1 = i1[b]                                   # (..., K, 256)
    s2 = i2[b]
    d_hi = torch.gather(hi, -1, s2) - torch.gather(hi, -1, s1)
    d_lo = torch.gather(lo, -1, s2) - torch.gather(lo, -1, s1)
    return ((d_hi + d_lo) > 0).to(torch.int32)


def _wrap_int32(v):
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_bits(bits):
    """(..., K, 256) {0,1} -> (..., K, 8) int32 packed words (bit j of word w
    = bit 32w+j)."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    v = torch.sum(bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64) << shifts,
                  dim=-1)
    return _wrap_int32(v)


def bits_to_pm1(bits):
    """(K, 256) {0,1} -> (K, 256) int8 {-1,+1}."""
    return bits.to(torch.int8) * 2 - 1


def unpack_pm1(desc_packed):
    """(..., N, 8) int32 packed words -> (..., N, 256) int8 in {-1, +1}."""
    shifts = torch.arange(32, device=desc_packed.device, dtype=torch.int64)
    words = desc_packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(desc_packed.shape[:-1] + (256,)).to(torch.int8) * 2 - 1
