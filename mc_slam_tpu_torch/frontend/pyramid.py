"""Image pyramid + Gaussian blur (port of mc_slam_tpu/frontend/pyramid.py).

`jax.image.resize(..., "bilinear")` antialiases on downscale: it is a
separable resampling with a triangle kernel widened by 1/scale
(`jax.image.scale_and_translate`). `F.interpolate` is a different filter, so
this port builds the same per-axis weight matrices in numpy float32 and
applies them as two matrix products.

Every function takes (H, W) images or a batch (B, H, W) of them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_LEVELS = 8
DEFAULT_SCALE = 1.2


def level_shapes(h, w, n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(n_levels)]


def scale_factors(n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    return [scale ** i for i in range(n_levels)]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased triangle-kernel weights, computed as
    jax.image's compute_weight_mat does under jit (scale = n_out / n_in, no
    shift). XLA fuses the sample position into one multiply-add and the
    kernel-scale division into a reciprocal multiply; both are mirrored here
    (float64 then one rounding), else positions differ by an ulp and levels
    by ~6e-4 grey."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, device: torch.device):
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_bilinear(img, shape):
    """Antialiased bilinear resize of (..., H, W) to (..., *shape)
    (jax.image.resize parity). A batch goes through the same two 2-D
    products as one image, its images side by side (rows: (H, B*W); columns:
    (B*h, W)), so every image gets the same sums as when resized alone."""
    h, w = shape
    H, W = img.shape[-2:]
    out = img
    if H != h:
        R = _resize_matrix(H, h, img.device).T
        if img.dim() == 2:
            out = R @ out
        else:
            lead = out.shape[:-2]
            side = out.reshape(-1, H, W).permute(1, 0, 2).reshape(H, -1)
            out = (R @ side).reshape(h, -1, W).permute(1, 0, 2).reshape(lead + (h, W))
    if W != w:
        out = out @ _resize_matrix(W, w, img.device)
    return out


def build_pyramid(img, n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    """img: (H, W) or (B, H, W) float32 in [0, 255]. Returns a list of
    (Hi, Wi) tensors (with the batch dim), each resized from the previous
    level as the reference does."""
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for i in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[i]))
    return levels


def _gauss_kernel1d(sigma=2.0, radius=3):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    return (k / np.sum(k, dtype=np.float32)).astype(np.float32)


def pad2d(img, pad, mode):
    """F.pad of the last two dims of a (H, W) or (B, H, W) image in a mode
    that wants (N, C, H, W) (reflect, replicate)."""
    x = img.reshape((-1, 1) + img.shape[-2:])
    out = F.pad(x, pad, mode=mode)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _reflect_pad(img, top_bottom, left_right):
    return pad2d(img, (left_right, left_right, top_bottom, top_bottom), "reflect")


def gaussian_blur(img, sigma=2.0, radius=3):
    """Separable 7x7 Gaussian with reflect padding; img (..., H, W) float32.
    Taps are summed in the JAX package's order (one shifted add per tap)."""
    k = [float(v) for v in _gauss_kernel1d(sigma, radius)]
    H, W = img.shape[-2:]
    x = _reflect_pad(img, radius, 0)
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * x[..., i:i + H, :]
    x = _reflect_pad(out, 0, radius)
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * x[..., :, i:i + W]
    return out
