"""Full ORB extraction: pyramid -> grid FAST -> orientation -> steered BRIEF
(port of mc_slam_tpu/frontend/extractor.py).

Output is a fixed-size padded keypoint table across all levels with per-level
quotas (mnFeaturesPerLevel logic) and level-0 coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.frontend import fast, orb, pyramid
from mc_slam_tpu_torch.utils.metrics import span


class Features(NamedTuple):
    xy: torch.Tensor        # (N, 2) float32 keypoints, level-0 pixels (raw/distorted)
    level: torch.Tensor     # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 rad
    score: torch.Tensor     # (N,) float32 FAST response
    desc: torch.Tensor      # (N, 8) int32 packed 256-bit descriptors (uint32 bits)
    desc_pm1: torch.Tensor  # (N, 256) int8 {-1,+1}
    valid: torch.Tensor     # (N,) bool


def per_level_quota(n_features, n_levels=8, scale=1.2):
    """Features per level ~ (1/scale)^i, normalized to sum to n_features."""
    inv = [(1.0 / scale) ** i for i in range(n_levels)]
    total = sum(inv)
    q = [int(round(n_features * v / total)) for v in inv]
    q[0] += n_features - sum(q)
    return q


def extract(img, n_features=1024, n_levels=8, scale=1.2, th_hi=20.0, th_lo=7.0,
            cell=32) -> Features:
    """img: (H, W) grayscale in [0, 255], float32 or uint8, on any device,
    or a batch (B, H, W) of such images (one set of launches for all B).
    Returns Features of exactly n_features rows (invalid rows masked), with
    the batch dim leading every field."""
    with span("frontend.extract"):
        img = img.to(torch.float32)
        lead = img.shape[:-2]
        levels = pyramid.build_pyramid(img, n_levels, scale)
        quotas = per_level_quota(n_features, n_levels, scale)
        sf = pyramid.scale_factors(n_levels, scale)
        # IC angle on the RAW level image, BRIEF on the blurred one (as the reference)
        xys, lvls, scores, valids, patches_raw, patches_blur = [], [], [], [], [], []
        for li, (lvl_img, quota) in enumerate(zip(levels, quotas)):
            if quota == 0:
                continue
            xy, score, valid = fast.detect_grid(lvl_img, th_hi, th_lo, cell=cell,
                                                max_kp=quota, border=16)
            blur = pyramid.gaussian_blur(lvl_img)
            patches_raw.append(orb.extract_patches(lvl_img, xy))
            patches_blur.append(orb.extract_patches(blur, xy))
            xys.append(xy * sf[li])
            lvls.append(torch.full(lead + (quota,), li, dtype=torch.int32, device=img.device))
            scores.append(score)
            valids.append(valid)

        # the per-level tables stack along the feature axis
        xy = torch.cat(xys, dim=-2)
        valid = torch.cat(valids, dim=-1)
        angle = orb.ic_angle_from_patches(torch.cat(patches_raw, dim=-3))
        bits = orb.brief_from_patches(torch.cat(patches_blur, dim=-3), angle)
        bits = bits * valid[..., None].to(bits.dtype)
        return Features(xy=xy, level=torch.cat(lvls, dim=-1), angle=angle,
                        score=torch.cat(scores, dim=-1), desc=orb.pack_bits(bits),
                        desc_pm1=orb.bits_to_pm1(bits), valid=valid)
