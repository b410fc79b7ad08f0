"""Keyframe-table writes (port of the parts of mc_slam_tpu/pipeline/mapping.py
that building a map for tracking reaches)."""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch.slam_map.mapstate import MapState

# Scale-invariance band floor: the reference always runs 8 pyramid levels,
# so its creation-time band [max_d / 1.2^7, max_d] never collapses
# (see mc_slam_tpu/pipeline/mapping.py:24-31).
BAND_LEVELS_FLOOR = 8


def band_min_dist(max_d, n_levels):
    """Creation-time minimum scale-invariance distance, floored at the
    8-level band the reference always uses."""
    span = max(float(n_levels) - 1.0, float(BAND_LEVELS_FLOOR - 1))
    return max_d / (np.float32(1.2) ** np.float32(span))   # float32 power, as jnp


def _set_row(t, slot, value):
    out = t.clone()
    out[slot] = value
    return out


def write_keyframe(m: MapState, slot: int, P_pose, R_pose, V, bg, ba, t_kf, fid,
                   uv, level, angle, ur, desc, pm1, feat_valid) -> MapState:
    """All keyframe-table writes of an insertion; returns the new MapState
    (inputs are not modified). The base bias is written, delta-bias zeroed.
    (The JAX function's optional feature->map-point row and preintegration
    row wait for the keyframe event's port.)"""
    ns = m.kf_ns
    z3 = torch.zeros(3, dtype=ns.P.dtype, device=ns.P.device)
    ns = ns._replace(
        P=_set_row(ns.P, slot, P_pose), R=_set_row(ns.R, slot, R_pose),
        V=_set_row(ns.V, slot, V), bg=_set_row(ns.bg, slot, bg),
        ba=_set_row(ns.ba, slot, ba), dbg=_set_row(ns.dbg, slot, z3),
        dba=_set_row(ns.dba, slot, z3))
    m = m._replace(
        kf_ns=ns,
        kf_time=_set_row(m.kf_time, slot, t_kf),
        kf_id=_set_row(m.kf_id, slot, fid),
        kf_active=_set_row(m.kf_active, slot, True),
        kf_uv=_set_row(m.kf_uv, slot, uv),
        kf_level=_set_row(m.kf_level, slot, level),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_ur=_set_row(m.kf_ur, slot, ur),
        kf_desc=_set_row(m.kf_desc, slot, desc),
        kf_pm1=_set_row(m.kf_pm1, slot, pm1),
        kf_feat_valid=_set_row(m.kf_feat_valid, slot, feat_valid),
    )
    return m
