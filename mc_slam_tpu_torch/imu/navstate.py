"""NavState: the 15-DoF IMU navigation state (port of mc_slam_tpu/imu/navstate.py).

{P, V, R in SO(3), bias_g, bias_a} plus the delta-bias {dbg, dba} that the
optimizers update while the base bias stays fixed. All fields broadcast over
leading batch dims, so a keyframe table is one NavState of (N, ...) tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.device import resolve


class NavState(NamedTuple):
    P: torch.Tensor    # (..., 3) position of body in world
    V: torch.Tensor    # (..., 3) velocity in world
    R: torch.Tensor    # (..., 3, 3) world-from-body rotation
    bg: torch.Tensor   # (..., 3) gyro bias (fixed linearization point)
    ba: torch.Tensor   # (..., 3) accel bias
    dbg: torch.Tensor  # (..., 3) delta gyro bias (optimized)
    dba: torch.Tensor  # (..., 3) delta accel bias

    @property
    def bg_full(self):
        return self.bg + self.dbg

    @property
    def ba_full(self):
        return self.ba + self.dba


def navstate_identity(batch_shape=(), dtype=torch.float32, device=None) -> NavState:
    batch_shape = tuple(batch_shape)
    device = resolve(device)
    z3 = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3))
    return NavState(P=z3, V=z3.clone(), R=eye.clone(), bg=z3.clone(),
                    ba=z3.clone(), dbg=z3.clone(), dba=z3.clone())

