"""The SLAM map as a fixed-capacity struct of tensors
(port of mc_slam_tpu/slam_map/mapstate.py).

Keyframe table, per-keyframe observation table and map-point table, with
the JAX package's field names, shapes and validity masks. Packed descriptor
tables (kf_desc, mp_desc) are int32 holding the uint32 bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.device import resolve

from mc_slam_tpu_torch.imu.navstate import NavState, navstate_identity
from mc_slam_tpu_torch.imu.preintegration import PreintState, preint_identity


class MapState(NamedTuple):
    # --- keyframes ---
    kf_ns: NavState          # (K, ...) body NavStates (world-from-body)
    kf_time: torch.Tensor    # (K,)
    kf_id: torch.Tensor      # (K,) int32 original frame id
    kf_active: torch.Tensor  # (K,) bool
    # --- per-keyframe features (observation table) ---
    kf_uv: torch.Tensor      # (K, F, 2) undistorted pixels
    kf_level: torch.Tensor   # (K, F) int32
    kf_angle: torch.Tensor   # (K, F) float32 IC angle (rad)
    kf_ur: torch.Tensor      # (K, F) right-image u; -1 = mono
    kf_desc: torch.Tensor    # (K, F, 8) int32 packed words
    kf_pm1: torch.Tensor     # (K, F, 256) int8
    kf_feat_valid: torch.Tensor  # (K, F) bool
    kf_mp: torch.Tensor      # (K, F) int32 map-point index or -1
    # --- IMU chain: preintegration from the previous active KF ---
    kf_preint: PreintState   # batch (K, ...)
    # --- map points ---
    mp_pos: torch.Tensor     # (P, 3)
    mp_desc: torch.Tensor    # (P, 8) int32 packed representative descriptor
    mp_pm1: torch.Tensor     # (P, 256) int8
    mp_normal: torch.Tensor  # (P, 3) mean viewing direction
    mp_min_dist: torch.Tensor  # (P,) scale-invariance range
    mp_max_dist: torch.Tensor  # (P,)
    mp_ref_kf: torch.Tensor  # (P,) int32 reference keyframe slot
    mp_angle: torch.Tensor   # (P,) float32 IC angle of the anchoring observation
    mp_found: torch.Tensor   # (P,) float32 found counter
    mp_visible: torch.Tensor  # (P,) float32 visible counter
    mp_first_kf: torch.Tensor  # (P,) int32 id of the creating frame
    mp_active: torch.Tensor  # (P,) bool

    # capacities; a stacked map (parallel/multiseq.stack_maps: every field
    # with a leading sequence dim B) has the same ones
    @property
    def K(self):
        return self.kf_active.shape[-1]

    @property
    def P(self):
        return self.mp_active.shape[-1]

    @property
    def F(self):
        return self.kf_feat_valid.shape[-1]


def empty_map(max_kf: int, max_mp: int, n_feat: int, dtype=torch.float32,
              device=None) -> MapState:
    K, P, F = max_kf, max_mp, n_feat
    device = resolve(device)
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    full = lambda s, v, dt: torch.full(s, v, dtype=dt, device=device)
    return MapState(
        kf_ns=navstate_identity((K,), dtype, device),
        kf_time=z(K),
        kf_id=full((K,), -1, torch.int32),
        kf_active=z(K, dt=torch.bool),
        kf_uv=z(K, F, 2),
        kf_level=z(K, F, dt=torch.int32),
        kf_angle=z(K, F),
        kf_ur=full((K, F), -1.0, dtype),
        kf_desc=z(K, F, 8, dt=torch.int32),
        kf_pm1=z(K, F, 256, dt=torch.int8),
        kf_feat_valid=z(K, F, dt=torch.bool),
        kf_mp=full((K, F), -1, torch.int32),
        kf_preint=preint_identity((K,), dtype, device),
        mp_pos=z(P, 3),
        mp_desc=z(P, 8, dt=torch.int32),
        mp_pm1=z(P, 256, dt=torch.int8),
        mp_normal=z(P, 3),
        mp_min_dist=z(P),
        mp_max_dist=z(P),
        mp_ref_kf=z(P, dt=torch.int32),
        mp_angle=z(P),
        mp_found=z(P),
        mp_visible=z(P),
        mp_first_kf=z(P, dt=torch.int32),
        mp_active=z(P, dt=torch.bool),
    )


def kf_sees_matrix(m: MapState, obs):
    """(K, P) float32 membership: 1 where keyframe k holds map point p in a
    feature selected by `obs` (K, F) bool. A scatter-max, so a keyframe that
    holds one point in two features still counts once, and the result does
    not depend on the order of the writes (unassociated features write 0
    through slot 0, as in the JAX package)."""
    K, P, F = m.K, m.P, m.F
    flat_k = torch.arange(K, device=obs.device).repeat_interleave(F)
    flat_p = torch.clamp(m.kf_mp.reshape(-1), 0, P - 1).to(torch.int64)
    sees = torch.zeros(K * P, dtype=torch.float32, device=obs.device)
    sees = sees.scatter_reduce(0, flat_k * P + flat_p,
                               obs.reshape(-1).to(torch.float32), reduce="amax",
                               include_self=True)
    return sees.reshape(K, P)


def _set_drop(t, idx, val):
    """t.at[idx].set(val, mode="drop"): entries of `idx` equal to t.shape[0]
    are not written (they land in an extra row that is sliced off). A Python
    scalar `val` becomes a device tensor by a fill, not by a host copy."""
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, dtype=t.dtype, device=t.device)
    buf = torch.cat([t, t.new_zeros((1,) + t.shape[1:])])
    buf[idx] = val
    return buf[:-1]


def _set_drop_batched(t, idx, val):
    """`_set_drop` along the LAST dim of t (..., n) with idx (..., k) and val
    broadcasting to idx: the leading dims are batch dims (one problem each),
    and entries of idx equal to n are not written. A 1-D t is `_set_drop`.
    As there, which of two writes to one index lands is not fixed."""
    if t.dim() == 1:
        return _set_drop(t, idx, val)
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, dtype=t.dtype, device=t.device)
    buf = torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)
    return buf.scatter(-1, idx, val.to(t.dtype).expand(idx.shape))[..., :-1]


def _slot_tensor(k, device):
    """(1,) int64 tensor of a keyframe slot given as a Python int (a fill, not
    a host copy) or as a 0-d / (1,) integer tensor."""
    if isinstance(k, int):
        return torch.full((1,), k, dtype=torch.int64, device=device)
    return k.reshape(1).to(torch.int64)


def _row(t, k):
    """t[k] for a Python int or a 0-d / (1,) integer tensor k, without a host
    read (indexing with a 0-d tensor would read it back)."""
    if isinstance(k, int):
        return t[k]
    return t.index_select(0, k.reshape(1).to(torch.int64))[0]


def covisibility_weights(m: MapState, kf_slot):
    """(K,) shared-map-point counts between `kf_slot` and every keyframe
    (KeyFrame::UpdateConnections, src/KeyFrame.cpp:668)."""
    sees = kf_sees_matrix(m, (m.kf_mp >= 0) & m.kf_feat_valid)
    this = _row(sees, kf_slot)
    return sees @ (this * m.mp_active)


def covisibility_matrix(m: MapState):
    """(K, K) shared-map-point counts between every pair of active keyframes."""
    sees = kf_sees_matrix(m, (m.kf_mp >= 0) & m.kf_feat_valid)
    sees = sees * m.mp_active[None, :] * m.kf_active[:, None]
    return sees @ sees.T


def observation_counts(m: MapState):
    """(P,) number of active keyframes observing each map point."""
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None]
    return torch.sum(kf_sees_matrix(m, obs), dim=0) * m.mp_active
