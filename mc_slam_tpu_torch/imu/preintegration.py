"""On-manifold IMU preintegration, Forster TRO'17
(port of mc_slam_tpu/imu/preintegration.py).

The JAX package runs a `lax.scan` over a (256, 7) zero-padded sample buffer.
A dt == 0 row is a no-op of the recursion (up to the last-ulp rounding of the
Gram-Schmidt re-orthonormalization), so this port loops over the rows it is
given: callers pass the real rows only and skip the padding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.device import resolve

from mc_slam_tpu_torch import lie


class IMUNoise(NamedTuple):
    """Continuous-time IMU noise densities (src/IMU/imudata.cpp:25-37)."""
    sigma_g: torch.Tensor   # gyro white noise [rad/s/sqrt(Hz)]
    sigma_a: torch.Tensor   # accel white noise [m/s^2/sqrt(Hz)]
    sigma_bg: torch.Tensor  # gyro bias random walk [rad/s^2/sqrt(Hz)]
    sigma_ba: torch.Tensor  # accel bias random walk [m/s^3/sqrt(Hz)]


def euroc_noise(dtype=torch.float32, device=None) -> IMUNoise:
    device = resolve(device)
    a = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return IMUNoise(sigma_g=a(1.7e-4), sigma_a=a(2e-2), sigma_bg=a(2e-5),
                    sigma_ba=a(5e-3))


class PreintState(NamedTuple):
    dP: torch.Tensor       # (..., 3)
    dV: torch.Tensor       # (..., 3)
    dR: torch.Tensor       # (..., 3, 3)
    J_P_bg: torch.Tensor   # (..., 3, 3)
    J_P_ba: torch.Tensor   # (..., 3, 3)
    J_V_bg: torch.Tensor   # (..., 3, 3)
    J_V_ba: torch.Tensor   # (..., 3, 3)
    J_R_bg: torch.Tensor   # (..., 3, 3)
    cov: torch.Tensor      # (..., 9, 9) covariance of [dP, dV, dPhi]
    dT: torch.Tensor       # (...,) total integration time


def preint_identity(batch_shape=(), dtype=torch.float32, device=None) -> PreintState:
    batch_shape = tuple(batch_shape)
    device = resolve(device)
    z = lambda *s: torch.zeros(batch_shape + s, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3))
    return PreintState(dP=z(3), dV=z(3), dR=eye.clone(), J_P_bg=z(3, 3),
                       J_P_ba=z(3, 3), J_V_bg=z(3, 3), J_V_ba=z(3, 3),
                       J_R_bg=z(3, 3), cov=z(9, 9), dT=z())


def preint_update(st: PreintState, omega, acc, dt, noise: IMUNoise) -> PreintState:
    """One bias-corrected sample update (IMUPreintegrator::update,
    src/IMU/IMUPreintegrator.cpp:63-112): covariance first with the old
    dP/dV/dR, then Jacobians, then state. omega/acc are bias-subtracted."""
    dt = torch.as_tensor(dt, dtype=st.dP.dtype, device=st.dP.device)
    dt2 = dt * dt
    w_dt = omega * dt[..., None]
    dR_inc = lie.so3_exp(w_dt)
    Jr = lie.so3_jr(w_dt)
    acc_hat = lie.hat(acc)
    dtm = dt[..., None, None]
    dt2m = dt2[..., None, None]

    I3 = torch.eye(3, dtype=st.dR.dtype, device=st.dR.device).expand(st.dR.shape)
    Z3 = torch.zeros_like(I3)
    dRa = st.dR @ acc_hat
    A = torch.cat([
        torch.cat([I3, I3 * dtm, -0.5 * dt2m * dRa], dim=-1),
        torch.cat([Z3, I3, -dtm * dRa], dim=-1),
        torch.cat([Z3, Z3, dR_inc.transpose(-1, -2)], dim=-1),
    ], dim=-2)

    dt_safe = torch.where(dt > 0, dt, torch.ones_like(dt))
    cov_g = (noise.sigma_g ** 2) / dt_safe
    cov_a = (noise.sigma_a ** 2) / dt_safe

    Bg_blk = Jr * dtm
    Ca_top = 0.5 * dt2m * st.dR
    Ca_mid = dtm * st.dR

    cov_new = A @ st.cov @ A.transpose(-1, -2)
    BgBgT = cov_g[..., None, None] * (Bg_blk @ Bg_blk.transpose(-1, -2))
    PP = cov_a[..., None, None] * (Ca_top @ Ca_top.transpose(-1, -2))
    PV = cov_a[..., None, None] * (Ca_top @ Ca_mid.transpose(-1, -2))
    VV = cov_a[..., None, None] * (Ca_mid @ Ca_mid.transpose(-1, -2))
    add = torch.cat([
        torch.cat([PP, PV, Z3], dim=-1),
        torch.cat([PV.transpose(-1, -2), VV, Z3], dim=-1),
        torch.cat([Z3, Z3, BgBgT], dim=-1),
    ], dim=-2)
    cov_new = cov_new + add

    J_P_ba = st.J_P_ba + st.J_V_ba * dtm - 0.5 * dt2m * st.dR
    J_P_bg = st.J_P_bg + st.J_V_bg * dtm - 0.5 * dt2m * (dRa @ st.J_R_bg)
    J_V_ba = st.J_V_ba - dtm * st.dR
    J_V_bg = st.J_V_bg - dtm * (dRa @ st.J_R_bg)
    J_R_bg = dR_inc.transpose(-1, -2) @ st.J_R_bg - Bg_blk

    Ra = (st.dR @ acc[..., None])[..., 0]
    dP = st.dP + st.dV * dt[..., None] + 0.5 * dt2[..., None] * Ra
    dV = st.dV + Ra * dt[..., None]
    dR = lie.so3_normalize_fast(st.dR @ dR_inc)
    return PreintState(dP=dP, dV=dV, dR=dR, J_P_bg=J_P_bg, J_P_ba=J_P_ba,
                       J_V_bg=J_V_bg, J_V_ba=J_V_ba, J_R_bg=J_R_bg,
                       cov=cov_new, dT=st.dT + dt)


def preintegrate(samples, bg, ba, noise: IMUNoise,
                 init: PreintState | None = None) -> PreintState:
    """Preintegrate (T, 7) rows [omega(3), acc(3), dt(1)] with biases bg/ba
    subtracted from every row. One update per row, in order."""
    st = init if init is not None else preint_identity(
        dtype=samples.dtype, device=samples.device)
    omega = samples[:, 0:3] - bg
    acc = samples[:, 3:6] - ba
    for k in range(samples.shape[0]):
        st = preint_update(st, omega[k], acc[k], samples[k, 6], noise)
    return st


def preintegrate_batch(samples, bg, ba, noise: IMUNoise) -> PreintState:
    """Preintegrate B row sequences at once: samples (B, T, 7), each sequence
    padded to T with dt == 0 rows (no-ops of the recursion), all at the same
    biases. T updates over the batch instead of one per row and sequence:
    what re-integrating every keyframe's rows at VI init needs."""
    B, T, _ = samples.shape
    st = preint_identity((B,), dtype=samples.dtype, device=samples.device)
    omega = samples[..., 0:3] - bg
    acc = samples[..., 3:6] - ba
    for k in range(T):
        st = preint_update(st, omega[:, k], acc[:, k], samples[:, k, 6], noise)
    return st


def predict_navstate(ns, preint: PreintState, gw):
    """Propagate a NavState through a preintegrated delta with first-order
    bias correction (Converter::updateNS, src/Converter.cpp:10-36)."""
    dt = preint.dT[..., None]
    dbg, dba = ns.dbg, ns.dba
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    dP = preint.dP + mv(preint.J_P_bg, dbg) + mv(preint.J_P_ba, dba)
    dV = preint.dV + mv(preint.J_V_bg, dbg) + mv(preint.J_V_ba, dba)
    dR = preint.dR @ lie.so3_exp(mv(preint.J_R_bg, dbg))
    P = ns.P + ns.V * dt + 0.5 * gw * dt * dt + mv(ns.R, dP)
    V = ns.V + gw * dt + mv(ns.R, dV)
    return ns._replace(P=P, V=V, R=ns.R @ dR)
