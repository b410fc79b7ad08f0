"""Visual-inertial initialization: gyro bias, scale, gravity, accelerometer
bias, velocities (port of mc_slam_tpu/pipeline/viinit.py).

LocalMapping::TryInitVIO (src/LocalMapping.cpp:200-893), the VI-ORB scheme
(Mur-Artal & Tardos, arXiv:1610.05949):
  step 1: gyro bias by Gauss-Newton on relative-rotation residuals;
  step 2: scale + gravity from the linear system A [s; gw] = B (eq. 12 / 13);
  step 3: accelerometer bias + gravity-direction refinement
          C [s; dtheta_xy; ba] = D (eq. 19 / 20);
  step 4: per-keyframe velocities (eq. 18 / the IMU motion model).

All solvers are batched dense linear algebra over fixed-size keyframe windows
with validity masks (padded keyframes give zero rows). The small solves use
`solve_ex`: a singular system gives inf / NaN, as in the JAX package, and
never raises or checks on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.imu.preintegration import PreintState
from mc_slam_tpu_torch.solver import factors


class VIInitResult(NamedTuple):
    bg: torch.Tensor          # (3,) gyro bias
    ba: torch.Tensor          # (3,) accelerometer bias
    scale: torch.Tensor       # () metric scale of the visual map
    scale_star: torch.Tensor  # () scale from step 2 (diagnostic)
    gw: torch.Tensor          # (3,) gravity in world (refined)
    Rwi: torch.Tensor         # (3, 3) world-from-inertial rotation
    cond: torch.Tensor        # (6,) singular values of C, descending


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _solve(A, b):
    return torch.linalg.solve_ex(A, b[..., None]).result[..., 0]


def _masked_lls(A, b, with_sv=False, rel_eps=1e-7):
    """Least squares by the normal equations (A^T A) x = A^T b with a
    trace-relative Tikhonov floor: exactly invariant to zero padding rows
    (see mc_slam_tpu/pipeline/viinit.py:40-52 for why not an SVD solve).
    with_sv: also return the singular values of A, descending, from
    eigvalsh(A^T A)."""
    AtA = A.T @ A
    Atb = A.T @ b
    n = AtA.shape[0]
    eps = rel_eps * torch.trace(AtA) / n
    x = _solve(AtA + eps * torch.eye(n, dtype=A.dtype, device=A.device), Atb)
    if not with_sv:
        return x
    # eigvalsh raises on a non-finite matrix; the JAX package returns NaN
    finite = torch.all(torch.isfinite(AtA))
    ev = torch.linalg.eigvalsh(torch.nan_to_num(AtA, nan=0.0, posinf=0.0, neginf=0.0))
    sv = torch.sqrt(torch.clamp(torch.flip(ev, dims=(0,)), min=0.0))
    return x, torch.where(finite, sv, torch.nan)


def estimate_gyro_bias(Rwb, pre: PreintState, valid_pair, iters: int = 5):
    """Gyro bias from the relative rotations of consecutive keyframes.

    Rwb: (N, 3, 3) body rotations (from vision, R_wc @ Rcb); pre: (N, ...)
    batch where pre[k] integrates keyframe k-1 -> k (entry 0 unused);
    valid_pair: (N,) mask with [0] == 0. Gauss-Newton on sum_k ||r_k(bg)||^2."""
    R_i = torch.roll(Rwb, 1, dims=0)
    N = Rwb.shape[0]
    bg = torch.zeros(3, dtype=Rwb.dtype, device=Rwb.device)
    eye = 1e-9 * torch.eye(3, dtype=Rwb.dtype, device=Rwb.device)
    wJ = valid_pair[:, None, None]
    for _ in range(iters):
        r, J = factors.gyr_bias(bg.expand(N, 3), pre.dR, pre.J_R_bg, R_i, Rwb)
        H = torch.einsum('nri,nrj->ij', J * wJ, J)
        g = torch.einsum('nri,nr->i', J * wJ, r)
        bg = bg - _solve(H + eye, g)
    return bg


def _triplet_terms(Pwc, Rwc, pre, valid_pair):
    """Per-triplet quantities of steps 2 / 3; triplet k = (k, k+1, k+2),
    k = 0 .. N-3, with the (N-2,) triplet mask."""
    take12 = lambda x: x[1:-1]      # pre[k] integrates (k-1 -> k)
    take23 = lambda x: x[2:]
    return dict(
        p1=Pwc[:-2], p2=Pwc[1:-1], p3=Pwc[2:],
        R1=Rwc[:-2], R2=Rwc[1:-1], R3=Rwc[2:],
        dt12=take12(pre.dT), dt23=take23(pre.dT),
        dp12=take12(pre.dP), dv12=take12(pre.dV), dp23=take23(pre.dP),
        Jpba12=take12(pre.J_P_ba), Jvba12=take12(pre.J_V_ba),
        Jpba23=take23(pre.J_P_ba),
        mask=take12(valid_pair) * take23(valid_pair))


def estimate_scale_gravity(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb):
    """Step 2: [s, gw] from the 3(N-2) x 4 system (eq. 12 / 13).
    Pwc / Rwc: (N, 3) / (N, 3, 3) camera poses in the unscaled visual world."""
    t = _triplet_terms(Pwc, Rwc, pre, valid_pair)
    dt12, dt23 = t['dt12'][:, None], t['dt23'][:, None]
    lam = (t['p2'] - t['p1']) * dt23 + (t['p2'] - t['p3']) * dt12          # (K, 3)
    beta = 0.5 * (dt12 * dt12 * dt23 + dt12 * dt23 * dt23)                 # (K, 1)
    Rwb1 = t['R1'] @ Rcb        # world-from-body = R_wc @ R_cb
    Rwb2 = t['R2'] @ Rcb
    gam = ((t['R3'] - t['R2']) @ pcb) * dt12 + ((t['R1'] - t['R2']) @ pcb) * dt23 \
        + _mv(Rwb1, t['dp12']) * dt23 - _mv(Rwb2, t['dp23']) * dt12 \
        - _mv(Rwb1, t['dv12']) * dt12 * dt23
    m = t['mask'][:, None]
    K = lam.shape[0]
    eye3 = torch.eye(3, dtype=Pwc.dtype, device=Pwc.device)
    A = torch.cat([
        (lam * m).reshape(3 * K, 1),
        ((beta[:, :, None] * eye3) * m[:, :, None]).reshape(3 * K, 3)], dim=1)
    x = _masked_lls(A, (gam * m).reshape(3 * K))
    return x[0], x[1:4]


def refine_gravity_accbias(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb,
                           gw_star, g_mag=9.810):
    """Step 3: [s, dtheta_xy, ba] from the 3(N-2) x 6 system (eq. 19 / 20).
    Returns (s, ba, gw, Rwi, singular values of C)."""
    t = _triplet_terms(Pwc, Rwc, pre, valid_pair)
    dtype, dev = Pwc.dtype, Pwc.device
    gI = torch.cat([torch.zeros(2, dtype=dtype, device=dev),
                    torch.ones(1, dtype=dtype, device=dev)])
    gwn = gw_star / torch.clamp(torch.linalg.norm(gw_star), min=1e-12)
    gIxgwn = torch.linalg.cross(gI, gwn)
    n_cross = torch.linalg.norm(gIxgwn)
    vhat = gIxgwn / torch.clamp(n_cross, min=1e-12)
    theta = torch.atan2(n_cross, torch.dot(gI, gwn))
    Rwi = lie.so3_exp(vhat * theta)
    GI = gI * g_mag

    dt12, dt23 = t['dt12'][:, None], t['dt23'][:, None]
    lam = (t['p2'] - t['p1']) * dt23 + (t['p2'] - t['p3']) * dt12
    coef = dt12 * dt12 * dt23 + dt12 * dt23 * dt23
    phi = (-0.5 * coef[:, :, None] * (Rwi @ lie.hat(GI)))[..., :2]   # columns x, y
    Rwb1 = t['R1'] @ Rcb
    Rwb2 = t['R2'] @ Rcb
    zeta = (Rwb2 @ t['Jpba23']) * dt12[:, :, None] \
        + (Rwb1 @ t['Jvba12']) * (dt12 * dt23)[:, :, None] \
        - (Rwb1 @ t['Jpba12']) * dt23[:, :, None]
    psi = ((t['R1'] - t['R2']) @ pcb) * dt23 + _mv(Rwb1, t['dp12']) * dt23 \
        - ((t['R2'] - t['R3']) @ pcb) * dt12 - _mv(Rwb2, t['dp23']) * dt12 \
        - _mv(Rwb1, t['dv12']) * dt23 * dt12 - 0.5 * coef * (Rwi @ GI)

    m = t['mask'][:, None]
    K = lam.shape[0]
    C = torch.cat([
        (lam * m).reshape(3 * K, 1),
        (phi * m[:, :, None]).reshape(3 * K, 2),
        (zeta * m[:, :, None]).reshape(3 * K, 3)], dim=1)
    y, sv = _masked_lls(C, (psi * m).reshape(3 * K), with_sv=True)
    dtheta = torch.cat([y[1:3], torch.zeros(1, dtype=dtype, device=dev)])
    Rwi_ = Rwi @ lie.so3_exp(dtheta)
    return y[0], y[3:6], Rwi_ @ GI, Rwi_, sv


def compute_velocities(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb,
                       scale, gw, ba):
    """Step 4: per-keyframe body velocities (src/LocalMapping.cpp:601-647).

    Rows whose successor pair is valid use the position equation
      V_k = [s (p_{k+1} - p_k) + (R_{k+1} - R_k) pcb - Rwb_k (dp + Jpba ba)
             - 0.5 gw dt^2] / dt;
    rows without one (the last real keyframe, trailing padding) fall back to
    the IMU motion model from the previous row,
      V_k = V_{k-1} + gw dt_k + Rwb_{k-1} (dv_k + Jvba ba)."""
    Rwb = Rwc @ Rcb
    dp_next = pre.dP[1:] + pre.J_P_ba[1:] @ ba             # (N-1, 3), k -> k+1
    dt_next = pre.dT[1:][:, None]
    num = (scale * (Pwc[1:] - Pwc[:-1]) + (Rwc[1:] - Rwc[:-1]) @ pcb
           - _mv(Rwb[:-1], dp_next) - 0.5 * gw * dt_next * dt_next)
    dt_safe = torch.where(dt_next > 1e-9, dt_next, torch.ones_like(dt_next))
    V_fwd = torch.cat([num / dt_safe, (num / dt_safe)[-1:]], dim=0)     # (N, 3)
    dv = pre.dV + pre.J_V_ba @ ba                          # (N, 3), row k: k-1 -> k
    V_mot = torch.cat([V_fwd[:1], V_fwd[:-1] + gw * pre.dT[1:, None]
                       + _mv(Rwb[:-1], dv[1:])], dim=0)
    valid_next = torch.cat([valid_pair[1:], torch.zeros_like(valid_pair[:1])])
    return torch.where(valid_next[:, None] > 0, V_fwd, V_mot)


def apply_init_to_navstates(Pwc, Rwc, Rcb, pcb, scale, bg, ba, V):
    """Keyframe NavStates from the visual poses and the init results
    (src/LocalMapping.cpp:585-599): P = s wPc + Rwc pcb, R = Rwc Rcb."""
    return scale * Pwc + Rwc @ pcb, Rwc @ Rcb, V


def try_init_vio(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb, g_mag=9.810,
                 gyro_iters: int = 5) -> VIInitResult:
    """The full VI-init solve; no success gating (the caller applies the time
    rule and the conditioning / agreement gates). `pre` is corrected for the
    estimated gyro bias to first order before steps 2 and 3."""
    Rwb = Rwc @ Rcb
    bg = estimate_gyro_bias(Rwb, pre, valid_pair, iters=gyro_iters)
    pre_corr = pre._replace(
        dP=pre.dP + pre.J_P_bg @ bg, dV=pre.dV + pre.J_V_bg @ bg,
        dR=pre.dR @ lie.so3_exp(pre.J_R_bg @ bg))
    s_star, gw_star = estimate_scale_gravity(Pwc, Rwc, pre_corr, valid_pair, Rcb, pcb)
    s, ba, gw, Rwi, sv = refine_gravity_accbias(
        Pwc, Rwc, pre_corr, valid_pair, Rcb, pcb, gw_star, g_mag)
    return VIInitResult(bg=bg, ba=ba, scale=s, scale_star=s_star, gw=gw, Rwi=Rwi,
                        cond=sv)
