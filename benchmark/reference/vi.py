"""Plain visual-inertial pieces of one VI frame: the benchmark's reference
for the port's IMU preintegration (`imu/preintegration.py`), its IMU
prediction, and its joint (last, current) pose solve with the marginal it
hands to the next frame (`solver/ba_vi.pose_only_vi`).

Written from Forster et al., "On-Manifold Preintegration for Real-Time
Visual-Inertial Odometry" (IEEE TRO 2017) and the reference system's
IMUPreintegrator::update, Converter::updateNS, the PRV / bias / prior edges
(src/IMU/g2otypes.cpp) and Optimizer::PoseOptimization(Frame, Frame, ...)
(src/Optimizer.cpp:1671-2041), as the port states them. Plain float32
PyTorch, one problem at a time; it imports nothing of the port.

A navigation state is a dict of P, V (world), R (world from body), bg, ba
(the biases' linearization point) and dbg, dba (the deltas the solves
move); the solve's tangent order is [dP, dphi, dV, ddbg, ddba].

Departures from the published forms, each one the port's:
* the prediction and the PRV factor correct the preintegration to first
  order by the state's delta bias, although it was integrated at the last
  frame's full bias (bias + delta);
* the PRV information inverts the preintegration covariance, reordered to
  [P, phi, V], after scaling it to a unit diagonal and adding 1e-6 there;
* the visual kernel is Huber truncated at 400 x its knee (the weight
  ramped to 0 over the last 30 %); a point behind the camera costs the
  plateau;
* the solve is a fixed number of Levenberg-Marquardt iterations (lambda
  from 1e-4, x0.5 on a kept step, x4 on a refused one, within [1e-9, 1e6],
  damping lambda * diag(H) + 1e-10), a step kept only where it lowers the
  cost and is finite, with no outlier re-classification inside it;
* the marginal of the current state is taken at the solution with the
  inliers' weights, the last state's block regularized by 1e-8.
"""
from __future__ import annotations

import torch

from benchmark.reference.track import CHI2_MONO, hat, mv, orthonormalize, robust, so3_exp

FIELDS = ("P", "V", "R", "bg", "ba", "dbg", "dba")


def so3_log(R):
    """(3, 3) rotation near the identity -> rotation vector: the angle from
    atan2(sin, cos), the axis from the skew part (exact at small angles)."""
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    s = torch.linalg.norm(w)
    c = (R[0, 0] + R[1, 1] + R[2, 2] - 1) / 2
    th = torch.atan2(s, c)
    return torch.where(s < 1e-7, 1.0 + s * s / 6, th / torch.clamp(s, min=1e-30)) * w


def _coeffs(phi):
    """The right Jacobian's (1 - cos)/theta^2 and (theta - sin)/theta^3, and
    the inverse one's 1/theta^2 - (1 + cos)/(2 theta sin), as Taylor series
    below theta = 1e-2."""
    ts = torch.sum(phi * phi)
    small = ts < 1e-4
    t = torch.sqrt(torch.where(small, torch.ones_like(ts), ts))
    b = torch.where(small, 0.5 - ts / 24 + ts * ts / 720, (1 - torch.cos(t)) / (t * t))
    c = torch.where(small, 1 / 6 - ts / 120 + ts * ts / 5040, (t - torch.sin(t)) / t ** 3)
    k = torch.where(small, 1 / 12 + ts / 720 + ts * ts / 30240,
                    1 / (t * t) - (1 + torch.cos(t)) / (2 * t * torch.sin(t)))
    return b, c, k


def jr(phi):
    """Right Jacobian of SO(3)."""
    b, c, _ = _coeffs(phi)
    W = hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) - b * W + c * (W @ W)


def jr_inv(phi):
    """Inverse right Jacobian of SO(3)."""
    _, _, k = _coeffs(phi)
    W = hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * W + k * (W @ W)


# ----------------------------------------------------------- preintegration

def preintegrate(rows, bg, ba, noise):
    """Preintegrate (T, 7) rows [gyro, acc, dt] at the biases bg, ba (each
    subtracted from every row). noise: (sigma_g, sigma_a) densities.
    Returns a dict of dP, dV, dR, the bias Jacobians J_P_bg, J_P_ba,
    J_V_bg, J_V_ba, J_R_bg, the covariance `cov` of [dP, dV, dphi] and dT."""
    dev, f32 = rows.device, torch.float32
    I3, Z3 = torch.eye(3, dtype=f32, device=dev), torch.zeros((3, 3), dtype=f32, device=dev)
    s = dict(dP=torch.zeros(3, dtype=f32, device=dev), dV=torch.zeros(3, dtype=f32, device=dev),
             dR=I3, J_P_bg=Z3, J_P_ba=Z3, J_V_bg=Z3, J_V_ba=Z3, J_R_bg=Z3,
             cov=torch.zeros((9, 9), dtype=f32, device=dev),
             dT=torch.zeros((), dtype=f32, device=dev))
    sg2, sa2 = noise[0] ** 2, noise[1] ** 2
    for k in range(rows.shape[0]):
        w, a, dt = rows[k, 0:3] - bg, rows[k, 3:6] - ba, rows[k, 6]
        dR = s["dR"]
        inc = so3_exp(w * dt)
        Jr = jr(w * dt)
        Ra = dR @ hat(a)
        # covariance first, with the state before this row
        A = torch.cat([torch.cat([I3, I3 * dt, -0.5 * dt * dt * Ra], 1),
                       torch.cat([Z3, I3, -dt * Ra], 1),
                       torch.cat([Z3, Z3, inc.T], 1)], 0)
        Bg = Jr * dt
        Ca = torch.cat([0.5 * dt * dt * dR, dt * dR], 0)          # (6, 3): dP, dV rows
        q = torch.zeros((9, 9), dtype=f32, device=dev)
        q[:6, :6] = (sa2 / dt) * (Ca @ Ca.T)
        q[6:, 6:] = (sg2 / dt) * (Bg @ Bg.T)
        cov = A @ s["cov"] @ A.T + q
        # the bias Jacobians, then the deltas
        J = dict(J_P_ba=s["J_P_ba"] + s["J_V_ba"] * dt - 0.5 * dt * dt * dR,
                 J_P_bg=s["J_P_bg"] + s["J_V_bg"] * dt - 0.5 * dt * dt * (Ra @ s["J_R_bg"]),
                 J_V_ba=s["J_V_ba"] - dt * dR,
                 J_V_bg=s["J_V_bg"] - dt * (Ra @ s["J_R_bg"]),
                 J_R_bg=inc.T @ s["J_R_bg"] - Bg)
        acc_w = mv(dR, a)
        s = dict(dP=s["dP"] + s["dV"] * dt + 0.5 * dt * dt * acc_w, dV=s["dV"] + acc_w * dt,
                 dR=orthonormalize(dR @ inc), cov=cov, dT=s["dT"] + dt, **J)
    return s


def corrected(pre, dbg, dba):
    """The preintegrated deltas corrected to first order for the delta
    biases: (dP, dV, dR, the rotation correction's vector)."""
    corr = mv(pre["J_R_bg"], dbg)
    return (pre["dP"] + mv(pre["J_P_bg"], dbg) + mv(pre["J_P_ba"], dba),
            pre["dV"] + mv(pre["J_V_bg"], dbg) + mv(pre["J_V_ba"], dba),
            pre["dR"] @ so3_exp(corr), corr)


def predict(ns, pre, gw):
    """The state at the end of the preintegrated interval (updateNS)."""
    dP, dV, dR, _ = corrected(pre, ns["dbg"], ns["dba"])
    dT = pre["dT"]
    return dict(ns, P=ns["P"] + ns["V"] * dT + 0.5 * gw * dT * dT + mv(ns["R"], dP),
                V=ns["V"] + gw * dT + mv(ns["R"], dV), R=ns["R"] @ dR)


def prv_info(pre):
    """9x9 information of the PRV factor, order [P, phi, V]."""
    idx = torch.tensor([0, 1, 2, 6, 7, 8, 3, 4, 5], device=pre["cov"].device)
    C = pre["cov"][idx][:, idx]
    d = torch.sqrt(torch.clamp(torch.diagonal(C), min=1e-16))
    Cn = C / d[:, None] / d[None, :]
    eye = torch.eye(9, dtype=C.dtype, device=C.device)
    return torch.linalg.inv(Cn + 1e-6 * eye) / d[:, None] / d[None, :]


def bias_info(dT, sigma_bg, sigma_ba):
    """6x6 information of the bias random walk over dT."""
    return torch.diag(torch.cat([torch.full((3,), 1.0, device=dT.device) / (sigma_bg ** 2 * dT),
                                 torch.full((3,), 1.0, device=dT.device) / (sigma_ba ** 2 * dT)]))


# --------------------------------------------------------------- factors

def prv_factor(si, sj, pre, gw):
    """Residual [rP, rphi, rV] (9,) of the PRV factor between states i and j,
    and its Jacobians (9, 15) with respect to each."""
    dP, dV, dR, corr = corrected(pre, si["dbg"], si["dba"])
    dT = pre["dT"]
    RiT = si["R"].T
    pvec = sj["P"] - si["P"] - si["V"] * dT - 0.5 * gw * dT * dT
    vvec = sj["V"] - si["V"] - gw * dT
    rphi = so3_log(dR.T @ RiT @ sj["R"])
    r = torch.cat([mv(RiT, pvec) - dP, rphi, mv(RiT, vvec) - dV])
    Jinv = jr_inv(rphi)
    Ji = torch.zeros((9, 15), dtype=r.dtype, device=r.device)
    Jj = torch.zeros_like(Ji)
    Ji[0:3, 0:3], Ji[0:3, 3:6], Ji[0:3, 6:9] = -RiT, hat(mv(RiT, pvec)), -RiT * dT
    Ji[0:3, 9:12], Ji[0:3, 12:15] = -pre["J_P_bg"], -pre["J_P_ba"]
    Ji[3:6, 3:6] = -Jinv @ sj["R"].T @ si["R"]
    Ji[3:6, 9:12] = -Jinv @ so3_exp(-rphi) @ jr(corr) @ pre["J_R_bg"]
    Ji[6:9, 3:6], Ji[6:9, 6:9] = hat(mv(RiT, vvec)), -RiT
    Ji[6:9, 9:12], Ji[6:9, 12:15] = -pre["J_V_bg"], -pre["J_V_ba"]
    Jj[0:3, 0:3], Jj[3:6, 3:6], Jj[6:9, 6:9] = RiT, Jinv, RiT
    return r, Ji, Jj


def bias_factor(si, sj):
    """Residual (6,) of the bias random walk and its Jacobians (6, 15)."""
    r = torch.cat([sj["bg"] + sj["dbg"] - si["bg"] - si["dbg"],
                   sj["ba"] + sj["dba"] - si["ba"] - si["dba"]])
    Jj = torch.zeros((6, 15), dtype=r.dtype, device=r.device)
    Jj[:, 9:] = torch.eye(6, dtype=r.dtype, device=r.device)
    return r, -Jj, Jj


def prior_factor(s, s0):
    """Residual (15,) of the prior on state s at s0 and its Jacobian."""
    rphi = so3_log(s0["R"].T @ s["R"])
    r = torch.cat([s["P"] - s0["P"], rphi, s["V"] - s0["V"], s["dbg"] - s0["dbg"],
                   s["dba"] - s0["dba"]])
    J = torch.eye(15, dtype=r.dtype, device=r.device)
    J[3:6, 3:6] = jr_inv(rphi)
    return r, J


def reprojection(s, pts, uv, rig):
    """Residuals (O, 2), Jacobians (O, 2, 6) w.r.t. [dP, dphi] and depths of
    the points pts (O, 3) seen at pixels uv from state s."""
    Pb = mv(s["R"].T, pts - s["P"])
    Pc = mv(rig.Rcb, Pb) + rig.tcb
    proj, z = rig.project(Pc)
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
    iz = 1.0 / zs
    o = torch.zeros_like(z)
    Jpi = torch.stack([torch.stack([rig.fx * iz, o, -rig.fx * Pc[:, 0] * iz * iz], -1),
                       torch.stack([o, rig.fy * iz, -rig.fy * Pc[:, 1] * iz * iz], -1)], -2)
    J = torch.cat([Jpi @ (-(rig.Rcb @ s["R"].T)), Jpi @ (rig.Rcb @ hat(Pb))], -1)
    return proj - uv, J, z


# ------------------------------------------------------------ the pose solve

class Problem:
    """The joint (last, current) problem of one frame: observations of fixed
    points by the current state, the PRV and bias factors between the two,
    the prior on the last state."""

    def __init__(self, pts, uv, info, pre, gw, prior_s0, prior_info, prv_inf, bias_inf, rig):
        self.pts, self.uv, self.info, self.pre, self.gw = pts, uv, info, pre, gw
        self.s0, self.pinfo, self.prv_inf, self.bias_inf = prior_s0, prior_info, prv_inf, bias_inf
        self.rig = rig

    def chi2(self, sc):
        r, _, z = reprojection(sc, self.pts, self.uv, self.rig)
        return torch.sum(r * r, -1) * self.info, z

    def cost(self, x, valid):
        sl, sc = x
        chi2, z = self.chi2(sc)
        c, _, plateau = robust(chi2, CHI2_MONO)
        cost = torch.sum(valid * torch.where(z > 1e-6, c, plateau))
        r, _, _ = prv_factor(sl, sc, self.pre, self.gw)
        rb, _, _ = bias_factor(sl, sc)
        rp, _ = prior_factor(sl, self.s0)
        return cost + r @ self.prv_inf @ r + rb @ self.bias_inf @ rb + rp @ self.pinfo @ rp

    def system(self, x, valid):
        """The normal equations (H (30, 30), g (30,)) at x."""
        sl, sc = x
        r, J, z = reprojection(sc, self.pts, self.uv, self.rig)
        _, w, _ = robust(torch.sum(r * r, -1) * self.info, CHI2_MONO)
        w = self.info * w * valid * (z > 1e-6).to(r.dtype)
        H = torch.zeros((30, 30), dtype=r.dtype, device=r.device)
        g = torch.zeros(30, dtype=r.dtype, device=r.device)
        H[15:21, 15:21] = torch.einsum('o,orc,ord->cd', w, J, J)
        g[15:21] = torch.einsum('o,orc,or->c', w, J, r)
        rv, Ji, Jj = prv_factor(sl, sc, self.pre, self.gw)
        rb, Bi, Bj = bias_factor(sl, sc)
        for res, Ja, Jb, W in ((rv, Ji, Jj, self.prv_inf), (rb, Bi, Bj, self.bias_inf)):
            Jf = torch.cat([Ja, Jb], 1)
            H = H + Jf.T @ W @ Jf
            g = g + Jf.T @ (W @ res)
        rp, Jp = prior_factor(sl, self.s0)
        H[:15, :15] += Jp.T @ self.pinfo @ Jp
        g[:15] += Jp.T @ (self.pinfo @ rp)
        return H, g


def retract(s, dx):
    return dict(s, P=s["P"] + dx[0:3], R=s["R"] @ so3_exp(dx[3:6]), V=s["V"] + dx[6:9],
                dbg=s["dbg"] + dx[9:12], dba=s["dba"] + dx[12:15])


def finite(x):
    return torch.stack([torch.isfinite(s[k]).all() for s in x for k in FIELDS]).all()


def pose_only_vi(cur0, last, pre, pts, uv, info, valid, gw, prior_s0, prior_info, prv_inf,
                 bias_inf, rig, iters=20, marginal=False):
    """The joint solve from (last, cur0). pts (O, 3), uv (O, 2), info (O,),
    valid (O,) float: the current frame's observations.
    Returns (the current state, chi2 (O,), n_inliers, H_marg (15, 15) or None)."""
    prob = Problem(pts, uv, info, pre, gw, prior_s0, prior_info, prv_inf, bias_inf, rig)
    x = (last, cur0)
    c = prob.cost(x, valid)
    lam = torch.full_like(c, 1e-4)
    for _ in range(iters):
        H, g = prob.system(x, valid)
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-10)
        L, bad = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(-g[:, None], torch.where(bad == 0, L, torch.nan))[:, 0]
        xn = (retract(x[0], dx[:15]), retract(x[1], dx[15:]))
        cn = prob.cost(xn, valid)
        ok = (cn < c) & finite(xn)
        x = tuple({k: torch.where(ok, a[k], b[k]) for k in FIELDS} for a, b in zip(xn, x))
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        c = torch.where(ok, cn, c)
    x = tuple(dict(s, R=orthonormalize(s["R"])) for s in x)
    chi2, z = prob.chi2(x[1])
    n_in = int(((chi2 <= CHI2_MONO) & (z > 0) & (valid > 0)).sum())
    Hm = None
    if marginal:
        inl = valid * ((chi2 <= CHI2_MONO) & (z > 1e-6)).to(valid.dtype)
        H, _ = prob.system(x, inl)
        Hll = H[:15, :15] + 1e-8 * torch.eye(15, dtype=H.dtype, device=H.device)
        Hlc = H[:15, 15:]
        Hm = H[15:, 15:] - Hlc.T @ torch.linalg.solve(Hll, Hlc)
    return x[1], chi2, n_in, Hm

