"""Plain localization against a prior map: the benchmark's reference for the
port's batched step (`parallel/multiseq.make_batched_step`: extraction,
undistortion, two projection searches and the pose solve of
`pipeline/tracking.track_frame_visual`).

One frame at a time, in plain PyTorch, from the description of the
reference's TrackWithMotionModel / SearchByProjection / PoseOptimization as
the port states them: every active map point is projected at the pose
prior and gated by the frustum, the scale-invariance band and the viewing
cone; each is matched to the frame feature of least Hamming distance inside
a square window (15 px, then 4 px) whose pyramid level is within one of the
predicted level; a match needs distance <= 100 and < 0.9 x the second best,
and a feature keeps only its best map point. The pose then takes 10
Levenberg-Marquardt iterations on a truncated-Huber reprojection cost. It
imports nothing of the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import orb

TH_HIGH, RATIO, BIG = 100, 0.9, 10_000
CHI2_MONO = 5.991
HUBER_TRUNC = 400.0


def mv(M, v):
    return (M @ v[..., None])[..., 0]


def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp(phi):
    ts = torch.sum(phi * phi, -1)
    small = ts < 1e-12                    # angles below 1e-6 rad: Taylor forms
    safe = torch.where(small, torch.ones_like(ts), ts)
    th = torch.sqrt(safe)
    A = torch.where(small, 1.0 - ts / 6.0 + ts ** 2 / 120.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - ts / 24.0 + ts ** 2 / 720.0, (1.0 - torch.cos(th)) / safe)
    W = hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + A[..., None, None] * W \
        + B[..., None, None] * (W @ W)


def orthonormalize(R):
    r0 = R[..., 0, :] / torch.clamp(torch.linalg.norm(R[..., 0, :], dim=-1, keepdim=True),
                                    min=1e-12)
    r1 = R[..., 1, :] - torch.sum(r0 * R[..., 1, :], -1, keepdim=True) * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], -2)


class Rig:
    """Intrinsics (fx, fy, cx, cy, k1, k2, p1, p2, k3), image size and the
    camera-from-body extrinsic (Rcb, tcb), as float32 tensors on one device."""

    def __init__(self, intr, width, height, Tbc, device):
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.fx, self.fy, self.cx, self.cy, self.k1, self.k2, self.p1, self.p2, self.k3 = \
            (t(v) for v in intr)
        self.width, self.height = width, height
        Tbc = t(Tbc)
        self.Rcb = Tbc[:3, :3].T.contiguous()
        self.tcb = -self.Rcb @ Tbc[:3, 3]

    def undistort(self, uv, iters=8):
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy], -1)
        xn = xd
        for _ in range(iters):
            x, y = xn[..., 0], xn[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            xy = x * y
            dx = 2.0 * self.p1 * xy + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * xy
            xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], -1)
        return torch.stack([xn[..., 0] * self.fx + self.cx, xn[..., 1] * self.fy + self.cy], -1)

    def project(self, Pc):
        z = Pc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
        return torch.stack([self.fx * Pc[..., 0] / zs + self.cx,
                            self.fy * Pc[..., 1] / zs + self.cy], -1), z


def visible_points(mp, rig, P, R):
    """Projections (Np, 2), visibility (Np,) and predicted levels (Np,) of
    the map's points at body pose (P, R) (Frame::isInFrustum, PredictScale)."""
    Pb = mv(R.T, mp["pos"] - P)
    Pc = mv(rig.Rcb, Pb) + rig.tcb
    uv, z = rig.project(Pc)
    vis = (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < rig.width) & (uv[:, 1] >= 0) \
        & (uv[:, 1] < rig.height) & mp["active"]
    dist = torch.linalg.norm(Pb, dim=-1)
    vis = vis & (dist >= 0.5 * mp["min_dist"]) & (dist <= 1.5 * mp["max_dist"].clamp(min=1e-6))
    Cw = P - mv(R, mv(rig.Rcb.T, rig.tcb))
    ray = mp["pos"] - Cw
    cos = torch.sum(ray * mp["normal"], -1) / torch.linalg.norm(ray, dim=-1).clamp(min=1e-9)
    vis = vis & ((cos > 0.5) | (torch.sum(mp["normal"] ** 2, -1) <= 0.25))
    d = torch.linalg.norm(mp["pos"] - P, dim=-1)
    ratio = mp["max_dist"].clamp(min=1e-6) / d.clamp(min=1e-6)
    lvl = torch.ceil(torch.log(ratio.clamp(min=1e-6)) / float(np.log(np.float32(1.2))))
    return uv, vis, lvl.clamp(0, 7).to(torch.int32)


def search(mp, feats, uv_feat, rig, P, R, radius):
    """Projection search: (feature -> map point index or -1) (F,)."""
    proj, vis, lvl = visible_points(mp, rig, P, R)
    dot = mp["pm1"].to(torch.float32) @ feats["pm1"].to(torch.float32).T
    dist = torch.div(256 - dot.to(torch.int32), 2, rounding_mode="floor")
    gate = (torch.abs(proj[:, None, 0] - uv_feat[None, :, 0]) < radius) \
        & (torch.abs(proj[:, None, 1] - uv_feat[None, :, 1]) < radius) \
        & (torch.abs(lvl[:, None] - feats["level"][None, :]) <= 1) \
        & vis[:, None] & feats["valid"][None, :]
    d = torch.where(gate, dist, BIG)
    best, idx = torch.min(d, dim=-1)
    second = torch.amin(d.scatter(-1, idx[:, None], BIG), dim=-1)
    ok = (best <= TH_HIGH) & (best.to(torch.float32) < RATIO * second.to(torch.float32))
    # one map point per feature: the least distance, then the lowest point index
    Fn = uv_feat.shape[0]
    key = torch.where(ok, best.to(torch.int64) * (1 << 32) + torch.arange(
        len(best), device=best.device), 2 ** 62)
    win = torch.full((Fn,), 2 ** 62, dtype=torch.int64, device=best.device)
    win = win.scatter_reduce(0, idx, key, reduce="amin")
    feat_mp = torch.where(win < 2 ** 62, win % (1 << 32), -1)
    return feat_mp.to(torch.int32)


def robust(chi2, d2):
    """(cost, IRLS weight) of the Huber kernel truncated at 400 x its knee,
    the weight ramped to 0 over the last 30 %."""
    safe = torch.clamp(chi2, min=1e-12)
    plateau = (2.0 * math.sqrt(HUBER_TRUNC) - 1.0) * d2
    cost = torch.clamp(torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * safe) - d2),
                       max=plateau)
    T = HUBER_TRUNC * d2
    w = torch.where(chi2 <= d2, torch.ones_like(chi2), torch.sqrt(d2 / safe)) \
        * torch.clamp((T - chi2) / (0.3 * T), 0.0, 1.0)
    return cost, w, plateau


def solve_pose(P0, R0, pts, uv, info, valid, rig, iters):
    """LM over one body pose against fixed points; returns (P, R, chi2)."""
    def residual(P, R):
        Pb = mv(R.T, pts - P)
        Pc = mv(rig.Rcb, Pb) + rig.tcb
        proj, z = rig.project(Pc)
        return proj - uv, z, Pb, Pc

    def cost(P, R):
        r, z, _, _ = residual(P, R)
        c, _, plateau = robust(torch.sum(r * r, -1) * info, CHI2_MONO)
        return torch.sum(valid * torch.where(z > 1e-6, c, plateau))

    P, R = P0, R0
    c = cost(P, R)
    lam = torch.full_like(c, 1e-4)
    for _ in range(iters):
        r, z, Pb, Pc = residual(P, R)
        _, w, _ = robust(torch.sum(r * r, -1) * info, CHI2_MONO)
        w = info * w * valid * (z > 1e-6).to(r.dtype)
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9 * torch.ones_like(z), z)
        iz = 1.0 / zs
        o = torch.zeros_like(z)
        Jpi = torch.stack([torch.stack([rig.fx * iz, o, -rig.fx * Pc[:, 0] * iz * iz], -1),
                           torch.stack([o, rig.fy * iz, -rig.fy * Pc[:, 1] * iz * iz], -1)], -2)
        J = torch.cat([Jpi @ (-(rig.Rcb @ R.T)), Jpi @ (rig.Rcb @ hat(Pb))], -1)
        H = torch.einsum('o,orc,ord->cd', w, J, J)
        g = torch.einsum('o,orc,or->c', w, J, r)
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-10)
        L, bad = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(-g[:, None], torch.where(bad == 0, L, torch.nan))[:, 0]
        Pn, Rn = P + dx[:3], R @ so3_exp(dx[3:])
        cn = cost(Pn, Rn)
        ok = (cn < c) & torch.isfinite(Pn).all() & torch.isfinite(Rn).all()
        P, R = torch.where(ok, Pn, P), torch.where(ok, Rn, R)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        c = torch.where(ok, cn, c)
    r, z, _, _ = residual(P, R)
    return P, orthonormalize(R), torch.sum(r * r, -1) * info, z


def localize(img, mp, rig, P0, R0, n_features=1024, n_levels=8, iters=10):
    """One frame against one map: (P (3,), R (3, 3), feat_mp (F,), n_inliers)."""
    f = orb.extract(img, n_features, n_levels)
    uv = rig.undistort(f["xy"])
    info = 1.0 / (1.2 ** (2.0 * f["level"].to(torch.float32)))
    P, R = P0, R0
    for radius in (15.0, 4.0):
        feat_mp = search(mp, f, uv, rig, P, R, radius)
        matched = feat_mp >= 0
        pts = mp["pos"][feat_mp.clamp(min=0).to(torch.int64)]
        P, R, chi2, z = solve_pose(P, R, pts, uv, info, matched.to(torch.float32), rig, iters)
    inlier = matched & (chi2 <= CHI2_MONO)
    return P, R, torch.where(inlier, feat_mp, -1), int((inlier & (z > 0)).sum())
