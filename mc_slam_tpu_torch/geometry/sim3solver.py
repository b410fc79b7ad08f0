"""Horn closed-form Sim3 estimation and batched RANSAC (port of
mc_slam_tpu/geometry/sim3solver.py, the role of Sim3Solver).

Horn's quaternion absolute-orientation method from 3-point sets inside
RANSAC, scored by bidirectional reprojection, with the fix-scale switch (SE3
after VI init and for depth sensors). All hypotheses are solved and scored as
one batch; the sample indices are an ARGUMENT (`pnp.draw_samples` makes them
from a `torch.Generator`).

The quaternion is the top eigenvector of a symmetric 4x4 matrix, its sign
fixed by q[0] >= 0; a collinear sample has a repeated top eigenvalue, for
which the eigenvector is any vector of a plane and differs by library: what
is held against the reference is the SELECTED result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch import lie


def horn_sim3(Pa, Pb, w=None, fix_scale: bool = False):
    """Closed-form Sim3 aligning point sets, Pb ~ s R Pa + t.
    Pa, Pb: (..., M, 3); w optional (..., M) weights. Returns (s, R, t)."""
    if w is None:
        w = torch.ones(Pa.shape[:-1], dtype=Pa.dtype, device=Pa.device)
    ws = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    ca = torch.sum(Pa * w[..., None], -2) / ws
    cb = torch.sum(Pb * w[..., None], -2) / ws
    A = (Pa - ca[..., None, :]) * w[..., None]
    B = Pb - cb[..., None, :]
    # Horn's cross-covariance S = sum a b^T (the rotation maps a -> b)
    M = torch.einsum('...mi,...mj->...ij', A, B)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]                       # max-eigenvalue quaternion (w, x, y, z)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    R = _quat_to_rot(q)
    Ar = torch.einsum('...ij,...mj->...mi', R, Pa - ca[..., None, :])
    num = torch.sum(torch.sum(B * Ar, -1) * w, -1)
    den = torch.sum(torch.sum(Ar * Ar, -1) * w, -1)
    s = num / torch.clamp(den, min=1e-12)
    if fix_scale:
        s = torch.ones_like(s)
    t = cb - s[..., None] * (R @ ca[..., None])[..., 0]
    return s, R, t


def _quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Sim3Result(NamedTuple):
    ok: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def sim3_ransac(idx, Pa, Pb, w, focal, th_px2: float = 9.21, min_inliers=20,
                fix_scale: bool = False) -> Sim3Result:
    """RANSAC Horn Sim3 between matched 3D point sets (the camera frames of
    two keyframes). Pa, Pb: (N, 3) matched points; w (N,) validity; idx
    (n_iters, 3) int64 sample indices; scored by the bidirectional projection
    error in pixels (th_px2 ~ chi2(2) 0.99). The result is the Horn fit over
    the inliers of the best hypothesis (the first of equal counts).

    Every array may carry one leading batch dim C (idx (C, n_iters, 3),
    Pa / Pb (C, N, 3), w (C, N), min_inliers a number or (C,)): C problems
    solved together, every field of the result with the leading C."""
    batched = Pa.dim() == 3
    if not batched:
        idx, Pa, Pb, w = idx[None], Pa[None], Pb[None], w[None]
    C, B = idx.shape[0], idx.shape[1]
    take = lambda a: torch.gather(a[:, None].expand(-1, B, -1, -1), 2,
                                  idx[..., None].expand(-1, -1, -1, 3))
    s, R, t = horn_sim3(take(Pa), take(Pb), fix_scale=fix_scale)   # (C, B) ...

    # bidirectional projection scoring
    Pb_hat = s[..., None, None] * torch.einsum('cbij,cnj->cbni', R, Pa) + t[:, :, None, :]
    s_inv, R_inv, t_inv = lie.sim3_inv(s, R, t)
    Pa_hat = s_inv[..., None, None] * torch.einsum('cbij,cnj->cbni', R_inv, Pb) \
        + t_inv[:, :, None, :]

    def perr(Xc, X):
        z1 = torch.clamp(Xc[..., 2], min=1e-9)
        z2 = torch.clamp(X[..., 2], min=1e-9)
        p1 = Xc[..., :2] / z1[..., None]
        p2 = (X[..., :2] / z2[..., None])[:, None]
        return torch.sum((p1 - p2) ** 2, -1) * focal * focal

    inl = (perr(Pb_hat, Pb) < th_px2) & (perr(Pa_hat, Pa) < th_px2) & (w[:, None] > 0)
    n_inl = torch.sum(inl, -1)                                    # (C, B)
    b = torch.argmax(n_inl, dim=-1)
    n_b = torch.gather(n_inl, 1, b[:, None])[:, 0]
    inl_b = torch.gather(inl, 1, b[:, None, None].expand(C, 1, inl.shape[-1]))[:, 0]
    # refine on the inlier set of the best hypothesis
    s2, R2, t2 = horn_sim3(Pa, Pb, w=inl_b.to(Pa.dtype), fix_scale=fix_scale)
    res = Sim3Result(ok=n_b >= min_inliers, s=s2, R=R2, t=t2, inliers=inl_b, n_inliers=n_b)
    return res if batched else Sim3Result(*[a[0] for a in res])
