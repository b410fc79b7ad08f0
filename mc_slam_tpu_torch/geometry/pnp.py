"""Batched RANSAC PnP for relocalization (port of mc_slam_tpu/geometry/pnp.py,
the role of PnPsolver).

All hypotheses at once: 6-point minimal sets solved by the normalized DLT
(12-dim null space -> projection matrix -> polar-decomposed R, t), scored by
reprojection inliers over the whole 2D-3D match set in one (B, N) pass; the
best hypothesis is refined by four Gauss-Newton steps on its inlier set.

The sample indices are an ARGUMENT (`draw_samples` makes them from a
`torch.Generator`), so a parity test can give both sides the same sets. The
null vector of a hypothesis is defined up to sign (fixed by the determinant)
and, for a degenerate sample, up to the null space's basis: what is held
against the reference is the SELECTED pose and its inlier mask. A singular
Gauss-Newton system gives a NaN step (`solve_ex`), no exception and no host
read; a NaN pose passes no inlier gate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def draw_samples(generator: torch.Generator | None, w, n_iters: int, k: int):
    """(n_iters, k) indices, each drawn with probability proportional to the
    weight column `w` (with replacement, as the JAX package's categorical
    draw); for w (C, N), (C, n_iters, k) indices, row by row. `generator`
    must live on w's device."""
    probs = torch.clamp(w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0),
                        min=1e-12)
    idx = torch.multinomial(probs, n_iters * k, replacement=True, generator=generator)
    return idx.reshape(*w.shape[:-1], n_iters, k)


def _dlt_pnp(Xw, xn, w=None):
    """P from >= 6 points. Xw (B, M, 3), xn (B, M, 2) normalized coordinates,
    w optional (B, M) row weights. Returns (R (B, 3, 3) cam-from-world,
    t (B, 3)) with det R = +1. Hartley-normalized: the world points are
    centred and scaled per problem before the design matrix is built."""
    B, M, _ = Xw.shape
    wn = torch.ones((B, M), dtype=Xw.dtype, device=Xw.device) if w is None else w
    wsum = torch.clamp(torch.sum(wn, -1, keepdim=True), min=1e-9)
    mu3 = torch.sum(Xw * wn[..., None], -2) / wsum
    d3 = torch.linalg.norm(Xw - mu3[:, None, :], dim=-1)
    s3 = (3.0 ** 0.5) / torch.clamp(torch.sum(d3 * wn, -1) / wsum[..., 0], min=1e-9)
    Xn = (Xw - mu3[:, None, :]) * s3[:, None, None]

    o = torch.zeros((B, M), dtype=Xw.dtype, device=Xw.device)
    l = torch.ones_like(o)
    X, Y, Z = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    r1 = torch.stack([X, Y, Z, l, o, o, o, o, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([o, o, o, o, X, Y, Z, l, -v * X, -v * Y, -v * Z, -v], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], dim=-2)                          # (B, 2M, 12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Pn = Vt[..., 11, :].reshape(B, 3, 4)
    # denormalize: Pn maps X' = s3 (X - mu3)
    A3 = Pn[..., :3] * s3[:, None, None]
    P = torch.cat([A3, (Pn[..., 3] - torch.einsum('bij,bj->bi', A3, mu3))[..., None]],
                  dim=-1)
    # P is up to a signed scale: det(P[:, :3]) > 0, then the polar factor
    Rr = P[..., :3]
    sgn = torch.sign(torch.linalg.det(Rr))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    U, S, Vt2 = torch.linalg.svd(Rr * sgn[..., None, None])
    scale = torch.clamp(torch.mean(S, dim=-1), min=1e-12)
    return U @ Vt2, sgn[..., None] * P[..., 3] / scale[..., None]


class PnPResult(NamedTuple):
    ok: torch.Tensor        # () bool
    R_cw: torch.Tensor      # (3, 3)
    t_cw: torch.Tensor      # (3,)
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def _gn_step(R_c, t_c, w_in, Xw, xn):
    """One Gauss-Newton step on the reprojection error of the weighted set,
    over [dt, dphi] with R <- Exp(dphi) R. Batched over leading dims."""
    Xc = torch.einsum('...ij,...nj->...ni', R_c, Xw) + t_c[..., None, :]
    z = torch.clamp(Xc[..., 2], min=1e-6)
    proj = Xc[..., :2] / z[..., None]
    r = proj - xn
    iz = 1.0 / z
    zero = torch.zeros_like(iz)
    Jp = torch.stack([torch.stack([iz, zero, -proj[..., 0] * iz], -1),
                      torch.stack([zero, iz, -proj[..., 1] * iz], -1)], -2)
    hatX = torch.stack([torch.stack([zero, -Xc[..., 2], Xc[..., 1]], -1),
                        torch.stack([Xc[..., 2], zero, -Xc[..., 0]], -1),
                        torch.stack([-Xc[..., 1], Xc[..., 0], zero], -1)], -2)
    J = torch.cat([Jp, -(Jp @ hatX)], dim=-1)                # (..., N, 2, 6)
    wj = (w_in * (Xc[..., 2] > 1e-6))[..., None, None] * J
    eye6 = torch.eye(6, dtype=J.dtype, device=J.device)
    H = torch.einsum('...nri,...nrj->...ij', wj, J) + 1e-9 * eye6
    g = torch.einsum('...nri,...nr->...i', wj, r)
    dx, info = torch.linalg.solve_ex(H, g[..., None])
    dx = -torch.where((info == 0)[..., None, None], dx, float("nan"))[..., 0]
    ph = dx[..., 3:6]
    an = torch.linalg.norm(ph, dim=-1) + 1e-12
    o = torch.zeros_like(an)
    K = torch.stack([torch.stack([o, -ph[..., 2], ph[..., 1]], -1),
                     torch.stack([ph[..., 2], o, -ph[..., 0]], -1),
                     torch.stack([-ph[..., 1], ph[..., 0], o], -1)], -2)
    Rd = torch.eye(3, dtype=R_c.dtype, device=R_c.device) \
        + (torch.sin(an) / an)[..., None, None] * K \
        + ((1 - torch.cos(an)) / (an * an))[..., None, None] * (K @ K)
    return Rd @ R_c, t_c + dx[..., :3]


def pnp_ransac(idx, Xw, xn, w, focal, th_px: float = 5.991, min_inliers=10) -> PnPResult:
    """Xw (N, 3) world points, xn (N, 2) normalized observations, w (N,)
    validity; idx (n_iters, 6) int64 sample indices (`draw_samples`). th_px: the
    squared-pixel inlier gate (scaled by focal inside).

    Every argument may carry one leading batch dim C (idx (C, n_iters, 6),
    Xw (C, N, 3), xn (N, 2) or (C, N, 2), w (C, N)): the C problems are then
    solved together and every field of the result has the leading C."""
    batched = Xw.dim() == 3
    if not batched:
        idx, Xw, w = idx[None], Xw[None], w[None]
    C, B = idx.shape[0], idx.shape[1]
    xn_c = xn if xn.dim() == 3 else xn[None].expand(C, -1, -1)
    take = lambda a: torch.gather(a[:, None].expand(-1, B, -1, -1), 2,
                                  idx[..., None].expand(-1, -1, -1, a.shape[-1]))
    R, t = _dlt_pnp(take(Xw).reshape(C * B, 6, 3), take(xn_c).reshape(C * B, 6, 2))
    R, t = R.reshape(C, B, 3, 3), t.reshape(C, B, 3)

    def score(Rh, th):
        """Inlier masks (C, H, N) and counts (C, H) of poses (C, H, 3, 3), (C, H, 3)."""
        Xc = torch.einsum('chij,cnj->chni', Rh, Xw) + th[:, :, None, :]
        z = Xc[..., 2]
        z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        proj = Xc[..., :2] / z_safe[..., None]
        e = torch.sum((proj - xn_c[:, None]) ** 2, dim=-1) * (focal * focal)
        inl = (e < th_px) & (z > 0) & (w[:, None] > 0)
        return inl, torch.sum(inl, dim=-1)

    inl, n_inl = score(R, t)
    b = torch.argmax(n_inl, dim=-1)                          # first maximum
    pick = lambda a: torch.gather(
        a, 1, b.reshape(C, *([1] * (a.dim() - 1))).expand(C, 1, *a.shape[2:]))[:, 0]
    R_best, t_best, inl_best, n_best = pick(R), pick(t), pick(inl), pick(n_inl)

    # local optimization: Gauss-Newton on the current inlier set, rescore, keep
    # the better state (ties prefer the refined pose)
    for _ in range(4):
        R2, t2 = _gn_step(R_best, t_best, inl_best.to(Xw.dtype), Xw, xn_c)
        inl2, n2 = (a[:, 0] for a in score(R2[:, None], t2[:, None]))
        better = n2 >= n_best
        R_best = torch.where(better[:, None, None], R2, R_best)
        t_best = torch.where(better[:, None], t2, t_best)
        inl_best = torch.where(better[:, None], inl2, inl_best)
        n_best = torch.maximum(n2, n_best)
    res = PnPResult(ok=n_best >= min_inliers, R_cw=R_best, t_cw=t_best,
                    inliers=inl_best, n_inliers=n_best)
    return res if batched else PnPResult(*[a[0] for a in res])
