"""Monocular two-view bootstrap (port of mc_slam_tpu/geometry/init2view.py):
parallel H/F RANSAC, model selection, reconstruction with cheirality and
parallax checks (Initializer, src/Initializer.cpp).

All RANSAC hypotheses are solved and scored as one batch: 200 SVDs of the
16x9 / 8x9 systems and a (200, N) scoring matrix. Everything is fixed-shape;
match validity is a weight column.

Differences of form from the JAX package, none of intent:
* The 8-point samples are an argument. `initialize_two_view` takes the
  (n_iters, 8) index tensor; `draw_samples` makes one from an explicit
  `torch.Generator`. The JAX function draws them inside from its key.
* A singular hypothesis gives a NaN inverse (`inv_ex`, no raise, no host
  check); its transfer errors are NaN, pass no gate and score 0.
* The selected candidate is gathered with `index_select`, so no device value
  is read on the host; `torch.linalg.svd` itself synchronizes on CUDA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mc_slam_tpu_torch.geometry.triangulation import parallax_cos, triangulate_two_view

SIGMA = 1.0              # reference Initializer sigma
TH_H = 5.991             # chi2(2) gate for homography transfer error
TH_F = 3.841             # chi2(1) gate for epipolar distance
SCORE_GAMMA_H = 5.991    # score offsets (the reference uses th for H
SCORE_GAMMA_F = 5.991    # and thScore = 5.991 for F)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _inv_nan(M):
    """Batched inverse; NaN where the matrix is singular (no raise, no sync)."""
    inv, info = torch.linalg.inv_ex(M)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def _normalize_points(xn, w):
    """Hartley normalization with validity weights. Returns (xh, T) with T the
    3x3 similarity mapping raw -> normalized homogeneous coordinates."""
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xn * w[:, None], dim=0) / wsum
    md = torch.sum(torch.abs(xn - mean) * w[:, None], dim=0) / wsum
    s = 1.0 / torch.clamp(md, min=1e-9)
    xh = (xn - mean) * s
    o, l = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], o, -mean[0] * s[0]]),
                     torch.stack([o, s[1], -mean[1] * s[1]]),
                     torch.stack([o, o, l])])
    return xh, T


def _dlt_homography(x0, x1):
    """H from >= 4 correspondences (B, M, 2) each -> (B, 3, 3), x1 ~ H x0."""
    B = x0.shape[0]
    u, v = x0[..., 0], x0[..., 1]
    up, vp = x1[..., 0], x1[..., 1]
    o, l = torch.zeros_like(u), torch.ones_like(u)
    r1 = torch.stack([o, o, o, -u, -v, -l, vp * u, vp * v, vp], dim=-1)
    r2 = torch.stack([u, v, l, o, o, o, -up * u, -up * v, -up], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                            # (B, 2M, 9)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return Vh[..., 8, :].reshape(B, 3, 3)


def _eight_point_f(x0, x1):
    """F from >= 8 correspondences (B, M, 2) -> (B, 3, 3), rank 2 enforced."""
    B = x0.shape[0]
    u, v = x0[..., 0], x0[..., 1]
    up, vp = x1[..., 0], x1[..., 1]
    l = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, l], dim=-1)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    F = Vh[..., 8, :].reshape(B, 3, 3)
    U, S, Vh2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vh2)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _apply_h(H, x):
    y = torch.einsum('...ij,...nj->...ni', H, _homogeneous(x))
    w = y[..., 2]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12 * torch.ones_like(w), w)
    return y[..., :2] / w_safe[..., None]


def score_homography(H, Hinv, uv0, uv1, w, sigma=SIGMA):
    """Symmetric transfer score (Initializer::CheckHomography).
    Returns (score (...,), inlier (..., N) bool)."""
    inv_s2 = 1.0 / (sigma * sigma)
    e01 = torch.sum((uv1 - _apply_h(H, uv0)) ** 2, dim=-1) * inv_s2
    e10 = torch.sum((uv0 - _apply_h(Hinv, uv1)) ** 2, dim=-1) * inv_s2
    in01 = e01 < TH_H
    in10 = e10 < TH_H
    zero = torch.zeros_like(e01)
    sc = torch.where(in01, SCORE_GAMMA_H - e01, zero) \
        + torch.where(in10, SCORE_GAMMA_H - e10, zero)
    return torch.sum(sc * w, dim=-1), in01 & in10 & (w > 0)


def score_fundamental(F, uv0, uv1, w, sigma=SIGMA):
    """Symmetric epipolar-distance score (Initializer::CheckFundamental)."""
    inv_s2 = 1.0 / (sigma * sigma)
    x0, x1 = _homogeneous(uv0), _homogeneous(uv1)
    l1 = torch.einsum('...ij,...nj->...ni', F, x0)             # line in image 1
    l0 = torch.einsum('...ji,...nj->...ni', F, x1)             # line in image 0
    d1 = torch.sum(l1 * x1, dim=-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * inv_s2
    d0 = torch.sum(l0 * x0, dim=-1) ** 2 / torch.clamp(
        l0[..., 0] ** 2 + l0[..., 1] ** 2, min=1e-12) * inv_s2
    in1 = d1 < TH_F
    in0 = d0 < TH_F
    zero = torch.zeros_like(d1)
    sc = torch.where(in1, SCORE_GAMMA_F - d1, zero) \
        + torch.where(in0, SCORE_GAMMA_F - d0, zero)
    return torch.sum(sc * w, dim=-1), in0 & in1 & (w > 0)


class TwoViewResult(NamedTuple):
    ok: torch.Tensor       # () bool
    used_h: torch.Tensor   # () bool: which model was selected
    R: torch.Tensor        # (3, 3) world(cam0)-from-cam1 rotation (cam0 = identity)
    t: torch.Tensor        # (3,) cam1 centre in the cam0 frame (unit-ish scale)
    Xw: torch.Tensor       # (N, 3) triangulated points in the cam0 frame
    good: torch.Tensor     # (N,) bool triangulation accepted
    n_good: torch.Tensor   # () int64
    score_h: torch.Tensor
    score_f: torch.Tensor


def _check_rt(R, t, xn0, xn1, w, th_reproj=4.0, min_par_cos=0.99998):
    """Triangulate under (R, t) and audit: positive depths, parallax,
    reprojection (Initializer::CheckRT). xn are normalized coordinates; the
    caller gives th_reproj in normalized units.
    Returns (Xw, good, n_good, parallax cosines)."""
    I = torch.eye(3, dtype=R.dtype, device=R.device)
    z = torch.zeros(3, dtype=R.dtype, device=R.device)
    Xw, d0, d1 = triangulate_two_view(I, z, R, t, xn0, xn1)
    cosp = parallax_cos(z, t, Xw)
    finite = torch.all(torch.isfinite(Xw), dim=-1)
    pos = (d0 > 0) & (d1 > 0)
    e0 = torch.sum((Xw[..., :2] / torch.clamp(Xw[..., 2:3], min=1e-9) - xn0) ** 2, -1)
    Xc1 = _mv(R.transpose(-1, -2), Xw - t)
    e1 = torch.sum((Xc1[..., :2] / torch.clamp(Xc1[..., 2:3], min=1e-9) - xn1) ** 2, -1)
    ok_rep = (e0 < th_reproj) & (e1 < th_reproj)
    good = finite & pos & (cosp < min_par_cos) & ok_rep & (w > 0)
    return Xw, good, torch.sum(good), cosp


def _proper(R):
    return torch.where(torch.linalg.det(R) < 0, -R, R)


def _to_pose(R, t):
    """x1 = R x0 + t (cam1-from-cam0) -> world-from-cam1 pose (Rwc1, C1)."""
    Rwc = R.transpose(-1, -2)
    return Rwc, -_mv(Rwc, t)


def _decompose_e(E):
    """E -> 4 (R, t) world-from-cam1 hypotheses (Initializer::DecomposeE)."""
    U, _, Vh = torch.linalg.svd(E)
    o, l = torch.zeros_like(E[0, 0]), torch.ones_like(E[0, 0])
    W = torch.stack([torch.stack([o, -l, o]), torch.stack([l, o, o]),
                     torch.stack([o, o, l])])
    R1 = _proper(U @ W @ Vh)
    R2 = _proper(U @ W.T @ Vh)
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return [_to_pose(R1, t), _to_pose(R1, -t), _to_pose(R2, t), _to_pose(R2, -t)]


def _decompose_h_normalized(H):
    """Plane-induced homography decomposition (x1 = H x0 in normalized
    coordinates) by the SVD method; 8 (R, t) world-from-cam1 hypotheses
    (Initializer::ReconstructH, Faugeras)."""
    U, S, Vh = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vh.transpose(-1, -2))
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / den)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / den)
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    o, l = torch.zeros_like(d1), torch.ones_like(d1)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    hyps = []
    # case d' > 0: rotations by theta about y
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for k in range(4):
        st = [1, -1, -1, 1][k] * sin_t
        Rp = torch.stack([torch.stack([cos_t, o, -st]), torch.stack([o, l, o]),
                          torch.stack([st, o, cos_t])])
        tp = (d1 - d3) * torch.stack([x1s[k], o, -x3s[k]])
        hyps.append((s * (U @ Rp @ Vh), _mv(U, tp)))
    # case d' < 0: rotations by pi about y
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for k in range(4):
        sp = [1, -1, -1, 1][k] * sin_p
        Rp = torch.stack([torch.stack([cos_p, o, sp]), torch.stack([o, -l, o]),
                          torch.stack([sp, o, -cos_p])])
        tp = (d1 + d3) * torch.stack([x1s[k], o, x3s[k]])
        hyps.append((s * (U @ Rp @ Vh), _mv(U, tp)))
    return [_to_pose(R, t / torch.clamp(torch.linalg.norm(t), min=1e-12))
            for R, t in hyps]


def draw_samples(w, n_iters: int = 200, generator: torch.Generator | None = None):
    """(n_iters, 8) match indices, each drawn with probability proportional
    to the weight column `w` (with replacement, as the JAX package's
    categorical draw). `generator` must live on w's device."""
    probs = torch.clamp(w / torch.clamp(torch.sum(w), min=1.0), min=1e-12)
    idx = torch.multinomial(probs, n_iters * 8, replacement=True, generator=generator)
    return idx.reshape(n_iters, 8)


def initialize_two_view(idx, xn0, xn1, w, focal, min_good: int = 50) -> TwoViewResult:
    """Full two-view bootstrap on normalized coordinates xn0 / xn1 (N, 2)
    with validity weights w.

    idx: (n_iters, 8) int64 sample indices into the N matches (`draw_samples`).
    focal: nominal focal length in pixels; scores are computed in
    pixel-equivalent units (err_px ~ err_n * focal).
    Returns a TwoViewResult with cam0 at the identity and unit-ish baseline."""
    dtype, dev = xn0.dtype, xn0.device
    uv0 = xn0 * focal
    uv1 = xn1 * focal
    s0 = uv0[idx]                                            # (B, 8, 2)
    s1 = uv1[idx]
    eye = torch.eye(3, dtype=dtype, device=dev)

    # --- homography branch ---
    Hs = _dlt_homography(s0, s1)
    sc_h, _ = score_homography(Hs, _inv_nan(Hs + 1e-12 * eye), uv0[None], uv1[None],
                               w[None])
    best_h = torch.argmax(sc_h).reshape(1)
    H_best = Hs.index_select(0, best_h)[0]
    score_h, inl_h = score_homography(H_best, _inv_nan(H_best), uv0, uv1, w)

    # --- fundamental branch ---
    Fs = _eight_point_f(s0, s1)
    sc_f, _ = score_fundamental(Fs, uv0[None], uv1[None], w[None])
    best_f = torch.argmax(sc_f).reshape(1)
    F_best = Fs.index_select(0, best_f)[0]
    score_f, inl_f = score_fundamental(F_best, uv0, uv1, w)

    rh = score_h / torch.clamp(score_h + score_f, min=1e-9)
    use_h = rh > 0.40

    # --- reconstruct both, pick by the selection rule ---
    th_n = 4.0 / (focal * focal)     # 4 px^2 reprojection in normalized units
    kd = torch.cat([torch.full((2,), float(focal), dtype=dtype, device=dev),
                    torch.ones(1, dtype=dtype, device=dev)])
    K, Kinv = torch.diag(kd), torch.diag(1.0 / kd)
    E = K.T @ F_best @ K             # E = K^T F K with K = diag(f, f, 1)
    w_f = w * inl_f
    w_h = w * inl_h

    cand = []
    for R, C in _decompose_e(E):
        Xw, good, n, _ = _check_rt(R, C, xn0, xn1, w_f, th_reproj=th_n)
        cand.append((Xw, good, n, R, C))
    Hn = Kinv @ H_best @ K           # the homography in normalized coordinates
    for R, C in _decompose_h_normalized(Hn):
        Xw, good, n, _ = _check_rt(R, C, xn0, xn1, w_h, th_reproj=th_n)
        cand.append((Xw, good, n, R, C))

    ns = torch.stack([c[2] for c in cand])                   # (12,)
    is_h_cand = torch.arange(12, device=dev) >= 4
    minus = torch.full_like(ns, -1)
    ns_sel = torch.where(use_h, torch.where(is_h_cand, ns, minus),
                         torch.where(is_h_cand, minus, ns))
    best = torch.argmax(ns_sel).reshape(1)
    pick = lambda i: torch.stack([c[i] for c in cand]).index_select(0, best)[0]
    n_good = pick(2)

    # acceptance: a clear winner with enough support (ReconstructF's rules)
    second = torch.sort(ns_sel).values[-2]
    ok = (n_good >= min_good) & (second.to(dtype) < 0.75 * n_good.to(dtype))
    return TwoViewResult(ok=ok, used_h=use_h, R=pick(3), t=pick(4), Xw=pick(0),
                         good=pick(1), n_good=n_good, score_h=score_h, score_f=score_f)
