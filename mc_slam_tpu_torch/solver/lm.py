"""Levenberg-Marquardt engine with dense-block Schur complement (port of
mc_slam_tpu/solver/lm.py: the pieces pose tracking and the window BA reach).

The JAX loops are fixed-count `lax.scan`s with `jnp.where` accept/reject;
here they are fixed-count Python loops with `torch.where` selects, so the
host never reads a device scalar (no `.item()`, no sync).

`jax.scipy.linalg.cho_factor` yields NaN on a non-positive-definite system
and the LM rejects the NaN candidate. `torch.linalg.cholesky` raises instead,
so `cho_solve_nan` uses `cholesky_ex` (no raise, no sync) and turns a failed
factorization into NaN, which the loop then rejects exactly as in JAX.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import math

import torch


def huber_weight(chi2, delta_sq):
    """IRLS weight of the Huber kernel on squared error chi2."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta_sq, torch.ones_like(chi2),
                       torch.sqrt(delta_sq / safe))


def huber_cost(chi2, delta_sq):
    """rho(chi2): chi2 below the knee, 2*delta*sqrt(chi2) - delta^2 above."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta_sq, chi2,
                       2.0 * torch.sqrt(delta_sq * safe) - delta_sq)


# Truncation point of the robust kernel as a multiple of the Huber knee
# (see mc_slam_tpu/solver/lm.py:44-63 for how this value was chosen).
HUBER_TRUNC = 400.0


def trunc_plateau(delta_sq):
    """Cost plateau of the truncated kernel == huber_cost(HUBER_TRUNC*d2, d2)."""
    return (2.0 * math.sqrt(HUBER_TRUNC) - 1.0) * delta_sq


def trunc_huber_cost(chi2, delta_sq):
    """Truncated Huber rho: huber(chi2) below HUBER_TRUNC*delta^2, flat above."""
    plateau = trunc_plateau(delta_sq)
    if isinstance(plateau, torch.Tensor):
        return torch.minimum(huber_cost(chi2, delta_sq), plateau)
    return torch.clamp(huber_cost(chi2, delta_sq), max=plateau)


def trunc_huber_weight(chi2, delta_sq):
    """IRLS weight of the truncated kernel: Huber weight inside, 0 beyond,
    with a linear ramp over the last 30% so the weight is continuous."""
    T = HUBER_TRUNC * delta_sq
    ramp = torch.clamp((T - chi2) / (0.3 * T), 0.0, 1.0)
    return huber_weight(chi2, delta_sq) * ramp


class Observations(NamedTuple):
    """A batch of landmark-observation factors with up to K camera blocks each
    (K = 1 plain XYZ reprojection, K = 2 anchored inverse depth: anchor +
    observer). Padded to fixed shapes; `w` == 0 disables an entry."""
    cam: torch.Tensor    # (O, K) int64 camera indices
    pt: torch.Tensor     # (O,) int64 landmark indices
    Jc: torch.Tensor     # (O, K, R, DC) camera Jacobian blocks
    Jp: torch.Tensor     # (O, R, DP) landmark Jacobian
    r: torch.Tensor      # (O, R) residuals
    w: torch.Tensor      # (O,) scalar weight (info * robust * valid)


class CamFactors(NamedTuple):
    """Camera-only factors with K camera blocks and a full RxR information."""
    cam: torch.Tensor    # (F, K) int64
    J: torch.Tensor      # (F, K, R, DC)
    r: torch.Tensor      # (F, R)
    info: torch.Tensor   # (F, R, R)
    w: torch.Tensor      # (F,) robust/valid scalar


def accumulate_cam_factors(H, g, cost, fac: CamFactors, free_mask):
    """Scatter camera-only factors into the dense camera system.
    H: (Nc, DC, Nc, DC), g: (Nc, DC). Returns updated (H, g, cost)."""
    Nc, DC = g.shape
    J = fac.J * free_mask[fac.cam][..., None, None]
    wInfo = fac.info * fac.w[..., None, None]
    # cost uses the UNMASKED residual (fixed cams still contribute error)
    cost = cost + torch.sum(fac.w * torch.einsum('fr,frs,fs->f', fac.r, fac.info, fac.r))
    JtW = torch.einsum('fkrc,frs->fksc', J, wInfo)
    g_blocks = torch.einsum('fksc,fs->fkc', JtW, fac.r)
    H_blocks = torch.einsum('fksc,flsd->fklcd', JtW, J)
    K = fac.cam.shape[-1]
    g = g.index_add(0, fac.cam.reshape(-1), g_blocks.reshape(-1, DC))
    ca = fac.cam.repeat_interleave(K, dim=-1).reshape(-1)
    cb = fac.cam.repeat(1, K).reshape(-1)
    Hp = H.permute(0, 2, 1, 3).reshape(Nc * Nc, DC, DC)
    Hp = Hp.index_add(0, ca * Nc + cb, H_blocks.reshape(-1, DC, DC))
    H = Hp.reshape(Nc, Nc, DC, DC).permute(0, 2, 1, 3)
    return H, g, cost


def cho_solve_nan(A, b):
    """Solve A x = b for SPD A by Cholesky; NaN (no raise, no sync) where the
    factorization fails, as jax.scipy.linalg.cho_factor/cho_solve."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def solve_cam_system(H, g, lam, free_mask):
    """Plain damped solve of a camera-only system (pose-only optimization)."""
    Nc, DC = g.shape
    n = Nc * DC
    Hf = H.reshape(n, n)
    Hf = Hf + torch.diag(lam * torch.diagonal(Hf) + 1e-10)
    fm = free_mask.repeat_interleave(DC)
    Hf = Hf * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    return cho_solve_nan(Hf, -(g.reshape(n) * fm)).reshape(Nc, DC)


def build_landmark_system(obs: Observations, free_mask, Nc, DC, Np, DP):
    """Accumulate reprojection factors into (Hcc (Nc, DC, Nc, DC), g_c (Nc, DC))
    plus the landmark-side blocks of the Schur complement: Hpp (Np, DP, DP),
    g_p (Np, DP), Wcp (Nc, DC, Np, DP), and the weighted cost.

    The camera system is one matrix product over the dense G matrix (each
    observation's Jacobian row scattered into the Nc*DC-wide camera state),
    as in the JAX package; the landmark side is index_add scatter-sums, whose
    order on a GPU is not fixed (float32 sums agree to rounding only)."""
    Jc = obs.Jc * free_mask[obs.cam][..., None, None]        # (O, K, R, DC)
    w = obs.w
    cost = torch.sum(w * torch.sum(obs.r * obs.r, dim=-1))

    wJp = obs.Jp * w[..., None, None]                        # (O, R, DP)
    Hpp = torch.zeros((Np, DP, DP), dtype=obs.r.dtype, device=obs.r.device)
    Hpp = Hpp.index_add(0, obs.pt, torch.einsum('ord,ore->ode', wJp, obs.Jp))
    g_p = torch.zeros((Np, DP), dtype=obs.r.dtype, device=obs.r.device)
    g_p = g_p.index_add(0, obs.pt, torch.einsum('ord,or->od', wJp, obs.r))

    wJc = Jc * w[..., None, None, None]
    O, K, R, _ = Jc.shape
    onehot = (obs.cam[..., None] == torch.arange(Nc, device=obs.cam.device)
              ).to(obs.r.dtype)                              # (O, K, Nc)
    G = torch.einsum('okc,okrj->orcj', onehot, Jc).reshape(O * R, Nc * DC)
    wG = torch.einsum('okc,okrj->orcj', onehot, wJc).reshape(O * R, Nc * DC)
    Hcc = (wG.T @ G).reshape(Nc, DC, Nc, DC)
    g_c = (wG.T @ obs.r.reshape(O * R)).reshape(Nc, DC)

    Wcp_blocks = torch.einsum('okrc,ord->okcd', wJc, obs.Jp)  # (O, K, DC, DP)
    flat = (obs.cam * Np + obs.pt[:, None]).reshape(-1)       # (O*K,) cam-major
    Wcp = torch.zeros((Nc * Np, DC, DP), dtype=obs.r.dtype, device=obs.r.device)
    Wcp = Wcp.index_add(0, flat, Wcp_blocks.reshape(-1, DC, DP))
    Wcp = Wcp.reshape(Nc, Np, DC, DP).permute(0, 2, 1, 3)
    return Hcc, g_c, Hpp, g_p, Wcp, cost


def batched_inv_small(H):
    """Closed-form inverse of batched 1x1 / 2x2 / 3x3 blocks (adjugate form)."""
    d = H.shape[-1]
    if d == 1:
        return 1.0 / H
    if d == 2:
        a, b = H[..., 0, 0], H[..., 0, 1]
        c, e = H[..., 1, 0], H[..., 1, 1]
        inv_det = 1.0 / (a * e - b * c)
        return torch.stack([torch.stack([e, -b], -1),
                            torch.stack([-c, a], -1)], -2) * inv_det[..., None, None]
    if d == 3:
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d2, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        A = e * i - f * h
        B = f * g - d2 * i
        C = d2 * h - e * g
        inv_det = 1.0 / (a * A + b * B + c * C)
        adj = torch.stack([
            torch.stack([A, c * h - b * i, b * f - c * e], -1),
            torch.stack([B, a * i - c * g, c * d2 - a * f], -1),
            torch.stack([C, b * g - a * h, a * e - b * d2], -1)], -2)
        return adj * inv_det[..., None, None]
    return torch.linalg.inv(H)


def damp_point_blocks(Hpp, lam):
    """LM-damp landmark blocks: multiplicative on the diagonal plus an
    absolute floor scaled to the problem (1e-3 x the mean per-point diagonal
    energy of the observed landmarks x lambda, at least 1e-8); see
    mc_slam_tpu/solver/lm.py:209-224 for why."""
    DP = Hpp.shape[-1]
    eyep = torch.eye(DP, dtype=Hpp.dtype, device=Hpp.device)
    d_pt = torch.sum(torch.diagonal(Hpp, dim1=-2, dim2=-1), -1)
    d_avg = torch.sum(d_pt) / torch.clamp(torch.sum(d_pt > 0), min=1)
    floor = torch.clamp(1e-3 * d_avg * lam, min=1e-8)
    return Hpp + lam * (Hpp * eyep) + floor * eyep


def _reduced_solve(S, g_s, Hcc, lam, free_mask):
    """Damp, fix and solve the reduced camera system S dx = -g_s."""
    Nc, DC = g_s.shape
    n = Nc * DC
    Sf = S.reshape(n, n)
    diag_c = torch.diagonal(Hcc.reshape(n, n))
    Sf = Sf + torch.diag(lam * diag_c + 1e-10)
    fm = free_mask.repeat_interleave(DC)
    Sf = Sf * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    return cho_solve_nan(Sf, -(g_s.reshape(n) * fm)).reshape(Nc, DC)


def schur_solve(Hcc, g_c, Hpp, g_p, Wcp, lam, free_mask, pt_mask):
    """Damped Schur solve. Returns (dxc (Nc, DC), dxp (Np, DP)). Fixed cameras
    get identity blocks; masked landmarks get a zero step."""
    Hpp_inv = batched_inv_small(damp_point_blocks(Hpp, lam))
    Y = torch.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
    S = Hcc - torch.einsum('cipk,djpk->cidj', Y, Wcp)
    g_s = g_c - torch.einsum('cipk,pk->ci', Y, g_p)
    dxc = _reduced_solve(S, g_s, Hcc, lam, free_mask)
    rhs = g_p + torch.einsum('cipj,ci->pj', Wcp, dxc)
    dxp = -torch.einsum('pjk,pk->pj', Hpp_inv, rhs)
    return dxc, dxp * pt_mask[:, None]


def schur_solve_pr(Hcc, g_c, Hpp, g_p, Wcp, lam, free_mask, pt_mask):
    """Damped Schur solve for VI systems where landmarks couple only to the
    leading Dv (pose) columns of each DC-dim camera block.
    Hcc: (Nc, DC, Nc, DC) full camera system (visual 6-d part already
    embedded); Wcp: (Nc, Dv, Np, DP). Returns (dxc (Nc, DC), dxp (Np, DP))."""
    Dv = Wcp.shape[1]
    Hpp_inv = batched_inv_small(damp_point_blocks(Hpp, lam))
    Y = torch.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
    S_corr = torch.einsum('cipk,djpk->cidj', Y, Wcp)
    g_corr = torch.einsum('cipk,pk->ci', Y, g_p)
    S = Hcc.clone()
    S[:, :Dv, :, :Dv] -= S_corr
    g_s = g_c.clone()
    g_s[:, :Dv] -= g_corr
    dxc = _reduced_solve(S, g_s, Hcc, lam, free_mask)
    rhs = g_p + torch.einsum('cipj,ci->pj', Wcp, dxc[:, :Dv])
    dxp = -torch.einsum('pjk,pk->pj', Hpp_inv, rhs)
    return dxc, dxp * pt_mask[:, None]


def tree_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for item in x for leaf in tree_leaves(item)]


def tree_select(cond, a, b):
    """Leafwise torch.where(cond, a, b) over matching tuples/NamedTuples; a
    cond with batch dims selects per problem (it is padded with trailing
    singleton dims to each leaf's rank)."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)
    vals = [tree_select(cond, u, v) for u, v in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def _all_finite(x, batch_dims: int = 0):
    """Whether every leaf is finite; per problem over `batch_dims` leading dims."""
    finite = None
    for leaf in tree_leaves(x):
        f = torch.isfinite(leaf)
        f = torch.all(f.reshape(f.shape[:batch_dims] + (-1,)), dim=-1)
        finite = f if finite is None else finite & f
    return finite


def lm_optimize(x0, linearize_solve: Callable, retract: Callable,
                cost_fn: Callable, iters: int, lam0=1e-4, lam_down=0.5,
                lam_up=4.0, lam_min=1e-9, lam_max=1e6, rtol=0.0):
    """Fixed-iteration LM. A candidate is accepted iff it lowers the cost AND
    is entirely finite; lambda shrinks on accept and grows on reject. With
    rtol > 0, once an accepted step improves cost by less than rtol relative
    the remaining iterations keep the state (the JAX lax.cond no-op branch).
    `cost_fn` may return one cost per problem of a leading batch (then every
    leaf of x carries that batch, and accept / lambda are per problem).
    Returns (x, final cost, per-iteration costs)."""
    c0 = cost_fn(x0)
    x, cost = x0, c0
    lam = torch.full_like(c0, lam0)
    done = torch.zeros_like(c0, dtype=torch.bool)
    costs = []
    for _ in range(iters):
        x_new = retract(x, linearize_solve(x, lam))
        c_new = cost_fn(x_new)
        accept = (c_new < cost) & _all_finite(x_new, c0.dim())
        x2 = tree_select(accept, x_new, x)
        lam2 = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up),
                           lam_min, lam_max)
        cost2 = torch.where(accept, c_new, cost)
        if rtol > 0.0:
            done2 = accept & (cost - cost2 < rtol * torch.clamp(cost, min=1e-12))
            x = tree_select(done, x, x2)
            lam = torch.where(done, lam, lam2)
            cost = torch.where(done, cost, cost2)
            done = done | done2
        else:
            x, lam, cost = x2, lam2, cost2
        costs.append(cost)
    return x, cost, torch.stack(costs) if costs else c0[None]


def lm_optimize_fused(x0, linearize, solve, retract, iters: int, lam0=1e-4,
                      lam_down=0.5, lam_up=4.0, lam_min=1e-9, lam_max=1e6,
                      rtol=0.0, lin0=None):
    """LM that reuses the linearization for the accept/reject cost:
    `linearize(x) -> (lin, cost)`, `solve(lin, lam) -> dx`; a rejected
    candidate re-solves from the carried linearization. lin0: the caller's
    `linearize(x0)`, when it already has it (it wants the starting cost)."""
    lin, cost = lin0 if lin0 is not None else linearize(x0)
    x = x0
    lam = torch.full_like(cost, lam0)
    done = torch.zeros_like(cost, dtype=torch.bool)
    costs = []
    for _ in range(iters):
        x_new = retract(x, solve(lin, lam))
        lin_new, c_new = linearize(x_new)
        accept = (c_new < cost) & _all_finite(x_new)
        x2 = tree_select(accept, x_new, x)
        lin2 = tree_select(accept, lin_new, lin)
        cost2 = torch.where(accept, c_new, cost)
        lam2 = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up),
                           lam_min, lam_max)
        if rtol > 0.0:
            done2 = accept & (cost - cost2 < rtol * torch.clamp(cost, min=1e-12))
            x, lin = tree_select(done, x, x2), tree_select(done, lin, lin2)
            lam = torch.where(done, lam, lam2)
            cost = torch.where(done, cost, cost2)
            done = done | done2
        else:
            x, lin, cost, lam = x2, lin2, cost2, lam2
        costs.append(cost)
    return x, cost, torch.stack(costs) if costs else cost[None]


def lm_two_phase(x0, make_fns, valid0, classify, iters: int, p1_frac=0.4,
                 rtol=0.0, lam0=1e-4, enable=True, curve: list | None = None):
    """Two-round LM with inlier re-classification between rounds
    (src/Optimizer.cpp:1920-1980); enable=False or rtol > 0 runs one round.
    curve: an optional list that receives, for each round, its starting cost
    followed by the cost after every iteration (0-d device tensors)."""
    def one_round(x, valid, n_it):
        ls, rt, cf = make_fns(valid)
        out = lm_optimize(x, ls, rt, cf, n_it, rtol=rtol, lam0=lam0)
        if curve is not None:
            curve.append(cf(x))
            curve.extend(out[2])
        return out

    if not enable or rtol > 0.0:
        return one_round(x0, valid0, iters)
    it1 = max(2, int(round(iters * p1_frac)))
    it2 = max(2, iters - it1)
    x1, _, _ = one_round(x0, valid0, it1)
    return one_round(x1, classify(x1, valid0), it2)
