"""Landmark-chunked whole-map bundle adjustment (port of
mc_slam_tpu/solver/ba_chunked.py): GlobalBundleAdjustment /
GlobalBundleAdjustmentNavStatePRV (src/Optimizer.cpp:3346 / :629) with a Schur
complement whose memory does not grow with the landmark count.

The dense engine in lm.py materializes Wcp (Nc, DC, Np, DP) over the whole
landmark table. Here landmarks are processed in chunks of C: each chunk builds
its own landmark system, eliminates it, and adds its part of the (small,
dense) reduced camera system; once the camera step is known, a second pass
over the chunks back-substitutes the landmark steps. The JAX package scans
over the chunks inside one compiled program; this port loops over them in
Python and accumulates in the same order (chunk 0 first).

The visual part is built in the 6-d [dP, dphi] space of each camera and
embedded into the 15-d VI system once per linearization (the JAX package
embeds every Jacobian row; the sums are the same, the zero columns are not
carried).

Observation layout: rows grouped by landmark chunk (chunk k owns landmarks
[k*C, (k+1)*C)), padded to one per-chunk budget; `chunk_observations` builds
it on the host, once per call of a whole-map BA. Stereo / RGB-D rows come in
`ChunkedObs.ur` (bf = fx * baseline), through `ba.reproj_rows`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.device import resolve
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.solver import factors, lm
from mc_slam_tpu_torch.solver.ba import reproj_rows
from mc_slam_tpu_torch.solver.ba_vi import (DC as DC_VI, IMUEdges, _imu_edge_factors,
                                            retract_states)

DV = 6      # the columns of a camera block that a reprojection row touches
DP = 3


class ChunkedObs(NamedTuple):
    """(S, Oc)-shaped observation chunks; chunk k references landmarks in
    [k*C, (k+1)*C) only (rows outside are masked when a chunk is used)."""
    cam: torch.Tensor          # (S, Oc) int64 camera index
    pt: torch.Tensor           # (S, Oc) int64 GLOBAL landmark index
    uv: torch.Tensor           # (S, Oc, 2)
    inv_sigma2: torch.Tensor   # (S, Oc)
    valid: torch.Tensor        # (S, Oc)
    ur: torch.Tensor | None = None   # (S, Oc) stereo rows; None = mono


def chunk_observations(cam, pt, uv, inv_sigma2, valid, Np, n_chunks, ur=None,
                       pad_to=None, device=None):
    """Host side: group a flat observation table by landmark chunk.

    cam / pt / ...: numpy arrays (O,). Returns (ChunkedObs on `device`, C)
    with C the landmark-chunk size. pad_to: the per-chunk row budget (default:
    the largest count rounded up to a multiple of 512). Padded rows are
    invalid and point at their chunk's first landmark."""
    cam = np.asarray(cam)
    pt = np.asarray(pt)
    uv = np.asarray(uv)
    inv_sigma2 = np.asarray(inv_sigma2)
    valid = np.asarray(valid).astype(np.float32)
    if Np % n_chunks:
        raise ValueError(f"{Np} landmarks do not divide into {n_chunks} chunks")
    C = Np // n_chunks
    live = valid > 0
    chunk_of = pt // C
    counts = np.bincount(chunk_of[live], minlength=n_chunks)
    Oc = int(counts.max()) if counts.size else 1
    if pad_to is None:
        Oc = max(512, int(np.ceil(Oc / 512)) * 512)
    elif pad_to < Oc:
        raise ValueError(f"pad_to {pad_to} is below the largest chunk's {Oc} observations")
    else:
        Oc = pad_to
    S = n_chunks
    o_cam = np.zeros((S, Oc), np.int32)
    o_pt = np.zeros((S, Oc), np.int32)
    o_uv = np.zeros((S, Oc, 2), np.float32)
    o_is2 = np.ones((S, Oc), np.float32)
    o_val = np.zeros((S, Oc), np.float32)
    o_ur = np.full((S, Oc), -1.0, np.float32) if ur is not None else None
    for k in range(S):
        sel = live & (chunk_of == k)
        n = int(sel.sum())
        o_cam[k, :n] = cam[sel]
        o_pt[k, :n] = pt[sel]
        o_uv[k, :n] = uv[sel]
        o_is2[k, :n] = inv_sigma2[sel]
        o_val[k, :n] = 1.0
        o_pt[k, n:] = k * C                 # padded rows point into the chunk
        if ur is not None:
            o_ur[k, :n] = np.asarray(ur)[sel]
    dev = resolve(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    return ChunkedObs(
        cam=t(o_cam).to(torch.int64), pt=t(o_pt).to(torch.int64), uv=t(o_uv),
        inv_sigma2=t(o_is2), valid=t(o_val),
        ur=t(o_ur) if ur is not None else None), C


def _robust_w(r, z, inv_sigma2, valid, d2):
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w = inv_sigma2 * lm.trunc_huber_weight(chi2, d2) * valid * (z > 1e-6)
    rho = lm.trunc_huber_cost(chi2, d2)
    # behind the camera: the truncation plateau (see lm.HUBER_TRUNC)
    rho = torch.where(z > 1e-6, rho, lm.trunc_plateau(d2))
    return w, torch.sum(valid * rho)


def _chunk_ids(cobs: ChunkedObs, ks):
    """ks: the GLOBAL ids (Python ints) of the chunks in `cobs`; a mesh shard
    passes its own so that the local landmark index stays right. None: 0..S-1."""
    return range(cobs.cam.shape[0]) if ks is None else [int(k) for k in ks]


def _chunk_rows(cobs: ChunkedObs, s, k, C):
    """Rows of the s-th stored chunk (global id k): (cam, pt, pt_local, uv,
    inv_sigma2, valid masked to rows inside the chunk, ur)."""
    o_pt = cobs.pt[s]
    pt_local = o_pt - k * C
    in_chunk = (pt_local >= 0) & (pt_local < C)
    return (cobs.cam[s], o_pt, torch.clamp(pt_local, 0, C - 1), cobs.uv[s],
            cobs.inv_sigma2[s], cobs.valid[s] * in_chunk,
            None if cobs.ur is None else cobs.ur[s])


def _chunk_system(get_PR, pts, rows, camera, ext, bf, free_cam, Nc, C, lam):
    """One chunk's landmark system at the current state: (Hcc, g_c, g_p, Wcp,
    Hpp_inv, robust cost), cameras in the 6-d visual space."""
    o_cam, o_pt, pt_local, o_uv, o_is2, o_val, o_ur = rows
    P_wb, R_wb = get_PR(o_cam)
    r, J_pr, J_pt, z, d2 = reproj_rows(camera, ext, P_wb, R_wb, pts[o_pt], o_uv, o_ur, bf)
    w, cost = _robust_w(r, z, o_is2, o_val, d2)
    o = lm.Observations(cam=o_cam[:, None], pt=pt_local, Jc=J_pr[:, None], Jp=J_pt,
                        r=r, w=w)
    Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(o, free_cam, Nc, DV, C, DP)
    Hpp_inv = lm.batched_inv_small(lm.damp_point_blocks(Hpp, lam))
    return Hcc, g_c, g_p, Wcp, Hpp_inv, cost


def _scan_reduce(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, free_cam, Nc, C, lam,
                 ks=None):
    """First pass: the Schur-reduced camera system summed over the chunks, in
    the 6-d visual space. get_PR(cam_idx) -> (P_wb, R_wb) per row. Returns
    (S_red (Nc, 6, Nc, 6), g_red (Nc, 6), diag of Hcc (Nc * 6,), cost)."""
    dt, dev = pts.dtype, pts.device
    S_acc = torch.zeros((Nc, DV, Nc, DV), dtype=dt, device=dev)
    g_acc = torch.zeros((Nc, DV), dtype=dt, device=dev)
    d_acc = torch.zeros((Nc * DV,), dtype=dt, device=dev)
    c_acc = torch.zeros((), dtype=dt, device=dev)
    n = Nc * DV
    for s, k in enumerate(_chunk_ids(cobs, ks)):
        Hcc, g_c, g_p, Wcp, Hpp_inv, cost = _chunk_system(
            get_PR, pts, _chunk_rows(cobs, s, k, C), camera, ext, bf, free_cam, Nc, C, lam)
        Y = torch.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
        S_acc = S_acc + (Hcc - torch.einsum('cipk,djpk->cidj', Y, Wcp))
        g_acc = g_acc + (g_c - torch.einsum('cipk,pk->ci', Y, g_p))
        d_acc = d_acc + torch.diagonal(Hcc.reshape(n, n))
        c_acc = c_acc + cost
    return S_acc, g_acc, d_acc, c_acc


def _scan_backsub(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, free_cam, Nc, C, lam,
                  dxc, pt_mask, ks=None):
    """Second pass: each chunk's landmark steps given the camera step dxc
    (Nc, >= 6; its leading 6 columns are used). Returns (S * C, 3), the chunks
    in their stored order."""
    out = []
    for s, k in enumerate(_chunk_ids(cobs, ks)):
        _, _, g_p, Wcp, Hpp_inv, _ = _chunk_system(
            get_PR, pts, _chunk_rows(cobs, s, k, C), camera, ext, bf, free_cam, Nc, C, lam)
        rhs = g_p + torch.einsum('cipj,ci->pj', Wcp, dxc[:, :DV])
        dxp = -torch.einsum('pjk,pk->pj', Hpp_inv, rhs)
        out.append(dxp * pt_mask[k * C:(k + 1) * C, None])
    return torch.cat(out)


def _chunk_cost(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, C, ks=None):
    c_acc = torch.zeros((), dtype=pts.dtype, device=pts.device)
    for s, k in enumerate(_chunk_ids(cobs, ks)):
        o_cam, o_pt, _, o_uv, o_is2, o_val, o_ur = _chunk_rows(cobs, s, k, C)
        P_wb, R_wb = get_PR(o_cam)
        r, _, _, z, d2 = reproj_rows(camera, ext, P_wb, R_wb, pts[o_pt], o_uv, o_ur, bf)
        c_acc = c_acc + _robust_w(r, z, o_is2, o_val, d2)[1]
    return c_acc


def _chunk_classify(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, C, ks=None):
    """Inlier re-classification at the current state, chunk by chunk:
    valid * (chi2 <= knee) * (z > 0), the between-rounds outlier gate
    (src/Optimizer.cpp:1920-1980). Returns (S, Oc)."""
    out = []
    for s in range(cobs.cam.shape[0]):
        P_wb, R_wb = get_PR(cobs.cam[s])
        r, _, _, z, d2 = reproj_rows(camera, ext, P_wb, R_wb, pts[cobs.pt[s]], cobs.uv[s],
                                     None if cobs.ur is None else cobs.ur[s], bf)
        chi2 = torch.sum(r * r, dim=-1) * cobs.inv_sigma2[s]
        out.append(cobs.valid[s] * ((chi2 <= d2) & (z > 1e-6)).to(cobs.valid.dtype))
    return torch.stack(out)


def _solve_reduced(S_red, g_red, diag, cam_H, cam_g, lam, free_cam, Nc, DC):
    """Damp, fix and solve (S_red + cam_H) dxc = -(g_red + cam_g). A matrix
    that is not positive definite gives a NaN step (no exception, no host
    read), which the LM loop rejects."""
    n = Nc * DC
    Sf = (S_red + cam_H).reshape(n, n)
    d = diag + torch.diagonal(cam_H.reshape(n, n))
    Sf = Sf + torch.diag(lam * d + 1e-10)
    fm = free_cam.repeat_interleave(DC)
    Sf = Sf * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    gf = (g_red + cam_g).reshape(n) * fm
    return lm.cho_solve_nan(Sf, -gf).reshape(Nc, DC)


def visual_gba_chunked(P0, R0, pts0, cobs: ChunkedObs, camera: Camera,
                       ext: factors.Extrinsics, free_cam, pt_mask, iters: int = 10,
                       lam0: float = 1e-4, bf=0.0, ks=None):
    """Whole-map visual BA (GlobalBundleAdjustment, src/Optimizer.cpp:3346)
    with the landmark-chunked Schur complement; one round, no outlier
    re-classification. Returns (P, R, pts, cost, costs): `costs` is the cost
    curve, the starting cost followed by the cost after every iteration."""
    Nc = P0.shape[0]
    C = pts0.shape[0] // cobs.cam.shape[0]
    Z = torch.zeros((Nc, DV, Nc, DV), dtype=pts0.dtype, device=pts0.device)
    z = torch.zeros((Nc, DV), dtype=pts0.dtype, device=pts0.device)

    def retract(x, dx):
        P, R, pts = x
        dxc, dxp = dx
        return (P + dxc[:, :3], R @ lie.so3_exp(dxc[:, 3:6]), pts + dxp)

    def make_fns(valid):
        vobs = cobs._replace(valid=valid)

        def cost_fn(x):
            P, R, pts = x
            return _chunk_cost(lambda ci: (P[ci], R[ci]), pts, vobs, camera, ext, bf, C, ks)

        def linearize_solve(x, lam):
            P, R, pts = x
            get_PR = lambda ci: (P[ci], R[ci])
            S_red, g_red, diag, _ = _scan_reduce(get_PR, pts, vobs, camera, ext, bf,
                                                 free_cam, Nc, C, lam, ks)
            dxc = _solve_reduced(S_red, g_red, diag, Z, z, lam, free_cam, Nc, DV)
            dxp = _scan_backsub(get_PR, pts, vobs, camera, ext, bf, free_cam, Nc, C, lam,
                                dxc, pt_mask, ks)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        P, R, pts = x
        return _chunk_classify(lambda ci: (P[ci], R[ci]), pts, cobs._replace(valid=valid0),
                               camera, ext, bf, C, ks)

    curve = []
    (P, R, pts), cost, _ = lm.lm_two_phase(
        (P0, R0, pts0), make_fns, cobs.valid, classify, iters, lam0=lam0, enable=False,
        curve=curve)
    return P, lie.so3_normalize_fast(R), pts, cost, torch.stack(curve)


def _embed15(A6, Nc):
    """(Nc, 6, Nc, 6) or (Nc, 6) visual blocks in the leading columns of the
    15-d VI camera blocks."""
    if A6.dim() == 2:
        out = torch.zeros((Nc, DC_VI), dtype=A6.dtype, device=A6.device)
        out[:, :DV] = A6
        return out
    out = torch.zeros((Nc, DC_VI, Nc, DC_VI), dtype=A6.dtype, device=A6.device)
    out[:, :DV, :, :DV] = A6
    return out


def vi_gba_chunked(ns0: NavState, pts0, cobs: ChunkedObs, edges: IMUEdges, camera: Camera,
                   ext: factors.Extrinsics, gw, free_cam, pt_mask, iters: int = 10,
                   lam0: float = 1e-4, bf=0.0, ks=None):
    """Whole-map VI BA (GlobalBundleAdjustmentNavStatePRV,
    src/Optimizer.cpp:629) with the landmark-chunked Schur complement; one
    round. Returns (ns, pts, cost, costs), `costs` as in visual_gba_chunked."""
    Nc = ns0.P.shape[0]
    C = pts0.shape[0] // cobs.cam.shape[0]
    edges = edges._replace(i=edges.i.to(torch.int64), j=edges.j.to(torch.int64))

    def cam_factor_system(ns):
        H = torch.zeros((Nc, DC_VI, Nc, DC_VI), dtype=pts0.dtype, device=pts0.device)
        g = torch.zeros((Nc, DC_VI), dtype=pts0.dtype, device=pts0.device)
        cost = torch.zeros((), dtype=pts0.dtype, device=pts0.device)
        prv, bias = _imu_edge_factors(ns, edges, gw)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free_cam)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free_cam)
        return H, g, cost

    def retract(x, dx):
        ns, pts = x
        dxc, dxp = dx
        return retract_states(ns, dxc), pts + dxp

    def make_fns(valid):
        vobs = cobs._replace(valid=valid)

        def cost_fn(x):
            ns, pts = x
            c = _chunk_cost(lambda ci: (ns.P[ci], ns.R[ci]), pts, vobs, camera, ext, bf, C, ks)
            return c + cam_factor_system(ns)[2]

        def linearize_solve(x, lam):
            ns, pts = x
            get_PR = lambda ci: (ns.P[ci], ns.R[ci])
            S6, g6, d6, _ = _scan_reduce(get_PR, pts, vobs, camera, ext, bf, free_cam, Nc,
                                         C, lam, ks)
            Hc, gc, _ = cam_factor_system(ns)
            diag = _embed15(d6.reshape(Nc, DV), Nc).reshape(-1)
            dxc = _solve_reduced(_embed15(S6, Nc), _embed15(g6, Nc), diag, Hc, gc, lam,
                                 free_cam, Nc, DC_VI)
            dxp = _scan_backsub(get_PR, pts, vobs, camera, ext, bf, free_cam, Nc, C, lam,
                                dxc, pt_mask, ks)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        ns, pts = x
        return _chunk_classify(lambda ci: (ns.P[ci], ns.R[ci]), pts,
                               cobs._replace(valid=valid0), camera, ext, bf, C, ks)

    curve = []
    (ns, pts), cost, _ = lm.lm_two_phase(
        (ns0, pts0), make_fns, cobs.valid, classify, iters, lam0=lam0, enable=False,
        curve=curve)
    return ns._replace(R=lie.so3_normalize_fast(ns.R)), pts, cost, torch.stack(curve)
