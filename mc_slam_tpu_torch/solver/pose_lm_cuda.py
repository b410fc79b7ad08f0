"""The pose LM of `ba.pose_only_visual` as one hand-written CUDA kernel.

`pose_only_visual_lm` launches `csrc/pose_lm.cu` (built for sm_90a with nvcc
into a plain-C shared library and loaded with ctypes, `utils/cuda_build`):
every Levenberg-Marquardt iteration of B body-pose problems in ONE launch,
one thread block a problem. It replaces no TPU kernel (the JAX package's
loop is a `lax.scan` that XLA fuses); it takes away the ~250 small launches
an iteration of the eager loop. Its plain twin is `ba.pose_only_visual_ref`,
the same algorithm as PyTorch operators: `ba.pose_only_visual` runs the
twin on CPU tensors and this kernel on CUDA tensors, with no fallback from
one to the other.

Contract: as `ba.pose_only_visual` (P0 (3,), R0 (3, 3), pts_w (Np, 3), the
VisualObs columns pt / uv / inv_sigma2 / valid / ur over O rows; one
optional leading batch dim B on every one of them), returning (P, R, chi2
(O,), n_inlier int64) with the same batch dim. obs.cam is not read (one
pose a problem). With obs.ur set the rows are the 3-row stereo / RGB-D
factor (bf = fx * baseline, a number or a 0-d tensor).
"""
from __future__ import annotations

import ctypes

import torch

from mc_slam_tpu_torch.solver import lm
from mc_slam_tpu_torch.utils import cuda_build

MAX_OBS = 2048          # the kernel's limit: 256 threads x 8 rows in registers

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_d = ctypes.c_double
LIB = cuda_build.Library(
    cuda_build.CSRC / "pose_lm.cu", "pose_lm_launch",
    [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _f, _i, _i, _i, _i, _f,
     _d, _d, _d, _p, _p, _p, _p, _p], "pose_only_visual_lm")


def validate_rows(pts_w, obs, camera, ext, bf, lead, device):
    """Raise on a point table, VisualObs columns, camera, extrinsics or bf
    that a pose kernel does not take: a device other than `device`; a dtype
    other than float32 (int64 obs.pt); a shape without the leading batch
    dims `lead`; a non-contiguous tensor; no points; more than MAX_OBS
    rows. Returns (O, Np)."""
    check = cuda_build.check
    f32 = torch.float32
    O = obs.pt.shape[-1] if obs.pt.dim() == len(lead) + 1 else -1
    Np = pts_w.shape[-2] if pts_w.dim() == len(lead) + 2 else -1
    check("pts_w", pts_w, f32, lead + (Np, 3), device)
    check("obs.pt", obs.pt, torch.int64, lead + (O,), device)
    check("obs.uv", obs.uv, f32, lead + (O, 2), device)
    check("obs.inv_sigma2", obs.inv_sigma2, f32, lead + (O,), device)
    check("obs.valid", obs.valid, f32, lead + (O,), device)
    if obs.ur is not None:
        check("obs.ur", obs.ur, f32, lead + (O,), device)
    for name in ("fx", "fy", "cx", "cy"):
        check(f"camera.{name}", getattr(camera, name), f32, (), device)
    check("ext.Rcb", ext.Rcb, f32, (3, 3), device)
    check("ext.tcb", ext.tcb, f32, (3,), device)
    if isinstance(bf, torch.Tensor):
        check("bf", bf, f32, (), device)
    if Np < 1:
        raise ValueError("pts_w holds no points")
    if O > MAX_OBS:
        raise ValueError(f"{O} observation rows, the kernel takes at most {MAX_OBS}")
    return O, Np


def validate_inputs(P0, R0, pts_w, obs, camera, ext, bf=0.0):
    """Raise on any input the kernel does not take: a device other than
    P0's; a dtype other than float32 (int64 obs.pt); a wrong shape (every
    tensor with the same leading batch dims: none, or one B); a
    non-contiguous tensor; no points; more than MAX_OBS rows. Returns
    (B, O, Np), B = None without a batch dim."""
    dev = P0.device
    if P0.dim() not in (1, 2):
        raise ValueError(f"P0 has shape {tuple(P0.shape)}, expected (3,) or (B, 3)")
    lead = tuple(P0.shape[:-1])
    cuda_build.check("P0", P0, torch.float32, lead + (3,), dev)
    cuda_build.check("R0", R0, torch.float32, lead + (3, 3), dev)
    O, Np = validate_rows(pts_w, obs, camera, ext, bf, lead, dev)
    return (lead[0] if lead else None), O, Np


def pose_only_visual_lm(P0, R0, pts_w, obs, camera, ext, iters: int = 40, bf=0.0,
                        rtol: float = 0.0, *, gates):
    """`ba.pose_only_visual` on CUDA tensors in one launch for all B
    problems, on the current stream, with no host sync; `LIB.launches`
    counts the launches. gates: the chi2 gates of monocular and of 3-row
    observations (ba.CHI2_MONO, ba.CHI2_STEREO); the robust kernel's
    truncation is lm.HUBER_TRUNC's."""
    B, O, Np = validate_inputs(P0, R0, pts_w, obs, camera, ext, bf)
    dev = P0.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lead = tuple(P0.shape[:-1])
    P = torch.empty_like(P0)
    R = torch.empty_like(R0)
    chi2 = torch.empty(lead + (O,), dtype=torch.float32, device=dev)
    n_in = torch.empty(lead, dtype=torch.int64, device=dev)
    bf_t = isinstance(bf, torch.Tensor)
    ptr = lambda t: None if t is None else t.data_ptr()
    LIB.launch(
        P0.data_ptr(), R0.data_ptr(), pts_w.data_ptr(), obs.pt.data_ptr(), obs.uv.data_ptr(),
        obs.inv_sigma2.data_ptr(), obs.valid.data_ptr(), ptr(obs.ur), camera.fx.data_ptr(),
        camera.fy.data_ptr(), camera.cx.data_ptr(), camera.cy.data_ptr(), ext.Rcb.data_ptr(),
        ext.tcb.data_ptr(), bf.data_ptr() if bf_t else None, 0.0 if bf_t else float(bf),
        1 if B is None else B, O, Np, int(iters), float(rtol), float(gates[0]),
        float(gates[1]), float(lm.HUBER_TRUNC), P.data_ptr(), R.data_ptr(), chi2.data_ptr(),
        n_in.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return P, R, chi2, n_in


# the kernel against its twin, in chip_smoke.py on recorded solves and in
# tests/test_torch_pose_lm.py (whose docstring gives the reasons): float32
# sums in another order move a converged pose by about its last step
POSE_LM_POS_TOL = 1e-4      # m
POSE_LM_ROT_TOL = 1e-4      # rad
POSE_LM_CHI2_RTOL, POSE_LM_CHI2_ATOL = 1e-2, 5e-2    # a row's chi2
POSE_LM_INLIER_TOL = 2


def rot_gap_rad(Ra, Rb):
    """Largest angle of Ra^T Rb over a batch, from its skew part."""
    M = Ra.transpose(-1, -2).double() @ Rb.double()
    w = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1) / 2
    cos = (M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return float(torch.atan2(torch.linalg.norm(w, dim=-1), cos).max())


def row_gaps(chi2, n_in, chi2_ref, n_ref):
    """The rows' gaps of a solve to its twin, each over its tolerance (a gap
    within it reads at most 1): each row's chi2 (atol + rtol |chi2|; a row
    NaN in both is no gap) and the inlier count."""
    r = (chi2 - chi2_ref).abs() / (POSE_LM_CHI2_ATOL + POSE_LM_CHI2_RTOL * chi2_ref.abs())
    r = torch.where(chi2.isnan() & chi2_ref.isnan(), 0.0, r).nan_to_num(nan=float("inf"))
    return dict(dchi2=float(r.max()) if r.numel() else 0.0,
                dn=float((n_in - n_ref).abs().max()) / POSE_LM_INLIER_TOL)


def twin_gaps(got, ref):
    """The gaps of one solve's answer `got` (P, R, chi2, n_inlier, batched or
    not) to the twin's `ref`, each over its tolerance."""
    (P, R, chi2, n), (Pr, Rr, chi2r, nr) = got, ref
    return dict(dP=float((P - Pr).abs().max()) / POSE_LM_POS_TOL,
                dR=rot_gap_rad(R, Rr) / POSE_LM_ROT_TOL, **row_gaps(chi2, n, chi2r, nr))


# float operations an observation row takes in one pass of csrc/pose_lm.cu,
# counted from the source (a multiply-add as two): the residual, the 2x6 /
# 3x6 Jacobian, the robust weight and cost and the 27 sums of H and g, by
# variant (monocular, stereo); the last pass forms residuals and chi2 only
POSE_LM_ROW_OPS = {False: 277, True: 390}
POSE_LM_FINAL_ROW_OPS = {False: 51, True: 57}
POSE_LM_SOLVE_OPS = 400     # thread 0's damping, 6x6 Cholesky, retraction a iteration


def work(B, O, iters, stereo=False):
    """What one launch of B problems of O rows has to do: (bytes, each input
    row, its gathered point and each output read or written once; float
    operations, 1 + iters passes over every row (a pass a candidate), the
    last pass, the block sums and thread 0's solves; detail, none). A
    candidate that is not finite skips its pass; that happens only where a
    Cholesky fails, so it is not counted."""
    n_bytes = B * (O * (8 + 8 + 4 + 4 + 12 + 4 + (4 if stereo else 0)) + 2 * 48 + 8)
    ops = B * (O * ((1 + iters) * POSE_LM_ROW_OPS[stereo] + POSE_LM_FINAL_ROW_OPS[stereo])
               + (1 + iters) * 28 * 255 + iters * POSE_LM_SOLVE_OPS)
    return n_bytes, ops, {}
