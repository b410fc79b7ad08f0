"""The VI pose LM of `ba_vi.pose_only_vi` as one hand-written CUDA kernel.

`pose_only_vi_lm` launches `csrc/pose_vi_lm.cu` (built for sm_90a with nvcc
into a plain-C shared library and loaded with ctypes, `utils/cuda_build`):
the joint (last, current) NavState solve of one VI frame, every
Levenberg-Marquardt iteration, the final chi2 and inlier count and the
current state's marginal, in ONE launch of one thread block. It replaces no
TPU kernel (the JAX package's loop is a `lax.scan` that XLA fuses); it takes
away the ~1,300 small launches an iteration of the eager loop. Its plain
twin is `ba_vi.pose_only_vi_ref`, the same algorithm as PyTorch operators:
`ba_vi.pose_only_vi` runs the twin on CPU tensors and this kernel on CUDA
tensors, with no fallback from one to the other.

Contract: as `ba_vi.pose_only_vi` (two NavStates of (3,) / (3, 3) fields,
the preintegration between them, pts_w (Np, 3), the VisualObs columns pt /
uv / inv_sigma2 / valid / ur over O rows, gw (3,), the prior on the last
state, info_prv (9, 9), info_bias (6, 6)), returning (ns_cur, chi2 (O,),
n_inliers int64, H_marg (15, 15)). obs.cam is not read (every row is on the
current state), nor the preintegration's covariance (info_prv carries it),
nor the prior's bg / ba (the prior's residual has none). With obs.ur set the
rows are the 3-row stereo / RGB-D factor (bf = fx * baseline, a number or a
0-d tensor). Every tensor's pointer goes to the kernel as it is: nothing is
stacked, gathered or copied on the way.
"""
from __future__ import annotations

import ctypes

import torch

from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.solver import lm, pose_lm_cuda
from mc_slam_tpu_torch.utils import cuda_build

MAX_OBS = pose_lm_cuda.MAX_OBS      # the same 256 threads x 8 rows in registers

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_d = ctypes.c_double
LIB = cuda_build.Library(
    cuda_build.CSRC / "pose_vi_lm.cu", "pose_vi_lm_launch",
    [ctypes.POINTER(_p), _i, _f, _i, _i, _i, _f, _i, _d, _d, _d, _p], "pose_only_vi_lm")

_F32 = torch.float32
_SHAPES = dict(P=(3,), V=(3,), R=(3, 3), bg=(3,), ba=(3,), dbg=(3,), dba=(3,),
               dP=(3,), dV=(3,), dR=(3, 3), J_P_bg=(3, 3), J_P_ba=(3, 3), J_V_bg=(3, 3),
               J_V_ba=(3, 3), J_R_bg=(3, 3), cov=(9, 9), dT=())


def _validate_fields(prefix, tup, device, skip=()):
    for name in tup._fields:
        if name not in skip:
            cuda_build.check(f"{prefix}.{name}", getattr(tup, name), _F32, _SHAPES[name], device)


def validate_inputs(ns_cur0, ns_last, pre, pts_w, obs, camera, ext, gw, prior, info_prv,
                    info_bias, bf=0.0):
    """Raise on any input the kernel does not take: a device other than
    ns_cur0.P's; a dtype other than float32 (int64 obs.pt and prior.cam); a
    wrong shape; a non-contiguous tensor; no points; more than MAX_OBS rows.
    Returns (O, Np)."""
    check = cuda_build.check
    dev = ns_cur0.P.device
    _validate_fields("ns_cur0", ns_cur0, dev)
    _validate_fields("ns_last", ns_last, dev)
    _validate_fields("pre_last_cur", pre, dev)
    _validate_fields("prior.ns0", prior.ns0, dev, skip=("bg", "ba"))
    check("prior.info", prior.info, _F32, (15, 15), dev)
    check("prior.cam", prior.cam, torch.int64, (), dev)
    check("prior.valid", prior.valid, _F32, (), dev)
    check("info_prv", info_prv, _F32, (9, 9), dev)
    check("info_bias", info_bias, _F32, (6, 6), dev)
    check("gw", gw, _F32, (3,), dev)
    return pose_lm_cuda.validate_rows(pts_w, obs, camera, ext, bf, (), dev)


def pose_only_vi_lm(ns_cur0: NavState, ns_last: NavState, pre_last_cur, pts_w, obs, camera,
                    ext, gw, prior_last, info_prv, info_bias, iters: int = 40,
                    compute_marg: bool = True, bf=0.0, rtol: float = 0.0, *, gates):
    """`ba_vi.pose_only_vi` on CUDA tensors in one launch, on the current
    stream, with no host sync; `LIB.launches` counts the launches. gates: the chi2 gates of monocular and of 3-row observations
    (ba.CHI2_MONO, ba.CHI2_STEREO); the robust kernel's truncation is
    lm.HUBER_TRUNC's. ns_cur's fields are views of one output buffer."""
    O, Np = validate_inputs(ns_cur0, ns_last, pre_last_cur, pts_w, obs, camera, ext, gw,
                            prior_last, info_prv, info_bias, bf)
    dev = ns_cur0.P.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    state = torch.empty(27, dtype=_F32, device=dev)     # NavState's fields in order
    chi2 = torch.empty(O, dtype=_F32, device=dev)
    n_in = torch.empty((), dtype=torch.int64, device=dev)
    H_marg = torch.empty((15, 15), dtype=_F32, device=dev)
    bf_t = isinstance(bf, torch.Tensor)
    p0 = prior_last.ns0
    pre = pre_last_cur
    # the kernel's pointer table, in the order of csrc/pose_vi_lm.cu's enum
    # Ptr (the C entry point refuses a table of another length)
    tensors = (*ns_cur0, *ns_last, pre.dP, pre.dV, pre.dR, pre.J_P_bg, pre.J_P_ba, pre.J_V_bg,
               pre.J_V_ba, pre.J_R_bg, pre.dT, info_prv, info_bias, p0.P, p0.V, p0.R, p0.dbg,
               p0.dba, prior_last.info, prior_last.cam, prior_last.valid, gw, camera.fx,
               camera.fy, camera.cx, camera.cy, ext.Rcb, ext.tcb, bf if bf_t else None,
               pts_w, obs.pt, obs.uv, obs.inv_sigma2, obs.valid, obs.ur, state, chi2, n_in,
               H_marg)
    ptrs = (_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    LIB.launch(ptrs, len(tensors), 0.0 if bf_t else float(bf), O, Np, int(iters), float(rtol),
               1 if compute_marg else 0, float(gates[0]), float(gates[1]),
               float(lm.HUBER_TRUNC), torch.cuda.current_stream(dev).cuda_stream)
    ns_cur = NavState(P=state[0:3], V=state[3:6], R=state[6:15].view(3, 3),
                      bg=state[15:18], ba=state[18:21], dbg=state[21:24], dba=state[24:27])
    return ns_cur, chi2, n_in, H_marg


# the kernel against its twin (ba_vi.pose_only_vi_ref), in chip_smoke.py on
# recorded solves and in tests/test_torch_pose_vi_lm.py (whose docstring
# gives the reasons): the position as the visual kernel's; the rest inside
# the mono-vi.stream cell's limits on the frame
# (benchmark/workloads/mono-vi.stream.json); each row's chi2 and the
# inliers as the visual kernel's (pose_lm_cuda.row_gaps)
POSE_VI_LM_POS_TOL = 1e-4       # m
POSE_VI_LM_ROT_TOL = 3e-5       # rad (the cell's 0.002 deg is 3.5e-5)
POSE_VI_LM_VEL_TOL = 4e-4       # m/s
POSE_VI_LM_BG_TOL = 5e-5        # rad/s, the full gyro bias
POSE_VI_LM_BA_TOL = 3e-5        # m/s^2, the full accelerometer bias
POSE_VI_LM_MARG_RTOL = 1e-3     # H_marg, Frobenius norm of the gap over H_marg's


def twin_gaps(got, ref):
    """The gaps of one VI solve's answer `got` (ns_cur, chi2, n_inliers,
    H_marg) to the twin's `ref`, each over its tolerance (a gap within it
    reads at most 1)."""
    (ns, chi2, n, Hm), (nr, chi2r, nrr, Hmr) = got, ref
    d = lambda a, b: float((a.double() - b.double()).abs().max())
    Hn = float(torch.linalg.norm(Hmr.double()))
    marg = float(torch.linalg.norm(Hm.double() - Hmr.double())) / Hn if Hn > 0 else d(Hm, Hmr)
    return dict(dP=d(ns.P, nr.P) / POSE_VI_LM_POS_TOL,
                dR=pose_lm_cuda.rot_gap_rad(ns.R, nr.R) / POSE_VI_LM_ROT_TOL,
                dV=d(ns.V, nr.V) / POSE_VI_LM_VEL_TOL,
                dbg=d(ns.bg + ns.dbg, nr.bg + nr.dbg) / POSE_VI_LM_BG_TOL,
                dba=d(ns.ba + ns.dba, nr.ba + nr.dba) / POSE_VI_LM_BA_TOL,
                **pose_lm_cuda.row_gaps(chi2, n, chi2r, nrr),
                marg=marg / POSE_VI_LM_MARG_RTOL)


# float operations of csrc/pose_vi_lm.cu counted from the source (a
# multiply-add as two; the visual rows' as csrc/pose_lm.cu's,
# pose_lm_cuda.POSE_LM_*_OPS): one linearization's 30-d system (J^T (w
# Lambda) 20,520, H's 465 lower entries 27,900 and their 3 factor sums
# 1,395, g 1,800, the quadratic costs ~700, the three factors' residuals and
# Jacobians ~1,500, the block sums 7,140); one iteration's solve (damping
# 60, the 30x30 Cholesky ~9,460, the two triangular solves 1,800, two
# retractions ~240); the marginal (elimination ~3,300, back substitution
# ~3,400, the 15x15 product 6,750)
POSE_VI_LM_SYSTEM_OPS = 61_000
POSE_VI_LM_SOLVE_OPS = 11_560
POSE_VI_LM_MARG_OPS = 13_450


def work(O, iters, marg=True, stereo=False):
    """What one launch (a VI solve of O rows) has to do: (bytes, each input
    row, its gathered point, the states, the preintegration, the
    informations, the prior and each output read or written once; float
    operations, a pass over every row and a linearization a candidate, one
    at the start and one for the marginal, a solve an iteration; detail,
    none)."""
    marg = int(marg)
    n_bytes = (O * (8 + 8 + 4 + 4 + 12 + (4 if stereo else 0) + 4)
               + 4 * (2 * 27 + 61 + 81 + 36 + 225 + 21 + 3 + 2) + 4 * (27 + 225) + 8)
    passes = 1 + iters + marg
    ops = (O * (passes * pose_lm_cuda.POSE_LM_ROW_OPS[stereo]
                + pose_lm_cuda.POSE_LM_FINAL_ROW_OPS[stereo])
           + passes * POSE_VI_LM_SYSTEM_OPS + iters * POSE_VI_LM_SOLVE_OPS
           + marg * POSE_VI_LM_MARG_OPS)
    return n_bytes, ops, {}
