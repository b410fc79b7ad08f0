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
from mc_slam_tpu_torch.solver import lm
from mc_slam_tpu_torch.utils import cuda_build

MAX_OBS = 2048          # the kernel's limit: 256 threads x 8 rows in registers

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_d = ctypes.c_double
_LIB = cuda_build.Library(
    cuda_build.CSRC / "pose_vi_lm.cu", "pose_vi_lm_launch",
    [ctypes.POINTER(_p), _i, _f, _i, _i, _i, _f, _i, _d, _d, _d, _p])

_F32 = torch.float32
_SHAPES = dict(P=(3,), V=(3,), R=(3, 3), bg=(3,), ba=(3,), dbg=(3,), dba=(3,),
               dP=(3,), dV=(3,), dR=(3, 3), J_P_bg=(3, 3), J_P_ba=(3, 3), J_V_bg=(3, 3),
               J_V_ba=(3, 3), J_R_bg=(3, 3), cov=(9, 9), dT=())


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} is a {type(t).__name__}, expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_fields(prefix, tup, device, skip=()):
    for name in tup._fields:
        if name not in skip:
            _check(f"{prefix}.{name}", getattr(tup, name), _F32, _SHAPES[name], device)


def validate_inputs(ns_cur0, ns_last, pre, pts_w, obs, camera, ext, gw, prior, info_prv,
                    info_bias, bf=0.0):
    """Raise on any input the kernel does not take: a device other than
    ns_cur0.P's; a dtype other than float32 (int64 obs.pt and prior.cam); a
    wrong shape; a non-contiguous tensor; no points; more than MAX_OBS rows.
    Returns (O, Np)."""
    dev = ns_cur0.P.device
    O = obs.pt.shape[0] if obs.pt.dim() == 1 else -1
    Np = pts_w.shape[0] if pts_w.dim() == 2 else -1
    _check_fields("ns_cur0", ns_cur0, dev)
    _check_fields("ns_last", ns_last, dev)
    _check_fields("pre_last_cur", pre, dev)
    _check_fields("prior.ns0", prior.ns0, dev, skip=("bg", "ba"))
    _check("prior.info", prior.info, _F32, (15, 15), dev)
    _check("prior.cam", prior.cam, torch.int64, (), dev)
    _check("prior.valid", prior.valid, _F32, (), dev)
    _check("info_prv", info_prv, _F32, (9, 9), dev)
    _check("info_bias", info_bias, _F32, (6, 6), dev)
    _check("gw", gw, _F32, (3,), dev)
    _check("pts_w", pts_w, _F32, (Np, 3), dev)
    _check("obs.pt", obs.pt, torch.int64, (O,), dev)
    _check("obs.uv", obs.uv, _F32, (O, 2), dev)
    _check("obs.inv_sigma2", obs.inv_sigma2, _F32, (O,), dev)
    _check("obs.valid", obs.valid, _F32, (O,), dev)
    if obs.ur is not None:
        _check("obs.ur", obs.ur, _F32, (O,), dev)
    for name in ("fx", "fy", "cx", "cy"):
        _check(f"camera.{name}", getattr(camera, name), _F32, (), dev)
    _check("ext.Rcb", ext.Rcb, _F32, (3, 3), dev)
    _check("ext.tcb", ext.tcb, _F32, (3,), dev)
    if isinstance(bf, torch.Tensor):
        _check("bf", bf, _F32, (), dev)
    if Np < 1:
        raise ValueError("pts_w holds no points")
    if O > MAX_OBS:
        raise ValueError(f"{O} observation rows, the kernel takes at most {MAX_OBS}")
    return O, Np


def pose_only_vi_lm(ns_cur0: NavState, ns_last: NavState, pre_last_cur, pts_w, obs, camera,
                    ext, gw, prior_last, info_prv, info_bias, iters: int = 40,
                    compute_marg: bool = True, bf=0.0, rtol: float = 0.0, *, gates):
    """`ba_vi.pose_only_vi` on CUDA tensors in one launch, on the current
    stream, with no host sync; `pose_only_vi_lm.launches` counts the
    launches. gates: the chi2 gates of monocular and of 3-row observations
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
    err = _LIB.fn()(
        ptrs, len(tensors), 0.0 if bf_t else float(bf), O, Np, int(iters), float(rtol),
        1 if compute_marg else 0, float(gates[0]), float(gates[1]), float(lm.HUBER_TRUNC),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_only_vi_lm launch failed: CUDA error {err}")
    _WRAPPER.launches += 1
    ns_cur = NavState(P=state[0:3], V=state[3:6], R=state[6:15].view(3, 3),
                      bg=state[15:18], ba=state[18:21], dbg=state[21:24], dba=state[24:27])
    return ns_cur, chi2, n_in, H_marg


pose_only_vi_lm.launches = 0
# the counter's owner, even if a caller rebinds the module attribute (a
# recording shim in front of the wrapper)
_WRAPPER = pose_only_vi_lm
