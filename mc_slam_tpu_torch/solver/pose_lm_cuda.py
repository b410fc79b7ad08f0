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
_LIB = cuda_build.Library(
    cuda_build.CSRC / "pose_lm.cu", "pose_lm_launch",
    [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _f, _i, _i, _i, _i, _f,
     _d, _d, _d, _p, _p, _p, _p, _p])


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


def validate_inputs(P0, R0, pts_w, obs, camera, ext, bf=0.0):
    """Raise on any input the kernel does not take: a device other than
    P0's; a dtype other than float32 (int64 obs.pt); a wrong shape (every
    tensor with the same leading batch dims: none, or one B); a
    non-contiguous tensor; no points; more than MAX_OBS rows. Returns
    (B, O, Np), B = None without a batch dim."""
    f32 = torch.float32
    dev = P0.device
    if P0.dim() not in (1, 2):
        raise ValueError(f"P0 has shape {tuple(P0.shape)}, expected (3,) or (B, 3)")
    lead = tuple(P0.shape[:-1])
    O = obs.pt.shape[-1] if obs.pt.dim() == len(lead) + 1 else -1
    Np = pts_w.shape[-2] if pts_w.dim() == len(lead) + 2 else -1
    _check("P0", P0, f32, lead + (3,), dev)
    _check("R0", R0, f32, lead + (3, 3), dev)
    _check("pts_w", pts_w, f32, lead + (Np, 3), dev)
    _check("obs.pt", obs.pt, torch.int64, lead + (O,), dev)
    _check("obs.uv", obs.uv, f32, lead + (O, 2), dev)
    _check("obs.inv_sigma2", obs.inv_sigma2, f32, lead + (O,), dev)
    _check("obs.valid", obs.valid, f32, lead + (O,), dev)
    if obs.ur is not None:
        _check("obs.ur", obs.ur, f32, lead + (O,), dev)
    for name in ("fx", "fy", "cx", "cy"):
        _check(f"camera.{name}", getattr(camera, name), f32, (), dev)
    _check("ext.Rcb", ext.Rcb, f32, (3, 3), dev)
    _check("ext.tcb", ext.tcb, f32, (3,), dev)
    if isinstance(bf, torch.Tensor):
        _check("bf", bf, f32, (), dev)
    if Np < 1:
        raise ValueError("pts_w holds no points")
    if O > MAX_OBS:
        raise ValueError(f"{O} observation rows, the kernel takes at most {MAX_OBS}")
    return (lead[0] if lead else None), O, Np


def pose_only_visual_lm(P0, R0, pts_w, obs, camera, ext, iters: int = 40, bf=0.0,
                        rtol: float = 0.0, *, gates):
    """`ba.pose_only_visual` on CUDA tensors in one launch for all B
    problems, on the current stream, with no host sync;
    `pose_only_visual_lm.launches` counts the launches. gates: the chi2
    gates of monocular and of 3-row observations (ba.CHI2_MONO,
    ba.CHI2_STEREO); the robust kernel's truncation is lm.HUBER_TRUNC's."""
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
    err = _LIB.fn()(
        P0.data_ptr(), R0.data_ptr(), pts_w.data_ptr(), obs.pt.data_ptr(), obs.uv.data_ptr(),
        obs.inv_sigma2.data_ptr(), obs.valid.data_ptr(), ptr(obs.ur), camera.fx.data_ptr(),
        camera.fy.data_ptr(), camera.cx.data_ptr(), camera.cy.data_ptr(), ext.Rcb.data_ptr(),
        ext.tcb.data_ptr(), bf.data_ptr() if bf_t else None, 0.0 if bf_t else float(bf),
        1 if B is None else B, O, Np, int(iters), float(rtol), float(gates[0]),
        float(gates[1]), float(lm.HUBER_TRUNC), P.data_ptr(), R.data_ptr(), chi2.data_ptr(),
        n_in.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_only_visual_lm launch failed: CUDA error {err}")
    _WRAPPER.launches += 1
    return P, R, chi2, n_in


pose_only_visual_lm.launches = 0
# the counter's owner, even if a caller rebinds the module attribute (a
# recording shim in front of the wrapper)
_WRAPPER = pose_only_visual_lm
