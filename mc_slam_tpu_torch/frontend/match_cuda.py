"""Windowed Hamming top-2 projection search: the hand-written CUDA kernel and
its plain PyTorch twin.

`hamming_top2_windowed` replaces the TPU kernel
`mc_slam_tpu/frontend/match_pallas.py::hamming_top2_windowed`. On a CUDA
tensor it launches `csrc/hamming_top2_windowed.cu` (built for sm_90a with
nvcc into a plain-C shared library and loaded with ctypes) or raises; on a
CPU tensor it runs the twin `hamming_top2_windowed_ref`, the materialized
(M, N) formulation of `tests/test_match_pallas.py`. There is no fallback
from the kernel to the twin.

Contract, both paths: queries a_* (M rows: packed descriptor words, uv,
level, valid), candidates b_* (N rows alike); returns int32 (best, second,
idx), each (M,). BIG = 10000 and idx = 0 where nothing passes the gate.
With a leading batch dim on every input ((B, M, .) queries, (B, N, .)
candidates) the B problems are independent and every output is (B, M): the
kernel takes them in ONE launch (a batch axis in its grid, as `jax.vmap`
gives the Pallas grid), the twin as one batched tensor program.
"""
from __future__ import annotations

import ctypes

import torch

from mc_slam_tpu_torch.utils import cuda_build

BIG = 10_000

_SOURCE = cuda_build.CSRC / "hamming_top2_windowed.cu"


def hamming_top2_windowed_ref(a_pm1, a_uv, a_lvl, a_valid, b_pm1, b_uv, b_lvl,
                              b_valid, radius, level_tol=1):
    """Plain PyTorch twin on +/-1 int8 rows: dense distance matrix, window
    gate, min / first argmin / min over the other columns. Every input may
    carry the same leading batch dims (one problem each)."""
    from mc_slam_tpu_torch.frontend.matching import hamming_matrix, window_mask
    N = b_pm1.shape[-2]
    if N == 0:
        full = lambda v: torch.full(a_pm1.shape[:-1], v, dtype=torch.int32,
                                    device=a_pm1.device)
        return full(BIG), full(BIG), full(0)
    dist = hamming_matrix(a_pm1, b_pm1)
    gate = window_mask(a_uv, b_uv, radius, a_lvl, b_lvl, level_tol)
    gate = gate & a_valid[..., :, None] & b_valid[..., None, :]
    d = torch.where(gate, dist, BIG)
    best, idx = torch.min(d, dim=-1)         # first minimum per row
    d2 = d.scatter(-1, idx[..., None], BIG)  # the best column out of the running
    second = torch.amin(d2, dim=-1)
    return best.to(torch.int32), second.to(torch.int32), idx.to(torch.int32)


def build_library():
    """Build (or find) csrc/hamming_top2_windowed.cu's library; its path."""
    return cuda_build.build_library(_SOURCE)


_p = ctypes.c_void_p
_LIB = cuda_build.Library(
    _SOURCE, "hamming_top2_windowed_launch_batched",
    [_p, _p, _p, _p, _p, _p, _p, _p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, _p, _p, _p, _p])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def validate_inputs(a_desc, a_pm1, a_uv, a_lvl, a_valid,
                    b_desc, b_pm1, b_uv, b_lvl, b_valid):
    """Raise on any input the kernel or its twin does not take: a device
    other than the first input's, a dtype other than int32 words / int8 +/-1
    rows / float32 uv / int32 level / bool valid, a wrong shape (every input
    has the same leading batch dims: none, or one B), or a non-contiguous
    tensor. Returns (B, M, N), B = None without a batch dim."""
    dev = a_desc.device
    if a_desc.dim() not in (2, 3):
        raise ValueError(f"a_desc has shape {tuple(a_desc.shape)}, expected (M, 8) "
                         "or (B, M, 8)")
    lead = tuple(a_desc.shape[:-2])
    M = a_desc.shape[-2]
    N = b_desc.shape[-2] if b_desc.dim() == a_desc.dim() else -1
    for pre, n, (desc, pm1, uv, lvl, valid) in (
            ("a", M, (a_desc, a_pm1, a_uv, a_lvl, a_valid)),
            ("b", N, (b_desc, b_pm1, b_uv, b_lvl, b_valid))):
        _check(f"{pre}_desc", desc, torch.int32, lead + (n, 8), dev)
        _check(f"{pre}_pm1", pm1, torch.int8, lead + (n, 256), dev)
        _check(f"{pre}_uv", uv, torch.float32, lead + (n, 2), dev)
        _check(f"{pre}_lvl", lvl, torch.int32, lead + (n,), dev)
        _check(f"{pre}_valid", valid, torch.bool, lead + (n,), dev)
    return (lead[0] if lead else None), M, N


def hamming_top2_windowed(a_desc, a_pm1, a_uv, a_lvl, a_valid,
                          b_desc, b_pm1, b_uv, b_lvl, b_valid,
                          radius, level_tol: int = 1):
    """Fused windowed top-2 Hamming match; see the module docstring.

    a_desc/b_desc: (., 8) int32 packed words (read by the kernel);
    a_pm1/b_pm1: the same descriptors as (., 256) int8 +/-1 rows (read by
    the CPU twin); every input may carry one leading batch dim B (B
    problems, outputs (B, M)). CUDA inputs launch the kernel on the current
    stream, once for all B problems, with no host sync;
    `hamming_top2_windowed.launches` counts those launches."""
    B, M, N = validate_inputs(a_desc, a_pm1, a_uv, a_lvl, a_valid,
                              b_desc, b_pm1, b_uv, b_lvl, b_valid)
    if a_desc.device.type == "cpu":
        return hamming_top2_windowed_ref(a_pm1, a_uv, a_lvl, a_valid, b_pm1,
                                         b_uv, b_lvl, b_valid, radius, level_tol)
    if a_desc.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_desc.device}")
    # the kernel reads descriptor rows as 16-byte and uv rows as 8-byte words
    for name, t, align in (("a_desc", a_desc, 16), ("b_desc", b_desc, 16),
                           ("a_uv", a_uv, 8), ("b_uv", b_uv, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} is not {align}-byte aligned")
    fn = _LIB.fn()
    outs = [torch.empty(a_desc.shape[:-1], dtype=torch.int32, device=a_desc.device)
            for _ in range(3)]
    stream = torch.cuda.current_stream(a_desc.device).cuda_stream
    err = fn(a_desc.data_ptr(), a_uv.data_ptr(), a_lvl.data_ptr(),
             a_valid.data_ptr(), b_desc.data_ptr(), b_uv.data_ptr(),
             b_lvl.data_ptr(), b_valid.data_ptr(), float(radius), int(level_tol),
             1 if B is None else B, M, N, outs[0].data_ptr(), outs[1].data_ptr(),
             outs[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2_windowed launch failed: CUDA error {err}")
    _WRAPPER.launches += 1
    return outs[0], outs[1], outs[2]


hamming_top2_windowed.launches = 0
# the counter's owner, even if a caller rebinds the module attribute (a
# timing or recording shim in front of the wrapper)
_WRAPPER = hamming_top2_windowed
