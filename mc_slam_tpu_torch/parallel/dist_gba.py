"""Mesh-sharded landmark-chunked whole-map bundle adjustment (port of
mc_slam_tpu/parallel/dist_gba.py).

solver/ba_chunked.py's O(map) landmark-chunked Schur (the scalable form of
GlobalBundleAdjustmentNavStatePRV, src/Optimizer.cpp:629) with dist_ba's
sharding: the CHUNK axis of `ChunkedObs` is split over the mesh's shards
(shard k owns a contiguous range of chunks, kept on its device with their
global ids `ks`), every shard reduces its own chunks into a partial Schur
camera system, ONE reduction per linearization (`dist_ba.psum`) sums
(S, g, diag, cost) on devices[0], the small Cholesky solves it there, and
each shard back-substitutes its own landmarks; the concatenation of the
shards' landmark steps (the JAX `all_gather`) keeps the LM state whole.

The LM itself is `ba_chunked.vi_gba_chunked`, handed the shards as its
observation groups and `dist_ba.psum` as its reduction: equal to the
single-device call up to float32 reduction order. Stereo / RGB-D `ur` rows go
through as there.
"""
from __future__ import annotations

import functools

from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.parallel.dist_ba import Mesh, psum, to_device
from mc_slam_tpu_torch.solver import ba_chunked as bc
from mc_slam_tpu_torch.solver.ba_vi import IMUEdges


def shard_chunked_obs(mesh: Mesh, cobs: bc.ChunkedObs):
    """Split a ChunkedObs by its leading (chunk) axis over the mesh: one
    (ChunkedObs, global chunk ids) a shard, on the shard's device. The chunk
    count must divide by the mesh size (pad with empty chunks)."""
    S = cobs.cam.shape[0]
    n = mesh.size
    if S % n:
        raise ValueError(f"{S} chunks do not divide over {n} shards")
    per = S // n
    out = []
    for k, dev in enumerate(mesh.devices):
        sl = slice(k * per, (k + 1) * per)
        out.append((to_device(bc.ChunkedObs(*[None if a is None else a[sl] for a in cobs]),
                              dev), list(range(k * per, (k + 1) * per))))
    return out


def vi_gba_chunked_sharded(mesh: Mesh, ns0: NavState, pts0, cobs, edges: IMUEdges, camera,
                           ext, gw, free_cam, pt_mask, iters: int = 10, lam0: float = 1e-4,
                           bf=0.0):
    """Mesh-distributed `ba_chunked.vi_gba_chunked`: the same arguments with
    `cobs` a ChunkedObs (split here) or `shard_chunked_obs`'s result. The
    state lives on devices[0]; each shard reads a copy of it on its device.
    Returns (ns, pts, cost, costs) on devices[0], as vi_gba_chunked."""
    shards = shard_chunked_obs(mesh, cobs) if isinstance(cobs, bc.ChunkedObs) else cobs
    dev0 = mesh.devices[0]
    ns0, pts0, edges, camera, ext, gw, free_cam, pt_mask = to_device(
        (ns0, pts0, edges, camera, ext, gw, free_cam, pt_mask), dev0)
    return bc.vi_gba_chunked(ns0, pts0, shards, edges, camera, ext, gw, free_cam, pt_mask,
                             iters=iters, lam0=lam0, bf=bf, reduce=functools.partial(psum, mesh))
