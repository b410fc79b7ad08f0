"""Distributed Sim3 / SE3 pose-graph optimization: edge-sharded LM over a
device mesh (port of mc_slam_tpu/parallel/dist_posegraph.py).

dist_ba's recipe applied to the essential graph (Optimizer::
OptimizeEssentialGraph, src/Optimizer.cpp:4243-4578; the reference runs it
single-threaded): the edges (loop, spanning tree, covisibility, earlier
loops) are split over the mesh's shards; each shard evaluates the residuals
and closed-form Jacobians of its edges (`solver.posegraph._res_and_jac`) and
accumulates its partial dense vertex system (K, 7, K, 7) on its device; ONE
reduction per iteration sums (H, g) on devices[0], one more sums the cost;
the damped solve and the LM accept / reject run there, every shard reading
the same vertex state.
"""
from __future__ import annotations

import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.parallel.dist_ba import Mesh, psum, to_device
from mc_slam_tpu_torch.solver import lm
from mc_slam_tpu_torch.solver.posegraph import Sim3Graph, _edge_residual, _res_and_jac


def pad_graph_edges(g: Sim3Graph, n_devices: int) -> Sim3Graph:
    """Pad the edge arrays so the edge count divides the mesh size: padded
    edges carry w = 0, an identity measurement and vertex 0 at both ends."""
    E = g.ei.shape[0]
    Ep = ((E + n_devices - 1) // n_devices) * n_devices
    if Ep == E:
        return g
    pad = Ep - E
    z = torch.zeros(pad, dtype=g.ei.dtype, device=g.ei.device)
    eye = torch.eye(3, dtype=g.R_m.dtype, device=g.R_m.device).expand(pad, 3, 3)
    return g._replace(
        ei=torch.cat([g.ei, z]), ej=torch.cat([g.ej, z]),
        s_m=torch.cat([g.s_m, torch.ones(pad, dtype=g.s_m.dtype, device=g.s_m.device)]),
        R_m=torch.cat([g.R_m, eye]),
        t_m=torch.cat([g.t_m, torch.zeros((pad, 3), dtype=g.t_m.dtype, device=g.t_m.device)]),
        w=torch.cat([g.w, torch.zeros(pad, dtype=g.w.dtype, device=g.w.device)]))


def optimize_pose_graph_dist(mesh: Mesh, g: Sim3Graph, iters: int = 20, lam0: float = 1e-8,
                             fix_scale: bool = False, curve: bool = False):
    """Edge-sharded pose-graph LM. Returns (R, s, t, cost) on devices[0], as
    `posegraph.optimize_pose_graph` (and the cost curve as a fifth with
    `curve`)."""
    n = mesh.size
    dev0 = mesh.devices[0]
    g = pad_graph_edges(g, n)
    K = g.s.shape[0]
    DC = 7
    per = g.ei.shape[0] // n
    dtype = g.s.dtype
    shards = []
    for k, dev in enumerate(mesh.devices):
        sl = slice(k * per, (k + 1) * per)
        ei, ej = g.ei[sl].to(dev), g.ej[sl].to(dev)
        shards.append(dict(dev=dev, ei=ei, ej=ej, cam=torch.stack([ei, ej], dim=-1),
                           s_m=g.s_m[sl].to(dev), R_m=g.R_m[sl].to(dev),
                           t_m=g.t_m[sl].to(dev), w=g.w[sl].to(dev),
                           free=g.free.to(dev),
                           info=torch.eye(7, dtype=dtype, device=dev).expand(per, 7, 7)))
    free0 = g.free.to(dev0)

    def cost_fn(x):
        parts = []
        for e in shards:
            s, R, t = to_device(x, e["dev"])
            r = _edge_residual(s[e["ei"]], R[e["ei"]], t[e["ei"]], s[e["ej"]], R[e["ej"]],
                               t[e["ej"]], e["s_m"], e["R_m"], e["t_m"])
            parts.append(torch.sum(e["w"] * torch.sum(r * r, dim=-1)))
        return psum(mesh, parts)

    def linearize_solve(x, lam):
        parts = []
        for e in shards:
            dev = e["dev"]
            s, R, t = to_device(x, dev)
            r, (Ji, Jj) = _res_and_jac(s[e["ei"]], R[e["ei"]], t[e["ei"]], s[e["ej"]],
                                       R[e["ej"]], t[e["ej"]], e["s_m"], e["R_m"], e["t_m"])
            fac = lm.CamFactors(cam=e["cam"], J=torch.stack([Ji, Jj], dim=1), r=r,
                                info=e["info"], w=e["w"])
            H = torch.zeros((K, DC, K, DC), dtype=dtype, device=dev)
            gv = torch.zeros((K, DC), dtype=dtype, device=dev)
            H, gv, _ = lm.accumulate_cam_factors(H, gv, torch.zeros((), dtype=dtype, device=dev),
                                                 fac, e["free"])
            parts.append((H, gv))
        H, gv = psum(mesh, parts)                   # the one collective
        dx = lm.solve_cam_system(H, gv, lam.to(dev0), free0)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], dim=-1)
        return dx

    def retract(x, dx):
        return lie.sim3_mul(*lie.sim3_exp(dx), *x)

    x0 = to_device((g.s, g.R, g.t), dev0)
    (s, R, t), cost, costs = lm.lm_optimize(x0, linearize_solve, retract, cost_fn, iters,
                                            lam0=lam0)
    out = (lie.so3_normalize_fast(R), s, t, cost)
    return out + (costs,) if curve else out
