"""Distributed bundle adjustment: the landmark-sharded Schur solve over a
device mesh (port of mc_slam_tpu/parallel/dist_ba.py).

The JAX package's mesh is single-controller: one process, a `Mesh` over its
devices, `shard_map` with one `psum` per linearization. The port keeps that
model in one process:

  * a `Mesh` is the list of its devices and an axis name; a mesh may name one
    device more than once (two shards on `cuda:0`, or on `cpu`), which is how
    a single card and the CPU tests exercise the sharding;
  * landmarks and their observations are split over the shards (an
    observation touches exactly one landmark), and each shard builds its
    partial camera system and Schur correction on its own device;
  * the `psum` is the sum of the shards' partials brought to `devices[0]`, in
    shard order, and the sum handed back to each shard;
  * the reduced solve (a small dense Cholesky) runs on `devices[0]`, and
    landmark back-substitution stays on each shard.

A mesh may also span the ranks of a `torch.distributed` process group (the
JAX package's multi-host mesh after `jax.distributed.initialize`;
tools/run_multihost_ba.py runs one): its `devices` are then this rank's
local shards, whose global shard index is `rank * len(devices) + k`, and
`psum` sums the local shards on `devices[0]` and then makes ONE
`dist.all_reduce(SUM)` over the group. The reduced solve runs replicated on
every rank (as under the JAX `shard_map`); landmark back-substitution stays
local. `dist_schur_solve` takes such a mesh; dist_gba and dist_posegraph
are single-process.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mc_slam_tpu_torch.solver import lm


class Mesh(NamedTuple):
    """A 1-D device mesh: the shards' devices, in order, and the axis name;
    with a process group, this rank's shards of a mesh over all its ranks."""
    devices: tuple
    axis: str = "mp"
    group: object = None

    @property
    def size(self):
        """This process's shards."""
        return len(self.devices)

    @property
    def rank(self):
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def n_ranks(self):
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def global_size(self):
        """The shards of every rank."""
        return self.size * self.n_ranks


def make_mesh(n_devices=None, axis="mp", devices=None, group=None):
    """A mesh over `devices` (torch devices or their names), or over the first
    `n_devices` visible CUDA devices (all of them when None); with `group`
    (a torch.distributed process group), these are this rank's shards."""
    if devices is None:
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n_devices or n)]
        if n_devices and n_devices > n:
            raise ValueError(f"{n_devices} devices asked for, {n} visible")
    return Mesh(tuple(torch.device(d) for d in devices), axis, group)


def to_device(x, dev):
    """A tensor, or a NamedTuple / tuple of them (ints and None kept), on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if x is None or isinstance(x, (int, float, str)):
        return x
    vals = [to_device(v, dev) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)


def psum(mesh: Mesh, parts):
    """The reduction of one value per shard (a tensor or a tuple of them):
    summed on devices[0] in shard order; over a process group, that local sum
    then goes through one all_reduce (`all_reduce_sum`)."""
    out = to_device(parts[0], mesh.devices[0])
    for p in parts[1:]:
        p = to_device(p, mesh.devices[0])
        if isinstance(out, torch.Tensor):
            out = out + p
        else:
            vals = [a + b for a, b in zip(out, p)]
            out = type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
    if mesh.group is not None:
        out = all_reduce_sum(out, mesh.group)
    return out


def all_reduce_sum(x, group):
    """Sum a tensor, or a tuple of same-dtype tensors, over the ranks of
    `group` with ONE dist.all_reduce (the tuple travels as one flat buffer).
    Every rank gets the same bits."""
    leaves = [x] if isinstance(x, torch.Tensor) else list(x)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    if isinstance(x, torch.Tensor):
        return out[0]
    return type(x)(*out) if hasattr(x, "_fields") else tuple(out)


def shard_ba_problem(mesh: Mesh, obs: lm.Observations, Np):
    """Split an observation table (sorted by landmark) into one contiguous
    block a shard of the whole mesh (every rank's), and return this
    process's blocks, each on its shard's device. The caller pads so that the
    landmarks divide evenly over the shards and no landmark's observations
    straddle two blocks: a fixed observation budget per landmark does both.
    Returns a list of Observations."""
    n = mesh.global_size
    O = obs.pt.shape[0]
    if O % n or Np % n:
        raise ValueError(f"{O} observations / {Np} landmarks do not divide into {n} shards")
    per = O // n
    first = mesh.rank * mesh.size
    return [to_device(lm.Observations(*[a[(first + k) * per:(first + k + 1) * per]
                                        for a in obs]), mesh.devices[k])
            for k in range(mesh.size)]


def dist_schur_solve(mesh: Mesh, obs, cam_H, cam_g, free_mask, pt_mask, lam, Nc, DC, Np,
                     DP):
    """One damped Schur solve with landmark shards.

    obs: the Observations (split here), or `shard_ba_problem`'s list; obs.pt
    holds GLOBAL landmark indices and each shard references its own landmark
    range only (other rows are masked). cam_H / cam_g: the replicated camera-only factor system (IMU
    chain, priors) added to the reduced system. Each shard: its landmark
    system, the damped 3x3 inverses (lam * diag + 1e-8, the JAX function's
    damping), its part of S and g; ONE reduction of (S, g, diag of Hcc); the
    damped reduced Cholesky with fixed cameras as identity rows (NaN when it
    fails, no raise); the local landmark steps. Returns (dxc (Nc, DC) on
    devices[0], dxp (Np, DP) gathered on devices[0]). Over a process group
    (`mesh.group`) obs is the whole table (every rank passes the same) or
    this rank's blocks, the reduction is one all_reduce, and dxp holds this
    rank's landmark range only (Np / n_ranks rows from rank * Np / n_ranks)."""
    shards = obs if isinstance(obs, list) else shard_ba_problem(mesh, obs, Np)
    Np_local = Np // mesh.global_size
    first = mesh.rank * mesh.size
    n = Nc * DC
    dev0 = mesh.devices[0]
    parts, local = [], []
    for k, o in enumerate(shards):
        dev = o.r.device
        fm = free_mask.to(dev)
        pt_local = o.pt - (first + k) * Np_local
        inside = ((pt_local >= 0) & (pt_local < Np_local)).to(o.w.dtype)
        ol = o._replace(pt=torch.clamp(pt_local, 0, Np_local - 1), w=o.w * inside)
        Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(ol, fm, Nc, DC, Np_local, DP)
        eyep = torch.eye(DP, dtype=Hpp.dtype, device=dev)
        Hpp_inv = lm.batched_inv_small(Hpp + lam * (Hpp * eyep) + 1e-8 * eyep)
        Y = torch.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
        parts.append((Hcc - torch.einsum('cipk,djpk->cidj', Y, Wcp),
                      g_c - torch.einsum('cipk,pk->ci', Y, g_p),
                      torch.diagonal(Hcc.reshape(n, n))))
        local.append((g_p, Wcp, Hpp_inv))
    S, g_s, diag_c = psum(mesh, parts)              # the one reduction
    S = S + cam_H.to(dev0)
    g_s = g_s + cam_g.to(dev0)
    diag_c = diag_c + torch.diagonal(cam_H.to(dev0).reshape(n, n))
    Sf = S.reshape(n, n) + torch.diag(lam * diag_c + 1e-10)
    fmr = free_mask.to(dev0).repeat_interleave(DC)
    Sf = Sf * fmr[:, None] * fmr[None, :] + torch.diag(1.0 - fmr)
    dxc = lm.cho_solve_nan(Sf, -(g_s.reshape(n) * fmr)).reshape(Nc, DC)
    dxp = []
    for k, (g_p, Wcp, Hpp_inv) in enumerate(local):
        dev = g_p.device
        rhs = g_p + torch.einsum('cipj,ci->pj', Wcp, dxc.to(dev))
        ptm = pt_mask[(first + k) * Np_local:(first + k + 1) * Np_local].to(dev)
        dxp.append((-torch.einsum('pjk,pk->pj', Hpp_inv, rhs) * ptm[:, None]).to(dev0))
    return dxc, torch.cat(dxp)
