"""Scaling report for the whole-map VI BA (the port of
examples/bench_scaling.py, parts A and B, and part C's exact byte count).

    python3 -m mc_slam_tpu_torch.tools.bench_scaling [--device cuda|cpu]
        [--ckpt PATH] [--small]

A. The landmark-chunked whole-map VI BA (`ba_chunked.vi_gba_chunked`,
   `ITERS` = 8 LM iterations, one round, as in the JAX script) on one
   device at map scale: on the map of a checkpoint when `--ckpt` names one
   (`eval_clone --save-checkpoint`, read with `io.checkpoint.load_map`;
   its active keyframes in slot order, a multiple of 8 chunks of 1024
   landmarks, the IMU chain over consecutive keyframes), else on
   `bench_problems.vi_window_problem(n_kf=128, n_pts=12288, obs_per_kf=400)`
   in 96 chunks. Reports ms an iteration and iterations/s (the mean of 3
   calls after 1 warm-up, host clock ending in a synchronize), launches an
   iteration (kernels and copies under torch.profiler, one call over its
   iterations), `torch.cuda.max_memory_allocated` of a call and the
   problem's meta.
B. The same problem through `dist_gba.vi_gba_chunked_sharded` on a mesh of 8
   CPU shards (`dist_ba.make_mesh(devices=["cpu"] * 8)`), in a subprocess,
   against the single-shard call, 4 iterations: its wall clock shows that the
   sharded program runs; the shards share the host's cores, so it is NOT a
   scaling measurement.
C. The bytes that cross between shards a linearization, exact for this
   program: the one reduction of the Schur-reduced camera system (the 6-d
   visual blocks of every keyframe, its gradient and diagonal, the cost) and
   the gathered landmark steps. The JAX script's projection over TPU links
   is not ported; a multi-card figure comes only from a measured run
   (`tools/run_multihost_ba.py`).

`--small` (8 keyframes, 512 points, 256 observations a keyframe, 8 chunks)
is for tests on the host. Prints ONE JSON line. Needs a GPU unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from mc_slam_tpu_torch.tools.bench import device_ops, timeit

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DV = 6          # the columns of a keyframe block in the reduced system
MESH_SHARDS = 8
MESH_ITERS = 4
ITERS = 8        # part A's LM iterations (examples/bench_scaling.py:163)
SYNTH = dict(n_kf=128, n_pts=12288, obs_per_kf=400, chunks=96)
SMALL = dict(n_kf=8, n_pts=512, obs_per_kf=256, chunks=8)


def synthetic_problem(n_kf, n_pts, obs_per_kf, chunks, device):
    """(args of vi_gba_chunked after the chunked observations, meta)."""
    from mc_slam_tpu_torch.bench_problems import vi_window_problem
    from mc_slam_tpu_torch.solver import ba_chunked
    p = vi_window_problem(n_kf=n_kf, n_pts=n_pts, obs_per_kf=obs_per_kf, device=device)
    obs = p["obs"]
    np_ = lambda a: a.cpu().numpy()
    cobs, _ = ba_chunked.chunk_observations(np_(obs.cam), np_(obs.pt), np_(obs.uv),
                                            np_(obs.inv_sigma2), np_(obs.valid),
                                            n_pts, chunks, device=device)
    meta = {"source": "synthetic", "n_kf": n_kf, "n_pts": n_pts,
            "n_obs": int(np_(obs.valid).sum()), "chunks": chunks}
    return (p["ns"], p["pts"], cobs, p["edges"], p["cam"], p["ext"], p["gw"], p["free"],
            p["pt_mask"]), meta


def checkpoint_problem(path, device):
    """The map of a checkpoint as the JAX script builds it
    (examples/bench_scaling.py:61-104)."""
    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.imu.preintegration import PreintState, euroc_noise
    from mc_slam_tpu_torch.io.checkpoint import load_map
    from mc_slam_tpu_torch.solver import ba_chunked, factors
    from mc_slam_tpu_torch.solver.ba_vi import IMUEdges
    m, extra = load_map(path, device=device)
    act = list(extra["kf_slots"])
    Nc = len(act)
    ks = torch.as_tensor(act, dtype=torch.int64, device=device)
    ns = type(m.kf_ns)(*[a[ks] for a in m.kf_ns])
    F, Np = m.F, m.P
    np_ = lambda a: a.cpu().numpy()
    cam_idx = np.repeat(np.arange(Nc, dtype=np.int64), F)
    mp = np_(m.kf_mp)[act].reshape(-1)
    uv = np_(m.kf_uv)[act].reshape(-1, 2)
    lvl = np_(m.kf_level)[act].reshape(-1)
    fv = np_(m.kf_feat_valid)[act].reshape(-1)
    valid = ((mp >= 0) & fv).astype(np.float32)
    inv_s2 = (1.0 / (1.2 ** (2.0 * lvl.astype(np.float32)))).astype(np.float32)
    chunks = 16 * max(1, Np // (16 * 1024))
    chunks = int(np.ceil(chunks / 8)) * 8
    cobs, _ = ba_chunked.chunk_observations(cam_idx, np.clip(mp, 0, Np - 1), uv, inv_s2,
                                            valid, Np, chunks, device=device)
    pre = PreintState(*[a[ks[1:]] for a in m.kf_preint])
    noise = euroc_noise(device=device)
    edges = IMUEdges(i=torch.arange(0, Nc - 1, device=device),
                     j=torch.arange(1, Nc, device=device), pre=pre,
                     info_prv=factors.imu_prv_info(pre),
                     info_bias=factors.bias_rw_info(pre.dT, float(noise.sigma_bg),
                                                    float(noise.sigma_ba)),
                     valid=torch.ones(Nc - 1, device=device))
    free = torch.ones(Nc, device=device)
    free[0] = 0.0
    gw = torch.as_tensor(extra.get("gw", [0.0, 0.0, -9.81]), dtype=torch.float32,
                         device=device)
    meta = {"source": f"checkpoint:{path}", "n_kf": Nc, "n_pts": int(Np),
            "n_obs": int(valid.sum()), "chunks": chunks}
    return (ns, m.mp_pos, cobs, edges, euroc_camera(device=device),
            factors.identity_extrinsics(device=device), gw, free,
            m.mp_active.to(torch.float32)), meta


def build_problem(args, device):
    if args.ckpt:
        return checkpoint_problem(args.ckpt, device)
    return synthetic_problem(**(SMALL if args.small else SYNTH), device=device)


def comm_bytes(n_kf, n_pts):
    """Bytes a linearization moves between shards: the reduced system
    (S (6K)^2, g 6K, diag 6K, cost) summed once, and the landmark steps
    (N, 3) gathered; float32."""
    d = n_kf * DV
    return {"psum_reduced_system": (d * d + d + d + 1) * 4,
            "gather_landmark_steps": n_pts * 3 * 4}


def mesh_sub(args):
    """Part B (run in a subprocess): the sharded call on CPU shards against
    the single one."""
    from mc_slam_tpu_torch.parallel import dist_ba, dist_gba
    from mc_slam_tpu_torch.solver import ba_chunked
    torch.set_num_threads(2)
    prob, meta = build_problem(args, torch.device("cpu"))
    ns, pts, cobs, edges, cam, ext, gw, free, ptm = prob
    mesh = dist_ba.make_mesh(devices=["cpu"] * MESH_SHARDS)
    shards = dist_gba.shard_chunked_obs(mesh, cobs)
    single = lambda: ba_chunked.vi_gba_chunked(ns, pts, cobs, edges, cam, ext, gw, free, ptm,
                                               iters=MESH_ITERS)
    sharded = lambda: dist_gba.vi_gba_chunked_sharded(mesh, ns, pts, shards, edges, cam, ext,
                                                      gw, free, ptm, iters=MESH_ITERS)
    t1, (_, _, c1, _) = timeit(single, False, n=2, warmup=1)
    tn, (_, _, cn, _) = timeit(sharded, False, n=2, warmup=1)
    d_cost = float(abs(cn - c1) / abs(c1))
    print(json.dumps({"cpu_mesh_shards": MESH_SHARDS, "cpu_iters_s_1shard": MESH_ITERS / t1,
                      "cpu_iters_s_mesh": MESH_ITERS / tn, "final_cost_rel_diff": d_cost}))


def part_a(prob, meta, iters, device, n=3, warm=1, profile=True):
    """Part A on a built problem: the mean time of n calls after `warm`,
    the cost curve of one call, and on the card its peak memory and (with
    `profile`) the kernels and copies of one more call under torch.profiler."""
    from mc_slam_tpu_torch.solver import ba_chunked
    cuda = device.type == "cuda"
    single = lambda: ba_chunked.vi_gba_chunked(*prob, iters=iters)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t, res = timeit(single, cuda, n=n, warmup=warm)
    out = {"problem": meta, "device": device.type, "iters": iters,
           "measured_iter_ms_1dev": 1e3 * t / iters, "measured_iters_s_1dev": iters / t,
           "costs": res[3].cpu().numpy().tolist(),
           "launches_per_iter": None, "peak_device_MiB": None}
    if cuda:
        out["peak_device_MiB"] = torch.cuda.max_memory_allocated() / 2 ** 20
    if cuda and profile:
        out["launches_per_iter"] = sum(device_ops(single)) / iters
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt", default="", help="an eval_clone checkpoint (.npz)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--mesh-sub", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh_sub:
        return mesh_sub(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_scaling: no GPU (pass --device cpu to run on the host)")
    a = part_a(*build_problem(args, device), ITERS, device)
    sub = [sys.executable, "-m", "mc_slam_tpu_torch.tools.bench_scaling", "--mesh-sub"]
    sub += (["--ckpt", args.ckpt] if args.ckpt else []) + (["--small"] if args.small else [])
    try:
        r = subprocess.run(sub, cwd=ROOT, capture_output=True, text=True, timeout=1500,
                           check=True)
        mesh = json.loads(r.stdout.strip().splitlines()[-1])
    except (subprocess.SubprocessError, OSError, ValueError, IndexError) as err:
        mesh = {"cpu_mesh_error": str(err)[:300]}
    mesh["note"] = ("CPU shards share the host's cores: shows the sharded program runs, "
                    "not a scaling measurement")
    meta = a["problem"]
    print(json.dumps({**a, "comm_per_linearization_bytes": comm_bytes(meta["n_kf"],
                                                                     meta["n_pts"]),
                      "cpu_mesh_structural": mesh}))


if __name__ == "__main__":
    main()
