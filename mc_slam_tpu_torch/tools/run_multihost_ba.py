"""Multi-host distributed Schur BA (port of examples/run_multihost_ba.py;
BASELINE.json config #5, "N>=2-host distributed VI full BA").

Each process joins a torch.distributed group, builds an "mp" mesh of its
local shards over the group (`dist_ba.make_mesh(group=)`), and runs the
landmark-sharded Schur solve: landmarks partitioned over every rank's shards,
the dense camera system reduced with ONE all_reduce, the solve replicated.
On a cluster run one process per host (or per card):

    python3 -m mc_slam_tpu_torch.tools.run_multihost_ba \\
        --init-method tcp://HOST:PORT --world-size N --rank R

For a local demonstration, --demo N spawns N ranks on this machine:

    python3 -m mc_slam_tpu_torch.tools.run_multihost_ba --demo 2 [--device cpu]

Problems (--problem, drawn with numpy from seed 0 identically on every rank):
"demo" is the JAX demo's (Nc 8, DC 6, Np = 64 x total shards, DP 3, 4
observations a landmark, camera 0 fixed); "map" is at the scale of the
2400-frame run's map (Nc 132, Np 16384, the same layout). Every rank checks
that its camera update is bit-equal to rank 0's (broadcast after the solve);
rank 0 checks max |dxc - lm.schur_solve| < 5e-4 against the single-process
solve. Each rank prints its lines and, last, one JSON object (rank, backend,
device, per problem: agreement, error, ms per solve).

Backend rule (printed by every rank): `nccl` when each rank has a card of its
own (device cuda, world size <= visible cards; rank r on cuda:r), else
`gloo` (which all-reduces CUDA tensors through the host; the shards stay on
the card); `--device cpu` takes gloo. `--backend` forces one. Every rank
initializes with a timeout (--init-timeout, 60 s), and --demo waits on its
ranks with one (--timeout): a hung or failing rank fails the run (exit code
not 0).
"""
from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mc_slam_tpu_torch.parallel import dist_ba
from mc_slam_tpu_torch.solver import lm

PROBLEMS = {"demo": dict(Nc=8, Np_per_shard=64), "map": dict(Nc=132, Np=16384)}
DC, DP, OBS_PER_PT = 6, 3, 4
LAM = 1e-3
N_TIMED = 5               # timed solves a problem, after one untimed
ERR_LIMIT = 5e-4          # the JAX demo's bound against the single-device solve


def make_problem(kind: str, n_shards: int, device):
    """The numpy-seeded problem of examples/run_multihost_ba.py (same draws in
    the same order); "map" takes Nc 132 and Np 16384 instead. Returns
    (obs, Hc, gc, free, ptm, Nc, Np)."""
    spec = PROBLEMS[kind]
    Nc = spec["Nc"]
    Np = spec.get("Np") or spec["Np_per_shard"] * n_shards
    if Np % n_shards:
        raise ValueError(f"{Np} landmarks do not divide over {n_shards} shards")
    rng = np.random.default_rng(0)
    O = Np * OBS_PER_PT
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    obs = lm.Observations(
        cam=t(rng.integers(0, Nc, O), torch.int64)[:, None],
        pt=t(np.repeat(np.arange(Np), OBS_PER_PT), torch.int64),
        Jc=t(rng.normal(size=(O, 1, 2, DC)).astype(np.float32)),
        Jp=t(rng.normal(size=(O, 2, DP)).astype(np.float32)),
        r=t(rng.normal(size=(O, 2)).astype(np.float32)),
        w=t(rng.uniform(0.5, 2.0, O).astype(np.float32)))
    free = torch.ones(Nc, device=device)
    free[0] = 0.0
    ptm = torch.ones(Np, device=device)
    Hc = torch.zeros((Nc, DC, Nc, DC), device=device)
    gc = torch.zeros((Nc, DC), device=device)
    return obs, Hc, gc, free, ptm, Nc, Np


def choose_backend(device: str, world: int, forced: str | None):
    """(backend, this process's device for rank 0..world-1 as a function)."""
    if forced:
        backend = forced
    elif device == "cpu":
        backend = "gloo"
    else:
        backend = "nccl" if world <= torch.cuda.device_count() else "gloo"
    if device == "cpu":
        return backend, lambda r: torch.device("cpu")
    n = max(torch.cuda.device_count(), 1)
    return backend, lambda r: torch.device("cuda", r % n)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def single_reference(obs, Hc, gc, free, ptm, Nc, Np):
    """lm.build_landmark_system + lm.schur_solve on the whole problem in one
    process (the JAX demo's single-device reference)."""
    Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(obs, free, Nc, DC, Np, DP)
    dxc, _ = lm.schur_solve(Hcc + Hc, g_c + gc, Hpp, g_p, Wcp, LAM, free, ptm)
    return dxc


def solve_on_rank(mesh, kind, dev):
    """Solve one problem on this rank's shards; returns (dxc, ms list)."""
    obs, Hc, gc, free, ptm, Nc, Np = make_problem(kind, mesh.global_size, "cpu")
    shards = dist_ba.shard_ba_problem(mesh, obs, Np)
    Hc, gc, free, ptm = (x.to(dev) for x in (Hc, gc, free, ptm))
    solve = lambda: dist_ba.dist_schur_solve(mesh, shards, Hc, gc, free, ptm, LAM,
                                             Nc, DC, Np, DP)
    dxc, _ = solve()            # first call: allocator, cuSOLVER, communicator set-up
    ms = []
    for _ in range(N_TIMED):
        dist.barrier(group=mesh.group)
        _sync(dev)
        t0 = time.perf_counter()
        dxc, _ = solve()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return dxc, ms


def _say(line: str):
    """One line in one write: print() writes the text and its newline apart
    when stdout is unbuffered (PYTHONUNBUFFERED), and ranks that share a pipe
    then run their lines together."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def worker(args):
    backend, dev_of = choose_backend(args.device, args.world_size, args.backend)
    dev = dev_of(args.rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tag = f"[rank {args.rank}/{args.world_size}]"
    _say(f"{tag} backend {backend}, device {dev}, {args.shards_per_proc} shards "
         f"(global shards {args.rank * args.shards_per_proc}.."
         f"{(args.rank + 1) * args.shards_per_proc - 1})")
    dist.init_process_group(backend, init_method=args.init_method,
                            world_size=args.world_size, rank=args.rank,
                            timeout=datetime.timedelta(seconds=args.init_timeout))
    ok = True
    report = {"rank": args.rank, "world": args.world_size, "backend": backend,
              "device": str(dev), "shards_per_proc": args.shards_per_proc, "problems": {}}
    saved = {}
    try:
        mesh = dist_ba.make_mesh(devices=[dev] * args.shards_per_proc,
                                 group=dist.group.WORLD)
        for kind in args.problem.split(","):
            dxc, ms = solve_on_rank(mesh, kind, dev)
            ref0 = dxc.clone()
            dist.broadcast(ref0, src=0)
            same = torch.equal(dxc, ref0)
            flag = torch.tensor([0.0 if same else 1.0], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.SUM)     # ranks that differ
            entry = {"agree_bitwise": same, "ranks_differing": int(flag.item()),
                     "ms_median": float(np.median(ms)), "ms": ms,
                     "dxc_norm": float(torch.linalg.norm(dxc))}
            line = (f"{tag} {kind}: |dxc| {entry['dxc_norm']:.6f}; bit-equal to rank 0: "
                    f"{same} ({entry['ranks_differing']} ranks differ); "
                    f"ms/solve median {entry['ms_median']:.3f}")
            if args.rank == 0:
                obs, Hc, gc, free, ptm, Nc, Np = make_problem(kind, mesh.global_size, dev)
                ref = single_reference(obs, Hc, gc, free, ptm, Nc, Np)
                err = float((dxc - ref).abs().max())
                entry["max_err_vs_single"] = err
                line += f"; max err vs single-process {err:.3e} (< {ERR_LIMIT:g})"
                ok &= err < ERR_LIMIT
                saved[f"dxc_{kind}"] = dxc.cpu().numpy()
                saved[f"err_{kind}"] = np.float64(err)
            ok &= same and entry["ranks_differing"] == 0 and bool(torch.isfinite(dxc).all())
            report["problems"][kind] = entry
            _say(line)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if args.rank == 0 and args.out:
        np.savez(args.out, **saved)
    report["ok"] = bool(ok)
    _say(f"{tag} {'MULTIHOST SCHUR OK' if ok else 'MULTIHOST SCHUR FAILED'}")
    _say(json.dumps(report))
    return 0 if ok else 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def demo(args):
    """Spawn args.demo ranks of this tool on this machine; wait on every one
    with a timeout. Each rank's stdout goes to a file of its own and is
    relayed whole, in rank order, once the ranks have ended, so no two ranks'
    lines mix. Returns the worst exit code (1 on a timeout)."""
    init = args.init_method or f"tcp://127.0.0.1:{free_port()}"
    base = [sys.executable, "-m", "mc_slam_tpu_torch.tools.run_multihost_ba",
            "--init-method", init, "--world-size", str(args.demo),
            "--shards-per-proc", str(args.shards_per_proc), "--device", args.device,
            "--problem", args.problem, "--init-timeout", str(args.init_timeout)]
    if args.backend:
        base += ["--backend", args.backend]
    procs, logs = [], []
    for r in range(args.demo):
        cmd = base + ["--rank", str(r)] + (["--out", args.out] if r == 0 and args.out else [])
        logs.append(tempfile.TemporaryFile())
        procs.append(subprocess.Popen(cmd, stdout=logs[-1]))
    deadline = time.monotonic() + args.timeout
    rcs, late = [], []
    for r, p in enumerate(procs):
        try:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 0.1)))
        except subprocess.TimeoutExpired:
            late.append(r)
            rcs.append(1)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.seek(0)
        sys.stdout.write(log.read().decode(errors="replace"))
        log.close()
    for r in late:
        _say(f"[demo] rank {r} did not finish within {args.timeout:g} s")
    sys.stdout.flush()
    return max(rcs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", type=int, default=0,
                    help="spawn N local ranks as a stand-in multi-host cluster")
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed init method, e.g. tcp://127.0.0.1:29500")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--shards-per-proc", type=int, default=4,
                    help="landmark shards of each rank (the JAX --devices-per-proc)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--problem", default="demo", help="demo, map, or demo,map")
    ap.add_argument("--timeout", type=float, default=300.0, help="--demo: seconds")
    ap.add_argument("--init-timeout", type=float, default=60.0,
                    help="seconds a rank waits for the group to form")
    ap.add_argument("--out", default=None, help="npz of rank 0's dxc and error")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("run_multihost_ba: no GPU visible; pass --device cpu")
    if args.demo:
        return demo(args)
    if args.init_method is None:
        raise SystemExit("run_multihost_ba: --init-method is needed without --demo")
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
