"""The multi-host Schur solve (mc_slam_tpu_torch/tools/run_multihost_ba.py,
the port of examples/run_multihost_ba.py) on the CPU: two gloo ranks of four
shards each agree bit for bit and match the JAX single-device Schur solve on
the same numpy problem; a process-group mesh of one rank equals the
single-controller mesh; a rank whose group never forms fails instead of
hanging. Tolerances are stated beside the assertions."""
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mc_slam_tpu.solver import lm as jlm
from mc_slam_tpu_torch.parallel import dist_ba
from mc_slam_tpu_torch.tools import run_multihost_ba as mh

ROOT = Path(__file__).resolve().parent.parent
TOOL = [sys.executable, "-m", "mc_slam_tpu_torch.tools.run_multihost_ba"]

torch.set_num_threads(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_reference(n_shards):
    """examples/run_multihost_ba.py's single-device reference on the tool's
    numpy problem: jax lm.build_landmark_system + lm.schur_solve."""
    obs, Hc, gc, free, ptm, Nc, Np = mh.make_problem("demo", n_shards, "cpu")
    jobs = jlm.Observations(*[jnp.asarray(x.numpy()).astype(jnp.int32)
                              if x.dtype == torch.int64 else jnp.asarray(x.numpy())
                              for x in obs])
    Hcc, g_c, Hpp, g_p, Wcp, _ = jlm.build_landmark_system(
        jobs, jnp.asarray(free.numpy()), Nc, mh.DC, Np, mh.DP)
    ref, _ = jlm.schur_solve(Hcc, g_c, Hpp, g_p, Wcp, mh.LAM, jnp.asarray(free.numpy()),
                             jnp.asarray(ptm.numpy()))
    return np.asarray(ref), Np


def test_two_gloo_ranks_agree_and_match_jax(tmp_path):
    """--demo 2 --device cpu --shards-per-proc 4 (8 shards, Np 512): every
    rank's camera update bit-equal to rank 0's, and rank 0's within 5e-4 of
    the JAX single-device solve (the JAX demo's bound). The run must end
    within 120 s: a hung rank fails here, it does not hang the suite. With
    stdout unbuffered, each rank's lines still come whole and together, in
    rank order, each JSON report right after its rank's verdict."""
    out = tmp_path / "dxc.npz"
    t0 = time.time()
    proc = subprocess.run(TOOL + ["--demo", "2", "--device", "cpu", "--shards-per-proc", "4",
                                  "--timeout", "100", "--out", str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONUNBUFFERED="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert time.time() - t0 < 120
    reports = sorted((json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")),
                     key=lambda r: r["rank"])
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["ok"] and r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["problems"]["demo"]["agree_bitwise"]
        assert r["problems"]["demo"]["ranks_differing"] == 0
    assert "backend gloo" in proc.stdout and "global shards 4..7" in proc.stdout
    lines = proc.stdout.splitlines()
    tags = [int(m.group(1)) for m in map(re.compile(r"\[rank (\d+)/2\]").match, lines) if m]
    assert tags == sorted(tags) and set(tags) == {0, 1}
    for r in reports:
        verdict = lines.index(f"[rank {r['rank']}/2] MULTIHOST SCHUR OK")
        assert json.loads(lines[verdict + 1]) == r
    ref, Np = _jax_reference(8)
    assert Np == 512
    dxc = np.load(out)["dxc_demo"]
    assert dxc.shape == ref.shape == (8, 6)
    assert np.abs(dxc - ref).max() < 5e-4
    assert reports[0]["problems"]["demo"]["max_err_vs_single"] < 5e-4


def test_group_mesh_of_one_rank_equals_single_controller():
    """A mesh over a one-rank gloo group (its all_reduce is the identity)
    equals the single-controller mesh of the same four cpu shards, bit for
    bit: dxc and dxp."""
    obs, Hc, gc, free, ptm, Nc, Np = mh.make_problem("demo", 4, "cpu")
    single = dist_ba.dist_schur_solve(dist_ba.make_mesh(devices=["cpu"] * 4), obs, Hc, gc,
                                      free, ptm, mh.LAM, Nc, mh.DC, Np, mh.DP)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = dist_ba.make_mesh(devices=["cpu"] * 4, group=dist.group.WORLD)
        assert (mesh.rank, mesh.n_ranks, mesh.global_size) == (0, 1, 4)
        grouped = dist_ba.dist_schur_solve(mesh, obs, Hc, gc, free, ptm, mh.LAM, Nc,
                                           mh.DC, Np, mh.DP)
        pair = dist_ba.all_reduce_sum((torch.ones(3), torch.arange(4.0)), mesh.group)
    finally:
        dist.destroy_process_group()
    assert torch.equal(single[0], grouped[0]) and torch.equal(single[1], grouped[1])
    assert torch.equal(pair[0], torch.ones(3)) and torch.equal(pair[1], torch.arange(4.0))


def test_rank_whose_group_never_forms_fails():
    """Rank 0 of a two-rank group whose rank 1 never starts: it must exit
    with an error once its --init-timeout (5 s) is up, not wait forever."""
    t0 = time.time()
    proc = subprocess.run(TOOL + ["--device", "cpu", "--world-size", "2", "--rank", "0",
                                  "--init-method", f"tcp://127.0.0.1:{_free_port()}",
                                  "--init-timeout", "5"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert time.time() - t0 < 60
    assert "MULTIHOST SCHUR OK" not in proc.stdout


@pytest.mark.parametrize("device,world,forced,expect", [
    ("cpu", 2, None, "gloo"), ("cpu", 1, None, "gloo"), ("cuda", 64, None, "gloo"),
    ("cuda", 2, "nccl", "nccl"), ("cpu", 2, "gloo", "gloo")])
def test_backend_rule(device, world, forced, expect):
    """nccl only when every rank has a card of its own (more ranks than
    visible cards: gloo); cpu takes gloo; --backend forces one."""
    backend, dev_of = mh.choose_backend(device, world, forced)
    assert backend == expect
    assert dev_of(1).type == ("cpu" if device == "cpu" else "cuda")


def test_problem_is_the_jax_demos():
    """The numpy draws of examples/run_multihost_ba.py:38-50, in its order:
    Nc 8, Np 64 a shard, 4 observations a landmark sorted by landmark, camera
    0 fixed; the map problem is Nc 132, Np 16384."""
    obs, Hc, gc, free, ptm, Nc, Np = mh.make_problem("demo", 8, "cpu")
    rng = np.random.default_rng(0)
    cam = rng.integers(0, 8, 512 * 4)
    Jc = rng.normal(size=(512 * 4, 1, 2, 6)).astype(np.float32)
    assert (Nc, Np) == (8, 512) and free[0] == 0 and free[1:].eq(1).all()
    np.testing.assert_array_equal(obs.cam[:, 0].numpy(), cam)
    np.testing.assert_array_equal(obs.Jc.numpy(), Jc)
    assert torch.equal(obs.pt, torch.arange(512).repeat_interleave(4))
    _, _, _, _, _, Nc2, Np2 = mh.make_problem("map", 8, "cpu")
    assert (Nc2, Np2) == (132, 16384)
