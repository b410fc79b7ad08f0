"""Parity of the port's mesh-sharded solvers (mc_slam_tpu_torch/parallel/)
with the JAX package's (mc_slam_tpu/parallel/) and with the port's own
unsharded solvers, on the CPU: meshes of 2 and 4 shards on the `cpu` device
against the JAX functions on 2 / 4 of conftest's 8 virtual devices. The cases
are tests/test_parallel.py's. Sums over shards run in another order than the
single-device sums: float32 reduction order is the only difference, and each
tolerance is stated beside its assertion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.bench_problems import vi_window_problem as j_vi_window_problem
from mc_slam_tpu.parallel import dist_ba as jdist
from mc_slam_tpu.parallel import dist_gba as jdist_gba
from mc_slam_tpu.parallel import dist_posegraph as jdist_pg
from mc_slam_tpu.solver import ba_chunked as jbc
from mc_slam_tpu.solver import lm as jlm
from mc_slam_tpu.solver import posegraph as jpg
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.parallel import dist_ba, dist_gba, dist_posegraph
from mc_slam_tpu_torch.solver import ba_chunked, lm, posegraph
from mc_slam_tpu_torch.solver.ba_vi import IMUEdges
from mc_slam_tpu_torch.solver.factors import Extrinsics

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _problem(rng, Nc, DC, Np, DP, obs_per_pt=4):
    """tests/test_parallel.py::make_problem, as numpy."""
    O = Np * obs_per_pt
    cam = rng.integers(0, Nc, size=O).astype(np.int64)
    pt = np.repeat(np.arange(Np), obs_per_pt).astype(np.int64)     # sorted by landmark
    Jc = rng.normal(size=(O, 1, 2, DC)).astype(np.float32)
    Jp = rng.normal(size=(O, 2, DP)).astype(np.float32)
    r = rng.normal(size=(O, 2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=O).astype(np.float32)
    return cam, pt, Jc, Jp, r, w


def _cpu_mesh(n, axis="mp"):
    return dist_ba.make_mesh(axis=axis, devices=["cpu"] * n)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("with_cam_factors", [False, True])
def test_dist_schur_matches_single_and_jax(rng, n_shards, with_cam_factors):
    """dist_schur_solve against lm.schur_solve on the port and against the JAX
    dist_schur_solve (oracles test_dist_matches_single /
    test_dist_with_cam_factors)."""
    Nc, DC, Np, DP = (6, 6, 64, 3) if not with_cam_factors else (4, 6, 32, 3)
    cam, pt, Jc, Jp, r, w = _problem(rng, Nc, DC, Np, DP)
    free = np.ones(Nc, np.float32)
    free[0] = 0.0
    ptm = np.ones(Np, np.float32)
    lam = 1e-3
    if with_cam_factors:
        A = rng.normal(size=(Nc * DC, Nc * DC)).astype(np.float32)
        Hc = (A @ A.T / 100).reshape(Nc, DC, Nc, DC)
        gc = rng.normal(size=(Nc, DC)).astype(np.float32)
    else:
        Hc = np.zeros((Nc, DC, Nc, DC), np.float32)
        gc = np.zeros((Nc, DC), np.float32)
    obs = lm.Observations(cam=T(cam)[:, None], pt=T(pt), Jc=T(Jc), Jp=T(Jp), r=T(r), w=T(w))
    dxc, dxp = dist_ba.dist_schur_solve(_cpu_mesh(n_shards), obs, T(Hc), T(gc), T(free),
                                        T(ptm), lam, Nc, DC, Np, DP)
    # the port's unsharded solve (its landmark damping adds a floor of
    # 1e-3 x the mean landmark energy x lambda, the sharded one 1e-8 as the
    # JAX function: the test_parallel.py tolerance, 2e-4 / 3e-4 absolute)
    Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(obs, T(free), Nc, DC, Np, DP)
    dxc_ref, dxp_ref = lm.schur_solve(Hcc + T(Hc), g_c + T(gc), Hpp, g_p, Wcp, lam, T(free),
                                      T(ptm))
    atol = 3e-4 if with_cam_factors else 2e-4
    np.testing.assert_allclose(dxc.numpy(), dxc_ref.numpy(), atol=atol)
    np.testing.assert_allclose(dxp.numpy(), dxp_ref.numpy(), atol=atol)
    # the JAX function, same damping: 1e-4 relative to the largest step
    jobs = jlm.Observations(cam=jnp.asarray(cam, jnp.int32)[:, None],
                            pt=jnp.asarray(pt, jnp.int32), Jc=jnp.asarray(Jc),
                            Jp=jnp.asarray(Jp), r=jnp.asarray(r), w=jnp.asarray(w))
    mesh = jdist.make_mesh(n_shards)
    jdxc, jdxp = jax.jit(lambda o, H, g, fm, pm: jdist.dist_schur_solve(
        mesh, o, H, g, fm, pm, lam, Nc, DC, Np, DP))(
        jobs, jnp.asarray(Hc), jnp.asarray(gc), jnp.asarray(free), jnp.asarray(ptm))
    scale_c = float(np.abs(np.asarray(jdxc)).max())
    scale_p = float(np.abs(np.asarray(jdxp)).max())
    np.testing.assert_allclose(dxc.numpy(), np.asarray(jdxc), atol=1e-4 * scale_c)
    np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), atol=1e-4 * scale_p)


def _ring_graph(rng, K=12):
    """tests/test_parallel.py::test_dist_posegraph_matches_single's drifted
    ring with one loop edge, as numpy."""
    from mc_slam_tpu import lie as jlie
    ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    P_gt = np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], 1).astype(np.float32)
    R_gt = np.stack([np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
                     for a in ang])
    Rcw = np.swapaxes(R_gt, 1, 2).astype(np.float32)
    tcw = -np.einsum('kij,kj->ki', Rcw, P_gt).astype(np.float32)
    s_gt = jnp.ones(K, jnp.float32)
    R_v, t_v = jnp.asarray(Rcw), jnp.asarray(tcw)
    ei = jnp.arange(0, K - 1, dtype=jnp.int32)
    ej = jnp.arange(1, K, dtype=jnp.int32)
    sm, Rm, tm = jpg.edge_measurement(s_gt[ei], R_v[ei], t_v[ei], s_gt[ej], R_v[ej], t_v[ej])
    drift = np.stack([np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, 0.02 * k], jnp.float32)))
                      for k in range(K)])
    s0 = jnp.asarray(1.0 + 0.01 * np.arange(K), jnp.float32)
    R0 = jnp.asarray(np.einsum('kij,kjl->kil', Rcw, drift))
    t0 = t_v + jnp.asarray(0.03 * rng.normal(size=(K, 3)).astype(np.float32))
    t0 = t0.at[0].set(t_v[0])
    sl, Rl, tl = jpg.edge_measurement(s_gt[K - 1:K], R_v[K - 1:], t_v[K - 1:], s_gt[:1],
                                      R_v[:1], t_v[:1])
    return jpg.Sim3Graph(
        s=s0, R=R0, t=t0, ei=jnp.concatenate([ei, jnp.asarray([K - 1], jnp.int32)]),
        ej=jnp.concatenate([ej, jnp.asarray([0], jnp.int32)]),
        s_m=jnp.concatenate([sm, sl]), R_m=jnp.concatenate([Rm, Rl]),
        t_m=jnp.concatenate([tm, tl]), w=jnp.ones(K, jnp.float32),
        free=jnp.ones(K, jnp.float32).at[0].set(0.0))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_posegraph_matches_single(rng, n_shards):
    """optimize_pose_graph_dist against the port's optimize_pose_graph (oracle
    test_dist_posegraph_matches_single): 12 edges over 2 or 4 shards."""
    jg = _ring_graph(rng)
    g = convert.to_torch(posegraph.Sim3Graph, jax.tree_util.tree_map(np.asarray, jg), "cpu")
    R_d, s_d, t_d, cost_d = dist_posegraph.optimize_pose_graph_dist(
        _cpu_mesh(n_shards, "e"), g, iters=25)
    R_r, s_r, t_r, cost_r = posegraph.optimize_pose_graph(g, iters=25)
    assert float(cost_d) < 1e-6, float(cost_d)
    # same iterations, sums in another order: 1e-4 on scale, 1e-3 on the
    # translation and rotation (the JAX test's tolerances)
    np.testing.assert_allclose(s_d.numpy(), s_r.numpy(), atol=1e-4)
    np.testing.assert_allclose(t_d.numpy(), t_r.numpy(), atol=1e-3)
    np.testing.assert_allclose(R_d.numpy(), R_r.numpy(), atol=1e-3)


def test_dist_posegraph_matches_jax(rng):
    """optimize_pose_graph_dist against the JAX optimize_pose_graph_dist on 4
    of the 8 virtual devices (one compile of the JAX program)."""
    jg = _ring_graph(rng)
    g = convert.to_torch(posegraph.Sim3Graph, jax.tree_util.tree_map(np.asarray, jg), "cpu")
    R_d, s_d, t_d, _ = dist_posegraph.optimize_pose_graph_dist(_cpu_mesh(4, "e"), g, iters=25)
    jR, js, jt, _ = jdist_pg.optimize_pose_graph_dist(jdist.make_mesh(4, axis="e"), jg,
                                                      iters=25)
    # closed-form Jacobians here, jacfwd there: 1e-4 on scale, 1e-3 on the
    # translation and rotation
    np.testing.assert_allclose(s_d.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(R_d.numpy(), np.asarray(jR), atol=1e-3)


def test_pad_graph_edges_matches_jax(rng):
    """Padding to the mesh: 12 edges over 8 shards -> 16, the pad edges carry
    weight 0, an identity measurement and vertex 0 (exactly the JAX arrays);
    the padded graph solves to the unpadded result."""
    jg = _ring_graph(rng)
    g = convert.to_torch(posegraph.Sim3Graph, jax.tree_util.tree_map(np.asarray, jg), "cpu")
    gp = dist_posegraph.pad_graph_edges(g, 8)
    jgp = jdist_pg.pad_graph_edges(jg, 8)
    for f in ("ei", "ej", "s_m", "R_m", "t_m", "w"):
        np.testing.assert_array_equal(getattr(gp, f).numpy(), np.asarray(getattr(jgp, f)), f)
    R_d, s_d, t_d, _ = dist_posegraph.optimize_pose_graph_dist(_cpu_mesh(8, "e"), g, iters=25)
    _, s_r, t_r, _ = posegraph.optimize_pose_graph(g, iters=25)
    np.testing.assert_allclose(s_d.numpy(), s_r.numpy(), atol=1e-4)
    np.testing.assert_allclose(t_d.numpy(), t_r.numpy(), atol=1e-3)


def _chunked_window(n_chunks):
    """The JAX bench window (6 keyframes, 32 landmarks, 32 observations a
    keyframe), chunked by landmark, in both packages' types."""
    p = j_vi_window_problem(n_kf=6, n_pts=32, obs_per_kf=32)
    o = jax.tree_util.tree_map(np.asarray, p["obs"])
    args = (o.cam, o.pt, o.uv, o.inv_sigma2, o.valid, 32, n_chunks)
    jcobs, _ = jbc.chunk_observations(*args)
    tcobs, _ = ba_chunked.chunk_observations(*args, device="cpu")
    np_ = lambda x: jax.tree_util.tree_map(np.asarray, x)
    tp = dict(ns=convert.to_torch(NavState, np_(p["ns"]), "cpu"),
              pts=T(np.array(p["pts"])),
              edges=convert.to_torch(IMUEdges, np_(p["edges"]), "cpu"),
              cam=convert.to_torch(Camera, np_(p["cam"]), "cpu"),
              ext=convert.to_torch(Extrinsics, np_(p["ext"]), "cpu"),
              gw=T(np.array(p["gw"])), free=T(np.array(p["free"])),
              pt_mask=T(np.array(p["pt_mask"])), cobs=tcobs)
    return p, jcobs, tp


def _sharded_gba(n_shards):
    p, jcobs, tp = _chunked_window(8)
    args = (tp["edges"], tp["cam"], tp["ext"], tp["gw"], tp["free"], tp["pt_mask"])
    out = dist_gba.vi_gba_chunked_sharded(_cpu_mesh(n_shards), tp["ns"], tp["pts"], tp["cobs"],
                                          *args, iters=4)
    return p, jcobs, tp, args, out


@pytest.mark.parametrize("n_shards", [2, 4])
def test_vi_gba_chunked_sharded_matches_single(n_shards):
    """vi_gba_chunked_sharded against the port's vi_gba_chunked on the same
    window (8 chunks over the shards)."""
    p, jcobs, tp, args, (ns_d, pts_d, cost_d, costs_d) = _sharded_gba(n_shards)
    ns_r, pts_r, cost_r, costs_r = ba_chunked.vi_gba_chunked(tp["ns"], tp["pts"], tp["cobs"],
                                                            *args, iters=4)
    assert torch.all(costs_d[1:] <= costs_d[:-1])
    # the same LM on sums in another order: costs to 1e-4 relative, the
    # camera update to 1e-4 relative of its size. The landmarks of this
    # synthetic window are weakly constrained in depth and move up to ~44 m in
    # 4 iterations; the order of the sums moves them by ~2e-4 of that move:
    # held to 5e-4 of the largest landmark move
    np.testing.assert_allclose(costs_d.numpy(), costs_r.numpy(), rtol=1e-4)
    dP = (ns_r.P - tp["ns"].P).abs().max().item()
    dX = (pts_r - tp["pts"]).abs().max().item()
    np.testing.assert_allclose(ns_d.P.numpy(), ns_r.P.numpy(), atol=1e-4 * dP)
    np.testing.assert_allclose(pts_d.numpy(), pts_r.numpy(), atol=5e-4 * dX)


def test_vi_gba_chunked_sharded_matches_jax():
    """vi_gba_chunked_sharded against the JAX vi_gba_chunked_sharded on 2 of
    the 8 virtual devices (one compile of the JAX program)."""
    p, jcobs, tp, args, (ns_d, pts_d, cost_d, _) = _sharded_gba(2)
    mesh = jdist.make_mesh(2)
    jns, jpts, jcost = jdist_gba.vi_gba_chunked_sharded(
        mesh, p["ns"], p["pts"], jdist_gba.shard_chunked_obs(mesh, jcobs), p["edges"], p["cam"],
        p["ext"], p["gw"], p["free"], p["pt_mask"], iters=4)
    # two libraries' float32 sums: the cost to 1e-4 relative, the camera
    # update to 2e-4 of its size (measured 9e-5), the landmarks to 5e-4 of
    # their largest move (as against the port's unsharded solver)
    dP = float(jnp.abs(jns.P - p["ns"].P).max())
    dX = float(jnp.abs(jpts - p["pts"]).max())
    np.testing.assert_allclose(float(cost_d), float(jcost), rtol=1e-4)
    np.testing.assert_allclose(ns_d.P.numpy(), np.asarray(jns.P), atol=2e-4 * dP)
    np.testing.assert_allclose(pts_d.numpy(), np.asarray(jpts), atol=5e-4 * dX)


def test_graft_entry_torch():
    """The port's entry points: one VI window BA solve, and the multi-shard
    dry run (sharded Schur step, edge-sharded pose graph, sharded chunked
    GBA) on a 2-shard CPU mesh."""
    import __graft_entry_torch__ as g
    fn, args = g.entry(device="cpu")
    cost = float(fn(*args))
    assert np.isfinite(cost) and cost > 0
    g.dryrun_multichip(2, device="cpu")
