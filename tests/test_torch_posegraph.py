"""Parity of the port's Sim3 pose graph and loop correction with the JAX
package (solver/posegraph.py, pipeline/loopclosing.close_loop) on the CPU, on
the graphs of tests/test_loop.py::TestPoseGraph and the 16-keyframe circle of
::TestEssentialGraphPersistence. The port's Jacobians are in closed form where
the JAX package differentiates with jacfwd: held to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.geometry.sim3solver import Sim3Result as JSim3Result
from mc_slam_tpu.pipeline import loopclosing as jlc
from mc_slam_tpu.slam_map.mapstate import empty_map as j_empty_map
from mc_slam_tpu.solver import posegraph as jpg
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.geometry.sim3solver import Sim3Result
from mc_slam_tpu_torch.pipeline import loopclosing as tlc
from mc_slam_tpu_torch.solver import posegraph as tpg
from torch_port_helpers import torch_map

T = torch.from_numpy


def _rotz(a):
    return np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)), np.float32)


def _circle(K):
    ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K).astype(np.float32)
    P = np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], 1).astype(np.float32)
    R = np.stack([_rotz(a) for a in ang])
    return P, R


def _drifted_graph(rng, K=12):
    """TestPoseGraph's case: true sequential measurements and a true loop
    edge K-1 -> 0 over vertices corrupted by scale, yaw and position drift."""
    P, R = _circle(K)
    Rcw = np.swapaxes(R, 1, 2).copy()
    tcw = -np.einsum('kij,kj->ki', Rcw, P).astype(np.float32)
    s_gt = jnp.ones(K)
    ei = np.concatenate([np.arange(K - 1), [K - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), [0]]).astype(np.int32)
    sm, Rm, tm = jpg.edge_measurement(s_gt[ei], jnp.asarray(Rcw)[ei], jnp.asarray(tcw)[ei],
                                      s_gt[ej], jnp.asarray(Rcw)[ej], jnp.asarray(tcw)[ej])
    s0 = (1.0 + 0.01 * np.arange(K)).astype(np.float32)
    R0 = np.einsum('kij,kjl->kil', Rcw, np.stack([_rotz(0.02 * k) for k in range(K)]))
    t0 = tcw + 0.03 * rng.normal(size=(K, 3)).astype(np.float32)
    t0[0] = tcw[0]
    free = np.ones(K, np.float32)
    free[0] = 0.0
    d = dict(s=s0, R=R0.astype(np.float32), t=t0.astype(np.float32), ei=ei, ej=ej,
             s_m=np.asarray(sm), R_m=np.asarray(Rm), t_m=np.asarray(tm),
             w=np.ones(K, np.float32), free=free)
    return d, P


def _graphs(d):
    return (jpg.Sim3Graph(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.to_torch(tpg.Sim3Graph, d, device="cpu"))


def test_edge_residual_and_jacobians_match_jax(rng):
    """Residuals 1e-5, both Jacobians 1e-4, against jacfwd under vmap."""
    d, _ = _drifted_graph(rng)
    jg, tg = _graphs(d)
    assert tg.ei.dtype == torch.int64 and tg.s.dtype == torch.float32
    a = lambda g, idx: (g.s[idx], g.R[idx], g.t[idx])
    rj, (Jij, Jjj) = jpg._res_and_jac(*a(jg, jg.ei), *a(jg, jg.ej), jg.s_m, jg.R_m, jg.t_m)
    rt, (Jit, Jjt) = tpg._res_and_jac(*a(tg, tg.ei), *a(tg, tg.ej), tg.s_m, tg.R_m, tg.t_m)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Jit.numpy(), np.asarray(Jij), atol=1e-4)
    np.testing.assert_allclose(Jjt.numpy(), np.asarray(Jjj), atol=1e-4)


@pytest.mark.parametrize("iters,fix_scale", [(4, False), (30, False), (30, True)])
def test_optimize_pose_graph_matches_jax(rng, iters, fix_scale):
    """Poses 1e-4 and cost 1e-3 relative (after 4 iterations, before the cost
    has fallen to rounding noise); after 30 both remove the drift."""
    d, P_gt = _drifted_graph(rng)
    jg, tg = _graphs(d)
    Rj, sj, tj, cj = jpg.optimize_pose_graph(jg, iters=iters, fix_scale=fix_scale)
    Rt, st, tt, ct, costs = tpg.optimize_pose_graph(tg, iters=iters, fix_scale=fix_scale,
                                                    curve=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert np.all(np.diff(costs.numpy()) <= 0)
    if iters == 4 or fix_scale:
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3, atol=1e-7)
    if fix_scale:
        np.testing.assert_array_equal(st.numpy(), d["s"])
    elif iters == 30:
        assert float(ct) < 1e-6 and float(cj) < 1e-6
        P_est = -np.einsum('kji,kj->ki', Rt.numpy(), tt.numpy()) / st.numpy()[:, None]
        assert np.linalg.norm(P_est - P_gt, axis=1).max() < 0.05
        np.testing.assert_allclose(st.numpy(), 1.0, atol=2e-3)


def test_correct_map_points_matches_jax(rng):
    K = 5
    xi_o, xi_n = (rng.normal(size=(K, 7)).astype(np.float32) * 0.3 for _ in range(2))
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    ref = rng.integers(0, K, 40).astype(np.int32)
    want = jpg.correct_map_points(jnp.asarray(pts), jnp.asarray(ref),
                                  *jlie.sim3_exp(jnp.asarray(xi_o)),
                                  *jlie.sim3_exp(jnp.asarray(xi_n)))
    got = tpg.correct_map_points(T(pts), T(ref).to(torch.int64), *tlie.sim3_exp(T(xi_o)),
                                 *tlie.sim3_exp(T(xi_n)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---- close_loop on the 16-keyframe circle ----

K16 = 16
CAM_J = j_make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)


def _drift(P, R, start, stop=None, per_kf_yaw=0.03, per_kf_t=0.04):
    P, R = P.copy(), R.copy()
    for k in range(start, len(P) if stop is None else stop):
        Rg = _rotz(per_kf_yaw * (k - start + 1))
        P[k] = Rg @ P[k] + np.array([per_kf_t * (k - start + 1), 0, 0], np.float32)
        R[k] = Rg @ R[k]
    return P, R


def _circle_map(rng):
    """The drifted circle as a JAX MapState, with a few map points created at
    different keyframes (they move with the keyframe nearest their creation)."""
    P_gt, R_gt = _circle(K16)
    P_est, R_est = _drift(P_gt, R_gt, start=6)
    m = j_empty_map(max_kf=K16, max_mp=64, n_feat=32)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    first = (np.arange(64) % 20).astype(np.int32)            # some past the newest id
    V = rng.normal(size=(K16, 3)).astype(np.float32) * 0.1
    m = m._replace(kf_ns=m.kf_ns._replace(P=jnp.asarray(P_est), R=jnp.asarray(R_est),
                                          V=jnp.asarray(V)),
                   kf_active=jnp.ones(K16, bool), kf_id=jnp.arange(K16, dtype=jnp.int32),
                   mp_pos=jnp.asarray(pts), mp_first_kf=jnp.asarray(first),
                   mp_active=jnp.asarray(np.arange(64) < 50))
    return m, P_gt, R_gt


def _measurement(P_gt, R_gt, loop, cur):
    Rcw = np.swapaxes(R_gt, 1, 2)
    tcw = -np.einsum('kij,kj->ki', Rcw, P_gt)
    one = jnp.ones((), jnp.float32)
    return jpg.edge_measurement(one, jnp.asarray(Rcw[loop]), jnp.asarray(tcw[loop]),
                                one, jnp.asarray(Rcw[cur]), jnp.asarray(tcw[cur]))


def _both_close(jm, tm, cur, loop, meas, loop_edges=None):
    s, R, t = meas
    jres = JSim3Result(ok=jnp.asarray(True), s=s, R=R, t=t, inliers=jnp.ones(1),
                       n_inliers=jnp.asarray(50))
    tres = Sim3Result(ok=True, s=float(s), R=np.asarray(R), t=np.asarray(t), inliers=None,
                      n_inliers=50)
    slots = list(range(K16))
    jm2 = jlc.close_loop(jm, slots, cur, loop, jres, CAM_J, fix_scale=True,
                         loop_edges=loop_edges)
    tm2, costs = tlc.close_loop(tm, slots, cur, loop, tres, None, fix_scale=True,
                                loop_edges=loop_edges, curve=True)
    return jm2, tm2, costs


def _rel(P, R, a, b):
    return R[a].T @ R[b], R[a].T @ (P[b] - P[a])


def test_close_loop_matches_jax_and_persisted_edge_keeps_the_seam(rng):
    """Two closures on the drifted circle, as TestEssentialGraphPersistence
    runs them: after each the port's keyframe positions equal the JAX
    package's to 1e-3 m (rotations, velocities and map points too); the
    cost curve never rises; with the first closure's edge persisted the
    healed 0 <-> 15 seam survives the second closure."""
    jm, P_gt, R_gt = _circle_map(rng)
    tm = torch_map(jm)

    def check(jm2, tm2):
        for f in ("P", "R", "V"):
            np.testing.assert_allclose(getattr(tm2.kf_ns, f).numpy(),
                                       np.asarray(getattr(jm2.kf_ns, f)), atol=1e-3,
                                       err_msg=f)
        np.testing.assert_allclose(tm2.mp_pos.numpy(), np.asarray(jm2.mp_pos), atol=2e-3)

    jm1, tm1, costs = _both_close(jm, tm, 15, 0, _measurement(P_gt, R_gt, 0, 15))
    check(jm1, tm1)
    assert np.all(np.diff(costs.numpy()) <= 0)
    # inactive points stay, active ones moved
    np.testing.assert_array_equal(tm1.mp_pos.numpy()[50:], tm.mp_pos.numpy()[50:])
    assert np.abs(tm1.mp_pos.numpy()[:50] - tm.mp_pos.numpy()[:50]).max() > 1e-2
    _, t_gt_ab = _rel(P_gt, R_gt, 0, 15)
    P1, R1 = tm1.kf_ns.P.numpy(), tm1.kf_ns.R.numpy()
    assert np.linalg.norm(_rel(P1, R1, 0, 15)[1] - t_gt_ab) < 0.15

    # new drift on the middle stretch only, then closure #2: 10 <-> 3
    P2d, R2d = _drift(P1, R1, start=6, stop=13, per_kf_yaw=0.02, per_kf_t=0.03)
    errs = {}
    for persist in (True, False):
        jm_d = jm1._replace(kf_ns=jm1.kf_ns._replace(P=jnp.asarray(P2d), R=jnp.asarray(R2d)))
        tm_d = tm1._replace(kf_ns=tm1.kf_ns._replace(P=T(P2d), R=T(R2d)))
        jm2, tm2, costs = _both_close(jm_d, tm_d, 10, 3, _measurement(P_gt, R_gt, 3, 10),
                                      loop_edges=[(0, 15)] if persist else None)
        check(jm2, tm2)
        assert np.all(np.diff(costs.numpy()) <= 0)
        errs[persist] = np.linalg.norm(
            _rel(tm2.kf_ns.P.numpy(), tm2.kf_ns.R.numpy(), 0, 15)[1] - t_gt_ab)
    assert errs[True] < 0.2 and errs[True] <= errs[False] + 1e-6


def test_close_loop_writes_each_keyframe_once_and_leaves_others(rng):
    """A subset of the slots active, in an order that is not the slot order:
    only those rows change, the loop keyframe (the gauge) keeps its pose, and
    the mesh option stays loud."""
    jm, P_gt, R_gt = _circle_map(rng)
    tm = torch_map(jm)
    slots = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15]
    s, R, t = _measurement(P_gt, R_gt, 0, 15)
    res = Sim3Result(ok=True, s=float(s), R=np.asarray(R), t=np.asarray(t), inliers=None,
                     n_inliers=50)
    tm2 = tlc.close_loop(tm, slots, 15, 0, res, None, fix_scale=True,
                         kf_ids={k: k for k in slots})
    P0, P2 = tm.kf_ns.P.numpy(), tm2.kf_ns.P.numpy()
    np.testing.assert_array_equal(P2[10:15], P0[10:15])
    np.testing.assert_allclose(P2[0], P0[0], atol=1e-6)
    assert np.linalg.norm(P2[15] - P_gt[15]) < 0.1 < np.linalg.norm(P0[15] - P_gt[15])
    with pytest.raises(NotImplementedError, match="mesh"):
        tlc.close_loop(tm, slots, 15, 0, res, None, mesh=object())
