"""Parity of the port's XYZ bundle adjustments with the JAX package on the
same perturbed windows: `ba.visual_ba` (tests/test_solver.py's arc scene) and
`ba_vi.vi_ba` (tests/test_vi_solver.py's keyframe window with exact IMU), with
the outlier round on and off, `fix_points`, and unobserved padded landmarks.

Tolerances: both sides run the same fixed count of float32 LM iterations with
the same accept / reject rule; normal equations summed in another order move
an accepted step by ~1e-6, so after 8-15 iterations keyframe positions agree
to 1e-3 m, rotations to 1e-3, landmarks to 1e-3 m (median; 5e-3 worst, a few
landmarks seen at low parallax), velocities to 1e-2 m/s, the final cost to
1e-3 relative, and the chi2 gate decides equally on >= 99 % of the rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.solver import ba as jba, ba_vi as jbavi, factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import make_camera as t_make_camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.solver import ba as tba, ba_vi as tbavi, factors as tfac

import synth
from test_solver import CAM as JCAM, EXT as JEXT, synth_scene
from test_vi_solver import build_vi_window, kfs_to_navstate

torch.set_num_threads(2)
TCAM = t_make_camera(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
TEXT = tfac.identity_extrinsics(device="cpu")
GW = np.asarray(synth.GW, np.float32)
_t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)
_np = lambda x: jax.tree_util.tree_map(np.asarray, x)


def _tobs(obs):
    return convert.to_torch(tba.VisualObs, _np(obs), "cpu")


def _gate_agreement(chi2_t, chi2_j):
    return ((chi2_t <= tba.CHI2_MONO) == (np.asarray(chi2_j) <= jba.CHI2_MONO)).mean()


def _perturbed_visual(rng, outliers=0):
    pts, P, R, obs = synth_scene(rng, Nc=6, Np=100, noise_px=0.5)
    P0 = P + rng.normal(size=P.shape).astype(np.float32) * 0.05
    phis = rng.normal(size=(P.shape[0], 3)).astype(np.float32) * 0.02
    R0 = np.einsum('nij,njk->nik', R, np.asarray(jlie.so3_exp(jnp.asarray(phis))))
    P0[:2], R0[:2] = P[:2], R[:2]
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.1
    if outliers:
        uv = np.array(obs.uv)
        bad = rng.choice(uv.shape[0], size=outliers, replace=False)
        uv[bad] += rng.uniform(30, 80, size=(outliers, 2))
        obs = obs._replace(uv=jnp.asarray(uv))
    free = np.concatenate([[0.0, 0.0], np.ones(P.shape[0] - 2)]).astype(np.float32)
    return pts, P, P0, R0.astype(np.float32), pts0, obs, free


@pytest.mark.parametrize("two_phase", [True, False])
def test_visual_ba_matches_jax(rng, two_phase):
    pts, P, P0, R0, pts0, obs, free = _perturbed_visual(rng, outliers=25)
    mask = np.ones(pts.shape[0], np.float32)
    Pj, Rj, pj, chi2_j, cost_j = jba.visual_ba(
        jnp.asarray(P0), jnp.asarray(R0), jnp.asarray(pts0), obs, JCAM, JEXT,
        jnp.asarray(free), jnp.asarray(mask), iters=12, two_phase=two_phase)
    Pt, Rt, pt, chi2_t, cost_t, costs = tba.visual_ba(
        _t(P0), _t(R0), _t(pts0), _tobs(obs), TCAM, TEXT, _t(free), _t(mask), iters=12,
        two_phase=two_phase)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    d = np.linalg.norm(pt.numpy() - np.asarray(pj), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 5e-3
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    assert _gate_agreement(chi2_t.numpy(), chi2_j) >= 0.99
    # the cost curve: each round's start, then one value per iteration, never rising
    costs = costs.numpy()
    rounds = [costs[:6], costs[6:]] if two_phase else [costs]
    assert len(costs) == (14 if two_phase else 13)
    for c in rounds:
        assert np.all(np.diff(c) <= 0) and c[-1] < c[0]
    assert float(cost_t) == costs[-1]
    np.testing.assert_allclose(Pt.numpy()[:2], P[:2], atol=1e-7)      # fixed cameras


def test_visual_ba_empty_points(rng):
    """Padded landmarks that nobody observes (tests/test_solver.py:219)."""
    pts, P, R, obs = synth_scene(rng, Nc=4, Np=50, noise_px=0.3)
    pts_pad = np.concatenate([pts, np.zeros((14, 3), np.float32)])
    pt_mask = np.concatenate([np.ones(50), np.zeros(14)]).astype(np.float32)
    free = np.concatenate([[0.0], np.ones(3)]).astype(np.float32)
    Pj, _, pj, _, cost_j = jba.visual_ba(
        jnp.asarray(P), jnp.asarray(R), jnp.asarray(pts_pad), obs, JCAM, JEXT,
        jnp.asarray(free), jnp.asarray(pt_mask), iters=5)
    Pt, Rt, pt, _, cost_t, _ = tba.visual_ba(
        _t(P), _t(R), _t(pts_pad), _tobs(obs), TCAM, TEXT, _t(free), _t(pt_mask), iters=5)
    assert torch.isfinite(Pt).all() and torch.isfinite(pt).all() and torch.isfinite(Rt).all()
    np.testing.assert_allclose(pt.numpy()[50:], 0.0, atol=1e-7)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)


def _vi_problem(rng, N=8):
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=N)
    ns_true = kfs_to_navstate(kfs)
    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
    dphi = rng.normal(size=(N, 3)).astype(np.float32) * 0.02
    dV = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
    dP[:2] = dphi[:2] = dV[:2] = 0
    ns0 = ns_true._replace(P=ns_true.P + dP, V=ns_true.V + dV,
                           R=ns_true.R @ jlie.so3_exp(jnp.asarray(dphi)))
    pts0 = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)
    pre1 = jax.tree_util.tree_map(lambda a: a[1:], pre)
    edges = jbavi.IMUEdges(
        i=jnp.arange(0, N - 1, dtype=jnp.int32), j=jnp.arange(1, N, dtype=jnp.int32),
        pre=pre1, info_prv=jfac.imu_prv_info(pre1),
        info_bias=jfac.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(N - 1, jnp.float32))
    free = np.asarray([0.0, 0.0] + [1.0] * (N - 2), np.float32)
    return ns_true, ns0, pts, pts0, obs, edges, free


@pytest.mark.parametrize("two_phase,fix_points", [(True, False), (False, False), (False, True)])
def test_vi_ba_matches_jax(rng, two_phase, fix_points):
    ns_true, ns0, pts, pts0, obs, edges, free = _vi_problem(rng)
    start = pts if fix_points else pts0
    mask = np.ones(pts.shape[0], np.float32)
    nsj, pj, chi2_j, cost_j = jbavi.vi_ba(
        ns0, jnp.asarray(start), obs, edges, JCAM, JEXT, jnp.asarray(GW), jnp.asarray(free),
        jnp.asarray(mask), iters=8, two_phase=two_phase, fix_points=fix_points)
    t_edges = convert.to_torch(tbavi.IMUEdges, _np(edges), "cpu")
    assert t_edges.i.dtype == torch.int64 and t_edges.pre.dT.shape == (7,)
    nst, pt, chi2_t, cost_t, costs = tbavi.vi_ba(
        convert.to_torch(NavState, _np(ns0), "cpu"), _t(start), _tobs(obs), t_edges, TCAM,
        TEXT, _t(GW), _t(free), _t(mask), iters=8, two_phase=two_phase,
        fix_points=fix_points)
    nsj = _np(nsj)
    np.testing.assert_allclose(nst.P.numpy(), nsj.P, atol=1e-3)
    np.testing.assert_allclose(nst.R.numpy(), nsj.R, atol=1e-3)
    np.testing.assert_allclose(nst.V.numpy(), nsj.V, atol=1e-2)
    np.testing.assert_allclose(nst.dbg.numpy(), nsj.dbg, atol=1e-4)
    np.testing.assert_allclose(nst.dba.numpy(), nsj.dba, atol=1e-2)
    d = np.linalg.norm(pt.numpy() - np.asarray(pj), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 5e-3
    if fix_points:
        assert d.max() == 0.0
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    assert _gate_agreement(chi2_t.numpy(), chi2_j) >= 0.99
    costs = costs.numpy()
    assert len(costs) == (10 if two_phase else 9) and costs[-1] < costs[0]
    # and it did its job: the perturbation is gone
    assert np.abs(nst.P.numpy() - np.asarray(ns_true.P)).max() < 0.03


def test_vi_ba_masked_edge_with_degenerate_preintegration(rng):
    """A masked edge may carry an identity preintegration (dT = 0): its
    informations are inf / NaN and `edges_from_map` replaces them, so the
    system stays finite (the JAX package's _imu_edges does the same)."""
    from mc_slam_tpu_torch.imu.preintegration import PreintState, preint_identity
    _, ns0, pts, pts0, obs, edges, free = _vi_problem(rng, N=6)
    pre = convert.to_torch(PreintState, _np(edges.pre), "cpu")
    ident = preint_identity((1,), device="cpu")
    table = PreintState(*[torch.cat([i0, a]) for i0, a in zip(ident, pre)])   # row k: k-1 -> k
    ks = torch.arange(6)
    idx_i = torch.tensor([0, 0, 1, 2, 3, 4])
    idx_j = torch.tensor([0, 1, 2, 3, 4, 5])
    ev = torch.tensor([0.0, 1, 1, 1, 1, 1])          # entry 0: the absent predecessor edge
    e2 = tbavi.edges_from_map(table, ks, idx_i, idx_j, ev, 2e-5, 5e-3)
    assert torch.isfinite(e2.info_prv).all() and torch.isfinite(e2.info_bias).all()
    assert torch.equal(e2.info_bias[0], torch.eye(6))
    np.testing.assert_allclose(e2.info_prv[1:].numpy(), np.asarray(edges.info_prv),
                               rtol=1e-3, atol=1e-3 * float(np.abs(edges.info_prv).max()))
    nst, pt, _, cost, _ = tbavi.vi_ba(
        convert.to_torch(NavState, _np(ns0), "cpu"), _t(pts0), _tobs(obs), e2, TCAM, TEXT,
        _t(GW), _t(free), torch.ones(pts.shape[0]), iters=4, two_phase=False)
    assert torch.isfinite(cost) and torch.isfinite(nst.P).all()
