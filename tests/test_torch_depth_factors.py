"""Parity of the port's stereo / RGB-D residual row with the JAX package:
`factors.reproj_xyz3`, `ba.obs_reproj` on a mixed table, the pose-only
solves (`pose_only_visual`, `pose_only_vi`) and the XYZ BAs (`visual_ba`,
`vi_ba`) with u_right rows and bf, and the chunked whole-map BA with u_right
rows against the dense one.

Every table mixes stereo rows (ur >= 0) with monocular ones (ur = -1).
Tolerances: the factor is closed-form float32 arithmetic, residuals and
Jacobians agree to 1e-5 relative (1e-5 of the largest entry absolute). The
solvers run the same fixed count of float32 LM iterations with the same
accept rule, summing their normal equations in another order: poses agree to
1e-4 (m / rad), landmarks to 1e-3 m (the VI window's median to 1e-4 m, its
worst, seen at low parallax, to 1e-2 m), chi2 per row to 1e-3 relative (1e-3
absolute for rows near 0), the inlier counts to one row. The chunked BA against the dense one (one
package, one round each): positions 2e-3 m, landmarks 1e-3 m median (5e-2 m
worst: the window's far landmarks, seen at low parallax, move along their
rays), the final cost 1e-2 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import euroc_camera as j_euroc
from mc_slam_tpu.imu import preintegration as jpre
from mc_slam_tpu.solver import ba_chunked as jch
from mc_slam_tpu.solver import ba as jba, ba_vi as jbavi, factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import euroc_camera as t_euroc
from mc_slam_tpu_torch.imu import navstate as tnav, preintegration as tpre
from mc_slam_tpu_torch.solver import ba as tba, ba_chunked as tch, ba_vi as tbavi, \
    factors as tfac

from test_torch_solver import TBC, _imu_setup, _np, _rot_err, _scene, _t
from test_torch_xyz_ba import (GW, JCAM, JEXT, TCAM, TEXT, _perturbed_visual, _tobs,
                               _vi_problem)

torch.set_num_threads(2)
BF = 458.654 * 0.11          # EuRoC fx * the 0.11 m baseline
BF_ARC = 400.0 * 0.11        # the arc scenes' fx * 0.11 m


def _ur_rows(rng, u, z, bf, frac_mono=0.3, noise=0.5):
    """u_right observations u - bf / z (+ noise); a share of rows monocular (-1)."""
    ur = (u - bf / z + rng.normal(size=u.shape) * noise).astype(np.float32)
    return np.where(rng.random(u.shape) < frac_mono, -1.0, ur).astype(np.float32)


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1.0))


def test_reproj_xyz3_matches_jax(rng):
    n = 400
    jext = jfac.extrinsics_from_Tbc(TBC)
    text = tfac.extrinsics_from_Tbc(TBC, device="cpu")
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(n, 3)) * 0.4, jnp.float32)))
    P = rng.normal(size=(n, 3)).astype(np.float32)
    Xc = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(0.5, 9, (n, 1))], 1)
    Rbc = np.asarray(jext.Rcb).T
    pbc = -Rbc @ np.asarray(jext.tcb)
    Xw = (np.einsum('nij,nj->ni', R, Xc @ Rbc.T + pbc) + P).astype(np.float32)
    uv = rng.uniform(0, 700, (n, 2)).astype(np.float32)
    ur = _ur_rows(rng, uv[:, 0], Xc[:, 2], BF)
    out_j = jfac.reproj_xyz3(j_euroc(), jext, jnp.asarray(P), jnp.asarray(R), jnp.asarray(Xw),
                             jnp.asarray(uv), jnp.asarray(ur), BF)
    out_t = tfac.reproj_xyz3(t_euroc(device="cpu"), text, _t(P), _t(R), _t(Xw), _t(uv), _t(ur),
                             BF)
    for a, b in zip(out_j, out_t):
        _close(b.numpy(), a)
    r, J_pr, J_pt, _ = (x.numpy() for x in out_t)
    mono = ur < 0
    assert mono.any() and (~mono).any()
    assert np.all(r[mono, 2] == 0) and np.all(J_pr[mono, 2] == 0) and np.all(J_pt[mono, 2] == 0)
    # the first two rows are the monocular factor's
    r2, Jpr2, Jpt2, _ = tfac.reproj_xyz(t_euroc(device="cpu"), text, _t(P), _t(R), _t(Xw), _t(uv))
    np.testing.assert_array_equal(r[:, :2], r2.numpy())
    np.testing.assert_array_equal(J_pr[:, :2], Jpr2.numpy())
    np.testing.assert_array_equal(J_pt[:, :2], Jpt2.numpy())


def _stereo_scene(seed):
    """test_torch_solver's EuRoC-camera scene with u_right rows at the true
    depths (the noisy u minus bf / z, +0.5 px)."""
    s = _scene(seed)
    rng = np.random.default_rng(100 + seed)
    _, _, _, z = jfac.reproj_xyz(j_euroc(), jfac.extrinsics_from_Tbc(TBC), jnp.asarray(s["P"]),
                                 jnp.asarray(s["R"]), jnp.asarray(s["Xw"]),
                                 jnp.asarray(s["obs"]["uv"]))
    s["obs"]["ur"] = _ur_rows(rng, s["obs"]["uv"][:, 0], np.asarray(z), BF)
    return s


def _port_obs3(obs):
    return tba.VisualObs(cam=_t(obs["cam"], torch.int64), pt=_t(obs["pt"], torch.int64),
                         uv=_t(obs["uv"]), inv_sigma2=_t(obs["inv_sigma2"]),
                         valid=_t(obs["valid"]), ur=_t(obs["ur"]))


def test_obs_reproj_mixed_table():
    s = _stereo_scene(6)
    jobs = jba.VisualObs(**{k: jnp.asarray(v) for k, v in s["obs"].items()})
    out_j = jba.obs_reproj(j_euroc(), jfac.extrinsics_from_Tbc(TBC), jnp.asarray(s["P0"]),
                           jnp.asarray(s["R0"]), jnp.asarray(s["Xw"]), jobs, BF)
    out_t = tba.obs_reproj(t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"),
                           _t(s["P0"]), _t(s["R0"]), _t(s["Xw"]), _port_obs3(s["obs"]), BF)
    for a, b in zip(out_j[:4], out_t[:4]):
        _close(b.numpy(), a)
    # the per-row Huber knee: stereo 7.815 where ur >= 0, mono 5.991 elsewhere
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert set(np.unique(out_t[4].numpy())) == {np.float32(tba.CHI2_MONO),
                                               np.float32(tba.CHI2_STEREO)}
    # a table without the column keeps the scalar mono knee
    assert tba.obs_reproj(t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"),
                          _t(s["P0"]), _t(s["R0"]), _t(s["Xw"]),
                          _port_obs3(s["obs"])._replace(ur=None))[4] == tba.CHI2_MONO


def _chi2_close(chi2_t, chi2_j):
    np.testing.assert_allclose(chi2_t.numpy(), np.asarray(chi2_j), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", [7, 8])
def test_pose_only_visual_stereo(seed):
    s = _stereo_scene(seed)
    jobs = jba.VisualObs(**{k: jnp.asarray(v) for k, v in s["obs"].items()})
    Pj, Rj, chi2j, nj = jba.pose_only_visual(
        jnp.asarray(s["P0"]), jnp.asarray(s["R0"]), jnp.asarray(s["Xw"]), jobs, j_euroc(),
        jfac.extrinsics_from_Tbc(TBC), iters=20, bf=BF)
    Pt, Rt, chi2t, nt = tba.pose_only_visual(
        _t(s["P0"]), _t(s["R0"]), _t(s["Xw"]), _port_obs3(s["obs"]), t_euroc(device="cpu"),
        tfac.extrinsics_from_Tbc(TBC, device="cpu"), iters=20, bf=BF)
    assert np.abs(np.asarray(Pj) - Pt.numpy()).max() < 1e-4
    assert _rot_err(np.asarray(Rj), Rt.numpy()) < 1e-4
    _chi2_close(chi2t, chi2j)
    assert abs(int(nj) - int(nt)) <= 1
    assert np.abs(np.asarray(Pj) - s["P"]).max() < 0.01      # it did converge


@pytest.mark.parametrize("compute_marg", [False, True])
def test_pose_only_vi_stereo(compute_marg):
    ns_last, ns_cur0, pre, gw = _imu_setup(4)
    s = _stereo_scene(5)
    Rc, Pc = np.asarray(ns_cur0.R), np.asarray(ns_cur0.P)
    Xw = ((Rc @ s["R"].T @ (s["Xw"] - s["P"]).T).T + Pc).astype(np.float32)
    ns_start = ns_cur0._replace(P=(Pc + 0.02).astype(np.float32))
    prior_info = np.diag(np.r_[np.full(9, 1e3), np.full(3, 1e6), np.full(3, 1e4)]
                         ).astype(np.float32)
    jpre_t = jpre.PreintState(*[jnp.asarray(a) for a in pre])
    jprior = jbavi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=ns_last,
                               info=jnp.asarray(prior_info), valid=jnp.asarray(1.0))
    jobs = jba.VisualObs(**{k: jnp.asarray(v) for k, v in s["obs"].items()})
    nsj, chi2j, nj, Hj = jbavi.pose_only_vi(
        ns_start, ns_last, jpre_t, jnp.asarray(Xw), jobs, j_euroc(),
        jfac.extrinsics_from_Tbc(TBC), gw, jprior, jfac.imu_prv_info(jpre_t),
        jfac.bias_rw_info(jpre_t.dT, 2e-5, 5e-3), iters=20, compute_marg=compute_marg, bf=BF)
    t_last = convert.to_torch(tnav.NavState, ns_last, "cpu")
    tprior = tbavi.PriorFactor(cam=torch.zeros((), dtype=torch.int64), ns0=t_last,
                               info=_t(prior_info), valid=torch.ones(()))
    tpre_t = convert.to_torch(tpre.PreintState, pre, "cpu")
    nst, chi2t, nt, Ht = tbavi.pose_only_vi(
        convert.to_torch(tnav.NavState, ns_start, "cpu"), t_last, tpre_t, _t(Xw),
        _port_obs3(s["obs"]), t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"),
        _t(gw), tprior, tfac.imu_prv_info(tpre_t), tfac.bias_rw_info(tpre_t.dT, 2e-5, 5e-3),
        iters=20, compute_marg=compute_marg, bf=BF)
    assert np.abs(np.asarray(nsj.P) - nst.P.numpy()).max() < 1e-4
    assert _rot_err(np.asarray(nsj.R), nst.R.numpy()) < 1e-4
    assert np.abs(np.asarray(nsj.V) - nst.V.numpy()).max() < 1e-3
    _chi2_close(chi2t, chi2j)
    assert abs(int(nj) - int(nt)) <= 1
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Hj, Ht.numpy(), rtol=1e-3, atol=1e-3 * max(np.abs(Hj).max(), 1.0))


def _arc_ur(rng, obs, pts, P, R):
    """u_right rows for an arc scene's observations at the true geometry."""
    _, _, _, z = jfac.reproj_xyz(JCAM, JEXT, jnp.asarray(P)[obs.cam], jnp.asarray(R)[obs.cam],
                                 jnp.asarray(pts)[obs.pt], obs.uv)
    return _ur_rows(rng, np.asarray(obs.uv)[:, 0], np.asarray(z), BF_ARC)


@pytest.mark.parametrize("two_phase", [True, False])
def test_visual_ba_stereo(rng, two_phase):
    pts, P, P0, R0, pts0, obs, free = _perturbed_visual(rng, outliers=25)
    # u_right rows from the true points seen from P and the start rotations
    # (true at the two fixed cameras, 0.02 rad off elsewhere)
    obs = obs._replace(ur=jnp.asarray(_arc_ur(rng, obs, pts, P, R0)))
    mask = np.ones(pts.shape[0], np.float32)
    Pj, Rj, pj, chi2_j, cost_j = jba.visual_ba(
        jnp.asarray(P0), jnp.asarray(R0), jnp.asarray(pts0), obs, JCAM, JEXT,
        jnp.asarray(free), jnp.asarray(mask), iters=12, two_phase=two_phase, bf=BF_ARC)
    Pt, Rt, pt, chi2_t, cost_t, _ = tba.visual_ba(
        _t(P0), _t(R0), _t(pts0), _tobs(obs), TCAM, TEXT, _t(free), _t(mask), iters=12,
        bf=BF_ARC, two_phase=two_phase)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    _chi2_close(chi2_t, chi2_j)


@pytest.mark.parametrize("two_phase", [True, False])
def test_vi_ba_stereo(rng, two_phase):
    ns_true, ns0, pts, pts0, obs, edges, free = _vi_problem(rng)
    _, _, _, z = jfac.reproj_xyz(JCAM, JEXT, ns_true.P[obs.cam], ns_true.R[obs.cam],
                                 jnp.asarray(pts)[obs.pt], obs.uv)
    obs = obs._replace(ur=jnp.asarray(_ur_rows(rng, np.asarray(obs.uv)[:, 0], np.asarray(z),
                                               BF_ARC)))
    mask = np.ones(pts.shape[0], np.float32)
    nsj, pj, chi2_j, cost_j = jbavi.vi_ba(
        ns0, jnp.asarray(pts0), obs, edges, JCAM, JEXT, jnp.asarray(GW), jnp.asarray(free),
        jnp.asarray(mask), iters=8, two_phase=two_phase, bf=BF_ARC)
    nst, pt, chi2_t, cost_t, _ = tbavi.vi_ba(
        convert.to_torch(tnav.NavState, _np(ns0), "cpu"), _t(pts0), _tobs(obs),
        convert.to_torch(tbavi.IMUEdges, _np(edges), "cpu"), TCAM, TEXT, _t(GW), _t(free),
        _t(mask), iters=8, bf=BF_ARC, two_phase=two_phase)
    nsj = _np(nsj)
    np.testing.assert_allclose(nst.P.numpy(), nsj.P, atol=1e-4)
    np.testing.assert_allclose(nst.R.numpy(), nsj.R, atol=1e-4)
    np.testing.assert_allclose(nst.V.numpy(), nsj.V, atol=1e-3)
    d = np.linalg.norm(pt.numpy() - np.asarray(pj), axis=1)
    assert np.median(d) < 1e-4 and d.max() < 1e-2      # a few landmarks at low parallax
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    _chi2_close(chi2_t, chi2_j)
    assert np.abs(nst.P.numpy() - np.asarray(ns_true.P)).max() < 0.03


def _landmarks_close(a, b):
    d = np.linalg.norm(a.numpy() - b.numpy(), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 5e-2, (np.median(d), d.max())


def test_chunked_ba_stereo_against_dense(rng):
    """The chunked whole-map BA with u_right rows (visual and VI) against the
    port's dense BA, one round each, and the visual form against the JAX
    package's chunked one."""
    ns_true, ns0, pts, pts0, obs, edges, free = _vi_problem(rng, N=6)
    _, _, _, z = jfac.reproj_xyz(JCAM, JEXT, ns_true.P[obs.cam], ns_true.R[obs.cam],
                                 jnp.asarray(pts)[obs.pt], obs.uv)
    ur = _ur_rows(rng, np.asarray(obs.uv)[:, 0], np.asarray(z), BF_ARC)
    obs = obs._replace(ur=jnp.asarray(ur))
    Np = pts.shape[0]
    Npad = int(np.ceil(Np / 4)) * 4
    pts_p = np.zeros((Npad, 3), np.float32)
    pts_p[:Np] = pts0
    mask = (np.arange(Npad) < Np).astype(np.float32)
    args = [np.asarray(a) for a in (obs.cam, obs.pt, obs.uv, obs.inv_sigma2, obs.valid)]
    ct, _ = tch.chunk_observations(*args, Npad, 4, ur=ur, device="cpu")
    cj, _ = jch.chunk_observations(*args, Npad, 4, ur=ur)
    t_ns0 = convert.to_torch(tnav.NavState, _np(ns0), "cpu")
    t_edges = convert.to_torch(tbavi.IMUEdges, _np(edges), "cpu")
    # visual
    Pc, Rc, pc, cost_c, costs = tch.visual_gba_chunked(
        t_ns0.P, t_ns0.R, _t(pts_p), ct, TCAM, TEXT, _t(free), _t(mask), iters=8, bf=BF_ARC)
    Pd, _, pd, _, cost_d, _ = tba.visual_ba(t_ns0.P, t_ns0.R, _t(pts_p), _tobs(obs), TCAM, TEXT,
                                            _t(free), _t(mask), iters=8, bf=BF_ARC,
                                            two_phase=False)
    np.testing.assert_allclose(Pc.numpy(), Pd.numpy(), atol=2e-3)
    _landmarks_close(pc, pd)
    np.testing.assert_allclose(float(cost_c), float(cost_d), rtol=1e-2)
    assert np.all(np.diff(costs.numpy()) <= 0)
    Pj, _, pj, cost_j = jch.visual_gba_chunked(ns0.P, ns0.R, jnp.asarray(pts_p), cj, JCAM, JEXT,
                                               jnp.asarray(free), jnp.asarray(mask), iters=8,
                                               bf=BF_ARC)
    np.testing.assert_allclose(Pc.numpy(), np.asarray(Pj), atol=1e-3)
    np.testing.assert_allclose(float(cost_c), float(cost_j), rtol=1e-3)
    # VI
    nsc, pvc, cost_vc, _ = tch.vi_gba_chunked(t_ns0, _t(pts_p), ct, t_edges, TCAM, TEXT, _t(GW),
                                              _t(free), _t(mask), iters=8, bf=BF_ARC)
    nsd, pvd, _, cost_vd, _ = tbavi.vi_ba(t_ns0, _t(pts_p), _tobs(obs), t_edges, TCAM, TEXT,
                                          _t(GW), _t(free), _t(mask), iters=8, bf=BF_ARC,
                                          two_phase=False)
    np.testing.assert_allclose(nsc.P.numpy(), nsd.P.numpy(), atol=2e-3)
    _landmarks_close(pvc, pvd)
    np.testing.assert_allclose(float(cost_vc), float(cost_vd), rtol=1e-2)
