"""Parity of the port's tracking solvers with the JAX package on identical
observations: the factors, pose_only_visual and pose_only_vi (with H_marg).

Tolerances: factors to rtol 1e-4 (float32 evaluation of the same closed
forms); optimized poses to 1e-4 m / 1e-4 rad after 20 LM iterations (both
sides run the same accept/reject sequence; float32 normal equations
summed in another order move the accepted steps by far less than that);
H_marg to rtol 1e-3 plus 1e-3 of its largest entry (a Schur complement of
15x15 blocks whose entries span 1e2..1e9, so float32 cancellation sets the
absolute floor)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import euroc_camera as j_euroc
from mc_slam_tpu.imu import navstate as jnav, preintegration as jpre
from mc_slam_tpu.solver import ba as jba, ba_vi as jbavi, factors as jfac, lm as jlm
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import euroc_camera as t_euroc
from mc_slam_tpu_torch.imu import navstate as tnav, preintegration as tpre
from mc_slam_tpu_torch.solver import ba as tba, ba_vi as tbavi, factors as tfac, \
    lm as tlm

torch.set_num_threads(2)

TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _scene(seed, n_obs=300, n_out=30):
    """Body pose, world points seen by the EuRoC camera, noisy pixel
    observations with some gross outliers; P/R truth and a perturbed start."""
    rng = np.random.default_rng(seed)
    ext = jfac.extrinsics_from_Tbc(TBC)
    cam = j_euroc()
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32)))
    P = rng.normal(size=3).astype(np.float32)
    Xc = np.concatenate([rng.uniform(-2, 2, (n_obs, 2)), rng.uniform(2, 8, (n_obs, 1))], 1)
    Rbc = np.asarray(ext.Rcb).T
    pbc = -Rbc @ np.asarray(ext.tcb)
    Xw = ((R @ (Rbc @ Xc.T + pbc[:, None])).T + P).astype(np.float32)
    uv, _ = jfac._project_ideal(cam, jnp.asarray(Xc, jnp.float32))
    uv = np.asarray(uv) + rng.normal(size=(n_obs, 2)) * 0.5
    uv[:n_out] += rng.uniform(-40, 40, (n_out, 2))
    level = rng.integers(0, 4, n_obs)
    obs = dict(cam=np.zeros(n_obs, np.int32), pt=np.arange(n_obs, dtype=np.int32),
               uv=uv.astype(np.float32),
               inv_sigma2=(1.0 / 1.2 ** (2.0 * level)).astype(np.float32),
               valid=(rng.random(n_obs) < 0.95).astype(np.float32))
    dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.01, jnp.float32)))
    P0 = (P + rng.normal(size=3) * 0.03).astype(np.float32)
    return dict(P=P, R=R, P0=P0, R0=(R @ dR).astype(np.float32), Xw=Xw, obs=obs)


def _port_obs(obs):
    return tba.VisualObs(cam=_t(obs["cam"], torch.int64), pt=_t(obs["pt"], torch.int64),
                         uv=_t(obs["uv"]), inv_sigma2=_t(obs["inv_sigma2"]),
                         valid=_t(obs["valid"]))


def _rot_err(Ra, Rb):
    return float(np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(Ra.T @ Rb)))))


@pytest.mark.parametrize("name", ["huber_weight", "huber_cost", "trunc_huber_cost",
                                  "trunc_huber_weight"])
def test_robust_kernels(name):
    chi2 = np.concatenate([np.linspace(0, 10, 50), np.geomspace(10, 1e5, 50)]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(getattr(jlm, name)(jnp.asarray(chi2), 5.991)),
                               getattr(tlm, name)(torch.from_numpy(chi2), 5.991).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_reproj_factor():
    s = _scene(0)
    r_j = jfac.reproj_xyz(j_euroc(), jfac.extrinsics_from_Tbc(TBC), jnp.asarray(s["P0"]),
                          jnp.asarray(s["R0"]), jnp.asarray(s["Xw"]),
                          jnp.asarray(s["obs"]["uv"]))
    r_t = tfac.reproj_xyz(t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"), _t(s["P0"]),
                          _t(s["R0"]), _t(s["Xw"]), _t(s["obs"]["uv"]))
    for a, b in zip(r_j, r_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4, atol=1e-3)


def _imu_setup(seed):
    """(ns_last, ns_cur0, preint, gw) with a 10-row preintegration."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((256, 7), np.float32)
    rows[:10, 0:3] = rng.normal(size=(10, 3)) * 0.3
    rows[:10, 3:6] = rng.normal(size=(10, 3)) * 0.5 + np.array([0, 0, 9.81])
    rows[:10, 6] = 0.005
    z3 = np.zeros(3, np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32)))
    ns_last = jnav.NavState(P=rng.normal(size=3).astype(np.float32),
                            V=rng.normal(size=3).astype(np.float32), R=R,
                            bg=np.array([0.003, -0.004, 0.003], np.float32),
                            ba=np.array([0.03, -0.02, 0.06], np.float32),
                            dbg=z3, dba=z3)
    pre = jpre.preintegrate(jnp.asarray(rows), jnp.asarray(ns_last.bg),
                            jnp.asarray(ns_last.ba), jpre.euroc_noise())
    gw = jnp.asarray([0.0, 0.0, -9.81])
    ns_cur0 = _np(jpre.predict_navstate(ns_last, pre, gw))
    return ns_last, ns_cur0, _np(pre), gw


def test_imu_factors():
    ns_last, ns_cur0, pre, gw = _imu_setup(1)
    ns_cur = ns_cur0._replace(P=ns_cur0.P + 0.01, dbg=ns_cur0.dbg + 1e-3)
    args_j = (ns_last.P, ns_last.R, ns_last.V, ns_last.dbg + 1e-3, ns_last.dba,
              ns_cur.P, ns_cur.R, ns_cur.V)
    out_j = jfac.imu_prv(*[jnp.asarray(a) for a in args_j], jpre.PreintState(
        *[jnp.asarray(a) for a in pre]), gw)
    out_t = tfac.imu_prv(*[_t(a) for a in args_j],
                         convert.to_torch(tpre.PreintState, pre, "cpu"), _t(gw))
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4, atol=1e-4)
    ij = np.asarray(jfac.imu_prv_info(jpre.PreintState(*[jnp.asarray(a) for a in pre])))
    it = tfac.imu_prv_info(convert.to_torch(tpre.PreintState, pre, "cpu")).numpy()
    np.testing.assert_allclose(ij, it, rtol=1e-3, atol=1e-3 * np.abs(ij).max())
    np.testing.assert_allclose(
        np.asarray(jfac.bias_rw_info(jnp.asarray(pre.dT), 2e-5, 5e-3)),
        tfac.bias_rw_info(_t(pre.dT), 2e-5, 5e-3).numpy(), rtol=1e-6)
    rp_j = jfac.prior_pr_v_bias(*[jnp.asarray(a) for a in (
        ns_cur.P, ns_cur.R, ns_cur.V, ns_cur.dbg, ns_cur.dba,
        ns_last.P, ns_last.R, ns_last.V, ns_last.dbg, ns_last.dba)])
    rp_t = tfac.prior_pr_v_bias(*[_t(a) for a in (
        ns_cur.P, ns_cur.R, ns_cur.V, ns_cur.dbg, ns_cur.dba,
        ns_last.P, ns_last.R, ns_last.V, ns_last.dbg, ns_last.dba)])
    for a, b in zip(rp_j, rp_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_pose_only_visual(seed):
    s = _scene(seed)
    jobs = jba.VisualObs(**{k: jnp.asarray(v) for k, v in s["obs"].items()})
    Pj, Rj, chi2j, nj = jba.pose_only_visual(
        jnp.asarray(s["P0"]), jnp.asarray(s["R0"]), jnp.asarray(s["Xw"]), jobs,
        j_euroc(), jfac.extrinsics_from_Tbc(TBC), iters=20)
    Pt, Rt, chi2t, nt = tba.pose_only_visual(
        _t(s["P0"]), _t(s["R0"]), _t(s["Xw"]), _port_obs(s["obs"]), t_euroc(device="cpu"),
        tfac.extrinsics_from_Tbc(TBC, device="cpu"), iters=20)
    assert np.abs(np.asarray(Pj) - Pt.numpy()).max() < 1e-4
    assert _rot_err(np.asarray(Rj), Rt.numpy()) < 1e-4
    assert abs(int(nj) - int(nt)) <= 1
    assert np.abs(np.asarray(Pj) - s["P"]).max() < 0.01      # it did converge


@pytest.mark.parametrize("compute_marg", [False, True])
def test_pose_only_vi(compute_marg):
    ns_last, ns_cur0, pre, gw = _imu_setup(4)
    s = _scene(5)
    # put the scene at the predicted current pose
    Rc, Pc = np.asarray(ns_cur0.R), np.asarray(ns_cur0.P)
    Xw = ((Rc @ s["R"].T @ (s["Xw"] - s["P"]).T).T + Pc).astype(np.float32)
    ns_start = ns_cur0._replace(P=(Pc + 0.02).astype(np.float32))
    prior_info = np.diag(np.r_[np.full(9, 1e3), np.full(3, 1e6), np.full(3, 1e4)]
                         ).astype(np.float32)
    jpre_t = jpre.PreintState(*[jnp.asarray(a) for a in pre])
    info_prv = jfac.imu_prv_info(jpre_t)
    info_bias = jfac.bias_rw_info(jpre_t.dT, 2e-5, 5e-3)
    jprior = jbavi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=ns_last,
                               info=jnp.asarray(prior_info), valid=jnp.asarray(1.0))
    jobs = jba.VisualObs(**{k: jnp.asarray(v) for k, v in s["obs"].items()})
    nsj, chi2j, nj, Hj = jbavi.pose_only_vi(
        ns_start, ns_last, jpre_t, jnp.asarray(Xw), jobs, j_euroc(),
        jfac.extrinsics_from_Tbc(TBC), gw, jprior, info_prv, info_bias, iters=20,
        compute_marg=compute_marg)
    t_last = convert.to_torch(tnav.NavState, ns_last, "cpu")
    tprior = tbavi.PriorFactor(cam=torch.zeros((), dtype=torch.int64), ns0=t_last,
                               info=_t(prior_info), valid=torch.ones(()))
    tpre_t = convert.to_torch(tpre.PreintState, pre, "cpu")
    nst, chi2t, nt, Ht = tbavi.pose_only_vi(
        convert.to_torch(tnav.NavState, ns_start, "cpu"), t_last, tpre_t, _t(Xw),
        _port_obs(s["obs"]), t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"), _t(gw), tprior,
        tfac.imu_prv_info(tpre_t), tfac.bias_rw_info(tpre_t.dT, 2e-5, 5e-3), iters=20,
        compute_marg=compute_marg)
    assert np.abs(np.asarray(nsj.P) - nst.P.numpy()).max() < 1e-4
    assert _rot_err(np.asarray(nsj.R), nst.R.numpy()) < 1e-4
    assert np.abs(np.asarray(nsj.V) - nst.V.numpy()).max() < 1e-3
    assert abs(int(nj) - int(nt)) <= 1
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Hj, Ht.numpy(), rtol=1e-3,
                               atol=1e-3 * max(np.abs(Hj).max(), 1.0))
    if compute_marg:
        assert np.abs(Hj).max() > 0


def test_cho_solve_nan_on_indefinite():
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    x = tlm.cho_solve_nan(A, torch.ones(2))
    assert torch.isnan(x).all()
    assert torch.allclose(tlm.cho_solve_nan(torch.eye(2) * 2, torch.ones(2)),
                          torch.full((2,), 0.5))


def _curve_fit_fns(lib, x, y):
    """y ~ a exp(b x): (linearize_solve, retract, cost_fn, linearize, solve)
    written once per library with the same arithmetic."""
    def resid_jac(p):
        e = lib.exp(p[1] * x)
        r = p[0] * e - y
        J = lib.stack([e, p[0] * x * e], -1)
        return r, J

    def cost_fn(p):
        r, _ = resid_jac(p)
        return lib.sum(r * r)

    def solve(lin, lam):
        H, g = lin
        return -(g / (lib.diagonal(H) * (1.0 + lam) + 1e-9))   # diagonal LM step

    def linearize(p):
        r, J = resid_jac(p)
        return (J.T @ J, J.T @ r), lib.sum(r * r)

    return (lambda p, lam: solve(linearize(p)[0], lam), lambda p, dp: p + dp,
            cost_fn, linearize, solve)


@pytest.mark.parametrize("mode", ["plain", "rtol", "fused"])
def test_lm_loops(mode):
    xs = np.linspace(0, 1, 40).astype(np.float32)
    ys = (2.0 * np.exp(-1.3 * xs) + np.random.default_rng(8).normal(size=40) * 0.01
          ).astype(np.float32)
    p0 = np.array([1.0, 0.0], np.float32)
    fj = _curve_fit_fns(jnp, jnp.asarray(xs), jnp.asarray(ys))
    ft = _curve_fit_fns(torch, torch.from_numpy(xs), torch.from_numpy(ys))
    if mode == "fused":
        pj, cj, _ = jlm.lm_optimize_fused(jnp.asarray(p0), fj[3], fj[4], fj[1], 30)
        pt, ct, _ = tlm.lm_optimize_fused(torch.from_numpy(p0), ft[3], ft[4], ft[1], 30)
    else:
        rtol = 1e-3 if mode == "rtol" else 0.0
        pj, cj, _ = jlm.lm_optimize(jnp.asarray(p0), *fj[:3], 30, rtol=rtol)
        pt, ct, _ = tlm.lm_optimize(torch.from_numpy(p0), *ft[:3], 30, rtol=rtol)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(cj), float(ct), rtol=1e-3)
    assert float(ct) < 0.05
