"""Parity of the port's VI initialization with the JAX package on the
fixtures of tests/test_vi_solver.py (keyframes on the analytic arc, exact IMU
with injected biases, preintegrated at zero bias): the gyro-bias factor, each
of the four steps, the whole `try_init_vio`, and padding invariance.

Tolerances: `gyr_bias` residual and Jacobian 1e-5. Gyro bias 1e-4 rad/s,
scale 1e-3 relative, gravity 1e-3 of its magnitude (1e-2 m/s^2), accelerometer
bias 2e-3 m/s^2 (the worst-observed direction of a normal-equation solve in
float32: condition numbers here are 60-120, squared by A^T A), velocities
1e-3 m/s, singular values of C within a factor 2 (the smallest comes from
eigvalsh of A^T A, which float32 resolves to ~sqrt(eps) of the largest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from mc_slam_tpu.pipeline import viinit as jvi
from mc_slam_tpu.solver import factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.imu.preintegration import PreintState
from mc_slam_tpu_torch.pipeline import viinit as tvi
from mc_slam_tpu_torch.solver import factors as tfac

from test_vi_solver import build_vi_window
from torch_port_helpers import TBC_EXT

torch.set_num_threads(2)
_t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)


def _window(N_kf, kf_dt, bg=np.zeros(3), ba=np.zeros(3), scale=1.0, ext=False):
    """(Pwc, Rwc, pre, valid, Rcb, pcb) as numpy / a numpy PreintState. With
    `ext`, the keyframes are BODY poses and the camera sits at EuRoC's Tbc."""
    kfs, pre, _, _ = build_vi_window(np.random.default_rng(0), N_kf=N_kf, kf_dt=kf_dt,
                                     noise_px=0.0, bg=bg, ba_=ba)
    P = np.stack([k[1] for k in kfs])
    R = np.stack([k[2] for k in kfs])
    Rcb, pcb = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    if ext:
        Rcb, pcb = TBC_EXT
        Rbc = Rcb.T
        pbc = -Rbc @ pcb
        P, R = P + R @ pbc, R @ Rbc
    valid = np.asarray([0.0] + [1.0] * (N_kf - 1), np.float32)
    return ((P / scale).astype(np.float32), R.astype(np.float32),
            jax.tree_util.tree_map(np.asarray, pre), valid, Rcb, pcb)


def _tpre(pre):
    return convert.to_torch(PreintState, pre, "cpu")


def _j(*xs):
    return [jax.tree_util.tree_map(jnp.asarray, x) for x in xs]


def test_gyr_bias_factor_matches_jax(rng):
    _, R, pre, _, _, _ = _window(8, 0.3, bg=np.array([0.02, -0.01, 0.015]))
    bg = rng.normal(size=(8, 3)).astype(np.float32) * 0.02
    R_i = np.roll(R, 1, axis=0)
    r_j, J_j = jfac.gyr_bias(jnp.asarray(bg), pre.dR, pre.J_R_bg, jnp.asarray(R_i), jnp.asarray(R))
    r_t, J_t = tfac.gyr_bias(_t(bg), _t(pre.dR), _t(pre.J_R_bg), _t(R_i), _t(R))
    np.testing.assert_allclose(r_t.numpy()[1:], np.asarray(r_j)[1:], atol=1e-5)
    np.testing.assert_allclose(J_t.numpy()[1:], np.asarray(J_j)[1:], atol=1e-5)
    # and the Jacobian is the derivative of the residual
    eps = 1e-3
    for a in range(3):
        d = np.zeros(3, np.float32)
        d[a] = eps
        r2, _ = tfac.gyr_bias(_t(bg + d), _t(pre.dR), _t(pre.J_R_bg), _t(R_i), _t(R))
        np.testing.assert_allclose(((r2 - r_t) / eps).numpy()[1:], J_t.numpy()[1:, :, a], atol=5e-3)


def test_estimate_gyro_bias_matches_jax():
    bg_true = np.array([0.02, -0.01, 0.015], np.float32)
    _, R, pre, valid, _, _ = _window(12, 0.5, bg=bg_true)
    ref = np.asarray(jvi.estimate_gyro_bias(jnp.asarray(R), pre, jnp.asarray(valid)))
    got = tvi.estimate_gyro_bias(_t(R), _tpre(pre), _t(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, bg_true, atol=1e-3)


@pytest.mark.parametrize("ext", [False, True])
def test_scale_gravity_and_refinement_match_jax(ext):
    ba_true = np.array([0.05, -0.08, 0.06], np.float32)
    P, R, pre, valid, Rcb, pcb = _window(20, 0.4, ba=ba_true, scale=2.5, ext=ext)
    args_j = _j(P, R, pre, valid, Rcb, pcb)
    args_t = [_t(P), _t(R), _tpre(pre), _t(valid), _t(Rcb), _t(pcb)]
    s_j, g_j = jvi.estimate_scale_gravity(*args_j)
    s_t, g_t = tvi.estimate_scale_gravity(*args_t)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-3)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-2)
    ref = jvi.refine_gravity_accbias(*args_j, g_j, synth.G)
    got = tvi.refine_gravity_accbias(*args_t, _t(g_j), synth.G)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-2)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-3)
    sv_t, sv_j = got[4].numpy(), np.asarray(ref[4])
    assert sv_t.shape == (6,) and np.all(np.diff(sv_t) <= 0)      # descending, as lstsq's
    assert np.all(sv_t < 2 * sv_j) and np.all(sv_j < 2 * sv_t)
    np.testing.assert_allclose(float(got[0]), 2.5, rtol=0.05)
    np.testing.assert_allclose(got[2].numpy(), synth.GW, atol=0.15)


def test_velocities_match_jax():
    P, R, pre, valid, Rcb, pcb = _window(10, 0.3, ext=True)
    gw, ba = np.asarray(synth.GW, np.float32), np.array([0.01, -0.02, 0.03], np.float32)
    ref = np.asarray(jvi.compute_velocities(*_j(P, R, pre, valid, Rcb, pcb),
                                            jnp.asarray(1.0), jnp.asarray(gw), jnp.asarray(ba)))
    got = tvi.compute_velocities(_t(P), _t(R), _tpre(pre), _t(valid), _t(Rcb), _t(pcb),
                                 torch.tensor(1.0), _t(gw), _t(ba)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    Pb, Rb, V = tvi.apply_init_to_navstates(_t(P), _t(R), _t(Rcb), _t(pcb), torch.tensor(2.0),
                                            None, None, _t(got))
    Pj, Rj, _ = jvi.apply_init_to_navstates(*_j(P, R, Rcb, pcb), jnp.asarray(2.0), None, None,
                                            jnp.asarray(ref))
    np.testing.assert_allclose(Pb.numpy(), np.asarray(Pj), atol=1e-5)
    np.testing.assert_allclose(Rb.numpy(), np.asarray(Rj), atol=1e-6)


@pytest.mark.parametrize("ext", [False, True])
def test_try_init_vio_matches_jax(ext):
    bg_true = np.array([0.015, -0.02, 0.01], np.float32)
    ba_true = np.array([0.05, -0.08, 0.06], np.float32)
    P, R, pre, valid, Rcb, pcb = _window(20, 0.4, bg=bg_true, ba=ba_true, scale=2.5, ext=ext)
    ref = jvi.try_init_vio(*_j(P, R, pre, valid, Rcb, pcb), g_mag=synth.G)
    got = tvi.try_init_vio(_t(P), _t(R), _tpre(pre), _t(valid), _t(Rcb), _t(pcb), g_mag=synth.G)
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(ref.bg), atol=1e-4)
    np.testing.assert_allclose(float(got.scale), float(ref.scale), rtol=1e-3)
    np.testing.assert_allclose(float(got.scale_star), float(ref.scale_star), rtol=1e-3)
    np.testing.assert_allclose(got.gw.numpy(), np.asarray(ref.gw), atol=1e-2)
    np.testing.assert_allclose(got.ba.numpy(), np.asarray(ref.ba), atol=2e-3)
    np.testing.assert_allclose(got.Rwi.numpy(), np.asarray(ref.Rwi), atol=1e-3)
    sv_t, sv_j = got.cond.numpy(), np.asarray(ref.cond)
    cond_t, cond_j = sv_t[0] / sv_t[-1], sv_j[0] / sv_j[-1]
    assert 0.5 < cond_t / cond_j < 2.0 and cond_t < 5e4         # the gate's decision agrees
    # and against the truth, by the JAX test's own gates
    np.testing.assert_allclose(got.bg.numpy(), bg_true, atol=2e-3)
    np.testing.assert_allclose(float(got.scale), 2.5, rtol=0.05)
    np.testing.assert_allclose(got.gw.numpy(), synth.GW, atol=0.15)
    np.testing.assert_allclose(got.ba.numpy(), ba_true, atol=0.05)


def test_padded_init_matches_unpadded():
    """Padding the window with masked copies of the last keyframe changes
    nothing in the port either (test_padded_init_matches_unpadded)."""
    P, R, pre, valid, Rcb, pcb = _window(14, 0.4, bg=np.array([0.01, -0.015, 0.02]),
                                         scale=2.0, ext=True)
    pad = 6
    dup = lambda a: np.concatenate([a, np.broadcast_to(a[-1], (pad,) + a.shape[1:])], 0)
    pre_p = jax.tree_util.tree_map(dup, pre)
    valid_p = np.concatenate([valid, np.zeros(pad, np.float32)])
    a = tvi.try_init_vio(_t(P), _t(R), _tpre(pre), _t(valid), _t(Rcb), _t(pcb), g_mag=synth.G)
    b = tvi.try_init_vio(_t(dup(P)), _t(dup(R)), _tpre(pre_p), _t(valid_p), _t(Rcb), _t(pcb),
                         g_mag=synth.G)
    for u, v, name in zip(a, b, a._fields):
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    V = tvi.compute_velocities(_t(P), _t(R), _tpre(pre), _t(valid), _t(Rcb), _t(pcb),
                               a.scale, a.gw, a.ba)
    V_p = tvi.compute_velocities(_t(dup(P)), _t(dup(R)), _tpre(pre_p), _t(valid_p), _t(Rcb),
                                 _t(pcb), b.scale, b.gw, b.ba)
    np.testing.assert_allclose(V_p.numpy()[:14], V.numpy(), rtol=1e-4, atol=1e-5)


def test_singular_solve_gives_nonfinite_not_an_exception():
    """All keyframes masked: A^T A = 0. JAX's solve returns inf / NaN; the
    port's solve_ex does too and never raises."""
    P, R, pre, valid, Rcb, pcb = _window(6, 0.4)
    none = np.zeros_like(valid)
    ref = jvi.try_init_vio(*_j(P, R, pre, none, Rcb, pcb), g_mag=synth.G)
    got = tvi.try_init_vio(_t(P), _t(R), _tpre(pre), _t(none), _t(Rcb), _t(pcb), g_mag=synth.G)
    assert not np.isfinite(float(ref.scale)) and not np.isfinite(float(got.scale))
