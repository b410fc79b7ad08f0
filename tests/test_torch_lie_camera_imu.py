"""Parity of the port's lie / camera / IMU modules with the JAX package.

Same numpy inputs through both; float outputs agree to rtol 1e-5, atol 1e-6
(float32 evaluation of the same formulas; only the operation order inside
fused XLA kernels differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import camera as jcam, lie as jlie
from mc_slam_tpu.imu import navstate as jnav, preintegration as jpre
from mc_slam_tpu_torch import camera as tcam, convert, lie as tlie
from mc_slam_tpu_torch.imu import navstate as tnav, preintegration as tpre

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy()
                               if isinstance(b, torch.Tensor) else np.asarray(b),
                               rtol=rtol, atol=atol)


def _phis(seed=0):
    """Rotation vectors: random, tiny (Taylor branch) and exactly zero."""
    rng = np.random.default_rng(seed)
    big = rng.normal(size=(64, 3)) * 0.8
    small = rng.normal(size=(16, 3)) * 1e-8
    return np.concatenate([big, small, np.zeros((1, 3))]).astype(np.float32)


@pytest.mark.parametrize("name", ["hat", "so3_exp", "so3_jr", "so3_jr_inv"])
def test_so3_maps(name):
    phi = _phis()
    _close(getattr(jlie, name)(jnp.asarray(phi)),
           getattr(tlie, name)(torch.from_numpy(phi)))


def test_so3_log_quat_normalize():
    phi = _phis(1)
    R = np.array(jlie.so3_exp(jnp.asarray(phi)))
    _close(jlie.so3_log(jnp.asarray(R)), tlie.so3_log(torch.from_numpy(R)))
    _close(jlie.so3_to_quat(jnp.asarray(R)), tlie.so3_to_quat(torch.from_numpy(R)))
    noisy = (R + np.random.default_rng(2).normal(size=R.shape) * 1e-3).astype(np.float32)
    _close(jlie.so3_normalize_fast(jnp.asarray(noisy)),
           tlie.so3_normalize_fast(torch.from_numpy(noisy)))


def _uv(seed=4, n=500):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 752, n), rng.uniform(0, 480, n)], -1).astype(np.float32)


def test_undistort_points():
    uv = _uv()
    _close(jcam.undistort_points(jcam.euroc_camera(), jnp.asarray(uv)),
           tcam.undistort_points(tcam.euroc_camera(device="cpu"), torch.from_numpy(uv)),
           rtol=1e-5, atol=1e-3)   # pixels: 1e-3 px is ~ulp(752) * 16


def test_distort_project_jacobian():
    rng = np.random.default_rng(5)
    Xc = np.concatenate([rng.normal(size=(200, 2)), rng.uniform(0.5, 8, (200, 1))],
                        -1).astype(np.float32)
    jc, tc = jcam.euroc_camera(), tcam.euroc_camera(device="cpu")
    xn = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    _close(jcam.distort(jc, jnp.asarray(xn)), tcam.distort(tc, torch.from_numpy(xn)))
    for dist in (False, True):
        uj, zj = jcam.project(jc, jnp.asarray(Xc), distortion=dist)
        ut, zt = tcam.project(tc, torch.from_numpy(Xc), distortion=dist)
        _close(uj, ut, atol=1e-3)
        _close(zj, zt)
    _close(jcam.project_jacobian(jc, jnp.asarray(Xc)),
           tcam.project_jacobian(tc, torch.from_numpy(Xc)), atol=1e-3)


def _imu_rows(seed, T=10):
    rng = np.random.default_rng(seed)
    rows = np.zeros((T, 7), np.float32)
    rows[:, 0:3] = rng.normal(size=(T, 3)) * 0.5
    rows[:, 3:6] = rng.normal(size=(T, 3)) + np.array([0, 0, 9.81])
    rows[:, 6] = 0.005
    return rows


def _jax_preint(rows, bg, ba, T_pad=256):
    padded = np.zeros((T_pad, 7), np.float32)
    padded[:len(rows)] = rows
    return jpre.preintegrate(jnp.asarray(padded), jnp.asarray(bg), jnp.asarray(ba),
                             jpre.euroc_noise())


@pytest.mark.parametrize("seed", [0, 1])
def test_preintegrate_matches_padded_jax(seed):
    rows = _imu_rows(seed)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.05, -0.03], np.float32)
    pj = _jax_preint(rows, bg, ba)
    pt = tpre.preintegrate(torch.from_numpy(rows), torch.from_numpy(bg),
                           torch.from_numpy(ba), tpre.euroc_noise(device="cpu"))
    for f in tpre.PreintState._fields:
        # cov entries are ~1e-12..1e-8: compare them relative to their scale
        atol = ATOL if f != "cov" else 1e-5 * float(np.abs(np.asarray(pj.cov)).max())
        _close(getattr(pj, f), getattr(pt, f), atol=atol)


def test_preintegrate_padding_rows_are_noops():
    """The JAX package scans 256 zero-padded rows; the port loops over the
    rows it is given. A dt == 0 row changes nothing beyond the last-ulp
    rounding of the Gram-Schmidt re-orthonormalization of dR."""
    rows = _imu_rows(7)
    padded = np.zeros((40, 7), np.float32)
    padded[:len(rows)] = rows
    z = torch.zeros(3)
    a = tpre.preintegrate(torch.from_numpy(rows), z, z, tpre.euroc_noise(device="cpu"))
    b = tpre.preintegrate(torch.from_numpy(padded), z, z, tpre.euroc_noise(device="cpu"))
    for f in tpre.PreintState._fields:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=1e-6, atol=1e-7)


def test_predict_navstate():
    rows = _imu_rows(8)
    z3 = np.zeros(3, np.float32)
    pj = _jax_preint(rows, z3, z3)
    rng = np.random.default_rng(9)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    ns = dict(P=rng.normal(size=3), V=rng.normal(size=3), R=R, bg=z3, ba=z3,
              dbg=rng.normal(size=3) * 1e-3, dba=rng.normal(size=3) * 1e-2)
    ns = {k: np.asarray(v, np.float32) for k, v in ns.items()}
    gw = np.array([0, 0, -9.81], np.float32)
    out_j = jpre.predict_navstate(jnav.NavState(**ns), pj, jnp.asarray(gw))
    pre_np = jax.tree_util.tree_map(np.asarray, pj)
    out_t = tpre.predict_navstate(convert.to_torch(tnav.NavState, ns, "cpu"),
                                  convert.to_torch(tpre.PreintState, pre_np, "cpu"),
                                  torch.from_numpy(gw))
    for f in ("P", "V", "R"):
        _close(getattr(out_j, f), getattr(out_t, f), atol=1e-5)
