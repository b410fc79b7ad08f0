"""Parity of the port's Sim(3) group and Sim3 reprojection factor with the JAX
package (mc_slam_tpu/lie.py:229-321, solver/factors.py:315) on the CPU: the
same numpy-seeded inputs through both, float32, tolerances stated per test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.solver import factors as jfac
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.solver import factors as tfac
from mc_slam_tpu_torch.solver import posegraph as tpg

ATOL = 1e-5


def _xi(rng, n=48):
    """sim(3) elements covering every branch: general, zero, tiny angle, tiny
    log-scale, both tiny."""
    xi = rng.normal(size=(n, 7)).astype(np.float32) * [1, 1, 1, 0.6, 0.6, 0.6, 0.3]
    xi = xi.astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:6] = 1e-8
    xi[2, 6] = 1e-9
    xi[3, 3:] = 0.0
    xi[4, 3:6] = 0.0
    return xi


def _both(xi):
    j = jlie.sim3_exp(jnp.asarray(xi))
    t = tlie.sim3_exp(torch.from_numpy(xi))
    return j, t


def _close(t, j, atol=ATOL):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=1e-5)


def test_sim3_exp_matches_jax(rng):
    j, t = _both(_xi(rng))
    _close(t, j)


def test_sim3_log_matches_jax_and_inverts_exp(rng):
    xi = _xi(rng)
    j, t = _both(xi)
    got = tlie.sim3_log(*t).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.sim3_log(*j)), atol=ATOL)
    np.testing.assert_allclose(got, xi, atol=2e-5)


def test_sim3_inv_mul_apply_match_jax(rng):
    (ja, ta), (jb, tb) = _both(_xi(rng)), _both(_xi(rng))
    _close(tlie.sim3_inv(*ta), jlie.sim3_inv(*ja))
    _close(tlie.sim3_mul(*ta, *tb), jlie.sim3_mul(*ja, *jb))
    x = rng.normal(size=(48, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.sim3_apply(*ta, torch.from_numpy(x)).numpy(),
                               np.asarray(jlie.sim3_apply(*ja, jnp.asarray(x))), atol=ATOL)


def test_sim3_adjoint_matches_jax(rng):
    j, t = _both(_xi(rng))
    np.testing.assert_allclose(tlie.sim3_adjoint(*t).numpy(),
                               np.asarray(jlie.sim3_adjoint(*j)), atol=ATOL)


def test_sim3_log_of_a_singular_w_is_nan_not_an_exception():
    # s = 0 is no member of the group: log gives -inf / NaN and must not raise
    out = tlie.sim3_log(torch.zeros(()), torch.eye(3), torch.ones(3))
    assert not torch.isfinite(out).all()


def test_sim3_ad_and_left_jacobian_are_consistent_with_exp(rng):
    """The closed forms the pose graph's Jacobians rest on, in float64:
    Ad(Exp(xi)) = expm(ad(xi)) to first order, and log(Exp(d) Exp(xi)) =
    xi + Jl^{-1}(xi) d by central differences (1e-6)."""
    xi = torch.from_numpy(_xi(rng, 12)[5:].astype(np.float64))
    eps = 1e-6
    Jl_inv = tpg.sim3_jl_inv(xi)
    fd = torch.zeros_like(Jl_inv)
    S = tlie.sim3_exp(xi)
    for k in range(7):
        d = torch.zeros_like(xi)
        d[:, k] = eps
        plus = tlie.sim3_log(*tlie.sim3_mul(*tlie.sim3_exp(d), *S))
        minus = tlie.sim3_log(*tlie.sim3_mul(*tlie.sim3_exp(-d), *S))
        fd[:, :, k] = (plus - minus) / (2 * eps)
    np.testing.assert_allclose(Jl_inv.numpy(), fd.numpy(), atol=1e-6)
    small = 1e-4 * xi
    Ad = tlie.sim3_adjoint(*tlie.sim3_exp(small))
    np.testing.assert_allclose(Ad.numpy(), (torch.eye(7, dtype=torch.float64)
                                            + tpg.sim3_ad(small)).numpy(), atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_sim3_reproj_matches_jax(rng, batched):
    """Residual, Jacobian (1e-4 relative to its scale) and depth; the port's
    form also takes (C,) transforms against shared (N, 3) points."""
    n = 40
    Pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], 1).astype(np.float32)
    uv = rng.uniform(0, 480, size=(n, 2)).astype(np.float32)
    xi = _xi(rng, 8)[5:] * np.float32(0.3)
    jc = j_make_camera(400.0, 400.0, 320.0, 240.0)
    tc = make_camera(400.0, 400.0, 320.0, 240.0, device="cpu")
    S_j, S_t = _both(xi)
    if batched:
        r, J, z = tfac.sim3_reproj(tc, *S_t, torch.from_numpy(Pc), torch.from_numpy(uv))
        assert r.shape == (3, n, 2) and J.shape == (3, n, 2, 7)
    for c in range(3):
        rj, Jj, zj = jfac.sim3_reproj(jc, S_j[0][c], S_j[1][c], S_j[2][c], jnp.asarray(Pc),
                                      jnp.asarray(uv))
        if batched:
            rt, Jt, zt = r[c], J[c], z[c]
        else:
            rt, Jt, zt = tfac.sim3_reproj(tc, S_t[0][c], S_t[1][c], S_t[2][c],
                                          torch.from_numpy(Pc), torch.from_numpy(uv))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(Jj)).max()))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
