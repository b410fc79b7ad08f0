"""Parity of the port's PnP RANSAC, Horn Sim3 RANSAC and pixel-space Sim3
refinement with the JAX package (geometry/pnp.py, geometry/sim3solver.py,
solver/sim3opt.py) on the CPU, on the cases of tests/test_geometry.py and
tests/test_sim3opt.py. The RANSAC sample indices are the ones the JAX call
draws from its key (`jax_samples`), given to the port as an argument, so both
sides score the same hypotheses; the SELECTED result is compared (pose 1e-4,
inlier masks exact away from the gate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.geometry import pnp as jpnp
from mc_slam_tpu.geometry import sim3solver as jsim3
from mc_slam_tpu.solver.sim3opt import optimize_sim3 as j_optimize_sim3
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.geometry import pnp as tpnp
from mc_slam_tpu_torch.geometry import sim3solver as tsim3
from mc_slam_tpu_torch.solver.sim3opt import optimize_sim3 as t_optimize_sim3
from torch_port_helpers import jax_samples

FOCAL = 400.0
T = torch.from_numpy


def _rot(v):
    return np.asarray(jlie.so3_exp(jnp.asarray(v, jnp.float32)), np.float32)


def _pnp_case(rng, n=120):
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 9, n)], 1).astype(np.float32)
    R, t = _rot([0.1, 0.2, -0.05]), np.array([0.3, -0.2, 0.5], np.float32)
    Xc = (R @ pts.T).T + t
    xn = Xc[:, :2] / Xc[:, 2:3]
    xn += rng.normal(size=xn.shape) * 0.3 / FOCAL
    bad = rng.choice(n, n // 4, replace=False)
    xn[bad] += rng.uniform(0.05, 0.2, size=(len(bad), 2)) * np.sign(
        rng.normal(size=(len(bad), 2)))
    w = np.ones(n, np.float32)
    w[rng.choice(n, 6, replace=False)] = 0.0
    return pts, xn.astype(np.float32), w, R, t, bad


def test_dlt_pnp_matches_jax(rng):
    """Noise-free 6- and 12-point problems: both sides recover the pose (the
    null vector's sign is fixed by the determinant), equal to 1e-4."""
    pts, _, _, R, t, _ = _pnp_case(rng)
    Xc = (R @ pts.T).T + t
    xn = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    for M in (6, 12):
        idx = np.stack([rng.choice(len(pts), M, replace=False) for _ in range(16)])
        Rj, tj = jpnp._dlt_pnp(jnp.asarray(pts[idx]), jnp.asarray(xn[idx]))
        Rt, tt = tpnp._dlt_pnp(T(pts[idx]), T(xn[idx]))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)
        np.testing.assert_allclose(Rt.numpy(), np.broadcast_to(R, Rt.shape), atol=5e-3)
        np.testing.assert_allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-4)
    # weighted rows: zero-weight rows drop out on both sides
    wts = np.ones((16, 12), np.float32)
    wts[:, 8:] = 0.0
    bad = xn[idx].copy()
    bad[:, 8:] += 0.3
    Rj, tj = jpnp._dlt_pnp(jnp.asarray(pts[idx]), jnp.asarray(bad), jnp.asarray(wts))
    Rt, tt = tpnp._dlt_pnp(T(pts[idx]), T(bad), T(wts))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)


@pytest.mark.parametrize("seed", [0, 5])
def test_pnp_ransac_matches_jax_on_the_same_samples(rng, seed):
    pts, xn, w, R, t, bad = _pnp_case(rng)
    key = jax.random.PRNGKey(seed)
    ref = jpnp.pnp_ransac(key, jnp.asarray(pts), jnp.asarray(xn), jnp.asarray(w), FOCAL)
    idx = jax_samples(key, jnp.asarray(w), 256, 6)
    got = tpnp.pnp_ransac(T(idx.astype(np.int64)), T(pts), T(xn), T(w), FOCAL)
    assert bool(got.ok) and bool(ref.ok)
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(got.R_cw.numpy(), np.asarray(ref.R_cw), atol=1e-4)
    np.testing.assert_allclose(got.t_cw.numpy(), np.asarray(ref.t_cw), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.t_cw.numpy(), t, atol=0.05)
    assert got.inliers.numpy()[bad].mean() < 0.2 and not got.inliers.numpy()[w == 0].any()


def test_pnp_ransac_batched_equals_one_by_one(rng):
    """The port's leading batch dim (the 5 relocalization candidates): each
    problem's result equals its own unbatched call, and min_inliers may be
    out of reach for one of them."""
    cases = [_pnp_case(rng) for _ in range(3)]
    g = torch.Generator().manual_seed(1)
    W = T(np.stack([c[2] for c in cases]))
    idx = tpnp.draw_samples(g, W, 64, 6)
    assert idx.shape == (3, 64, 6)
    assert all(bool((W[c][idx[c]] > 0).all()) for c in range(3))
    X, x = T(np.stack([c[0] for c in cases])), T(np.stack([c[1] for c in cases]))
    res = tpnp.pnp_ransac(idx, X, x, W, FOCAL)
    for c in range(3):
        one = tpnp.pnp_ransac(idx[c], X[c], x[c], W[c], FOCAL)
        assert int(one.n_inliers) == int(res.n_inliers[c]) and bool(res.ok[c])
        np.testing.assert_allclose(res.R_cw[c].numpy(), one.R_cw.numpy(), atol=1e-5)
        np.testing.assert_array_equal(res.inliers[c].numpy(), one.inliers.numpy())


def test_pnp_degenerate_and_singular_inputs_do_not_raise(rng):
    """A sample of one point six times (rank-deficient design matrix) loses
    to the good samples; an all-zero-weight problem has a singular
    Gauss-Newton system and gives ok = False with no exception."""
    pts, xn, w, R, t, _ = _pnp_case(rng)
    idx = jax_samples(jax.random.PRNGKey(0), jnp.asarray(w), 32, 6).astype(np.int64)
    idx[0] = idx[0, 0]
    got = tpnp.pnp_ransac(T(idx), T(pts), T(xn), T(w), FOCAL)
    assert bool(got.ok) and np.abs(got.t_cw.numpy() - t).max() < 0.05
    none = tpnp.pnp_ransac(T(idx), T(pts), T(xn), torch.zeros(len(pts)), FOCAL)
    assert not bool(none.ok) and int(none.n_inliers) == 0
    flat = tpnp.pnp_ransac(T(idx), torch.zeros_like(T(pts)), T(xn), T(w), FOCAL)
    assert not bool(flat.ok)


def _sim3_case(rng, n=80, s_true=0.7):
    pts = (rng.uniform(-2, 2, size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    R, t = _rot([-0.1, 0.25, 0.1]), np.array([1.0, 0.2, -0.4], np.float32)
    Pb = (s_true * (R @ pts.T).T + t).astype(np.float32)
    bad = rng.choice(n, n // 4, replace=False)
    Pb[bad] += rng.uniform(0.5, 2.0, size=(len(bad), 3)).astype(np.float32)
    return pts, Pb, R, t, bad


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(rng, weighted, fix_scale):
    pts, Pb, R, t, bad = _sim3_case(rng)
    w = None
    if weighted:
        w = np.ones(len(pts), np.float32)
        w[bad] = 0.0
    sj, Rj, tj = jsim3.horn_sim3(jnp.asarray(pts), jnp.asarray(Pb),
                                 None if w is None else jnp.asarray(w), fix_scale=fix_scale)
    st, Rt, tt = tsim3.horn_sim3(T(pts), T(Pb), None if w is None else T(w),
                                 fix_scale=fix_scale)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    if weighted and not fix_scale:
        np.testing.assert_allclose(float(st), 0.7, rtol=1e-4)
        np.testing.assert_allclose(Rt.numpy(), R, atol=1e-4)
    # batched 3-point samples, as RANSAC calls it
    idx = np.stack([rng.choice(len(pts), 3, replace=False) for _ in range(32)])
    sj, Rj, tj = jsim3.horn_sim3(jnp.asarray(pts[idx]), jnp.asarray(Pb[idx]),
                                 fix_scale=fix_scale)
    st, Rt, tt = tsim3.horn_sim3(T(pts[idx]), T(Pb[idx]), fix_scale=fix_scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax_on_the_same_samples(rng, fix_scale):
    pts, Pb, R, t, bad = _sim3_case(rng, s_true=1.0 if fix_scale else 0.7)
    w = np.ones(len(pts), np.float32)
    w[:5] = 0.0
    key = jax.random.PRNGKey(0)
    ref = jsim3.sim3_ransac(key, jnp.asarray(pts), jnp.asarray(Pb), jnp.asarray(w), FOCAL,
                            fix_scale=fix_scale)
    idx = jax_samples(key, jnp.asarray(w), 300, 3).astype(np.int64)
    got = tsim3.sim3_ransac(T(idx), T(pts), T(Pb), T(w), FOCAL, fix_scale=fix_scale)
    assert bool(got.ok) == bool(ref.ok) is True
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(float(got.s), float(ref.s), rtol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), t, atol=0.05)
    if fix_scale:
        assert float(got.s) == 1.0
    assert not got.inliers.numpy()[:5].any()


def test_sim3_ransac_batch_dim_bars_and_a_collinear_sample(rng):
    """Three problems at once with per-problem bars (20, 40, unreachable): each
    equals its unbatched call; a collinear 3-point sample (a repeated top
    eigenvalue, whose eigenvector is the library's choice) sits in the sample
    set and does not win."""
    cases = [_sim3_case(rng) for _ in range(3)]
    Pa, Pb = T(np.stack([c[0] for c in cases])), T(np.stack([c[1] for c in cases]))
    for c in range(3):                      # points 0, 1, 2 of each problem on one line
        Pa[c, 1] = Pa[c, 0] + torch.tensor([0.5, 0.0, 0.0])
        Pa[c, 2] = Pa[c, 0] + torch.tensor([1.0, 0.0, 0.0])
    w = torch.ones(3, Pa.shape[1])
    g = torch.Generator().manual_seed(0)
    idx = tpnp.draw_samples(g, w, 300, 3)
    idx[:, 0] = torch.tensor([0, 1, 2])
    bars = torch.tensor([20, 40, 1 << 20])
    res = tsim3.sim3_ransac(idx, Pa, Pb, w, FOCAL, min_inliers=bars)
    assert res.ok.tolist() == [True, True, False] and res.inliers.shape == (3, 80)
    for c in range(3):
        one = tsim3.sim3_ransac(idx[c], Pa[c], Pb[c], w[c], FOCAL)
        assert int(one.n_inliers) == int(res.n_inliers[c]) >= 50
        np.testing.assert_allclose(res.R[c].numpy(), one.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(res.s[c]), 0.7, rtol=0.02)


CAM_J = j_make_camera(400.0, 400.0, 320.0, 240.0)


def _opt_case(rng, n=60):
    Pc1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    s_t, R_t, t_t = 1.4, _rot([0.1, -0.2, 0.15]), np.array([0.4, -0.2, 0.3], np.float32)
    Pc2 = ((R_t.T @ (Pc1 - t_t).T).T / s_t).astype(np.float32)
    px = lambda P: np.stack([400 * P[:, 0] / P[:, 2] + 320, 400 * P[:, 1] / P[:, 2] + 240], 1)
    uv1 = (px(Pc1) + rng.normal(size=(n, 2)) * 0.3).astype(np.float32)
    uv2 = (px(Pc2) + rng.normal(size=(n, 2)) * 0.3).astype(np.float32)
    uv2[rng.choice(n, 6, replace=False)] += 50.0
    s0 = np.float32(s_t * 1.15)
    R0 = (R_t @ _rot([0.03, -0.02, 0.04])).astype(np.float32)
    t0 = (t_t + np.array([0.1, -0.05, 0.08], np.float32)).astype(np.float32)
    return (s0, R0, t0, Pc1, Pc2, uv1, uv2, np.ones(n, np.float32)), (s_t, R_t, t_t)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    """The refined Sim3 (1e-4; scale 1e-4 relative), the inlier count exact."""
    args, (s_t, R_t, t_t) = _opt_case(rng)
    cam = make_camera(400.0, 400.0, 320.0, 240.0, device="cpu")
    ref = j_optimize_sim3(*[jnp.asarray(a) for a in args], CAM_J, iters=15,
                          fix_scale=fix_scale)
    got = t_optimize_sim3(*[torch.as_tensor(a) for a in args], cam, iters=15,
                          fix_scale=fix_scale, curve=True)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=2e-4)
    assert int(got[3]) == int(ref[3])
    costs = got[4].numpy()
    assert np.all(np.diff(costs) <= 0) and costs.shape == (15,)
    if fix_scale:
        np.testing.assert_allclose(float(got[0]), float(args[0]), rtol=1e-6)
    else:
        assert abs(float(got[0]) - s_t) < 0.02 and int(got[3]) >= 50


def test_optimize_sim3_batched_and_singular(rng):
    """Three problems in one LM (the candidates of a loop event; Pc1 / uv1
    shared as the current keyframe's are): each equals its own call. A problem
    with no valid row has H = 1e-8 I and g = 0: its state stays, finite; NaN
    points give a NaN step that the LM rejects, no exception."""
    cam = make_camera(400.0, 400.0, 320.0, 240.0, device="cpu")
    args, _ = _opt_case(rng)
    s0, R0, t0, Pc1, Pc2, uv1, uv2, w = [torch.as_tensor(a) for a in args]
    S0 = torch.stack([s0, s0 * 0.95, s0])
    RR = torch.stack([R0, R0, R0])
    tt = torch.stack([t0, t0 + 0.02, t0])
    W = torch.stack([w, w, torch.zeros_like(w)])
    P2 = torch.stack([Pc2, Pc2, Pc2])
    U2 = torch.stack([uv2, uv2, uv2])
    s, R, t, n_in = t_optimize_sim3(S0, RR, tt, Pc1, P2, uv1, U2, W, cam, iters=10)
    for c in range(2):
        one = t_optimize_sim3(S0[c], RR[c], tt[c], Pc1, Pc2, uv1, uv2, w, cam, iters=10)
        np.testing.assert_allclose(float(s[c]), float(one[0]), rtol=1e-5)
        np.testing.assert_allclose(R[c].numpy(), one[1].numpy(), atol=1e-5)
        assert int(n_in[c]) == int(one[3])
    assert int(n_in[2]) == 0 and torch.isfinite(t[2]).all()
    np.testing.assert_allclose(float(s[2]), float(s0), rtol=1e-6)
    bad = t_optimize_sim3(s0, R0, t0, Pc1, torch.full_like(Pc2, float("nan")), uv1, uv2, w,
                          cam, iters=3)
    np.testing.assert_allclose(float(bad[0]), float(s0), rtol=1e-6)
    assert int(bad[3]) == 0
