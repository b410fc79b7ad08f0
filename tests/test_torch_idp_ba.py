"""Parity of the inverse-depth window VI BA (vi_ba_idp, vi_window_ba,
window_vi_ba_map) with the JAX package on a small synthetic window, and the
port's handling of padded windows, landmark overflow and a keyframe that
holds one point twice.

Small shapes (6-8 keyframes, 250 landmarks, 256 features a keyframe) so that
XLA:CPU compiles each program in seconds. Tolerances: the two sides run the
same eight float32 LM iterations with accept / reject; their normal equations
agree to ~1e-4 relative (test_torch_idp_factors.py), so the accepted steps
and the states after them agree to ~1e-4 of the perturbation that the solve
removes: positions 2e-4 m, rotations 2e-4, velocities 2e-3 m/s, inverse
depths 1e-3 relative, costs 1e-3 relative. The cost curves are compared
point by point at the same 1e-3, so that a run that parted ways on a
rounding-level accept / reject shows as what it is."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.imu.navstate import NavState as JNavState
from mc_slam_tpu.slam_map import mapstate as jms
from mc_slam_tpu.solver import ba_vi as jbavi, ba_vi_idp as jidp, factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.pipeline import mapping_ctl
from mc_slam_tpu_torch.solver import ba_vi as tbavi, ba_vi_idp as tidp, factors as tfac

from test_idp_ba import _to_idp_problem
from test_vi_solver import CAM, EXT, GW, build_vi_window, kfs_to_navstate
from torch_port_helpers import torch_map

torch.set_num_threads(2)
N = 6
npy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _edges(pre, n):
    return jbavi.IMUEdges(
        i=jnp.arange(0, n - 1, dtype=jnp.int32), j=jnp.arange(1, n, dtype=jnp.int32),
        pre=jax.tree_util.tree_map(lambda x: x[1:], pre),
        info_prv=jfac.imu_prv_info(jax.tree_util.tree_map(lambda x: x[1:], pre)),
        info_bias=jfac.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(n - 1, jnp.float32))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=N, noise_px=0.3)
    ns_true = kfs_to_navstate(kfs)
    idp_obs, rho_true, anchor, uv0, used = _to_idp_problem(kfs, pts, obs)
    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.04
    dphi = rng.normal(size=(N, 3)).astype(np.float32) * 0.015
    dV = rng.normal(size=(N, 3)).astype(np.float32) * 0.04
    dP[:2] = 0
    dphi[:2] = 0
    dV[:2] = 0
    ns0 = ns_true._replace(P=ns_true.P + dP, V=ns_true.V + dV,
                           R=ns_true.R @ jlie.so3_exp(jnp.asarray(dphi)))
    rho0 = rho_true * jnp.asarray(1.0 + 0.05 * rng.normal(size=rho_true.shape), jnp.float32)
    free = jnp.asarray([0.0, 0.0] + [1.0] * (N - 2), jnp.float32)
    return dict(ns0=ns0, rho0=rho0, obs=idp_obs, edges=_edges(pre, N), free=free,
                pt_mask=jnp.asarray(used, jnp.float32), ns_true=ns_true, kfs=kfs, pre=pre,
                pts=pts, vobs=obs)


def _port_args(p):
    cpu = "cpu"
    return (convert.to_torch(NavState, npy(p["ns0"]), cpu), torch.from_numpy(np.array(p["rho0"])),
            convert.to_torch(tidp.IDPObs, npy(p["obs"]), cpu),
            convert.to_torch(tbavi.IMUEdges, npy(p["edges"]), cpu),
            convert.to_torch(Camera, npy(CAM), cpu),
            convert.to_torch(tfac.Extrinsics, npy(EXT), cpu),
            torch.from_numpy(np.array(GW)), torch.from_numpy(np.array(p["free"])),
            torch.from_numpy(np.array(p["pt_mask"])))


def _check_states(ns_t, ns_j):
    np.testing.assert_allclose(ns_t.P.numpy(), np.asarray(ns_j.P), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ns_t.R.numpy(), np.asarray(ns_j.R), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ns_t.V.numpy(), np.asarray(ns_j.V), rtol=0, atol=2e-3)
    np.testing.assert_allclose(ns_t.dbg.numpy(), np.asarray(ns_j.dbg), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ns_t.dba.numpy(), np.asarray(ns_j.dba), rtol=0, atol=2e-3)


def test_vi_ba_idp_matches_jax(problem):
    p = problem
    ns_j, rho_j, chi2_j, cost_j = jidp.vi_ba_idp(
        p["ns0"], p["rho0"], p["obs"], p["edges"], CAM, EXT, GW, p["free"], p["pt_mask"],
        iters=8)
    ns_t, rho_t, chi2_t, cost_t, costs_t = tidp.vi_ba_idp(*_port_args(p), iters=8)
    _check_states(ns_t, ns_j)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    valid = np.asarray(p["obs"].valid) > 0
    np.testing.assert_allclose(chi2_t.numpy()[valid], np.asarray(chi2_j)[valid], rtol=2e-2,
                               atol=2e-3)
    # the solve recovers the perturbation, as in the JAX package's own test
    assert np.abs(ns_t.P.numpy() - np.asarray(p["ns_true"].P)).max() < 0.02
    costs = costs_t.numpy()
    assert costs.shape == (2 * 1 + 3 + 5,) and costs[3] <= costs[0] and costs[-1] <= costs[4]


def test_cost_curve_matches_jax(problem):
    """One round (two_phase=False): the JAX run with k iterations ends at the
    port's k-th point of the curve."""
    p = problem
    _, _, _, _, costs_t = tidp.vi_ba_idp(*_port_args(p), iters=4, two_phase=False)
    costs_t = costs_t.numpy()
    assert costs_t.shape == (5,) and np.all(np.diff(costs_t) <= 0)
    assert costs_t[-1] < 0.1 * costs_t[0]
    for k in (1, 2, 4):
        _, _, _, cost_j = jidp.vi_ba_idp(
            p["ns0"], p["rho0"], p["obs"], p["edges"], CAM, EXT, GW, p["free"],
            p["pt_mask"], iters=k, two_phase=False)
        np.testing.assert_allclose(costs_t[k], float(cost_j), rtol=1e-3, err_msg=f"iters={k}")


# ---------------------------------------------------------------------------
# the MapState entry: a map built from the synthetic window's tables
# ---------------------------------------------------------------------------

K, F, PTS = 8, 256, 512


def _window_map(p, rng, n_kf=N):
    """A JAX MapState whose keyframe tables hold the synthetic window's
    observations (feature f of keyframe k = its f-th observation), with the
    perturbed NavStates and slightly perturbed landmark positions."""
    jm = jax.tree_util.tree_map(np.array, jms.empty_map(K, PTS, F))
    cam = np.asarray(p["vobs"].cam)
    pt = np.asarray(p["vobs"].pt)
    uv = np.asarray(p["vobs"].uv)
    kf_mp = np.full((K, F), -1, np.int32)
    kf_uv = np.zeros((K, F, 2), np.float32)
    fv = np.zeros((K, F), bool)
    for k in range(n_kf):
        sel = np.nonzero(cam == k)[0][:F]
        kf_mp[k, :len(sel)] = pt[sel]
        kf_uv[k, :len(sel)] = uv[sel]
        fv[k, :len(sel)] = True
    ns0 = npy(p["ns0"])
    kf_ns = jm.kf_ns._replace(**{f: np.concatenate([getattr(ns0, f), getattr(jm.kf_ns, f)[n_kf:]])
                                 for f in ns0._fields})
    pre = npy(p["pre"])
    kf_pre = jm.kf_preint._replace(**{
        f: np.concatenate([getattr(pre, f), getattr(jm.kf_preint, f)[n_kf:]])
        for f in pre._fields})
    mp_pos = np.zeros((PTS, 3), np.float32)
    mp_pos[:len(p["pts"])] = p["pts"] + rng.normal(size=p["pts"].shape).astype(np.float32) * 0.03
    active = np.zeros(PTS, bool)
    active[:len(p["pts"])] = True
    kf_active = np.zeros(K, bool)
    kf_active[:n_kf] = True
    return jm._replace(kf_ns=kf_ns, kf_preint=kf_pre, kf_mp=kf_mp, kf_uv=kf_uv,
                       kf_feat_valid=fv, kf_active=kf_active, mp_pos=mp_pos,
                       mp_active=active, kf_id=np.arange(K, dtype=np.int32))


def _port_window(tm, slots, n_real, Pw=512, do_prune=True):
    n = len(slots)
    n_window = n_real
    ii, jj, ev = mapping_ctl.imu_edge_lists(slots, n_window, n_pad=n)
    free = np.zeros(n, np.float32)
    free[1:n_window] = 1.0
    t = torch.as_tensor
    return tidp.window_vi_ba_map(
        tm, t(slots, dtype=torch.int64), t(ii, dtype=torch.int64), t(jj, dtype=torch.int64),
        t(ev), n_real, t(free), convert.to_torch(Camera, npy(CAM), "cpu"),
        convert.to_torch(tfac.Extrinsics, npy(EXT), "cpu"),
        torch.from_numpy(np.array(GW)), 2e-5, 5e-3, iters=8, Pw=Pw, do_prune=do_prune)


@pytest.fixture(scope="module")
def window(problem):
    jm = _window_map(problem, np.random.default_rng(7))
    slots = list(range(N))
    ii, jj, ev = mapping_ctl.imu_edge_lists(slots, N)
    free = np.zeros(N, np.float32)
    free[1:] = 1.0
    jm2 = jidp.window_vi_ba_map(
        jm, jnp.asarray(slots, jnp.int32), jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(ev),
        jnp.asarray(N, jnp.int32), jnp.asarray(free), CAM, EXT, GW, 2e-5, 5e-3, iters=8,
        Pw=512, do_prune=True)
    return jm, npy(jm2)


def _check_window(tm2, jm2, n_kf=N):
    _check_states(NavState(*[a[:n_kf] for a in tm2.kf_ns]),
                  JNavState(*[a[:n_kf] for a in jm2.kf_ns]))
    np.testing.assert_allclose(tm2.mp_pos.numpy(), jm2.mp_pos, rtol=0, atol=2e-3)
    # the chi2 prune cuts at a threshold: allow the few observations within
    # rounding of it to fall on either side (none on this problem's seeds)
    assert (tm2.kf_mp.numpy() != jm2.kf_mp).mean() <= 1e-3


def test_window_vi_ba_map_matches_jax(window):
    jm, jm2 = window
    tm2, stats = _port_window(torch_map(jm), list(range(N)), N)
    _check_window(tm2, jm2)
    assert int(stats.overflow) == 0 and int(stats.n_landmarks) > 100
    assert float(stats.cost) < 0.1 * float(stats.cost0)


def test_padded_window_real_rows_win(window):
    """The window padded to 10 slots with copies of its last slot (the JAX
    package's pad rule): the real, optimised rows are what the map keeps. The
    reference is the JAX package's UNPADDED solve of the same window."""
    jm, jm2 = window
    tm = torch_map(jm)
    slots = list(range(N)) + [N - 1] * 4
    tm2, stats = _port_window(tm, slots, N)
    _check_window(tm2, jm2)
    moved = np.abs(tm2.kf_ns.P.numpy()[N - 1] - tm.kf_ns.P.numpy()[N - 1]).max()
    assert moved > 1e-3, "the last window keyframe was optimised and must be written back"
    unp, _ = _port_window(tm, list(range(N)), N)
    np.testing.assert_allclose(tm2.kf_ns.P.numpy(), unp.kf_ns.P.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm2.kf_mp.numpy(), unp.kf_mp.numpy())


def test_landmark_overflow_is_counted(window):
    jm, _ = window
    tm = torch_map(jm)
    _, full = _port_window(tm, list(range(N)), N, Pw=512)
    n_seen = int(full.n_landmarks)
    tm2, stats = _port_window(tm, list(range(N)), N, Pw=64)
    assert int(stats.overflow) == n_seen - 64 and int(stats.n_landmarks) == 64
    assert np.isfinite(tm2.mp_pos.numpy()).all() and float(stats.cost) <= float(stats.cost0)


def test_point_held_twice_by_its_anchor_keyframe(window):
    """After fusion a keyframe may hold one point in two features. The port
    anchors the landmark at the lower feature index, whatever the scatter
    order: the result equals that of the map with the second copy removed."""
    jm, _ = window
    tm = torch_map(jm)
    p5 = int(tm.kf_mp[0, 5])
    free_feat = int(torch.nonzero(~tm.kf_feat_valid[0])[0])
    kf_mp = tm.kf_mp.clone()
    kf_mp[0, free_feat] = p5
    kf_uv = tm.kf_uv.clone()
    kf_uv[0, free_feat] = tm.kf_uv[0, 5] + 40.0
    fv = tm.kf_feat_valid.clone()
    fv[0, free_feat] = True
    dup = tm._replace(kf_mp=kf_mp, kf_uv=kf_uv, kf_feat_valid=fv)
    a, _ = _port_window(dup, list(range(N)), N, do_prune=False)
    b, _ = _port_window(tm, list(range(N)), N, do_prune=False)
    np.testing.assert_allclose(a.mp_pos.numpy(), b.mp_pos.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.kf_ns.P.numpy(), b.kf_ns.P.numpy(), rtol=0, atol=1e-6)


def test_idp_xyz_round_trip(problem):
    p = problem
    cam = convert.to_torch(Camera, npy(CAM), "cpu")
    ext = convert.to_torch(tfac.Extrinsics, npy(EXT), "cpu")
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(p["pts"][:50])
    P = torch.from_numpy(np.array(p["ns_true"].P[0])).expand(50, 3)
    R = torch.from_numpy(np.array(p["ns_true"].R[0])).expand(50, 3, 3)
    Pc = (R.transpose(-1, -2) @ (pts - P)[..., None])[..., 0]
    uv0 = torch.stack([cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx,
                       cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy], -1)
    rho = tidp.xyz_to_idp(pts, P, R, uv0, cam, ext)
    front = Pc[:, 2] > 0.5
    back = tidp.idp_to_xyz(rho, uv0, P, R, cam, ext)
    np.testing.assert_allclose(back[front].numpy(), pts[front].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        rho.numpy(), np.asarray(jidp.xyz_to_idp(jnp.asarray(pts.numpy()), jnp.asarray(P.numpy()),
                                                jnp.asarray(R.numpy()), jnp.asarray(uv0.numpy()),
                                                CAM, EXT)), rtol=1e-6)
