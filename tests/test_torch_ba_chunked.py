"""Parity of the port's landmark-chunked whole-map BA with the JAX package:
the three single-device cases of tests/test_ba_chunked.py through both
packages on the same seeded scenes, the port's chunked form against the
port's dense form, and the failure modes (a reduced system that is not
positive definite) and the stereo / RGB-D rows.

Tolerances: `chunk_observations` is host arithmetic and must agree exactly.
Both solvers run the same fixed count of float32 LM iterations with the same
accept rule, summing their normal equations in another order: keyframe
positions agree to 1e-3 m, landmarks to 5e-3 m, velocities to 2e-2 m/s, the
final cost to 1e-3 relative. Chunked against dense (one package): positions
2e-3 m, landmarks 5e-3 m, as the JAX package's own test holds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.solver import ba_chunked as jch, ba_vi as jbavi, factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.solver import ba as tba, ba_chunked as tch, ba_vi as tbavi

from test_solver import CAM as JCAM, EXT as JEXT, synth_scene
from test_torch_xyz_ba import GW, TCAM, TEXT, _np, _t, _tobs
from test_vi_solver import build_vi_window, kfs_to_navstate

torch.set_num_threads(2)


def _chunk_both(obs, Np, n_chunks):
    args = [np.asarray(a) for a in (obs.cam, obs.pt, obs.uv, obs.inv_sigma2, obs.valid)]
    cj, Cj = jch.chunk_observations(*args, Np, n_chunks)
    ct, Ct = tch.chunk_observations(*args, Np, n_chunks, device="cpu")
    assert Cj == Ct == Np // n_chunks
    for f in ("cam", "pt", "uv", "inv_sigma2", "valid"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                                      err_msg=f)
    assert ct.ur is None and ct.cam.dtype == torch.int64
    assert ct.cam.shape[1] % 512 == 0
    # padded rows are invalid and point into their own chunk
    pad = ct.valid.numpy() == 0
    assert np.all((ct.pt.numpy() // Ct)[pad] == np.nonzero(pad)[0])
    return cj, ct


def test_chunk_observations_pad_to_and_stereo_rows(rng):
    _, _, _, obs = synth_scene(rng, Nc=4, Np=40, noise_px=0.3)
    args = [np.asarray(a) for a in (obs.cam, obs.pt, obs.uv, obs.inv_sigma2, obs.valid)]
    ur = rng.uniform(0, 600, size=args[0].shape).astype(np.float32)
    cj, _ = jch.chunk_observations(*args, 40, 4, ur=ur, pad_to=96)
    ct, _ = tch.chunk_observations(*args, 40, 4, ur=ur, pad_to=96, device="cpu")
    assert ct.cam.shape == (4, 96)
    for f in ct._fields:
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)))
    with pytest.raises(ValueError, match="pad_to"):
        tch.chunk_observations(*args, 40, 4, pad_to=2, device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        tch.chunk_observations(*args, 40, 3, device="cpu")
    # stereo rows of a chunk (ba.reproj_rows) reach reproj_xyz3 with the
    # per-row gate: the JAX rows to 1e-4 px (residuals), 1e-3 relative
    # (Jacobians), the gate exactly; rows with ur < 0 keep a zero third row
    Pw = _t(rng.uniform(-1, 1, (5, 3)) + [0, 0, 4])
    ur5 = np.asarray([300.0, -1.0, 250.0, -1.0, 100.0], np.float32)
    uv5 = rng.uniform(100, 300, (5, 2)).astype(np.float32)
    Pwb, Rwb = torch.zeros(5, 3), torch.eye(3).expand(5, 3, 3)
    got = tba.reproj_rows(TCAM, TEXT, Pwb, Rwb, Pw, _t(uv5), _t(ur5), 40.0)
    ref = jch._chunk_reproj(JCAM, JEXT, jnp.asarray(Pwb.numpy()), jnp.asarray(Rwb.numpy()),
                            jnp.asarray(Pw.numpy()), jnp.asarray(uv5), jnp.asarray(ur5), 40.0)
    for g, r, tol in zip(got, ref, (1e-4, 1e-3, 1e-3, 1e-6, 0.0)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=max(tol, 1e-6), atol=tol)
    assert np.all(got[0].numpy()[ur5 < 0, 2] == 0) and np.all(got[1].numpy()[ur5 < 0, 2] == 0)


def test_chunked_visual_matches_jax_and_dense(rng):
    pts, P, R, obs = synth_scene(rng, Nc=6, Np=80, noise_px=0.5)
    free = np.ones(6, np.float32)
    free[0] = 0.0
    mask = np.ones(80, np.float32)
    dP = rng.normal(size=(6, 3)).astype(np.float32) * 0.05
    dP[0] = 0
    P0 = P + dP
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    cj, ct = _chunk_both(obs, 80, 4)
    Pj, Rj, pj, cost_j = jch.visual_gba_chunked(
        jnp.asarray(P0), jnp.asarray(R), jnp.asarray(pts0), cj, JCAM, JEXT, jnp.asarray(free),
        jnp.asarray(mask), iters=8)
    Pt, Rt, pt, cost_t, costs = tch.visual_gba_chunked(
        _t(P0), _t(R), _t(pts0), ct, TCAM, TEXT, _t(free), _t(mask), iters=8)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    costs = costs.numpy()
    assert len(costs) == 9 and np.all(np.diff(costs) <= 0) and costs[-1] < costs[0]
    assert float(cost_t) == costs[-1]
    np.testing.assert_allclose(Pt.numpy()[0], P[0], atol=1e-7)       # the fixed camera
    # the port's dense form, one round as the chunked one
    Pd, _, pd, _, cost_d, _ = tba.visual_ba(_t(P0), _t(R), _t(pts0), _tobs(obs), TCAM, TEXT,
                                            _t(free), _t(mask), iters=8, two_phase=False)
    np.testing.assert_allclose(Pt.numpy(), Pd.numpy(), atol=2e-3)
    np.testing.assert_allclose(pt.numpy(), pd.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_d), rtol=1e-2)
    # a shard that holds chunks 2 and 3 only: `ks` keeps the local index right
    half = tch.ChunkedObs(*[a[2:] if a is not None else None for a in ct])
    dxp = tch._scan_backsub(lambda ci: (_t(P0)[ci], _t(R)[ci]), _t(pts0), half, TCAM, TEXT,
                            0.0, _t(free), 6, 20, torch.tensor(1e-4), torch.zeros(6, 6), _t(mask),
                            ks=[2, 3])
    full = tch._scan_backsub(lambda ci: (_t(P0)[ci], _t(R)[ci]), _t(pts0), ct, TCAM, TEXT,
                             0.0, _t(free), 6, 20, torch.tensor(1e-4), torch.zeros(6, 6), _t(mask))
    np.testing.assert_allclose(dxp.numpy(), full.numpy()[40:], atol=1e-6)


def test_chunked_visual_converges(rng):
    pts, P, R, obs = synth_scene(rng, Nc=8, Np=160, noise_px=0.3)
    free = np.ones(8, np.float32)
    free[:2] = 0.0
    dP = rng.normal(size=(8, 3)).astype(np.float32) * 0.08
    dP[:2] = 0
    P0 = P + dP
    cj, ct = _chunk_both(obs, 160, 8)
    Pj, _, _, _ = jch.visual_gba_chunked(
        jnp.asarray(P0), jnp.asarray(R), jnp.asarray(pts), cj, JCAM, JEXT, jnp.asarray(free),
        jnp.ones(160), iters=12)
    Pt, _, _, _, _ = tch.visual_gba_chunked(_t(P0), _t(R), _t(pts), ct, TCAM, TEXT, _t(free),
                                            torch.ones(160), iters=12)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-3)
    assert np.abs(Pt.numpy() - P).max() < 0.3 * np.abs(P0 - P).max()


def test_chunked_vi_matches_jax_and_dense(rng):
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=6, noise_px=0.3)
    N, Np = 6, pts.shape[0]
    Npad = int(np.ceil(Np / 4)) * 4
    pts_p = np.zeros((Npad, 3), np.float32)
    pts_p[:Np] = pts
    ns_true = kfs_to_navstate(kfs)
    pre1 = jax.tree_util.tree_map(lambda a: a[1:], pre)
    edges = jbavi.IMUEdges(
        i=jnp.arange(0, N - 1, dtype=jnp.int32), j=jnp.arange(1, N, dtype=jnp.int32),
        pre=pre1, info_prv=jfac.imu_prv_info(pre1),
        info_bias=jfac.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(N - 1, jnp.float32))
    free = np.asarray([0.0, 0.0] + [1.0] * (N - 2), np.float32)
    mask = (np.arange(Npad) < Np).astype(np.float32)
    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
    dP[:2] = 0
    ns0 = ns_true._replace(P=ns_true.P + dP)
    cj, ct = _chunk_both(obs, Npad, 4)
    nsj, pj, cost_j = jch.vi_gba_chunked(
        ns0, jnp.asarray(pts_p), cj, edges, JCAM, JEXT, jnp.asarray(GW), jnp.asarray(free),
        jnp.asarray(mask), iters=8)
    t_ns0 = convert.to_torch(NavState, _np(ns0), "cpu")
    t_edges = convert.to_torch(tbavi.IMUEdges, _np(edges), "cpu")
    nst, pt, cost_t, costs = tch.vi_gba_chunked(
        t_ns0, _t(pts_p), ct, t_edges, TCAM, TEXT, _t(GW), _t(free), _t(mask), iters=8)
    nsj = _np(nsj)
    np.testing.assert_allclose(nst.P.numpy(), nsj.P, atol=1e-3)
    np.testing.assert_allclose(nst.R.numpy(), nsj.R, atol=1e-3)
    np.testing.assert_allclose(nst.V.numpy(), nsj.V, atol=2e-2)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-3)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    assert len(costs) == 9 and float(costs[-1]) < float(costs[0])
    np.testing.assert_allclose(pt.numpy()[Np:], 0.0, atol=1e-7)      # masked landmarks stay
    assert np.abs(nst.P.numpy() - np.asarray(ns_true.P)).max() < \
        0.3 * np.abs(np.asarray(ns0.P) - np.asarray(ns_true.P)).max()
    # the port's dense VI BA, one round
    nsd, pd, _, cost_d, _ = tbavi.vi_ba(t_ns0, _t(pts_p), _tobs(obs), t_edges, TCAM, TEXT,
                                        _t(GW), _t(free), _t(mask), iters=8, two_phase=False)
    np.testing.assert_allclose(nst.P.numpy(), nsd.P.numpy(), atol=3e-3)
    np.testing.assert_allclose(nst.V.numpy(), nsd.V.numpy(), atol=2e-2)
    np.testing.assert_allclose(float(cost_t), float(cost_d), rtol=1e-2)


def test_reduced_system_not_positive_definite_gives_nan_and_a_rejected_step(rng):
    """jax.scipy's cho_factor / cho_solve return NaN on a matrix that is not
    positive definite and the LM loop rejects the step; torch.linalg.cholesky
    would raise. The port's solve writes NaN where the factorization failed."""
    n = 12
    S = -torch.eye(n).reshape(2, 6, 2, 6)
    dxc = tch._solve_reduced(S, torch.ones(2, 6), torch.zeros(n), torch.zeros(2, 6, 2, 6),
                             torch.zeros(2, 6), torch.tensor(1e-4), torch.ones(2), 2, 6)
    assert dxc.shape == (2, 6) and torch.isnan(dxc).all()
    good = tch._solve_reduced(-S, torch.ones(2, 6), torch.zeros(n), torch.zeros(2, 6, 2, 6),
                              torch.zeros(2, 6), torch.tensor(0.0), torch.ones(2), 2, 6)
    np.testing.assert_allclose(good.numpy(), -1.0, atol=1e-6)
    # a whole solve whose every step is NaN keeps its start and its cost
    pts, P, R, obs = synth_scene(rng, Nc=4, Np=40, noise_px=0.3)
    _, ct = _chunk_both(obs, 40, 4)
    orig = tch.lm.cho_solve_nan
    tch.lm.cho_solve_nan = lambda A, b: torch.full_like(b, torch.nan)
    try:
        Pt, _, pt, cost, costs = tch.visual_gba_chunked(
            _t(P), _t(R), _t(pts), ct, TCAM, TEXT, torch.ones(4), torch.ones(40), iters=3)
    finally:
        tch.lm.cho_solve_nan = orig
    assert torch.equal(Pt, _t(P)) and torch.equal(pt, _t(pts))
    assert np.all(costs.numpy() == float(cost)) and np.isfinite(float(cost))
