"""Parity of the port's depth-sensor system code with the JAX SlamSystem's:
the per-feature depth of an RGB-D map and of a stereo pair
(`SlamSystem._frame_depth` / `_feature_depth`) with the virtual right-image
u (`_cur_ur`), the first-frame initialization from depth, the depth points
of a new keyframe (`mapping_ctl.add_depth_points` / `_add_depth_points`),
the XYZ window VI BA that a depth sensor takes (`mapping_ctl.local_ba` /
`_local_ba` on the bootstrap run's state), and the per-row prune gate.

Both packages see the JAX extraction's feature tables (`jax_features`) on
the dot world of tests/test_e2e_depth.py (480x360, 384 features, 3 levels).
Tolerances: the RGB-D lookup, every integer table and the slot choices are
exact; u_right and the stereo depth (float32 fx * b / d) agree to 1e-5
relative; map tables after seeding to 1e-5 (float32 arithmetic in another
order). The depth points of a keyframe away from the origin differ in
`mp_normal` by design (ROADMAP F9): the port writes unit vectors. The window
BA: both run 8 float32 LM iterations over the same window (the JAX package's
padding copies a FIXED observer there, so its scatter-back writes what the
port's does); keyframe positions agree to 1e-3 m, rotations to 1e-3,
velocities to 1e-2 m/s, landmarks to 5e-3 m, and the chi2 prune may differ on
observations within rounding of its threshold (<= 0.2 % of the table)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.frontend import extractor as jex
from mc_slam_tpu.pipeline import mapping as jmap, system as jsystem
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import make_camera, undistort_points
from mc_slam_tpu_torch.frontend import extractor as tex
from mc_slam_tpu_torch.pipeline import mapping_ctl
from mc_slam_tpu_torch.pipeline.pipebase import NO_IMAGES_YET, OK
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
from mc_slam_tpu_torch.slam_map.mapstate import empty_map
from mc_slam_tpu_torch.solver import ba as tba

from render import DotWorld
from torch_port_helpers import (assert_maps_match, boot_run, jax_features, jax_map,
                                jax_system_from_port, torch_map)

torch.set_num_threads(2)
CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360, device="cpu")
JCAM = j_make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
KW = dict(max_kf=64, max_mp=2048, n_feat=384, n_levels=3, cull_min_obs=2)


def _pose(t):
    P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.05 * t], np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.08 * np.sin(0.5 * t), 0.0], jnp.float32)))
    return P, R.astype(np.float32)


def _systems(monkeypatch, **kw):
    monkeypatch.setenv("MC_SLAM_PAIR", "1")
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "1")
    cfg = dict(KW, **kw)
    js = jsystem.SlamSystem(JCAM, jsystem.SlamConfig(**cfg))
    js._summary_ready = lambda pend: True
    return js, SlamSystem(CAM, SlamConfig(**cfg), device="cpu")


def _features(img):
    jf = jex.extract(jnp.asarray(img, jnp.float32), n_features=KW["n_feat"],
                     n_levels=KW["n_levels"])
    tf = convert.to_torch(tex.Features, jax.tree_util.tree_map(np.asarray, jf)._asdict(), "cpu")
    return jf, tf, undistort_points(CAM, tf.xy)


def test_feature_depth_rgbd_and_stereo(monkeypatch, rng):
    world = DotWorld(rng)
    P, R = _pose(0.3)
    img, dep = world.render(R, P, with_depth=True)
    js, slam = _systems(monkeypatch, stereo_baseline=0.25)
    jf, tf, uv = _features(img)
    juv = js._undistort(jf)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-6, atol=1e-4)
    # RGB-D: a lookup at the raw pixel, exact
    dj = np.asarray(js._feature_depth(jf, juv, dep, None))
    fd = slam._frame_depth(tf, uv, dep, None)
    np.testing.assert_array_equal(fd.depth.numpy(), dj)
    assert (dj > 0).sum() > 100 and (dj == -1).any()
    # the virtual right u of every feature with depth (SlamSystem._track_sync)
    bf = 300.0 * 0.25
    ur_j = np.where(dj > 1e-3, np.asarray(juv)[:, 0] - bf / np.maximum(dj, 1e-6), -1.0)
    np.testing.assert_allclose(fd.ur.numpy(), ur_j, rtol=1e-5)
    np.testing.assert_allclose(float(fd.bf), bf, rtol=1e-6)
    # stereo: the right image through the same extraction, the 35-baseline rule
    left, right = world.render_stereo(R, P, baseline=0.25)
    jf, tf, uv = _features(left)
    with jax_features():
        fd = slam._frame_depth(tf, uv, None, right)
    dj = np.asarray(js._feature_depth(jf, js._undistort(jf), None, right))
    np.testing.assert_array_equal(fd.depth.numpy() > 0, dj > 0)
    np.testing.assert_allclose(fd.depth.numpy(), dj, rtol=1e-5)
    assert (dj > 0).sum() > 50 and dj.max() < 35 * 0.25
    assert "stereo" in slam.timers.summary()


def test_initialize_from_depth_matches_jax(monkeypatch, rng):
    world = DotWorld(rng)
    P, R = _pose(0.0)
    img, dep = world.render(R, P, with_depth=True)
    js, slam = _systems(monkeypatch)
    # a frame with fewer than 50 depth points initializes nothing
    none = np.zeros_like(dep)
    with jax_features():
        assert slam.track(img, 0.0, depth=none) is False
    js.track(img, 0.0, depth=none)
    assert slam.state == js.state == NO_IMAGES_YET and slam.sensor_depth and js.sensor_depth
    with jax_features():
        assert slam.track(img, 0.1, depth=dep) is True
    js.track(img, 0.1, depth=dep)
    assert slam.state == js.state == OK
    assert slam.kf_slots == js.kf_slots == [0] and slam.n_kf == js.n_kf == 1
    assert_maps_match(js.m, slam.m, msg="after the depth initialization")
    np.testing.assert_allclose(slam.m.kf_ur[0].numpy(), np.asarray(js._cur_ur), rtol=1e-5)
    good = (slam.m.kf_ur[0] >= 0) & slam.m.kf_feat_valid[0]
    assert int(slam.m.mp_active.sum()) == int(good.sum()) >= 50
    assert slam.events[-1][1] == "init" and len(slam.get_trajectory()) == 1


def test_add_depth_points_matches_jax(monkeypatch, rng):
    world = DotWorld(rng)
    js, slam = _systems(monkeypatch)
    P0, R0 = _pose(0.0)
    img0, dep0 = world.render(R0, P0, with_depth=True)
    js.track(img0, 0.0, depth=dep0)
    # the next keyframe at a pose away from the origin (camera == body here),
    # none of its features associated yet
    P1, R1 = _pose(1.5)
    img1, dep1 = world.render(R1, P1, with_depth=True)
    jf, tf, uv = _features(img1)
    juv = js._undistort(jf)
    dj = js._feature_depth(jf, juv, dep1, None)
    js.frame_id = 15
    Pb, Rb = P1 - P0, R0.T @ R1
    slot = js._insert_kf_raw(jnp.asarray(Pb), jnp.asarray(Rb), jf, juv, t_kf=1.5)
    m_before = js.m
    js._add_depth_points(slot, jf, juv, dj)
    tm = mapping_ctl.add_depth_points(torch_map(m_before), slam.cfg, CAM, slam.ext, slot, tf, uv,
                                      torch.from_numpy(np.array(dj)), 15)
    new = np.asarray(js.m.mp_active) & ~np.asarray(m_before.mp_active)
    assert new.sum() == 128 < int((np.asarray(dj) > 0).sum())     # nearest 128 of them
    assert_maps_match(js.m, tm, skip=("mp_normal",), msg="after the depth points")
    nrm = np.linalg.norm(tm.mp_normal.numpy()[new], axis=1)
    np.testing.assert_allclose(nrm, 1.0, rtol=1e-5)
    # the JAX normal is Xw / |Xw - P_kf|: not a unit vector away from the origin (F9)
    assert np.abs(np.linalg.norm(np.asarray(js.m.mp_normal)[new], axis=1) - 1).max() > 1e-2


def _with_ur(m, cam, ext, bf, rng):
    """A copy of the map whose keyframes carry u_right rows for about half of
    their associated features, at each landmark's depth in that keyframe."""
    kf_ur = np.full(m.kf_ur.shape, -1.0, np.float32)
    P, R = m.kf_ns.P.numpy(), m.kf_ns.R.numpy()
    Rcb, tcb = ext.Rcb.numpy(), ext.tcb.numpy()
    mp, pos, uv = m.kf_mp.numpy(), m.mp_pos.numpy(), m.kf_uv.numpy()
    for k in np.nonzero(m.kf_active.numpy())[0]:
        rows = np.nonzero(mp[k] >= 0)[0]
        rows = rows[rng.random(len(rows)) < 0.5]
        Pc = (Rcb @ (R[k].T @ (pos[mp[k, rows]] - P[k]).T)).T + tcb
        kf_ur[k, rows] = uv[k, rows, 0] - bf / np.maximum(Pc[:, 2], 1e-3)
    return m._replace(kf_ur=torch.from_numpy(kf_ur))


def test_xyz_window_vi_ba_matches_jax(monkeypatch):
    """A depth sensor's map after VI init: the window BA takes its XYZ form
    (the JAX package's `cfg.use_idp_ba and not self.sensor_depth` gate) with
    the u_right rows, the chain predecessor as a fixed vertex, and the per-row
    prune; the port's `local_ba` against the JAX `_local_ba` on the same
    state. use_idp_ba=False takes the same branch without a depth sensor."""
    seq, cam, ext, res, _ = boot_run()
    slam = res["slam"]
    st = copy.deepcopy(slam.st)
    st.sensor_depth = True
    tm = _with_ur(slam.m, cam, ext, float(cam.fx) * slam.cfg.stereo_baseline,
                  np.random.default_rng(3))
    prob = mapping_ctl.window_problem(st, slam.cfg)
    n_real, slots = prob["n_real"], prob["all_slots"]
    window = mapping_ctl.vi_window_slots(st, slam.cfg)
    # padding copies a fixed slot (the chain predecessor or an observer)
    assert len(slots) > n_real and slots[n_real - 1] not in window and prob["ev"][0] == 1.0
    js = jax_system_from_port(monkeypatch, cam, tm, st, frame_id=slam.frame_id,
                              local_window=slam.cfg.local_window)
    js.gw = jnp.asarray(slam.gw.numpy())
    assert js.sensor_depth and js.vi_inited
    js._local_ba()
    tm2, stats = mapping_ctl.local_ba(tm, st, slam.cfg, cam, ext, slam.gw, slam.noise)
    jn, tn = jax.tree_util.tree_map(np.asarray, js.m.kf_ns), convert.to_numpy(tm2.kf_ns)
    np.testing.assert_allclose(tn["P"], jn.P, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tn["R"], jn.R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tn["V"], jn.V, rtol=0, atol=1e-2)
    np.testing.assert_allclose(tm2.mp_pos.numpy(), np.asarray(js.m.mp_pos), rtol=0, atol=5e-3)
    assert (tm2.kf_mp.numpy() != np.asarray(js.m.kf_mp)).mean() <= 2e-3
    costs = stats.costs.numpy()
    assert np.isfinite(costs).all() and float(stats.cost) <= float(stats.cost0)
    # the newest keyframe moved; the fixed vertices did not
    newest = st.last_kf_slot
    assert np.abs(tn["P"][newest] - tm.kf_ns.P.numpy()[newest]).max() > 1e-6
    for s in slots[len(window):n_real]:
        np.testing.assert_allclose(tn["P"][s], tm.kf_ns.P.numpy()[s], atol=1e-7)
    # without a depth sensor, use_idp_ba=False takes the same solver (no ur rows)
    seen = {}
    orig = mapping_ctl.ba_vi.vi_ba

    def spy(*a, **k):
        seen["ur"] = a[2].ur
        seen["prior"] = k.get("prior")
        return orig(*a, **k)

    monkeypatch.setattr(mapping_ctl.ba_vi, "vi_ba", spy)
    st.sensor_depth = False
    cfg2 = copy.deepcopy(slam.cfg)
    cfg2.use_idp_ba = False
    mapping_ctl.local_ba(slam.m, st, cfg2, cam, ext, slam.gw, slam.noise)
    assert "ur" in seen and seen["ur"] is None and seen["prior"] is None


def test_prune_gate_per_row():
    """The association prune after an XYZ BA: chi2 above 1.5 x the row's
    gate, 7.815 on rows with a u_right observation, 5.991 elsewhere (the JAX
    package's `_prune_obs` -> `mapping.prune_associations`)."""
    K, F, Pn = 4, 6, 10
    m = empty_map(K, Pn, F, device="cpu")
    m = m._replace(kf_mp=torch.arange(F, dtype=torch.int32).repeat(K, 1),
                   kf_active=torch.ones(K, dtype=torch.bool))
    ks_real = torch.tensor([0, 2])
    chi2 = torch.tensor([1.0, 10.0, 10.0, 12.0, 20.0, 3.0] * 2)
    ur = torch.tensor([5.0, -1.0, 5.0, 5.0, -1.0, -1.0] * 2)
    valid = torch.ones(12)
    obs = tba.VisualObs(cam=torch.arange(2).repeat_interleave(F),
                        pt=torch.zeros(12, dtype=torch.int64), uv=torch.zeros(12, 2),
                        inv_sigma2=torch.ones(12), valid=valid, ur=ur)
    m2, _ = mapping_ctl._finish_ba(m, obs, ks_real, chi2, torch.tensor(0.0), torch.zeros(2),
                                   True)
    jm2 = jmap.prune_associations(jax_map(m), jnp.asarray([0, 2]), jnp.asarray(chi2.numpy()),
                                  jnp.asarray(valid.numpy()),
                                  jnp.where(jnp.asarray(ur.numpy()) >= 0, 7.815, 5.991))
    np.testing.assert_array_equal(m2.kf_mp.numpy(), np.asarray(jm2.kf_mp))
    # rows 1 (mono, 10 > 8.99), 3 (stereo, 12 > 11.72) and 4 go; row 2 (stereo, 10) stays
    assert m2.kf_mp[0].tolist() == [0, -1, 2, -1, -1, 5]
    assert torch.equal(m2.kf_mp[1], m.kf_mp[1])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["rgbd", "stereo"])
def test_depth_mode_metric(mode, rng):
    """tests/test_e2e_depth.py::test_rgbd_mode_metric and
    test_stereo_mode_metric through the port, with their gates: depth makes
    the map metric (alignment scale within 0.05 / 0.2 of 1)."""
    from mc_slam_tpu_torch.eval.ate import ate_rmse
    world = DotWorld(rng)
    kw = dict(KW) if mode == "rgbd" else dict(KW, stereo_baseline=0.25)
    slam = SlamSystem(CAM, SlamConfig(**kw), device="cpu")
    n = 35 if mode == "rgbd" else 30
    gts, n_ok = [], 0
    for i in range(n):
        t = i * 0.1
        P, R = _pose(t)
        if mode == "rgbd":
            img, dep = world.render(R, P, with_depth=True)
            n_ok += int(slam.track(img, t, depth=dep))
        else:
            left, right = world.render_stereo(R, P, baseline=0.25)
            n_ok += int(slam.track(left, t, img_right=right))
        gts.append((t, P))
    tr = slam.get_trajectory()
    stats = ate_rmse(np.asarray([x[0] for x in tr]), np.asarray([x[1] for x in tr]),
                     np.asarray([g[0] for g in gts]), np.asarray([g[1] for g in gts]),
                     with_scale=True)
    assert slam.state == OK
    if mode == "rgbd":
        assert n_ok > 30, n_ok
        assert stats["rmse"] < 0.05, stats
        assert abs(stats["scale"] - 1.0) < 0.05, stats["scale"]
        assert int(slam.m.mp_active.sum()) > 150
    else:
        assert n_ok > 25, n_ok
        assert stats["rmse"] < 0.12, stats
        assert abs(stats["scale"] - 1.0) < 0.2, stats["scale"]
