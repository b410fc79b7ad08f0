"""The slice as a whole: one `frame_pipeline_vi` plus one chained frame, the
JAX package's and the port's, on the same converted MapState, images, IMU
rows and prior; and the map-seeding helpers against their JAX originals.

Small size (240x320, 3 levels, 256 features, 1024 map points, 8 keyframes)
so the JAX program compiles once per file. Tolerances, and why:
* features: levels and validity exact; descriptor bits may differ in
  <= 0.05% of bits (pyramid levels agree to 1e-4, not bit for bit; see
  test_torch_frontend.py);
* feat_mp: the same map point on >= 99% of the features either side
  matched (a flipped descriptor bit can move one ratio test);
* pose: 1e-3 m and 1e-3 rad (two LM solves per frame on matches that may
  differ by that 1%);
* summary counts (inliers, matches) within 1%;
* found/visible counters equal except map slot 0, which the JAX scatter
  writes in an order-dependent way (tracking.py docstring)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.imu.navstate import NavState as JNavState
from mc_slam_tpu.imu.preintegration import PreintState as JPreint, \
    euroc_noise as j_noise
from mc_slam_tpu.pipeline import mapping as jmapping, tracking as jtracking
from mc_slam_tpu.pipeline.system import SlamSystem
from mc_slam_tpu.pipeline.tracking_ctl import TrackingCtlMixin
from mc_slam_tpu.slam_map import mapstate as jms
from mc_slam_tpu.solver import ba_vi as jbavi, factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.frontend.orb import pack_bits
from mc_slam_tpu_torch.pipeline import (mapping as tmapping, mapping_ctl as tmapping_ctl,
                                        tracking_ctl as ttracking_ctl)
from mc_slam_tpu_torch.slam_map.mapstate import MapState, empty_map

torch.set_num_threads(2)
P = chip_smoke.Profile(width=320, height=240, n_feat=256, n_levels=3, max_mp=1024,
                       max_kf=8, n_frames=3, kf_every=10, tex_size=256)


def _jax_map(d):
    d = dict(d)
    d["kf_ns"] = JNavState(**d["kf_ns"])
    d["kf_preint"] = JPreint(**d["kf_preint"])
    return jms.MapState(**d)


def _jax_cam(cam):
    return j_make_camera(*[float(getattr(cam, f)) for f in
                           ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")],
                         width=cam.width, height=cam.height)


@pytest.fixture(scope="module")
def scene():
    seq = chip_smoke.make_sequence(P, seed=0)
    cam = chip_smoke.profile_camera(P, "cpu")
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device="cpu")
    m, n_kf = chip_smoke.build_map(seq, P, cam, ext, torch.device("cpu"))
    return SimpleNamespace(seq=seq, cam=cam, ext=ext, m=m, n_kf=n_kf)


def test_built_map_packs_consistently(scene):
    m = scene.m
    assert scene.n_kf == 1 and int(m.mp_active.sum()) > 50
    assert torch.equal(pack_bits((m.mp_pm1 > 0).to(torch.int32)), m.mp_desc)
    assert torch.equal(pack_bits((m.kf_pm1.reshape(-1, 256) > 0).to(torch.int32)),
                       m.kf_desc.reshape(-1, 8))


def test_convert_round_trip_keeps_dtypes():
    jm = jax.tree_util.tree_map(np.asarray, jms.empty_map(4, 32, 16))
    tm = convert.to_torch(MapState, jm, "cpu")
    assert tm.kf_desc.dtype == torch.int32 and tm.kf_pm1.dtype == torch.int8
    back = convert.to_numpy(tm)
    ref = jax.tree_util.tree_map(np.asarray, jm)._asdict()
    for k, v in back.items():
        rv = ref[k]
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(vv, np.asarray(getattr(rv, kk)))
                assert vv.dtype == np.asarray(getattr(rv, kk)).dtype
        else:
            np.testing.assert_array_equal(v, rv)
            assert v.dtype == rv.dtype, k
    port_empty = convert.to_numpy(empty_map(4, 32, 16, device="cpu"))
    for k, v in port_empty.items():
        if not isinstance(v, dict):
            np.testing.assert_array_equal(v, ref[k])
            assert v.dtype == ref[k].dtype, k


def test_map_seeding_helpers(scene):
    """write_keyframe, depth_to_world, alloc_points (keyframe at the origin,
    the JAX caller's case) and fresh_prior_info against the JAX code."""
    rng = np.random.default_rng(1)
    F = P.n_feat
    jcam = _jax_cam(scene.cam)
    jext = jfac.extrinsics_from_Tbc(chip_smoke.TBC)
    uv = rng.uniform(0, 300, (F, 2)).astype(np.float32)
    depth = np.where(rng.random(F) < 0.8, rng.uniform(0.5, 6, F), -1.0).astype(np.float32)
    host = SimpleNamespace(cam=jcam, ext=jext)
    z3, I3 = np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    Xw_j = np.array(SlamSystem._depth_to_world(host, jnp.asarray(uv), jnp.asarray(depth),
                                                 jnp.asarray(z3), jnp.asarray(I3)))
    Xw_t = tmapping_ctl.depth_to_world(scene.cam, scene.ext, torch.from_numpy(uv),
                                       torch.from_numpy(depth), torch.zeros(3), torch.eye(3))
    np.testing.assert_allclose(Xw_j, Xw_t.numpy(), rtol=1e-5, atol=1e-5)

    words = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    pm1 = bits.reshape(F, 256).astype(np.int8) * 2 - 1
    level = rng.integers(0, 3, F).astype(np.int32)
    angle = rng.uniform(-3, 3, F).astype(np.float32)
    valid = rng.random(F) < 0.9
    kf = (z3, I3, z3, z3, z3, np.float32(1.5), np.int32(7), uv, level, angle,
          np.full(F, -1.0, np.float32), words, pm1, valid)
    jm = jmapping.write_keyframe(jms.empty_map(P.max_kf, P.max_mp, F), 2,
                                 *[jnp.asarray(a) for a in kf])
    tm = tmapping.write_keyframe(empty_map(P.max_kf, P.max_mp, F, device="cpu"), 2,
                                 *[convert._tensor(a, None) for a in kf])
    good = valid & (depth > 1e-3)
    jhost = SimpleNamespace(m=jm, cfg=SimpleNamespace(n_levels=P.n_levels), frame_id=7)
    fj, sj = SlamSystem._alloc_points(jhost, jnp.asarray(Xw_j), jnp.asarray(words),
                                      jnp.asarray(pm1), jnp.asarray(level), 2, good,
                                      angle=jnp.asarray(angle))
    tm, ft, st = tmapping_ctl.alloc_points(tm, torch.from_numpy(Xw_j),
                                           convert._tensor(words, None),
                                           torch.from_numpy(pm1), torch.from_numpy(level), 2,
                                           good, P.n_levels, 7, angle=torch.from_numpy(angle))
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_array_equal(sj, st)
    got = convert.to_numpy(tm)
    for k, v in jax.tree_util.tree_map(np.asarray, jhost.m)._asdict().items():
        if isinstance(v, tuple):
            for kk, vv in v._asdict().items():
                np.testing.assert_allclose(got[k][kk], vv, rtol=1e-6, err_msg=k + kk)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ttracking_ctl.fresh_prior_info(1e2),
                                  TrackingCtlMixin._fresh_prior_info(1e2))
    md = rng.uniform(0.1, 10, 50).astype(np.float32)
    for n_levels in (3, 8, 10):
        np.testing.assert_allclose(tmapping.band_min_dist(md, n_levels),
                                   np.asarray(jmapping.band_min_dist(md, n_levels)),
                                   rtol=1e-7)


def _run_two_frames_jax(scene):
    seq, F = scene.seq, P.n_feat
    jm = _jax_map(convert.to_numpy(scene.m))
    jcam = _jax_cam(scene.cam)
    jext = jfac.extrinsics_from_Tbc(chip_smoke.TBC)
    ns = JNavState(P=seq.P[0].astype(np.float32), V=seq.V[0].astype(np.float32),
                   R=seq.R[0].astype(np.float32),
                   bg=chip_smoke.TRUE_BG.astype(np.float32),
                   ba=chip_smoke.TRUE_BA.astype(np.float32),
                   dbg=np.zeros(3, np.float32), dba=np.zeros(3, np.float32))
    prior = jbavi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=ns,
                              info=jnp.asarray(ttracking_ctl.fresh_prior_info(1e3)),
                              valid=jnp.asarray(1.0, jnp.float32))
    pfm, pan = np.full(F, -1, np.int32), np.zeros(F, np.float32)
    gw = jnp.asarray([0.0, 0.0, -9.81])
    outs = []
    for i in (1, 2):
        rawp = np.zeros((256, 7), np.float32)
        rawp[:len(seq.imu[i])] = seq.imu[i]
        out = jtracking.frame_pipeline_vi(
            jm, jnp.asarray(seq.imgs[i]), jnp.asarray(rawp), jcam, jext, j_noise(), ns,
            gw, prior, pfm, pan, np.int32(0), np.float32(0.05),
            jnp.asarray(ttracking_ctl.fresh_prior_info(1e2)), sigma_bg=2e-5, sigma_ba=5e-3,
            n_features=F, n_levels=P.n_levels, iters=P.iters, has_prev=True)
        out = jax.tree_util.tree_map(np.asarray, out)
        feats, _, ns, fmp, H_prior, mp_found, mp_vis, _, summary = out
        prior = jbavi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=ns, info=H_prior,
                                  valid=jnp.asarray(1.0, jnp.float32))
        pfm, pan = fmp, feats.angle
        jm = jm._replace(mp_found=mp_found, mp_visible=mp_vis)
        outs.append(dict(feats=feats._asdict(), P=ns.P, R=ns.R, fmp=fmp,
                         summary=summary, found=mp_found))
    return outs


def test_two_chained_frames_match_jax(scene):
    ref = _run_two_frames_jax(scene)
    rec = chip_smoke.SearchRecorder(keep_frames=2, timed=False)
    res = chip_smoke.run_slice(scene.m, scene.seq, P, scene.cam, scene.ext,
                               torch.device("cpu"), recorder=rec)
    assert len(rec.calls) == 4          # coarse + fine search per frame
    for i, r in enumerate(ref):
        np.testing.assert_allclose(res["P"][i], r["P"], rtol=0, atol=1e-3)
        dR = res["R"][i].T @ r["R"]
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
        s_t, s_j = res["summary"][i], r["summary"]
        assert abs(s_t[0] - s_j[0]) <= max(1.0, 0.01 * s_j[0]), (s_t, s_j)
        assert abs(s_t[3] - s_j[3]) <= max(1.0, 0.01 * s_j[3]), (s_t, s_j)
        assert s_t[2] == s_j[2]                      # fallback taken on both or neither
        assert s_j[0] >= P.fb_min_inliers
        fmp_t, fmp_j = res["feat_mp"][i], r["fmp"]
        either = (fmp_t >= 0) | (fmp_j >= 0)
        assert either.sum() >= P.fb_min_inliers
        assert (fmp_t == fmp_j)[either].mean() >= 0.99, (fmp_t != fmp_j).sum()
    # the recorded fine searches carry the port's features of each frame
    for (_, args, _), r in zip(rec.calls[1::2], ref):
        feats_j = r["feats"]
        np.testing.assert_array_equal(args[8].numpy(), feats_j["level"])
        np.testing.assert_array_equal(args[9].numpy(), feats_j["valid"])
        n_diff = int((args[6].numpy() != feats_j["desc_pm1"]).sum())
        assert n_diff <= 0.0005 * feats_j["desc_pm1"].size, n_diff
    # found/visible counters after both frames (slot 0: see module docstring)
    np.testing.assert_array_equal(res["m"].mp_found.numpy()[1:], ref[-1]["found"][1:])


def test_frame_pipeline_visual_matches_jax(scene):
    """The visual per-frame program (velocity model from the last pose, the
    40 px retry on too few inliers) on frame 1, from ground-truth frame 0."""
    seq, F = scene.seq, P.n_feat
    jm = _jax_map(convert.to_numpy(scene.m))
    P0, R0 = seq.P[0].astype(np.float32), seq.R[0].astype(np.float32)
    z3, I3 = np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    out_j = jtracking.frame_pipeline_visual(
        jm, jnp.asarray(seq.imgs[1]), _jax_cam(scene.cam),
        jfac.extrinsics_from_Tbc(chip_smoke.TBC), P0, R0, z3, I3,
        np.full(F, -1, np.int32), np.zeros(F, np.float32), np.int32(0), 20,
        n_features=F, n_levels=P.n_levels, iters=P.iters, has_prev=False)
    _, _, res_j, vel_j, found_j, _, traj_j, summ_j = jax.tree_util.tree_map(
        np.asarray, out_j)
    from mc_slam_tpu_torch.pipeline import tracking as ttracking
    out_t = ttracking.frame_pipeline_visual(
        scene.m, torch.from_numpy(seq.imgs[1]), scene.cam, scene.ext,
        torch.from_numpy(P0), torch.from_numpy(R0), torch.zeros(3), torch.eye(3),
        torch.full((F,), -1, dtype=torch.int32), torch.zeros(F), 0, 20,
        n_features=F, n_levels=P.n_levels, iters=P.iters, has_prev=False)
    _, _, res_t, vel_t, found_t, _, traj_t, summ_t = out_t
    np.testing.assert_allclose(res_t.P.numpy(), res_j.P, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res_t.R.numpy(), res_j.R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(vel_t[0].numpy(), vel_j[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(traj_t[0].numpy(), traj_j[0], rtol=0, atol=1e-3)
    s_t = summ_t.numpy()
    assert abs(s_t[0] - summ_j[0]) <= max(1.0, 0.01 * summ_j[0]), (s_t, summ_j)
    assert s_t[1] == summ_j[1] and summ_j[0] >= 20
    either = (res_t.feat_mp.numpy() >= 0) | (res_j.feat_mp >= 0)
    assert (res_t.feat_mp.numpy() == res_j.feat_mp)[either].mean() >= 0.99
    np.testing.assert_array_equal(found_t.numpy()[1:], found_j[1:])
