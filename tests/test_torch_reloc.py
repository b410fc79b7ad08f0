"""Relocalization and the bias window after it, against the JAX package on
converted states (tracking.reloc_candidates_batch, tracking_ctl._relocalize /
_track_reference_kf / _recompute_bias_from_window), and the whole sequence
through the port's `SlamSystem` by chip_smoke.py's own gates.

The states come from ONE run of chip_smoke.py's path 5 on the CPU
(torch_port_helpers.revisit_run: on a copy of the bootstrap run's system, 3
blank frames lose the camera, the carried pose and gyro bias are corrupted,
46 earlier frames are fed again). The JAX side is a SlamSystem in parity mode
that holds the converted state, the detector's table included. RANSAC: the
JAX methods draw their PnP samples from the system's key; the harness repeats
the key splits (`jax_samples`) and gives the port the same (256, 6) index
sets, so both sides score the same hypotheses.

Tolerances: match counts, PnP decisions and the chosen keyframe exact; PnP
poses 1e-3; refined poses 1e-3 m / 1e-3; the window's biases 1e-4, its
position 1e-3 m."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mc_slam_tpu.frontend.extractor import Features as JFeatures
from mc_slam_tpu.imu.navstate import NavState as JNavState
from mc_slam_tpu.pipeline import tracking as jtracking
from mc_slam_tpu.pipeline.pipebase import LOST, OK
from mc_slam_tpu_torch import camera as tcam, convert
from mc_slam_tpu_torch.frontend import extractor, matching
from mc_slam_tpu_torch.pipeline import tracking, tracking_ctl

from torch_port_helpers import (BOOT, REVISIT_SRC, jax_map, jax_samples, jax_system_from_port,
                                revisit_run)

torch.set_num_threads(2)
_jfeats = lambda f: JFeatures(**{k: jnp.asarray(v) for k, v in convert.to_numpy(f).items()})
_jns = lambda ns: JNavState(**{k: jnp.asarray(v) for k, v in convert.to_numpy(ns).items()})


def _frame(seq, cam, i):
    f = extractor.extract(torch.from_numpy(seq.imgs[i]), n_features=BOOT.n_feat,
                          n_levels=BOOT.n_levels)
    return f, tcam.undistort_points(cam, f.xy)


def _jax_lost_system(monkeypatch, cam, slam, m, st, ts):
    """A JAX SlamSystem holding the port's state at the moment it is LOST."""
    js = jax_system_from_port(monkeypatch, cam, m, st, frame_id=slam.frame_id)
    d = convert.detector_to_dict(slam.loop)
    js.loop.hists = jnp.asarray(d["hists"])
    js.loop.hist_ids = d["hist_ids"]
    js.state = LOST
    js.gw = jnp.asarray(ts.gw.numpy())
    js.last_ns = _jns(ts.ns)
    js.last_pose = (jnp.asarray(ts.P.numpy()), jnp.asarray(ts.R.numpy()))
    js.velocity = (jnp.zeros(3), jnp.eye(3))
    js._cur_ur = None               # what _track_sync sets for a monocular frame
    return js


def _candidate_weights(m, cand, f, ratio=0.85):
    """The mutual-match masks (the PnP sampling weights) of the frame against
    each candidate keyframe's landmark features."""
    ks = torch.as_tensor(cand, dtype=torch.int64)
    has = (m.kf_mp[ks] >= 0) & m.kf_feat_valid[ks]
    return matching.mutual_match(f.desc_pm1, f.valid, m.kf_pm1[ks], has,
                                 max_dist=matching.TH_LOW, ratio=ratio, angle_a=f.angle,
                                 angle_b=m.kf_angle[ks])[2]


def test_reloc_candidates_batch_matches_jax():
    """Five candidate keyframes (two of them the same slot, as the padded
    call has) in one batched pass against the JAX vmap: match counts and PnP
    decisions exact, inlier counts within 1, poses 1e-3."""
    seq, cam, ext, slam, rv, cap = revisit_run()
    m = cap["lost"][0]
    f, uv = _frame(seq, cam, REVISIT_SRC)
    cand = [5, 6, 4, 7, 5]
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    okm = _candidate_weights(m, cand, f)
    idx = np.stack([jax_samples(keys[c], jnp.asarray(okm[c].numpy(), jnp.float32), 256, 6)
                    for c in range(5)]).astype(np.int64)
    xn = tracking_ctl._normalized(cam, uv)
    got = tracking.reloc_candidates_batch(
        m, torch.as_tensor(cand), torch.from_numpy(idx), f.desc_pm1, f.valid, f.angle, xn,
        cam.fx).numpy()
    jf = _jfeats(f)
    ref = np.asarray(jtracking.reloc_candidates_batch(
        jax.tree_util.tree_map(jnp.asarray, jax_map(m)), jnp.asarray(cand, jnp.int32), keys,
        jf.desc_pm1, jf.valid, jf.angle, jnp.asarray(xn.numpy()), float(cam.fx)))
    assert got.shape == ref.shape == (5, 15)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])           # mutual matches
    np.testing.assert_array_equal(got[:, 1], ref[:, 1])           # PnP accepted
    assert got[:, 0].max() > 100 and got[:, 1].sum() >= 3
    np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=1)      # a point on the gate
    ok = got[:, 1] > 0.5
    np.testing.assert_allclose(got[ok, 3:], ref[ok, 3:], atol=1e-3)
    # drawn from a generator: the same call needs no index argument
    g = torch.Generator().manual_seed(0)
    own = tracking.reloc_candidates_batch(m, torch.as_tensor(cand), None, f.desc_pm1, f.valid,
                                          f.angle, xn, cam.fx, generator=g).numpy()
    np.testing.assert_array_equal(own[:, 0], got[:, 0])
    best = int(np.argmax(got[:, 2]))     # other samples, the same pose where support is wide
    assert own[best, 1] == 1.0
    np.testing.assert_allclose(own[best, 3:], got[best, 3:], atol=2e-2)


def test_relocalize_matches_jax(monkeypatch):
    """`relocalize` on the LOST, corrupted state against `_relocalize`: the
    same keyframe, the same inlier count (within 2), the pose to 1e-3, and
    the same state afterwards (bias window open, chain break pending, the IMU
    rows so far forgotten)."""
    seq, cam, ext, slam, rv, cap = revisit_run()
    m, st0, ts0 = cap["lost"]
    st, ts = copy.deepcopy(st0), copy.copy(ts0)
    f, uv = _frame(seq, cam, REVISIT_SRC)
    js = _jax_lost_system(monkeypatch, cam, slam, m, st, ts)
    # the candidates and key splits of _relocalize, repeated
    q = convert.to_numpy(slam.loop.hists @ tracking_ctl.bow.bow_histogram(
        f.desc_pm1, f.valid.to(torch.float32), slam.loop.vocab, idf=slam.loop.idf))
    act = list(st.kf_slots)
    order = np.argsort(-q[act], kind="stable")
    cand = [act[int(o)] for o in order[:5] if q[act][int(o)] >= 0.75 * q[act][order[0]]]
    cand_p = (cand + [cand[0]] * 5)[:5]
    _, sub = jax.random.split(js.key)
    keys = jax.random.split(sub, 5)
    okm = _candidate_weights(m, cand_p, f)
    idx = np.stack([jax_samples(keys[c], jnp.asarray(okm[c].numpy(), jnp.float32), 256, 6)
                    for c in range(5)]).astype(np.int64)
    t = 5.4
    hit = tracking_ctl.relocalize(m, st, slam.cfg, ts, slam.loop, f, uv, t, cam, ext,
                                  idx=torch.from_numpy(idx))
    ok = js._relocalize(_jfeats(f), jnp.asarray(uv.numpy()), t)
    assert ok and hit is not None
    kind, detail = js.events[-1][1:]
    assert kind == "reloc" and detail["kf"] == hit["kf"]      # (the live run drew other samples)
    assert abs(detail["n_in"] - hit["n_in"]) <= 2
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.last_pose[0]), atol=1e-3)
    np.testing.assert_allclose(ts.R.numpy(), np.asarray(js.last_pose[1]), atol=1e-3)
    assert js.state == OK == ts.state
    assert js.reloc_buf == [] == ts.reloc_buf and ts.prior is None and js.prior is None
    assert js._chain_break_pending and st.chain_break_pending
    assert js.imu_since_kf == [] == ts.imu_since_kf
    np.testing.assert_allclose(ts.ns.P.numpy(), np.asarray(js.last_ns.P), atol=1e-3)
    np.testing.assert_array_equal(ts.ns.V.numpy(), 0.0)
    np.testing.assert_array_equal(ts.ns.bg.numpy(), np.asarray(js.last_ns.bg))   # still corrupted
    assert st.covis_row is None and st.ref_tracked is None
    # a blank frame relocalizes nowhere, and changes nothing
    blank = np.full_like(seq.imgs[0], 40)
    fb = extractor.extract(torch.from_numpy(blank), n_features=BOOT.n_feat,
                           n_levels=BOOT.n_levels)
    st2, ts2 = copy.deepcopy(st0), copy.copy(ts0)
    assert tracking_ctl.relocalize(m, st2, slam.cfg, ts2, slam.loop, fb,
                                   tcam.undistort_points(cam, fb.xy), t, cam, ext,
                                   generator=torch.Generator().manual_seed(0)) is None
    assert ts2.state == LOST and ts2.reloc_buf is None and not st2.chain_break_pending


def test_default_config_draws_256_hypotheses_and_matches_jax(monkeypatch):
    """F17's count: on the default SlamConfig a relocalization draws the JAX
    package's 256 PnP hypotheses a candidate (pnp.pnp_ransac's default, taken
    at mc_slam_tpu/pipeline/tracking.py:309), one batch of (5, 256, 6); given
    the samples the JAX `_relocalize` draws (its key splits repeated), the
    port relocalizes against the same keyframe with the same inliers
    (within 2) and pose (1e-3)."""
    import dataclasses
    from mc_slam_tpu_torch.geometry import pnp
    from mc_slam_tpu_torch.pipeline.system import SlamConfig
    seq, cam, ext, slam, rv, cap = revisit_run()
    m, st0, ts0 = cap["lost"]
    st, ts = copy.deepcopy(st0), copy.copy(ts0)
    cfg = dataclasses.replace(slam.cfg, pnp_iters=SlamConfig().pnp_iters)
    assert cfg.pnp_iters == 256 and slam.cfg.pnp_iters == chip_smoke.PATH5_PNP_ITERS
    f, uv = _frame(seq, cam, REVISIT_SRC)
    js = _jax_lost_system(monkeypatch, cam, slam, m, st, ts)
    _, sub = jax.random.split(js.key)
    keys = jax.random.split(sub, 5)
    drawn = []

    def draw(generator, w, n_iters, k):
        drawn.append((tuple(w.shape), n_iters, k))
        return torch.from_numpy(np.stack([
            jax_samples(keys[c], jnp.asarray(w[c].numpy(), jnp.float32), n_iters, k)
            for c in range(w.shape[0])]).astype(np.int64))
    monkeypatch.setattr(pnp, "draw_samples", draw)
    t = 5.4
    hit = tracking_ctl.relocalize(m, st, cfg, ts, slam.loop, f, uv, t, cam, ext,
                                  generator=torch.Generator().manual_seed(0))
    assert drawn == [((5, BOOT.n_feat), 256, 6)]
    assert js._relocalize(_jfeats(f), jnp.asarray(uv.numpy()), t) and hit is not None
    kind, detail = js.events[-1][1:]
    assert kind == "reloc" and detail["kf"] == hit["kf"]
    assert abs(detail["n_in"] - hit["n_in"]) <= 2
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.last_pose[0]), atol=1e-3)


def test_track_reference_kf_matches_jax(monkeypatch):
    """The reference-keyframe fallback against `_track_reference_kf`: a frame
    4 frames before the last keyframe's, no motion prior given; same decision,
    inliers within 2, pose 1e-3. With too few matches (a blank frame) both
    give up before PnP. (A frame 15 frames away leaves 51 matches, of which no
    clean 6-point sample is all inliers; the winner is then a sample with a
    repeated index, whose null space the two SVDs resolve differently: the
    port relocalizes there, the JAX package does not.)"""
    seq, cam, ext, slam, rv, cap = revisit_run()
    m, st0, ts0 = cap["lost"]
    st = copy.deepcopy(st0)
    k = st.last_kf_slot
    i = st.kf_id_host[k] - 4
    f, uv = _frame(seq, cam, i)
    js = _jax_lost_system(monkeypatch, cam, slam, m, st, ts0)
    _, sub = jax.random.split(js.key)
    okm = _candidate_weights(m, [k], f)[0]
    idx = jax_samples(sub, jnp.asarray(okm.numpy(), jnp.float32), 256, 6).astype(np.int64)
    tr, n_in = tracking_ctl.track_reference_kf(m, st, slam.cfg, f, uv, cam, ext,
                                               idx=torch.from_numpy(idx))
    ref = js._track_reference_kf(_jfeats(f), jnp.asarray(uv.numpy()))
    assert tr is not None and ref is not None
    assert abs(n_in - int(ref.n_inliers)) <= 2 and n_in > 100
    np.testing.assert_allclose(tr.P.numpy(), np.asarray(ref.P), atol=1e-3)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(ref.R), atol=1e-3)
    np.testing.assert_array_equal(tr.feat_mp.numpy() >= 0, np.asarray(ref.feat_mp) >= 0)
    blank = extractor.extract(torch.from_numpy(np.full_like(seq.imgs[0], 40)),
                              n_features=BOOT.n_feat, n_levels=BOOT.n_levels)
    uvb = tcam.undistort_points(cam, blank.xy)
    none = tracking_ctl.track_reference_kf(m, st, slam.cfg, blank, uvb, cam, ext,
                                           generator=torch.Generator().manual_seed(0))
    assert none == (None, 0)
    assert js._track_reference_kf(_jfeats(blank), jnp.asarray(uvb.numpy())) is None


def test_recompute_bias_from_window_matches_jax(monkeypatch):
    """The 20-frame solve on the window the run buffered, against
    `_recompute_bias_from_window` given the same buffer as numpy: gyro and
    accelerometer bias 1e-4, position 1e-3 m, rotation and velocity 1e-3; the
    corrupted gyro bias is recovered."""
    seq, cam, ext, slam, rv, cap = revisit_run()
    m, ts0 = cap["window"]
    ts = copy.copy(ts0)
    assert len(ts.reloc_buf) == 20
    js = jax_system_from_port(monkeypatch, cam, m, slam.st, frame_id=slam.frame_id)
    js.gw = jnp.asarray(ts.gw.numpy())
    js.last_ns = _jns(ts.ns)
    js.reloc_buf = [{k: (v if k == "t" else v.numpy()) for k, v in b.items()}
                    for b in ts.reloc_buf]
    js._recompute_bias_from_window()
    costs = tracking_ctl.recompute_bias_from_window(m, ts, cam, ext, slam.noise)
    c = costs.numpy()
    assert np.isfinite(c).all() and np.all(np.diff(c) <= 0) and c[-1] < 0.5 * c[0]
    ref = js.last_ns
    np.testing.assert_allclose(ts.ns.bg_full.numpy(), np.asarray(ref.bg_full), atol=1e-4)
    np.testing.assert_allclose(ts.ns.ba_full.numpy(), np.asarray(ref.ba_full), atol=1e-4)
    np.testing.assert_allclose(ts.ns.P.numpy(), np.asarray(ref.P), atol=1e-3)
    np.testing.assert_allclose(ts.ns.R.numpy(), np.asarray(ref.R), atol=1e-3)
    np.testing.assert_allclose(ts.ns.V.numpy(), np.asarray(ref.V), atol=1e-3)
    assert ts.prior is None and js.prior is None
    err0 = np.abs(ts0.ns.bg_full.numpy() - chip_smoke.TRUE_BG)
    err = np.abs(ts.ns.bg_full.numpy() - chip_smoke.TRUE_BG)
    assert np.all(err0 > 0.02) and np.all(err < 0.4 * err0)


def test_system_loses_relocalizes_and_completes_the_window():
    """The whole sequence through `SlamSystem.track`, by chip_smoke.py's own
    gates for path 5: three "lost" events, a "reloc" event on the first
    replayed frame, 20 window frames during which no keyframe is inserted,
    the bias recovered, VI tracking afterwards with no frame lost, and the
    first keyframe after the relocalization starting a new IMU chain."""
    seq, cam, ext, slam, rv, cap = revisit_run()
    chip_smoke.check_revisit(rv, BOOT, n_vi_min=10)
    kinds = [e[1] for e in rv["events"]]
    assert kinds[:4] == ["lost", "lost", "lost", "reloc"] and rv["i_reloc"] == 0
    assert [e[2]["mode"] for e in rv["events"][:3]] == ["vi", "lost", "lost"]
    fr = rv["frames"]
    assert [f["ok"] for f in fr[:3]] == [False] * 3 and all(f["ok"] for f in fr[3:])
    window = [f for f in fr if f["mode"] == "reloc_window"]
    assert len(window) == 20 and all(f["keyframe"] is None for f in window[:-1])
    assert window[-1]["keyframe"] == rv["new_kf"][0] and not window[-1]["window"]
    assert slam.n_lost_frames == 3 and slam.state == OK and slam.reloc_buf is None
    assert rv["reloc_pos_err"] < 0.03
    # every tracked frame left a trajectory row, composed through the map
    tr = slam.get_trajectory()
    assert len(tr) == len(slam.traj) and np.isfinite(np.asarray([x[1] for x in tr])).all()
    # the chain break: no IMU edge into the first keyframe after the relocalization
    st = slam.st
    assert rv["new_kf"][0] in st.broken_chain_slots and not st.chain_break_pending
    assert st.kf_imu_raw[rv["new_kf"][0]].shape[0] == 20 * 10   # the window's rows only
    # detection ran at the events after VI init and proposed nothing covisible
    assert rv["diags"] and all(d[2]["n_cands"] == 0 for d in rv["diags"])
    assert slam.n_loops_closed == 0
