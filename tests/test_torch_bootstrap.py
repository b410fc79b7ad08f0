"""The bootstrap slice as a whole, step by step against the JAX package on
converted states, so that no step inherits another's drift:

 (a) `system.try_initialize` on two rendered frames against
     `SlamSystem._try_initialize`, the 200 x 8 sample indices replayed from
     the system's key split;
 (b) one visual keyframe event on a converted MapState: the pre-BA half, the
     window choice, the visual window BA and its association prune;
 (c) `tracking_ctl.need_new_kf` over the run's decisions against
     `_need_new_kf`;
 (d) `viinit_ctl.maybe_vi_init` on a converted 10-keyframe MapState with
     EuRoC's Tbc against `_maybe_vi_init`;
and the port's whole run (chip_smoke.py's path 3) by its own checks.

The states come from ONE run of the port's bootstrap path on the CPU
(torch_port_helpers.boot_run: 480x360, 512 features, 4 levels, K = 16,
P = 2048; two-view init at frame 1, VI init accepted at frame 100 with 10
keyframes). The JAX side is a SlamSystem in parity mode (MC_SLAM_PAIR = 1,
MC_SLAM_LAG_MAX = 1, `_summary_ready` forced true on the instance) whose
state is the converted one. Where the JAX method pads a window with copies of
its last slot and scatters every row back (so that slot's result is
overwritten by a stale copy), the harness holds the port's padded call
against the JAX solver's UNPADDED call, or leaves that one keyframe out.

Tolerances: integer tables exact; poses 1e-3 m / 1e-3 after a BA, landmarks
1e-3 m median (1e-3 of their distance in the metric map after VI init, with
keyframe positions to 2e-3 m there); VI init: scale 1e-3 relative, gyro bias 1e-4, gravity 2e-2
m/s^2, accelerometer bias 2e-2 m/s^2 (a 5 s window with cond ~3e3, squared by
the normal equations: float32 input differences of 1e-6 show at this level in
the worst-observed direction), cond within a factor 2."""
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mc_slam_tpu.frontend.extractor import Features as JFeatures
from mc_slam_tpu.pipeline import mapping as jmap
from mc_slam_tpu.pipeline.pipebase import NOT_INITIALIZED, OK
from mc_slam_tpu.pipeline.system import SlamConfig, SlamSystem
from mc_slam_tpu_torch.pipeline.system import SlamConfig as TSlamConfig
from mc_slam_tpu.pipeline.tracking_ctl import TrackingCtlMixin
from mc_slam_tpu.solver import ba as jba
from mc_slam_tpu_torch import camera as tcam, convert
from mc_slam_tpu_torch.frontend import extractor, matching
from mc_slam_tpu_torch.eval.ate import ate_rmse
from mc_slam_tpu_torch.imu.preintegration import euroc_noise, preint_identity
from mc_slam_tpu_torch.pipeline import (mapping as tmap, mapping_ctl, system, tracking_ctl,
                                        viinit_ctl)
from mc_slam_tpu_torch.slam_map.mapstate import empty_map

from torch_port_helpers import (BOOT, assert_maps_match, boot_run, jax_cam, jax_map,
                                jax_samples, jax_system_from_port)

torch.set_num_threads(2)
i32 = lambda v: jnp.asarray(v, jnp.int32)
_np = lambda x: jax.tree_util.tree_map(np.asarray, x)


def _cfg():
    return chip_smoke.slam_config(BOOT)


def jax_system(monkeypatch, cam, tm=None, st=None, frame_id=0):
    """A JAX SlamSystem in parity mode holding the converted state."""
    monkeypatch.setenv("MC_SLAM_PAIR", "1")
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "1")
    cfg = SlamConfig(max_kf=BOOT.max_kf, max_mp=BOOT.max_mp, n_feat=BOOT.n_feat,
                     n_levels=BOOT.n_levels, local_window=BOOT.local_window, use_imu=True,
                     vi_init_time=BOOT.vi_init_time)
    js = SlamSystem(jax_cam(cam), cfg, Tbc=chip_smoke.TBC)
    js._summary_ready = lambda p: True
    js.frame_id = frame_id
    if tm is not None:
        js.m = jax.tree_util.tree_map(jnp.asarray, jax_map(tm))
    if st is not None:
        js.kf_slots = list(st.kf_slots)
        js.last_kf_slot = st.last_kf_slot
        js.last_kf_frame = st.last_kf_frame
        js.n_kf = st.n_kf
        js.next_fresh_slot = len(st.kf_slots)
        js.first_kf_time = st.first_kf_time
        js.kf_id_host = dict(st.kf_id_host)
        js.kf_imu_raw = {k: v.numpy() for k, v in st.kf_imu_raw.items()}
        js.state = OK
        if st.covis_row is not None:
            js._covis_row_cache = (st.kf_slots[-2], np.array(st.covis_row))
    return js


def _jfeats(f):
    return JFeatures(**{k: jnp.asarray(v) for k, v in convert.to_numpy(f).items()})


def _extract(seq, cam, i):
    f = extractor.extract(torch.from_numpy(seq.imgs[i]), n_features=BOOT.n_feat,
                          n_levels=BOOT.n_levels)
    return f, tcam.undistort_points(cam, f.xy)


def test_try_initialize_matches_jax(monkeypatch):
    seq, cam, ext, res, _ = boot_run()
    i1 = res["init"]["frame"]
    assert i1 == 1
    (f0, uv0), (f1, uv1) = _extract(seq, cam, 0), _extract(seq, cam, i1)
    t0, t1 = float(seq.times[0]), float(seq.times[i1])
    rows = np.ascontiguousarray(seq.imu[i1])

    # ---- the JAX system: its own method, the two-view BA held back ----
    js = jax_system(monkeypatch, cam, frame_id=i1)
    js.init_feats, js.init_uv = _jfeats(f0), jnp.asarray(uv0.numpy())
    js.state, js.last_time = NOT_INITIALIZED, t0
    js.imu_since_kf = [(i1, rows)]
    js._local_ba = lambda *a, **k: None
    sub = jax.random.split(jax.random.PRNGKey(js.cfg.seed))[1]
    assert js._try_initialize(_jfeats(f1), jnp.asarray(uv1.numpy()), t1)

    # ---- the port, with the samples that call drew ----
    idx, _, ok = matching.search_for_initialization(
        uv0, f0.desc_pm1, f0.valid, uv1, f1.desc_pm1, f1.valid, radius=100.0, ratio=0.9,
        f0_angle=f0.angle, f1_angle=f1.angle)
    samples = jax_samples(sub, jnp.asarray(ok.numpy().astype(np.float32)))
    st = mapping_ctl.MappingState()
    pre_ba = []
    orig = mapping_ctl.local_ba
    monkeypatch.setattr(mapping_ctl, "local_ba",
                        lambda m, *a, **k: (pre_ba.append(m), orig(m, *a, **k))[1])
    noise = euroc_noise(device="cpu")
    m, att = system.try_initialize(
        empty_map(BOOT.max_kf, BOOT.max_mp, BOOT.n_feat, device="cpu"), st, _cfg(), cam, ext,
        noise, (f0, uv0, t0), f1, uv1, t1, i1, torch.from_numpy(rows),
        idx_samples=torch.as_tensor(np.array(samples), dtype=torch.int64))
    assert att.ok and att.n_matches == int(ok.sum()) and not att.reset_ref
    assert st.kf_slots == js.kf_slots == [0, 1] and st.n_kf == js.n_kf == 2
    assert st.first_kf_time == js.first_kf_time and st.kf_id_host == js.kf_id_host
    tv = att.two_view
    assert int(tv.n_good) == int(js.m.mp_active.sum()) == int(m.mp_active.sum())

    # map tables before the BA: exact, floats to the two-view solve's tolerance.
    # kf_preint apart: the JAX method hands the IMU rows to keyframe 0 and
    # leaves keyframe 1 with an identity preintegration (dT = 0, an edge of
    # infinite information); the port gives them to keyframe 1
    assert_maps_match(js.m, pre_ba[0], rtol=2e-3, atol=2e-3, skip=("kf_preint",),
                      msg="after try_initialize, before the BA")
    jpre = _np(js.m.kf_preint)
    assert jpre.dT[0] > 0 and jpre.dT[1] == 0 and set(js.kf_imu_raw) == {0}
    assert float(m.kf_preint.dT[0]) == 0 and set(st.kf_imu_raw) == {1}
    for f, a in zip(jpre._fields, jpre):
        np.testing.assert_allclose(getattr(m.kf_preint, f)[1].numpy(), a[0], rtol=2e-4,
                                   atol=2e-4 * max(np.abs(a[0]).max(), 1e-6), err_msg=f)
    # keyframe 1 sits at unit median depth from keyframe 0, as a BODY pose
    P_b, R_b = mapping_ctl.cam_to_body(ext, torch.zeros(3), torch.eye(3))
    np.testing.assert_allclose(pre_ba[0].kf_ns.P[0].numpy(), P_b.numpy(), atol=1e-6)
    assert abs(float(np.median(pre_ba[0].mp_pos.numpy()[:int(tv.n_good), 2])) - 1.0) < 1e-5

    # ---- the two-view BA: the port's padded call, the JAX solver unpadded ----
    obs = js._gather_obs([0, 1], [])
    ks = i32([0, 1])
    P2, R2, pts2, _, cost_j = jba.visual_ba(
        js.m.kf_ns.P[ks], js.m.kf_ns.R[ks], js.m.mp_pos, obs, js.cam, js.ext,
        jnp.asarray([0.0, 1.0]), js.m.mp_active.astype(jnp.float32), iters=10, bf=js._bf,
        rtol=0.0, two_phase=False)
    np.testing.assert_allclose(m.kf_ns.P[:2].numpy(), np.asarray(P2), atol=1e-3)
    np.testing.assert_allclose(m.kf_ns.R[:2].numpy(), np.asarray(R2), atol=1e-3)
    d = np.linalg.norm(m.mp_pos.numpy() - np.asarray(pts2), axis=1)
    assert np.median(d[:int(tv.n_good)]) < 1e-3 and d.max() < 2e-2
    np.testing.assert_allclose(float(att.ba.cost), float(cost_j), rtol=2e-2)
    assert float(att.ba.cost) <= float(att.ba.cost0)
    # the padded rows (6 copies of slot 1) were not written back over the result
    assert np.abs(m.kf_ns.P[1].numpy() - pre_ba[0].kf_ns.P[1].numpy()).max() > 1e-6


def test_too_few_matches_resets_the_reference():
    seq, cam, ext, _, _ = boot_run()
    (f0, uv0), (f1, uv1) = _extract(seq, cam, 0), _extract(seq, cam, 1)
    cfg = TSlamConfig(n_levels=BOOT.n_levels, min_init_matches=10 ** 6)
    m0 = empty_map(BOOT.max_kf, BOOT.max_mp, BOOT.n_feat, device="cpu")
    st = mapping_ctl.MappingState()
    m, att = system.try_initialize(m0, st, cfg, cam, ext, euroc_noise(device="cpu"),
                                   (f0, uv0, 0.0), f1, uv1, 0.05, 1, None,
                                   generator=torch.Generator().manual_seed(0))
    assert not att.ok and att.reset_ref and st.kf_slots == [] and m is m0


def test_visual_keyframe_event_matches_jax(monkeypatch):
    seq, cam, ext, _, cap = boot_run()
    tm, st, frame = cap["events"][4]          # the 7th keyframe's event
    slot, cfg = st.last_kf_slot, _cfg()
    assert not st.vi_inited and len(st.kf_slots) == 7 and st.covis_row is not None
    js = jax_system(monkeypatch, cam, tm, st, frame_id=frame)
    jm = js.m

    # ---- pre-BA half: every table ----
    jm1, _, _, wslots, wvalid = jmap.kf_event_pre(
        jm, i32(slot), jnp.asarray(frame), js.cam, js.ext, i32(cfg.n_levels),
        min_obs=cfg.cull_min_obs, n_evict=int(0.07 * tm.P),
        covis_th=cfg.covis_th, max_new=BOOT.max_new)
    tm1, _, _, wslots_t, wvalid_t, (n_new, _) = tmap.kf_event_pre(
        tm, slot, frame, cam, ext, cfg.n_levels, min_obs=cfg.cull_min_obs,
        n_evict=int(0.07 * tm.P), covis_th=cfg.covis_th, max_new=BOOT.max_new)
    assert_maps_match(jm1, tm1, rtol=1e-4, atol=1e-4, msg="after kf_event_pre")
    assert int(n_new) > 0

    # ---- the window and its fixed observers ----
    js.m = jm1
    for ba_window in (8, 3):                  # all covisibles inside / some outside
        js.cfg.ba_window = ba_window
        c2 = dataclasses.replace(cfg, ba_window=ba_window)
        w_j = js._ba_window_slots()
        f_j = [s for s in js._covisible_stale(slot, ba_window + 6, strong=True)
               if s not in w_j][:4]
        w_t = mapping_ctl.visual_window_slots(tm1, st, c2)
        f_t = [s for s in mapping_ctl.covisible_stale(tm1, st, slot, ba_window + 6, strong=True)
               if s not in w_t][:4]
        assert w_t == w_j and f_t == f_j and w_t[0] == slot and st.kf_slots[-2] in w_t
    assert len(f_j) > 0                        # ba_window = 3 leaves observers outside
    # before the first event there is no row on the host: both read a fresh one
    st0, js._covis_row_cache = copy.deepcopy(st), None
    st0.covis_row = None
    assert mapping_ctl.visual_window_slots(tm1, st0, c2) == js._ba_window_slots()
    js._covis_row_cache = (st.kf_slots[-2], np.array(st.covis_row))

    # ---- the visual window BA (ba_window = 3: 3 free + fixed observers),
    # the port padded to 12 slots, the JAX solver unpadded ----
    all_j = w_j + f_j
    obs = js._gather_obs(w_j, f_j)
    ks = i32(all_j)
    free = np.asarray([1.0] * len(w_j) + [0.0] * len(f_j), np.float32)
    P2, R2, pts2, chi2, cost_j = jba.visual_ba(
        jm1.kf_ns.P[ks], jm1.kf_ns.R[ks], jm1.mp_pos, obs, js.cam, js.ext, jnp.asarray(free),
        jm1.mp_active.astype(jnp.float32), iters=10, bf=js._bf, rtol=0.0, two_phase=True)
    js._prune_obs(all_j, obs, chi2)
    tm2, stats = mapping_ctl.local_ba(tm1, st, c2, cam, ext, torch.zeros(3),
                                      euroc_noise(device="cpu"))
    np.testing.assert_allclose(tm2.kf_ns.P[all_j].numpy(), np.asarray(P2), atol=1e-3)
    np.testing.assert_allclose(tm2.kf_ns.R[all_j].numpy(), np.asarray(R2), atol=1e-3)
    d = np.linalg.norm(tm2.mp_pos.numpy() - np.asarray(pts2), axis=1)
    assert np.median(d[tm2.mp_active.numpy()]) < 1e-3 and d.max() < 2e-2
    assert (tm2.kf_mp.numpy() != np.asarray(js.m.kf_mp)).mean() <= 2e-3
    np.testing.assert_allclose(float(stats.cost), float(cost_j), rtol=2e-2)
    assert float(stats.cost) <= float(stats.cost0) and int(stats.overflow) == 0
    others = [s for s in st.kf_slots if s not in all_j]
    assert torch.equal(tm2.kf_ns.P[others], tm1.kf_ns.P[others])
    assert np.abs(tm2.kf_ns.P[slot].numpy() - tm1.kf_ns.P[slot].numpy()).max() > 1e-6


def test_need_new_kf_decisions_match_jax():
    _, _, _, res, cap = boot_run()
    cfg = _cfg()
    jcfg = SlamConfig(kf_min_gap=cfg.kf_min_gap, kf_max_gap=cfg.kf_max_gap,
                      kf_ref_ratio=cfg.kf_ref_ratio)
    assert len(cap["need_kf"]) == len(res["frames"])
    n_true = n_fresh = n_ratio = 0
    for before, fid, n_in, decision, ref_after, m in cap["need_kf"]:
        host = types.SimpleNamespace(
            cfg=jcfg, frame_id=fid, reloc_buf=None, last_kf_frame=before["last_kf_frame"],
            _ref_tracked_cache=before["ref_tracked"], _cur_inliers=n_in,
            kf_slots=before["kf_slots"], last_kf_slot=before["last_kf_slot"],
            m=jax_map(m) if m is not None else None)
        assert bool(TrackingCtlMixin._need_new_kf(host)) == decision, fid
        since = fid - before["last_kf_frame"]
        if cfg.kf_min_gap <= since < cfg.kf_max_gap:
            assert host._ref_tracked_cache == ref_after, fid
            n_ratio += decision
        n_fresh += m is not None and host._ref_tracked_cache is not None
        n_true += decision
    # both rules fired in the run, and the count was read from the device once
    assert n_true == len(res["events"]) and 0 < n_ratio < n_true and n_fresh >= 1
    # the gap rules by themselves
    st = mapping_ctl.MappingState(kf_slots=[0, 1, 2], last_kf_slot=2, last_kf_frame=50,
                                  ref_tracked=100)
    assert not tracking_ctl.need_new_kf(None, st, cfg, 52, 10)
    assert tracking_ctl.need_new_kf(None, st, cfg, 70, 99)
    assert tracking_ctl.need_new_kf(None, st, cfg, 55, 79)
    assert not tracking_ctl.need_new_kf(None, st, cfg, 55, 80)
    assert not tracking_ctl.need_new_kf(None, st, cfg, 55, 15)


def test_maybe_vi_init_matches_jax(monkeypatch, tmp_path):
    seq, cam, ext, res, cap = boot_run()
    tm, st, t, traj = cap["vi_attempts"][0]
    act = list(st.kf_slots)
    assert len(act) == 10 and not st.vi_inited and len(st.kf_imu_raw) == 9
    cfg, noise = _cfg(), euroc_noise(device="cpu")
    gw0 = torch.tensor([0.0, 0.0, -cfg.g_mag])

    js = jax_system(monkeypatch, cam, tm, st, frame_id=res["i_accept"])
    js._maybe_vi_init(t)
    assert js.vi_inited
    (_, kind, detail), = [e for e in js.events if e[1] == "vi_init"]

    st2, traj2 = copy.deepcopy(st), copy.deepcopy(traj)
    before = traj2.compose(tm.kf_ns.P, tm.kf_ns.R, tm.kf_id, tm.kf_active)
    from mc_slam_tpu_torch.utils.metrics import VIInitLog
    log = VIInitLog(str(tmp_path))
    m2, att = viinit_ctl.maybe_vi_init(tm, st2, cfg, t, cam, ext, gw0, noise, traj=traj2,
                                       log=log)
    log.close()
    # the diagnostic log received the solved attempt
    t_log, s_log, s_star_log = map(float, (tmp_path / "scale.txt").read_text().split())
    assert t_log == t and abs(s_log - att.scale) < 1e-5 and abs(s_star_log - att.scale_star) < 1e-5
    assert len((tmp_path / "biasa.txt").read_text().split()) == 4
    assert att.attempted and att.accepted and att.reason == "accepted" and st2.vi_inited
    assert att.n_kf == detail["n_kf"] == 10
    np.testing.assert_allclose(att.scale, detail["scale"], rtol=1e-3)
    jn = _np(js.m.kf_ns)
    np.testing.assert_allclose(att.bg, jn.bg[act[0]], atol=1e-4)
    np.testing.assert_allclose(att.ba, jn.ba[act[0]], atol=2e-2)
    np.testing.assert_allclose(att.gw.numpy(), np.asarray(js.gw), atol=2e-2)
    assert abs(float(att.gw.norm()) - cfg.g_mag) < 1e-3
    assert att.cond < cfg.vi_init_max_cond
    # every keyframe's rows were integrated again at the new biases
    pre_j = _np(js.m.kf_preint)
    for f, a in zip(pre_j._fields, pre_j):
        b = getattr(m2.kf_preint, f).numpy()
        scale = max(np.abs(a[act[1:]]).max(), 1e-6)
        np.testing.assert_allclose(b[act[1:]], a[act[1:]], rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=f)
    # NavStates and landmarks after the whole-map VI BA; the JAX method writes
    # the newest keyframe's result under a stale padded copy, so that row apart
    real = act[:-1]
    tn = convert.to_numpy(m2.kf_ns)
    np.testing.assert_allclose(tn["P"][real], jn.P[real], atol=2e-3)
    np.testing.assert_allclose(tn["R"][real], jn.R[real], atol=1e-3)
    np.testing.assert_allclose(tn["V"][real], jn.V[real], atol=2e-2)
    np.testing.assert_allclose(tn["bg"][real], jn.bg[real], atol=1e-4)
    assert np.all(tn["bg"][act] == tn["bg"][act[0]]) and np.all(tn["ba"][act] == tn["ba"][act[0]])
    # landmarks sit 3-10 m out in the metric map: the scale's 1e-3 shows as mm
    d = np.linalg.norm(m2.mp_pos.numpy() - np.asarray(js.m.mp_pos), axis=1)
    far = np.maximum(np.linalg.norm(np.asarray(js.m.mp_pos), axis=1), 1.0)
    assert np.median((d / far)[m2.mp_active.numpy()]) < 1e-3
    np.testing.assert_allclose(m2.mp_max_dist.numpy(), np.asarray(js.m.mp_max_dist), rtol=2e-3)
    assert (m2.kf_mp.numpy() != np.asarray(js.m.kf_mp)).mean() <= 2e-3
    # inactive keyframe rows were not touched by the padded scatter
    idle = [k for k in range(tm.K) if k not in act]
    assert torch.equal(m2.kf_ns.P[idle], tm.kf_ns.P[idle])
    assert float(att.ba_vi.cost) <= float(att.ba_vi.cost0)
    assert float(att.ba_visual.cost) <= float(att.ba_visual.cost0)
    # the recorded trajectory went to metres with the map
    after = traj2.compose(tm.kf_ns.P * att.scale, tm.kf_ns.R, tm.kf_id, tm.kf_active)
    assert len(after) == len(before) == len(traj) > 90
    k0 = act[0]
    for (t_a, Pa, _), (_, Pb, _) in zip(after[::10], before[::10]):
        np.testing.assert_allclose(Pa - tm.kf_ns.P[k0].numpy() * att.scale,
                                   (Pb - tm.kf_ns.P[k0].numpy()) * att.scale, atol=1e-4)
    # gates: one attempt per keyframe count, and the time rule
    again = viinit_ctl.maybe_vi_init(tm, st2, cfg, t, cam, ext, gw0, noise)[1]
    assert not again.attempted and again.reason == "same keyframes"
    early = viinit_ctl.maybe_vi_init(tm, copy.deepcopy(st), cfg, 3.0, cam, ext, gw0, noise)[1]
    assert not early.attempted and early.reason == "time"
    few = copy.deepcopy(st)
    few.kf_slots = few.kf_slots[:7]
    assert viinit_ctl.maybe_vi_init(tm, few, cfg, t, cam, ext, gw0, noise)[1].reason == "keyframes"
    tight = dataclasses.replace(cfg, vi_init_max_cond=10.0)
    refused = viinit_ctl.maybe_vi_init(tm, copy.deepcopy(st), tight, t, cam, ext, gw0, noise)[1]
    assert refused.attempted and not refused.accepted and refused.reason == "cond"


def test_bootstrap_run_passes_its_own_checks():
    """chip_smoke.py's path 3 at the BOOT profile on the CPU, by the gates it
    applies on the card."""
    seq, _, _, res, cap = boot_run()
    measured = chip_smoke.check_bootstrap(res, seq, BOOT)
    assert res["init"]["frame"] == 1 and res["i_accept"] == 100
    assert [a["reason"] for a in res["attempts"]] == ["accepted"]
    assert measured["ate_post_m"] < 0.03 and abs(measured["scale_all"] - 1) < 0.05
    assert all(f["n_inliers"] >= 20 for f in res["frames"])
    assert sum(f["vi"] for f in res["frames"]) == BOOT.n_vi_frames
    assert res["st"].vi_inited and len(res["traj"]) == len(res["frames"]) + 1
    assert len(cap["events"]) == len(res["events"]) == len(res["st"].kf_slots) - 2
    for e in res["events"]:
        assert e["cost"] <= e["cost0"] and e["overflow"] == 0 and e["syncs"] == 0


# ---------------------------------------------------------------------------
# F22: the whole-map VI BA at VI init on the two layouts of the first IMU span
# ---------------------------------------------------------------------------

def _gba_vi_input(monkeypatch):
    """The port's VI-init attempt on boot_run()'s state, replayed: the
    MapState, MappingState and gravity handed to its whole-map VI BA (stage
    "gba_vi", right after `vi_apply`), and the attempt's resulting map."""
    seq, cam, ext, res, cap = boot_run()
    tm, st, t, _ = cap["vi_attempts"][0]
    cfg, noise = _cfg(), euroc_noise(device="cpu")
    seen, orig = [], mapping_ctl.local_ba

    def spy(m, st_, cfg_, cam_, ext_, gw, noise_, **kw):
        if st_.vi_inited:
            seen.append((m, copy.deepcopy(st_), gw))
        return orig(m, st_, cfg_, cam_, ext_, gw, noise_, **kw)
    monkeypatch.setattr(mapping_ctl, "local_ba", spy)
    m2, att = viinit_ctl.maybe_vi_init(tm, copy.deepcopy(st), cfg, t, cam, ext,
                                       torch.tensor([0.0, 0.0, -cfg.g_mag]), noise)
    monkeypatch.setattr(mapping_ctl, "local_ba", orig)
    assert att.accepted and len(seen) == 1
    return seen[0] + (m2,)


def _jax_gba_vi(monkeypatch, m, st, gw):
    """The JAX package's whole-map VI BA (`_local_ba(force_all=True)`, which
    runs `ba_vi.vi_ba` over every keyframe) on the converted state; returns
    its MapState."""
    js = jax_system_from_port(monkeypatch, boot_run()[1], m, st)
    assert js.vi_inited
    js.gw = jnp.asarray(gw.numpy())
    js._local_ba(force_all=True)
    return _np(js.m)


def _kf_scale(P, st, slots):
    """The similarity scale of the keyframes' positions against ground truth."""
    seq = boot_run()[0]
    t = np.asarray([seq.times[st.kf_id_host[s]] for s in slots])
    return ate_rmse(t, np.asarray(P)[slots], seq.times, seq.P, with_scale=True)["scale"]


def test_vi_init_gba_scale_matches_jax_on_the_ports_layout(monkeypatch):
    """F22 (a): on the port's layout (keyframe 1 holds the first IMU span),
    the port's whole-map VI BA at VI init (`local_ba(force_all=True)`) and
    the JAX `ba_vi.vi_ba` move the keyframes to the same similarity scale
    against ground truth, to 1e-4. The newest keyframe is left out: the JAX
    method writes a stale padded copy over it (F1)."""
    m_in, st_in, gw, m_port = _gba_vi_input(monkeypatch)
    jm = _jax_gba_vi(monkeypatch, m_in, st_in, gw)
    real = list(st_in.kf_slots)[:-1]
    s_in = _kf_scale(m_in.kf_ns.P.numpy(), st_in, real)
    s_port = _kf_scale(m_port.kf_ns.P.numpy(), st_in, real)
    s_jax = _kf_scale(jm.kf_ns.P, st_in, real)
    assert abs(s_port - s_jax) < 1e-4, (s_in, s_port, s_jax)
    assert abs(s_port - s_in) > 1e-4, (s_in, s_port)       # the BA moved the scale


def test_vi_init_gba_refuses_every_step_on_the_jax_layout(monkeypatch):
    """F22 (b): on the JAX layout (F16: keyframe 0 holds the first IMU rows,
    so keyframe 1's preintegration is empty, dT = 0, and its bias random-walk
    information 1/dT is infinite) the port's whole-map VI BA refuses every
    step, as the JAX one does: the map leaves it as `vi_apply` left it, with
    no NaN written (F13: NaN where a factorization fails, never a raise).
    Exact but for the rotations, which both packages hand back
    re-orthonormalized: within 2.4e-7 (two float32 ulps of 1)."""
    m_in, st_in, gw, _ = _gba_vi_input(monkeypatch)
    act = list(st_in.kf_slots)
    k1 = torch.tensor([act[1]])
    empty = preint_identity(device="cpu")
    m_j = m_in._replace(kf_preint=type(m_in.kf_preint)(
        *[a.index_copy(0, k1, b[None]) for a, b in zip(m_in.kf_preint, empty)]))
    st_j = copy.deepcopy(st_in)
    st_j.kf_imu_raw[act[0]] = st_j.kf_imu_raw.pop(act[1])
    assert float(m_j.kf_preint.dT[act[1]]) == 0.0 and float(m_in.kf_preint.dT[act[1]]) > 0
    m_out, stats = mapping_ctl.local_ba(m_j, st_j, _cfg(), boot_run()[1], boot_run()[2], gw,
                                        euroc_noise(device="cpu"), force_all=True)
    assert not torch.isfinite(stats.costs).any()              # NaN from the start: all refused
    jm = _jax_gba_vi(monkeypatch, m_j, st_j, gw)                 # the JAX method, same state
    for f, a, b in zip(m_j.kf_ns._fields, m_out.kf_ns, m_j.kf_ns):
        assert torch.isfinite(a[act]).all(), f
        for got in (a.numpy()[act], getattr(jm.kf_ns, f)[act]):
            if f == "R":
                np.testing.assert_allclose(got, b.numpy()[act], rtol=0, atol=2.4e-7)
            else:
                np.testing.assert_array_equal(got, b.numpy()[act], err_msg=f)
    for got in (m_out.mp_pos.numpy(), jm.mp_pos):
        np.testing.assert_array_equal(got, m_j.mp_pos.numpy())
    assert torch.isfinite(m_out.mp_pos[m_out.mp_active]).all()
