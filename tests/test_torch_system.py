"""The port's `SlamSystem` class on the CPU (`device="cpu"`): its state
machine on the first frames of the bootstrap fixture, `reset`, localization
mode, LOST handling with its count and event, the inputs and options that are
not ported (they raise) and the depth inputs that now are, `upload`, `global_refine` over 41 synthetic
keyframes (which must take the landmark-chunked BA and agree with the dense
one to 1e-3 m), `StageTimer` (as tests/test_aux.py), `VIInitLog`, the config's
defaults against the JAX package's field by field, and the hand-over of the
host state through `convert`."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from mc_slam_tpu.pipeline import pipebase as jpipebase
from mc_slam_tpu.pipeline.system import SlamConfig as JSlamConfig
from mc_slam_tpu.utils.metrics import VIInitLog as JVIInitLog
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.imu.navstate import navstate_identity
from mc_slam_tpu_torch.pipeline import mapping_ctl, pipebase, tracking_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, NO_IMAGES_YET, NOT_INITIALIZED, OK
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
from mc_slam_tpu_torch.pipeline.viinit import VIInitResult
from mc_slam_tpu_torch.utils.metrics import StageTimer, VIInitLog

import chip_smoke
from torch_port_helpers import BOOT, boot_run

torch.set_num_threads(2)


def _system():
    seq, cam, _, _, _ = boot_run()
    return seq, SlamSystem(cam, chip_smoke.slam_config(BOOT), Tbc=chip_smoke.TBC, device="cpu")


def test_config_defaults_equal_the_jax_config():
    j, t = JSlamConfig(), SlamConfig()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert tf == jf and list(tf) == list(jf)
    assert (pipebase.NO_IMAGES_YET, pipebase.NOT_INITIALIZED, pipebase.OK, pipebase.LOST) == \
        (jpipebase.NO_IMAGES_YET, jpipebase.NOT_INITIALIZED, jpipebase.OK, jpipebase.LOST)


def test_state_machine_reset_and_localization_mode():
    seq, slam = _system()
    assert slam.state == NO_IMAGES_YET and slam.frame_id == 0 and slam.kf_slots == []
    assert not slam.vi_inited and slam.n_kf == 0 and slam.get_trajectory() == []
    np.testing.assert_allclose(slam.gw.numpy(), [0, 0, -9.81], atol=1e-6)
    # frame 0 is kept as the two-view reference; frame 1 initializes the map
    assert slam.track(seq.imgs[0], seq.times[0], seq.imu[0]) is False
    assert slam.state == NOT_INITIALIZED and slam.frame_id == 1 and slam.n_kf == 0
    assert slam.track(seq.imgs[1], seq.times[1], seq.imu[1]) is True
    assert slam.state == OK and slam.kf_slots == [0, 1] and slam.n_kf == 2
    assert slam.events[0][:2] == (1, "init") and slam.last_init.ok
    assert slam.st.next_fresh_slot == 2 and set(slam.st.kf_time_host) == {0, 1}
    # the IMU rows given before the first keyframe went to keyframe 1
    assert set(slam.st.kf_imu_raw) == {1} and float(slam.m.kf_preint.dT[1]) > 0.04
    assert len(slam.get_trajectory()) == 1
    assert slam.track(seq.imgs[2], seq.times[2], seq.imu[2]) is True
    assert slam.last_outcome.n_inliers > 50 and len(slam.traj) == 2
    P, R = slam.last_pose
    assert P.shape == (3,) and R.shape == (3, 3) and slam.last_ns.P.shape == (3,)
    # localization mode: frames are tracked, no keyframe is inserted even past
    # kf_max_gap, and the map's keyframe tables stay as they are
    slam.set_localization_mode(True)
    kf_mp = slam.m.kf_mp.clone()
    for i in range(3, 3 + slam.cfg.kf_max_gap + 2):
        assert slam.track(seq.imgs[i], seq.times[i], seq.imu[i])
    assert slam.n_kf == 2 and slam.kf_slots == [0, 1] and torch.equal(slam.m.kf_mp, kf_mp)
    assert slam.frame_id - slam.st.last_kf_frame > slam.cfg.kf_max_gap
    slam.set_localization_mode(False)
    i += 1
    assert slam.track(seq.imgs[i], seq.times[i], seq.imu[i]) and slam.n_kf == 3
    assert slam.last_outcome.keyframe == 2 and slam.last_outcome.event is not None
    s = slam.timers.summary()
    assert s["track"]["n"] == slam.frame_id - 2 and s["lm_ba"]["n"] == 1 and "lm_cull" in s
    assert s["extract"]["n"] == 2 and s["initialize"]["n"] == 1
    assert len(slam.get_trajectory()) == slam.frame_id - 1
    # reset: an empty system with the same configuration
    cfg = slam.cfg
    slam.reset()
    assert slam.state == NO_IMAGES_YET and slam.frame_id == 0 and slam.n_kf == 0
    assert slam.cfg is cfg and slam.ts is None and len(slam.traj) == 0 and slam.events == []
    assert not bool(slam.m.kf_active.any()) and not bool(slam.m.mp_active.any())
    assert slam.track(seq.imgs[0], seq.times[0]) is False and slam.state == NOT_INITIALIZED


def test_blank_frame_gives_lost_counted_and_logged():
    seq, slam = _system()
    for i in range(3):
        slam.track(seq.imgs[i], seq.times[i], seq.imu[i])
    assert slam.state == OK and slam.n_lost_frames == 0
    n_rows = len(slam.traj)
    blank = np.zeros_like(seq.imgs[0])
    assert slam.track(blank, seq.times[3], seq.imu[3]) is False
    assert slam.state == LOST and slam.n_lost_frames == 1 and len(slam.traj) == n_rows
    fid, kind, detail = slam.events[-1]
    assert (fid, kind) == (3, "lost") and detail["mode"] == "vis"
    assert detail["n_in"] < slam.cfg.min_track_inliers
    # a LOST system tries to relocalize on every frame: a second blank frame
    # fails and is counted, the next real frame is relocalized against the map
    assert slam.track(blank, seq.times[4], seq.imu[4]) is False
    assert slam.state == LOST and slam.n_lost_frames == 2 and slam.events[-1][:2] == (4, "lost")
    assert slam.events[-1][2]["mode"] == "lost"
    assert slam.frame_id == 5 and len(slam.get_trajectory()) == n_rows
    assert slam.track(seq.imgs[4], seq.times[5], seq.imu[5]) is True
    assert slam.state == OK and slam.n_lost_frames == 2 and len(slam.traj) == n_rows + 1
    fid, kind, detail = slam.events[-1]
    assert (fid, kind) == (5, "reloc") and detail["n_in"] >= slam.cfg.min_track_inliers
    assert slam.last_outcome.mode == "reloc" and slam.reloc_buf is None   # no VI init yet


def test_inputs_and_options_that_are_not_ported_raise():
    seq, slam = _system()
    img = seq.imgs[0]
    # depth= and img_right= are ported: a depth frame with too few depth
    # points initializes nothing; one with enough builds the metric map at once
    assert slam.track(img, 0.0, depth=np.zeros_like(img, np.float32)) is False
    assert slam.frame_id == 1 and slam.state == NO_IMAGES_YET and slam.sensor_depth
    assert slam.track(img, 0.05, img_right=img) is False       # zero disparity: no depth
    assert slam.track(img, 0.1, seq.imu[1], depth=seq.depths[0]) is True
    assert slam.state == OK and slam.kf_slots == [0] and slam.events[-1][1] == "init"
    assert bool((slam.m.kf_ur[0] >= 0).any()) and int(slam.m.mp_active.sum()) >= 50
    slam.reset()
    assert slam.frame_id == 0 and slam.state == NO_IMAGES_YET and not slam.sensor_depth
    # loop closing is on by default and can be set, as in the JAX class
    assert slam.enable_loop_closing is True
    slam.enable_loop_closing = False
    assert slam.enable_loop_closing is False
    slam.enable_loop_closing = True
    assert slam.enable_loop_closing is True and slam.n_loops_closed == 0
    assert slam.loop.hists.shape == (slam.cfg.max_kf, 32768) and slam.loop_edges == []
    with pytest.raises(NotImplementedError, match="mesh"):
        slam.enable_mesh()
    # the XYZ form of the VI window BA is ported (use_idp_ba=False): a window
    # of one keyframe has nothing to solve
    st = mapping_ctl.MappingState(kf_slots=[0], last_kf_slot=0, vi_inited=True)
    assert mapping_ctl.local_ba(slam.m, st, SlamConfig(use_idp_ba=False), slam.cam, slam.ext,
                                slam.gw, slam.noise) == (slam.m, None)


def test_upload_keeps_uint8_and_accepts_tensors():
    _, slam = _system()
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    u = slam.upload(a)
    assert u.dtype == torch.uint8 and u.device.type == "cpu" and u.tolist() == a.tolist()
    assert slam.upload(a.astype(np.float64)).dtype == torch.float32
    assert slam.upload(a.astype(np.float32)).dtype == torch.float32
    t = torch.from_numpy(a)
    assert slam.upload(t) is t
    assert slam._imu_rows(None) is None and slam._imu_rows(np.zeros((0, 7))) is None
    rows = slam._imu_rows(np.ones((3, 7)))
    assert rows.dtype == torch.float32 and rows.shape == (3, 7)
    with pytest.raises((RuntimeError, AssertionError)):
        SlamSystem(slam.cam, SlamConfig())          # no device given: the card, absent here


def _synthetic_system(n_kf=41, n_pts=300, seed=3):
    """A SlamSystem whose map holds n_kf keyframes on a line looking down +z
    at n_pts random points (exact observations), visual state."""
    rng = np.random.default_rng(seed)
    cam = make_camera(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
    cfg = SlamConfig(max_kf=64, max_mp=2048, n_feat=64, n_levels=4)
    slam = SlamSystem(cam, cfg, device="cpu")
    pts = np.stack([rng.uniform(-3, 7, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 9, n_pts)], 1).astype(np.float32)
    slots = rng.choice(cfg.max_mp, n_pts, replace=False)     # spread over both chunks
    m = slam.m
    mp_pos, mp_active = m.mp_pos.clone(), m.mp_active.clone()
    mp_pos[slots] = torch.from_numpy(pts)
    mp_active[slots] = True
    m = m._replace(mp_pos=mp_pos, mp_active=mp_active)
    feats = type("F", (), dict(level=torch.zeros(64, dtype=torch.int32), angle=torch.zeros(64),
                               desc=torch.zeros((64, 8), dtype=torch.int32),
                               desc_pm1=torch.ones((64, 256), dtype=torch.int8),
                               valid=torch.ones(64, dtype=torch.bool)))
    P_true = np.stack([np.linspace(0, 4, n_kf), np.zeros(n_kf), np.zeros(n_kf)], 1)
    for k in range(n_kf):
        rel = pts - P_true[k]
        uv = np.stack([400 * rel[:, 0] / rel[:, 2] + 320, 400 * rel[:, 1] / rel[:, 2] + 240], 1)
        vis = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480))[0]
        pick = rng.choice(vis, 64, replace=False)
        ns = navstate_identity(device="cpu")._replace(
            P=torch.tensor(P_true[k], dtype=torch.float32))
        m, slot = mapping_ctl.insert_keyframe(
            m, slam.st, cfg, ns, feats, torch.from_numpy(uv[pick].astype(np.float32)),
            0.5 * k, k, None, slam.noise,
            feat_mp=torch.from_numpy(slots[pick].astype(np.int32)))
    slam.m = m
    slam.ts = tracking_ctl.start_tracking(m, slam.st, cfg.g_mag, 0.5 * n_kf, traj=slam.traj)
    slam.state = OK
    return slam, P_true.astype(np.float32)


def test_global_refine_over_41_keyframes_takes_the_chunked_ba(monkeypatch):
    slam, P_true = _synthetic_system()
    assert len(slam.kf_slots) == 41 > mapping_ctl.GBA_MAX_KF
    rng = np.random.default_rng(0)
    noise = rng.normal(size=P_true.shape).astype(np.float32) * 0.03
    noise[0] = 0                                   # the oldest keyframe is the gauge
    P0 = slam.m.kf_ns.P.clone()
    P0[:41] += torch.from_numpy(noise)
    slam.m = slam.m._replace(kf_ns=slam.m.kf_ns._replace(P=P0))
    m0 = slam.m
    calls = []
    orig = mapping_ctl.global_ba_chunked
    monkeypatch.setattr(mapping_ctl, "global_ba_chunked",
                        lambda *a, **k: (calls.append(k), orig(*a, **k))[1])
    slam.global_refine()
    assert len(calls) == 1 and calls[0]["prune"] is False
    stats = slam.last_gba
    costs = stats.costs.numpy()
    assert len(costs) == 11 and np.all(np.diff(costs) <= 0) and costs[-1] < 1e-2 * costs[0]
    P1 = slam.m.kf_ns.P[:41].numpy()
    assert np.abs(P1 - P_true).max() < 0.2 * np.abs(noise).max()
    # rows past the real keyframes (the padding to 64) were not written back:
    # the newest keyframe holds the solver's result, idle slots are untouched
    assert np.abs(P1[40] - P_true[40]).max() < 0.01 < np.abs(noise[40]).max()
    assert torch.equal(slam.m.kf_ns.P[41:], m0.kf_ns.P[41:])
    assert torch.equal(slam.m.kf_mp, m0.kf_mp)              # prune off
    # tracking was re-seated on the refined newest keyframe
    assert torch.equal(slam.ts.P, slam.m.kf_ns.P[slam.st.last_kf_slot])
    assert slam.st.covis_row is None and "global_refine" in slam.timers.summary()
    # against the dense form on the same start (its keyframe limit lifted)
    monkeypatch.setattr(mapping_ctl, "GBA_MAX_KF", 64)
    args = (slam.st, slam.cfg, slam.cam, slam.ext, slam.gw, slam.noise)
    m_d, st_d = mapping_ctl.local_ba(m0, *args, force_all=True, prune=False)
    assert len(calls) == 1                                   # this one was dense
    np.testing.assert_allclose(P1, m_d.kf_ns.P[:41].numpy(), atol=1e-3)
    np.testing.assert_allclose(float(stats.cost), float(st_d.cost), rtol=1e-2, atol=1e-3)
    # with the prune on, the flat chi2 pass clears a planted outlier only
    uv = m0.kf_uv.clone()
    uv[5, 7] += 40.0
    m_bad = m0._replace(kf_uv=uv)
    m_p, _ = orig(m_bad, *args, list(slam.st.kf_slots), prune=True)
    changed = (m_p.kf_mp != m_bad.kf_mp).nonzero().tolist()
    assert changed == [[5, 7]] and int(m_p.kf_mp[5, 7]) == -1


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        with t.stage("inner"):
            pass
    s = t.summary()
    assert s["a"]["n"] == 2 and s["inner"]["n"] == 1 and "device_median_ms" not in s["a"]
    assert s["a"]["total_s"] >= s["inner"]["total_s"]       # nested: reported, not summed
    assert "a" in t.report() and "inner" in t.report()
    mark = t.marks("ev_")
    for name in ("pre", "ba", "post", "end"):
        mark(name)
    mark("pre")
    mark("end")
    s = t.summary()
    assert s["ev_pre"]["n"] == 2 and s["ev_ba"]["n"] == s["ev_post"]["n"] == 1
    assert "ev_end" not in s
    assert StageTimer("cpu").cuda is False and StageTimer(torch.device("cuda", 0)).cuda is True


def test_viinit_log_writes_the_reference_file_set(tmp_path):
    res = VIInitResult(bg=torch.tensor([1e-3, 2e-3, 3e-3]), ba=torch.tensor([0.1, 0.2, 0.3]),
                       scale=torch.tensor(3.5), scale_star=torch.tensor(3.4),
                       gw=torch.tensor([0.0, 0.1, -9.8]), Rwi=torch.eye(3),
                       cond=torch.arange(6.0).flip(0))
    res_np = VIInitResult(*[x.numpy() for x in res])
    for cls, d, r in ((VIInitLog, tmp_path / "t", res), (JVIInitLog, tmp_path / "j", res_np)):
        log = cls(str(d))
        log.log_attempt(5.0, r, 12.5)
        log.log_attempt(5.5, r, 13.0)
        log.close()
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(["scale.txt", "biasg.txt", "biasa.txt", "gw.txt", "condnum.txt",
                            "computetime.txt", "Rwi.txt"])
    for n in names:
        assert (tmp_path / "t" / n).read_text() == (tmp_path / "j" / n).read_text(), n
    assert len((tmp_path / "t" / "scale.txt").read_text().splitlines()) == 2


def test_host_state_goes_through_convert_both_ways():
    _, _, _, res, _ = boot_run()
    st, traj = res["st"], res["ts"].traj
    d = convert.host_state_to_dict(st, traj)
    assert d["kf_slots"] == st.kf_slots and d["kf_slots"] is not st.kf_slots
    assert d["_chain_break_pending"] is False and d["next_fresh_slot"] == 11
    assert all(isinstance(v, np.ndarray) for v in d["kf_imu_raw"].values())
    st2, traj2 = convert.host_state_from_dict(copy.deepcopy(d), "cpu")
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(st2, f.name)
        if f.name == "kf_imu_raw":
            assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        elif f.name == "covis_row":
            np.testing.assert_array_equal(a, b)
        elif f.name != "last_init_attempt_nkf":
            assert a == b, f.name
    m = res["m"]
    kf = (m.kf_ns.P, m.kf_ns.R, m.kf_id, m.kf_active)
    for (t0, P0, R0), (t1, P1, R1) in zip(traj.compose(*kf), traj2.compose(*kf)):
        assert t0 == t1
        np.testing.assert_array_equal(P0, P1)
    assert len(traj2) == len(traj) == len(res["frames"]) + 1
