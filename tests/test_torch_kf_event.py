"""The slice as a whole: one Mono+IMU keyframe event (insertion, pre-BA half,
inverse-depth window BA, post-BA half), the JAX package's and the port's, on
the same converted MapState; the track-and-map run of chip_smoke.py at
the small profile on the CPU; and the host helpers of the event.

The MapState is the small track-and-map run's (torch_port_helpers.SMALL:
K = 8, P = 1024, F = 256, window of 3 keyframes padded to 12 slots on the
port's side). The JAX side solves the UNPADDED window: its own pad rule
writes the last window slot several times (old values among them), which is
the divergence the port repairs; every other step is the same call.

Tolerances: after the pre-BA half every table must match as in
test_torch_mapping.py (integers exact, floats 1e-4). After the window BA the
two float32 LM runs (8 iterations, accept / reject) agree to 1e-3 m in
keyframe positions, 1e-3 in rotations, 5e-3 m in landmark positions, and
the chi2 prune may differ on observations within rounding of its threshold
(<= 0.2 % of the association table). The cost curves are compared at 2 %."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mc_slam_tpu.imu.preintegration import euroc_noise as j_noise, preintegrate as j_preintegrate
from mc_slam_tpu.pipeline import mapping as jmap
from mc_slam_tpu.pipeline.mapping_ctl import MappingCtlMixin
from mc_slam_tpu.solver import ba_vi_idp as jidp
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.frontend import match_cuda
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise
from mc_slam_tpu_torch.pipeline import mapping as tmap, mapping_ctl
from mc_slam_tpu_torch.pipeline.system import SlamConfig
from mc_slam_tpu_torch.slam_map.mapstate import MapState, empty_map
from mc_slam_tpu_torch.solver import pose_lm_cuda, pose_vi_lm_cuda
from mc_slam_tpu_torch.tools import probes

from torch_port_helpers import (SMALL, assert_maps_match, jax_cam, jax_ext, jax_map,
                                small_run, torch_map)

torch.set_num_threads(2)
i32 = lambda v: jnp.asarray(v, jnp.int32)
GW = np.array([0.0, 0.0, -9.81], np.float32)


def test_filled_map_converts_both_ways():
    """A MapState with a filled kf_preint and kf_mp goes to the JAX package's
    layout and back field by field, dtypes kept."""
    _, _, _, _, captured = small_run()
    tm = captured[1][0]
    assert float(tm.kf_preint.dT[2]) > 0.4 and int((tm.kf_mp[2] >= 0).sum()) > 20
    back = torch_map(jax_map(tm))
    for a, b, name in zip(tm, back, MapState._fields):
        leaves = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for u, v in leaves:
            assert u.dtype == v.dtype and torch.equal(u, v), name
    jm = jax_map(tm)
    assert jm.kf_desc.dtype == np.uint32 and jm.kf_mp.dtype == np.int32


def test_one_keyframe_event_matches_jax():
    seq, cam, ext, res, captured = small_run()
    tm, st, frame = captured[1]
    slot = st.last_kf_slot
    cfg = SlamConfig(n_levels=SMALL.n_levels, local_window=SMALL.local_window, use_imu=True)
    jm, jcam, jext = jax_map(tm), jax_cam(cam), jax_ext()

    # ---- pre-BA half ----
    jm1, nb4, nbv4, wslots, wvalid = jmap.kf_event_pre(
        jm, i32(slot), jnp.asarray(frame), jcam, jext, i32(cfg.n_levels),
        min_obs=cfg.cull_min_obs, n_evict=int(0.07 * tm.P),
        covis_th=cfg.covis_th, max_new=SMALL.max_new)
    tm1, nb4_t, nbv4_t, wslots_t, wvalid_t, (n_new, n_fused) = tmap.kf_event_pre(
        tm, slot, frame, cam, ext, cfg.n_levels, min_obs=cfg.cull_min_obs,
        n_evict=int(0.07 * tm.P), covis_th=cfg.covis_th, max_new=SMALL.max_new)
    for a, b in ((nb4, nb4_t), (nbv4, nbv4_t), (wslots, wslots_t), (wvalid, wvalid_t)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert_maps_match(jm1, tm1, rtol=1e-4, atol=1e-4, msg="after kf_event_pre")
    assert int(n_new) == int(jm1.mp_active.sum()) - int(jm.mp_active.sum()) > 0

    # ---- window BA: the port's padded window against the JAX unpadded one ----
    prob = mapping_ctl.window_problem(st, cfg)
    n_real = prob["n_real"]
    assert n_real == 3 and len(prob["all_slots"]) == 12
    assert prob["all_slots"][n_real:] == [prob["all_slots"][n_real - 1]] * 9
    jm2 = jidp.window_vi_ba_map(
        jm1, i32(prob["all_slots"][:n_real]), jnp.asarray(prob["idx_i"][:n_real]),
        jnp.asarray(prob["idx_j"][:n_real]), jnp.asarray(prob["ev"][:n_real]),
        i32(n_real), jnp.asarray(prob["free"][:n_real]), jcam, jext, jnp.asarray(GW),
        2e-5, 5e-3, prior=None, iters=mapping_ctl.BA_ITERS, rtol=0.0, Pw=SMALL.ba_Pw,
        do_prune=True)
    noise = euroc_noise(device="cpu")
    tm2, ba = mapping_ctl.local_ba_idp(tm1, st, cfg, cam, ext, torch.from_numpy(GW), noise,
                                       ba_Pw=SMALL.ba_Pw)
    jn, tn = jax.tree_util.tree_map(np.asarray, jm2.kf_ns), convert.to_numpy(tm2.kf_ns)
    np.testing.assert_allclose(tn["P"], jn.P, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tn["R"], jn.R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tn["V"], jn.V, rtol=0, atol=1e-2)
    np.testing.assert_allclose(tm2.mp_pos.numpy(), np.asarray(jm2.mp_pos), rtol=0, atol=5e-3)
    assert (tm2.kf_mp.numpy() != np.asarray(jm2.kf_mp)).mean() <= 2e-3
    assert int(ba.overflow) == 0 and float(ba.cost) <= float(ba.cost0)
    # the optimised newest keyframe was written back (padding did not win)
    assert np.abs(tn["P"][slot] - tm1.kf_ns.P.numpy()[slot]).max() > 1e-5

    # ---- post-BA half, each side on its own BA result ----
    hists = np.zeros((tm.K, 4), np.float32)
    jm3, jstats, _, jW = jmap.kf_event_post(jm2, i32(slot), wslots, wvalid, jext,
                                            jnp.asarray(hists), i32(cfg.n_levels), min_obs=3)
    tm3, tstats, scores, tW = tmap.kf_event_post(tm2, slot, wslots_t, wvalid_t, ext,
                                                 torch.from_numpy(hists), cfg.n_levels,
                                                 min_obs=3)
    same_assoc = (tm2.kf_mp.numpy() == np.asarray(jm2.kf_mp)).all()
    if same_assoc:
        for a, b in zip(jstats, tstats):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(tm3.mp_desc.numpy().view(np.uint32), np.asarray(jm3.mp_desc))
    np.testing.assert_allclose(tm3.mp_normal.numpy(), np.asarray(jm3.mp_normal), rtol=0, atol=5e-3)
    assert float(scores.abs().max()) == 0.0

    # ---- and the port's one-call event gives the port's step-by-step result ----
    tm_e, result = mapping_ctl.keyframe_event(tm, st, cfg, frame, cam, ext,
                                              torch.from_numpy(GW), noise)
    assert torch.equal(tm_e.kf_mp, tm3.kf_mp) and torch.equal(tm_e.mp_active, tm3.mp_active)
    np.testing.assert_allclose(tm_e.mp_pos.numpy(), tm3.mp_pos.numpy(), rtol=0, atol=1e-6)
    assert int(result.n_created) == int(n_new) and int(result.n_fused) == int(n_fused)


def test_event_cost_curve_matches_jax():
    """The window BA of the event with one LM round, k iterations on the JAX
    side against the k-th point of the port's curve."""
    _, cam, ext, _, captured = small_run()
    tm, st, _ = captured[1]
    cfg = SlamConfig(n_levels=SMALL.n_levels, local_window=SMALL.local_window, use_imu=True)
    prob = mapping_ctl.window_problem(st, cfg)
    n = prob["n_real"]
    t = lambda a, dt: torch.as_tensor(np.asarray(a[:n]), dtype=dt)
    from mc_slam_tpu_torch.solver import ba_vi_idp as tidp
    _, stats = tidp.window_vi_ba_map(
        tm, t(prob["all_slots"], torch.int64), t(prob["idx_i"], torch.int64),
        t(prob["idx_j"], torch.int64), t(prob["ev"], torch.float32), n,
        t(prob["free"], torch.float32), cam, ext, torch.from_numpy(GW), 2e-5, 5e-3,
        iters=3, two_phase=False, Pw=SMALL.ba_Pw, do_prune=False)
    curve = stats.costs.numpy()
    assert curve.shape == (4,) and np.all(np.diff(curve) <= 0)
    jm, jcam, jext = jax_map(tm), jax_cam(cam), jax_ext()
    # the JAX entry returns no cost: recompute it from its result with the
    # port's own cost (one more linearization, zero iterations would not run)
    for k in (1, 3):
        jm2 = jidp.window_vi_ba_map(
            jm, i32(prob["all_slots"][:n]), jnp.asarray(prob["idx_i"][:n]),
            jnp.asarray(prob["idx_j"][:n]), jnp.asarray(prob["ev"][:n]), i32(n),
            jnp.asarray(prob["free"][:n]), jcam, jext, jnp.asarray(GW), 2e-5, 5e-3,
            iters=k, two_phase=False, Pw=SMALL.ba_Pw, do_prune=False)
        tm_k = tm._replace(kf_ns=torch_map(jm2).kf_ns, mp_pos=torch.from_numpy(np.array(jm2.mp_pos)))
        _, st_k = tidp.window_vi_ba_map(
            tm_k, t(prob["all_slots"], torch.int64), t(prob["idx_i"], torch.int64),
            t(prob["idx_j"], torch.int64), t(prob["ev"], torch.float32), n,
            t(prob["free"], torch.float32), cam, ext, torch.from_numpy(GW), 2e-5, 5e-3,
            iters=2, two_phase=False, Pw=SMALL.ba_Pw, do_prune=False)
        np.testing.assert_allclose(float(st_k.cost0), curve[k], rtol=2e-2, err_msg=f"k={k}")


def test_track_and_map_run_small_profile():
    """chip_smoke.py's path 2 at the small profile on the CPU: 20 frames, two
    events, its own checks, and kernel-wrapper == twin on recorded searches."""
    seq, cam, ext, res, captured = small_run()
    assert len(res["events"]) == 2 and len(captured) == 2
    chip_smoke.check_track_and_map(res, SMALL)
    assert res["st"].kf_slots == [0, 1, 2] and res["st"].covis_row is not None
    for e in res["events"]:
        assert e["overflow"] == 0 and e["cost"] <= e["cost0"] and e["syncs"] == 0
        assert e["n_landmarks"] > 50 and "triangulated" in chip_smoke.event_line(e)
    assert res["events"][1]["n_created"] > 0
    assert int(res["m"].kf_active.sum()) == 3
    rec = res["recorder"]
    assert len(rec.calls) == 4
    for _, args, _ in rec.calls:
        inp = dict(zip(("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid", "b_desc",
                        "b_pm1", "b_uv", "b_lvl", "b_valid"), args[:10]))
        assert chip_smoke.compare_kernel(inp, args[10])[0] == 0


@pytest.mark.parametrize("kernel", ["search", "pose_lm", "pose_vi_lm"])
def test_kernel_bound_arithmetic(kernel):
    """Each hand kernel's `work` (its module) over the card's peaks
    (`probes.bound_ms`): the search on planted inputs at r = 15 px, the pose
    LM at the batched step's B = 11, O = 1024, 10 iterations, monocular, and
    the VI pose LM at O = 1024, 20 iterations with the marginal (PERF.md's
    bounds: 0.53 us and 0.118 us)."""
    if kernel == "search":
        inp = chip_smoke.planted_inputs(3000, 500, np.random.default_rng(2), "cpu")
        work = match_cuda.work(*chip_smoke.search_args(inp), 15.0)
        rate = probes.SIMPLE_OPS_PER_S
    elif kernel == "pose_lm":
        work, rate = pose_lm_cuda.work(11, 1024, 10), probes.FLOAT_OPS_PER_S
    else:
        work, rate = pose_vi_lm_cuda.work(1024, 20), probes.FLOAT_OPS_PER_S
    ms, by, d = probes.bound_ms(*work, rate=rate)
    assert by == "operations" and ms == pytest.approx(d["operations"] / rate * 1e3)
    if kernel == "search":
        assert d["pairs"] <= 3000 * 500 and 0 < d["passing_pairs"] < d["pairs"]
        assert d["bytes"] == (3000 + 500) * 45 + 12 * 3000
        assert ms == pytest.approx((d["pairs"] * 8 + d["passing_pairs"] * 24) / 33.5e12 * 1e3)
    elif kernel == "pose_lm":
        assert (d["bytes"], d["operations"]) == (451_704, 35_803_812)    # 0.45 MB, 35.8 M
        assert round(ms * 1e3, 2) == 0.53
    else:
        assert (d["bytes"], d["operations"]) == (43_908, 7_879_130)      # 44 KB, 7.88 M
        assert round(ms * 1e3, 3) == 0.118


@pytest.mark.parametrize("prev_idx,broken", [(None, ()), (5, ()), (5, (3,)), (None, (0, 2))])
def test_imu_edge_lists_match_jax(prev_idx, broken):
    slots = [4, 0, 2, 3, 7, 9, 9, 9]
    host = types.SimpleNamespace(broken_chain_slots=set(broken))
    ref = MappingCtlMixin._imu_edge_lists(host, slots, 5, prev_idx=prev_idx, n_pad=8)
    got = mapping_ctl.imu_edge_lists(slots, 5, set(broken), prev_idx=prev_idx, n_pad=8)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_window_problem_pad_rule_and_predecessor():
    cfg = SlamConfig(local_window=3, ba_window=2)
    st = mapping_ctl.MappingState(kf_slots=[0, 1, 2, 3, 4], last_kf_slot=4)
    prob = mapping_ctl.window_problem(st, cfg)
    # window = the newest 3; its front's predecessor (slot 1) joins as fixed
    assert prob["all_slots"] == [2, 3, 4, 1, 1, 1, 1] and prob["n_real"] == 4
    assert prob["free"].tolist() == [1, 1, 1, 0, 0, 0, 0]
    assert (prob["idx_i"][0], prob["idx_j"][0], prob["ev"][0]) == (3, 0, 1.0)
    assert prob["ev"].tolist() == [1, 1, 1, 0, 0, 0, 0]
    # all keyframes inside the window: no observer, so the oldest is the gauge
    st2 = mapping_ctl.MappingState(kf_slots=[0, 1], last_kf_slot=1)
    prob2 = mapping_ctl.window_problem(st2, cfg)
    assert prob2["free"].tolist()[:2] == [0, 1] and prob2["ev"][0] == 0.0
    assert mapping_ctl.window_problem(mapping_ctl.MappingState(kf_slots=[0], last_kf_slot=0),
                                      cfg) is None
    # a strongly covisible keyframe outside the window joins as a fixed observer
    row = np.zeros(8, np.float32)
    row[[0, 1]] = [40, 10]
    st3 = mapping_ctl.MappingState(kf_slots=[0, 1, 2, 3, 4], last_kf_slot=4, covis_row=row)
    prob3 = mapping_ctl.window_problem(st3, cfg)
    assert prob3["all_slots"][:5] == [2, 3, 4, 1, 0] and prob3["n_real"] == 5


def test_insert_keyframe_matches_jax_tables():
    """insert_keyframe = the preintegration of every row since the last
    keyframe at the carried bias + write_keyframe with the bias folded."""
    seq, cam, ext, res, captured = small_run()
    tm, st, frame = captured[0]
    slot = st.last_kf_slot
    rows = np.concatenate(seq.imu[1:frame + 1]).astype(np.float32)
    assert float(tm.kf_preint.dT[slot]) == pytest.approx(rows[:, 6].sum(), rel=1e-5)
    rawp = np.zeros((256, 7), np.float32)
    rawp[:len(rows)] = rows
    bg = tm.kf_ns.bg[slot].numpy()
    ba = tm.kf_ns.ba[slot].numpy()
    pre_j = j_preintegrate(jnp.asarray(rawp), jnp.asarray(bg), jnp.asarray(ba), j_noise())
    for f, a in zip(pre_j._fields, pre_j):
        b = getattr(tm.kf_preint, f)[slot].numpy()
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-4,
                                   atol=2e-4 * max(np.abs(np.asarray(a)).max(), 1e-6), err_msg=f)
    assert tm.kf_ns.dbg[slot].abs().max() == 0 and bool(tm.kf_active[slot])
    assert int(tm.kf_id[slot]) == frame and (tm.kf_ur[slot] == -1).all()
    assert int((tm.kf_mp[slot] >= 0).sum()) >= SMALL.fb_min_inliers
    # the first keyframe carries no preintegration
    m0, slot0 = mapping_ctl.insert_keyframe(
        empty_map(4, 16, tm.F, device="cpu"), mapping_ctl.MappingState(),
        SlamConfig(use_imu=True), NavState(*[a[slot] for a in tm.kf_ns]),
        types.SimpleNamespace(level=tm.kf_level[slot], angle=tm.kf_angle[slot],
                              desc=tm.kf_desc[slot], desc_pm1=tm.kf_pm1[slot],
                              valid=tm.kf_feat_valid[slot]),
        tm.kf_uv[slot], 0.0, 0, None, euroc_noise(device="cpu"))
    assert slot0 == 0 and float(m0.kf_preint.dT[0]) == 0.0 and (m0.kf_mp[0] == -1).all()
