"""Keyframe slots, removal and culling of the port against the JAX package's
SlamSystem methods, on the final state of one bootstrap run of the port
(torch_port_helpers.boot_run: 11 keyframes, VI initialized, 104 trajectory
rows) handed to a JAX SlamSystem in parity mode, and on small synthetic
chains for the time-gap guards.

Tolerances: every integer / bool / descriptor table and every host table
exactly; float tables 1e-5; the successor's preintegration after a splice
1e-5 absolute plus 2e-4 of each field's largest entry (two float32
recursions over up to 400 rows, the JAX one chained in 256-row pieces);
composed trajectories 1e-5."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.pipeline import mapping as jmap
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise
from mc_slam_tpu_torch.pipeline import mapping as tmap, mapping_ctl
from mc_slam_tpu_torch.pipeline.system import SlamConfig
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import empty_map

import chip_smoke
from torch_port_helpers import (BOOT, assert_host_state_matches, assert_maps_match, boot_run,
                                jax_system_from_port)

torch.set_num_threads(2)
NOISE = euroc_noise(device="cpu")
_np = lambda x: jax.tree_util.tree_map(np.asarray, x)


def _final_state(monkeypatch, **cfg_kw):
    """(JAX system, port MapState, MappingState copy, TrajStore copy, cfg)."""
    _, cam, _, res, _ = boot_run()
    tm, st, traj = res["m"], copy.deepcopy(res["st"]), copy.deepcopy(res["ts"].traj)
    cfg = chip_smoke.slam_config(BOOT)
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    js = jax_system_from_port(monkeypatch, cam, tm, st, traj, frame_id=res["last_frame"],
                              **cfg_kw)
    return js, tm, st, traj, cfg


def _assert_preint_row(jm, tm, slot, msg):
    for f, a in zip(jm.kf_preint._fields, _np(jm.kf_preint)):
        b = getattr(tm.kf_preint, f)[slot].numpy()
        np.testing.assert_allclose(b, a[slot], rtol=0, atol=1e-5 + 2e-4 * np.abs(a[slot]).max(),
                                   err_msg=f"{msg} {f}")


def _assert_same_trajectory(js, tm, traj):
    ref = js.get_trajectory()
    got = traj.compose(tm.kf_ns.P, tm.kf_ns.R, tm.kf_id, tm.kf_active)
    assert len(ref) == len(got) > 100
    for (t0, P0, R0), (t1, P1, R1) in zip(ref, got):
        assert t0 == t1
        np.testing.assert_allclose(P1, P0, atol=1e-5)
        np.testing.assert_allclose(R1, R0, atol=1e-5)


@pytest.mark.parametrize("which", [4, -2, -1])
def test_remove_keyframe_matches_jax(monkeypatch, which):
    """A middle keyframe, the second-newest (heir: the newest) and the newest
    (no successor: heir is the previous one, nothing to splice)."""
    js, tm, st, traj, cfg = _final_state(monkeypatch)
    victim = st.kf_slots[which]
    nxt = st.kf_slots[which + 1] if which != -1 else None
    heir = nxt if nxt is not None else st.kf_slots[-2]
    n_anchored = sum(m[1] == victim for m in traj.meta)
    n_ref = int((tm.mp_ref_kf == victim).sum())
    assert n_anchored > 0
    js._remove_keyframe(victim)
    tm2 = mapping_ctl.remove_keyframe(tm, st, cfg, victim, NOISE, traj=traj)
    assert_maps_match(js.m, tm2, rtol=1e-5, atol=1e-5, skip=("kf_preint",), msg="removal")
    assert_host_state_matches(js, st)
    assert victim not in st.kf_slots and st.free_slots == [victim]
    assert not bool(tm2.kf_active[victim]) and (tm2.kf_mp[victim] == -1).all()
    assert int((tm2.mp_ref_kf == victim).sum()) == 0
    assert int((tm2.mp_ref_kf == heir).sum()) >= n_ref
    # the rows recorded against the culled keyframe now hang on its heir
    assert sum(m[1] == victim for m in traj.meta) == 0
    assert sum(m[1] == heir for m in traj.meta) >= n_anchored
    _assert_same_trajectory(js, tm2, traj)
    if nxt is not None:
        n_rows = st.kf_imu_raw[nxt].shape[0]
        assert abs(float(tm2.kf_preint.dT[nxt]) - 0.005 * n_rows) < 1e-4
        assert float(tm2.kf_preint.dT[nxt]) > float(tm.kf_preint.dT[nxt])
        _assert_preint_row(js.m, tm2, nxt, "successor")
    others = [s for s in st.kf_slots if s != nxt]
    for f, a in zip(tm.kf_preint._fields, tm.kf_preint):
        assert torch.equal(getattr(tm2.kf_preint, f)[others], a[others]), f


def test_reparented_rows_follow_later_corrections(monkeypatch):
    """What the re-anchoring is for: after the removal, moving the heir moves
    the culled keyframe's frames with it (they do not fall back to their
    track-time pose)."""
    _, tm, st, traj, cfg = _final_state(monkeypatch)
    victim, heir = st.kf_slots[4], st.kf_slots[5]
    rows = [i for i, m in enumerate(traj.meta) if m[1] == victim]
    before = traj.compose(tm.kf_ns.P, tm.kf_ns.R, tm.kf_id, tm.kf_active)
    tm2 = mapping_ctl.remove_keyframe(tm, st, cfg, victim, NOISE, traj=traj)
    same = traj.compose(tm2.kf_ns.P, tm2.kf_ns.R, tm2.kf_id, tm2.kf_active)
    shift = torch.tensor([0.5, -0.25, 0.125])
    P_moved = tm2.kf_ns.P.clone()
    P_moved[heir] += shift
    moved = traj.compose(P_moved, tm2.kf_ns.R, tm2.kf_id, tm2.kf_active)
    for i in rows:
        np.testing.assert_allclose(same[i][1], before[i][1], atol=1e-5)
        np.testing.assert_allclose(moved[i][1] - same[i][1], shift.numpy(), atol=1e-6)


def test_slot_reuse_overwrites_no_active_keyframe(monkeypatch):
    """Remove a keyframe, insert one: the new keyframe takes the freed slot
    and no active keyframe's row changes. (Choosing the slot as the count of
    active keyframes would name the newest keyframe's slot here.)"""
    _, tm, st, traj, cfg = _final_state(monkeypatch)
    victim = st.kf_slots[4]
    tm2 = mapping_ctl.remove_keyframe(tm, st, cfg, victim, NOISE, traj=traj)
    active = list(st.kf_slots)
    assert len(active) in active                 # the old rule would hit an active slot
    newest = st.last_kf_slot
    feats = type("F", (), dict(level=tm.kf_level[newest], angle=tm.kf_angle[newest],
                               desc=tm.kf_desc[newest], desc_pm1=tm.kf_pm1[newest],
                               valid=tm.kf_feat_valid[newest]))
    ns = NavState(*[a[newest] for a in tm2.kf_ns])
    rows = torch.zeros((20, 7))
    rows[:, 6] = 0.005
    n_kf = st.n_kf
    tm3, slot = mapping_ctl.insert_keyframe(tm2, st, cfg, ns, feats, tm.kf_uv[newest], 9.0,
                                            777, rows, NOISE, traj=traj)
    assert slot == victim and st.free_slots == [] and st.kf_slots == active + [victim]
    assert st.n_kf == n_kf + 1 and st.kf_time_host[slot] == 9.0 and st.kf_id_host[slot] == 777
    assert st.next_fresh_slot == len(active) + 1        # the high-water mark did not move
    for name in ("kf_id", "kf_uv", "kf_mp", "kf_desc", "kf_active", "kf_time"):
        assert torch.equal(getattr(tm3, name)[active], getattr(tm2, name)[active]), name
    for f, a in zip(tm2.kf_ns._fields, tm2.kf_ns):
        assert torch.equal(getattr(tm3.kf_ns, f)[active], a[active]), f
    assert int(tm3.kf_id[slot]) == 777 and bool(tm3.kf_active[slot])
    # the next one is fresh again
    tm4, slot2 = mapping_ctl.insert_keyframe(tm3, st, cfg, ns, feats, tm.kf_uv[newest], 9.5,
                                             778, rows, NOISE, traj=traj)
    assert slot2 == len(active) + 1 and slot2 not in active
    # a pending chain break marks the keyframe that follows it, once
    st.chain_break_pending = True
    _, slot3 = mapping_ctl.insert_keyframe(tm4, st, cfg, ns, feats, tm.kf_uv[newest], 10.0,
                                           779, rows, NOISE, traj=traj)
    assert st.broken_chain_slots == {slot3} and not st.chain_break_pending


def test_redundancy_all_equals_redundancy_per_keyframe(monkeypatch):
    _, tm, st, _, _ = _final_state(monkeypatch)
    ratio, npts = tmap.kf_redundancy_all(tm)
    for s in st.kf_slots:
        r1, n1 = tmap.kf_redundancy(tm, s)
        assert float(ratio[s]) == float(r1) and int(npts[s]) == int(n1)
    assert int(npts[st.kf_slots].min()) > 20


@pytest.mark.parametrize("loop_edge", [False, True])
def test_alloc_kf_slot_at_capacity_matches_jax(monkeypatch, loop_edge):
    """The table is full (high-water mark at max_kf, no free slot): both
    evict the same keyframe. With a loop edge on the first choice, the
    next."""
    js, tm, st, traj, cfg = _final_state(monkeypatch)
    js.next_fresh_slot = st.next_fresh_slot = tm.K
    if loop_edge:
        st0 = copy.deepcopy(st)
        first = mapping_ctl.alloc_kf_slot(tm, st0, cfg, NOISE, traj=copy.deepcopy(traj))[1]
        st.loop_edges = [(first, st.kf_slots[-1])]
        js.loop_edges = [(first, st.kf_slots[-1])]
    slot_j = js._alloc_kf_slot()
    tm2, slot_t = mapping_ctl.alloc_kf_slot(tm, st, cfg, NOISE, traj=traj)
    assert slot_t == slot_j and slot_t not in st.kf_slots and st.free_slots == []
    if loop_edge:
        assert slot_t != first and first in st.kf_slots
    prot = set(js.kf_slots[-cfg.local_window:]) | {js.kf_slots[0]}
    assert slot_t not in prot
    assert_maps_match(js.m, tm2, rtol=1e-5, atol=1e-5, skip=("kf_preint",), msg="eviction")
    assert_host_state_matches(js, st)
    # ties go to the HIGHER slot, as max() over (ratio, slot) pairs
    flat = lambda m: (torch.full((m.K,), 0.5), torch.full((m.K,), 100))
    monkeypatch.setattr(tmap, "kf_redundancy_all", flat)
    st1 = copy.deepcopy(st)
    st1.next_fresh_slot, st1.free_slots, st1.loop_edges = tm.K, [], []
    cand = [s for s in st1.kf_slots if s not in
            set(st1.kf_slots[-cfg.local_window:]) | {st1.kf_slots[0]}]
    assert mapping_ctl.alloc_kf_slot(tm2, st1, cfg, NOISE)[1] == max(cand)


def test_cull_keyframes_forced_first_round_matches_jax(monkeypatch):
    """Every keyframe is called redundant in the first round (the event's
    stats); the later rounds compute the real redundancy on the device."""
    js, tm, st, traj, cfg = _final_state(monkeypatch)
    ratio = np.full(tm.K, 0.95, np.float32)
    npts = np.full(tm.K, 100, np.float32)
    before = list(st.kf_slots)
    js._cull_keyframes(ratio, npts)
    tm2, removed = mapping_ctl.cull_keyframes(tm, st, cfg, NOISE, traj=traj, ratio_all=ratio,
                                              npts_all=npts)
    # the oldest keyframe outside the protected sets went (keyframe 0 never does)
    assert removed == [before[1]] and st.kf_slots == js.kf_slots and st.free_slots == removed
    assert_maps_match(js.m, tm2, rtol=1e-5, atol=1e-5, skip=("kf_preint",), msg="cull")
    _assert_preint_row(js.m, tm2, before[2], "successor")
    assert_host_state_matches(js, st)
    _assert_same_trajectory(js, tm2, traj)
    # nothing redundant: nothing goes, and no device value is read
    low = np.zeros(tm.K, np.float32)
    tm3, removed = mapping_ctl.cull_keyframes(tm2, st, cfg, NOISE, traj=traj, ratio_all=low,
                                              npts_all=npts)
    assert removed == [] and tm3 is tm2


def test_cull_keyframes_round_by_round_matches_jax(monkeypatch):
    """With the redundancy forced high in EVERY round, removals go on, one a
    round, until only protected keyframes are left."""
    js, tm, st, traj, cfg = _final_state(monkeypatch)
    hi_t = lambda m: (torch.full((m.K,), 0.95), torch.full((m.K,), 100))
    hi_j = lambda m: (jnp.full((m.K,), 0.95), jnp.full((m.K,), 100))
    monkeypatch.setattr(tmap, "kf_redundancy_all", hi_t)
    monkeypatch.setattr(jmap, "kf_redundancy_all", hi_j)
    before = list(st.kf_slots)
    js._cull_keyframes()
    tm2, removed = mapping_ctl.cull_keyframes(tm, st, cfg, NOISE, traj=traj)
    # 11 keyframes: the newest 8 are protected and keyframe 0 stays
    assert removed == before[1:3] and st.kf_slots == js.kf_slots == [before[0]] + before[3:]
    assert st.free_slots == js.free_slots == removed
    assert_maps_match(js.m, tm2, rtol=1e-5, atol=1e-5, skip=("kf_preint",), msg="cull rounds")
    _assert_preint_row(js.m, tm2, before[3], "successor of both")
    _assert_same_trajectory(js, tm2, traj)


def _chain(times, vi_inited, use_imu=True, local_window=2):
    """A synthetic chain of keyframes at the given times (K = 16, 8 features,
    10 IMU rows each), and the config."""
    n = len(times)
    m = empty_map(16, 64, 8, device="cpu")
    st = mapping_ctl.MappingState(vi_inited=vi_inited)
    cfg = SlamConfig(max_kf=16, max_mp=64, n_feat=8, use_imu=use_imu,
                     local_window=local_window, ba_window=2)
    rng = np.random.default_rng(0)
    feats = type("F", (), dict(level=torch.zeros(8, dtype=torch.int32), angle=torch.zeros(8),
                               desc=torch.zeros((8, 8), dtype=torch.int32),
                               desc_pm1=torch.ones((8, 256), dtype=torch.int8),
                               valid=torch.ones(8, dtype=torch.bool)))
    for i, t in enumerate(times):
        rows = torch.from_numpy(np.concatenate(
            [rng.normal(size=(10, 3)) * 0.1, rng.normal(size=(10, 3)) + [0, 0, 9.8],
             np.full((10, 1), 0.005)], 1).astype(np.float32))
        ns = NavState(P=torch.tensor([0.1 * i, 0.0, 0.0]), V=torch.zeros(3), R=torch.eye(3),
                      bg=torch.zeros(3), ba=torch.zeros(3), dbg=torch.zeros(3),
                      dba=torch.zeros(3))
        m, _ = mapping_ctl.insert_keyframe(m, st, cfg, ns, feats, torch.zeros((8, 2)), t, i,
                                           rows if i else None, NOISE)
    return m, st, cfg


# 12 keyframes: the newest 8 are protected, so candidates are indices 1..3.
# times of keyframes 0..4 vary; 4..11 sit at 10.0 .. 10.7
_TAIL = [10.0 + 0.1 * i for i in range(8)]
GUARD_CASES = {
    # name: (times of the first 4, vi_inited, use_imu, removed indices)
    "gaps under 0.51 s before VI init": ([9.6, 9.7, 9.8, 9.9], False, True, [1, 2, 3]),
    "each removal widens the next gap": ([9.0, 9.2, 9.4, 9.6], False, True, [1]),
    "a gap over 0.51 s before VI init": ([8.0, 8.4, 8.8, 9.7], False, True, []),
    "old keyframes after VI init may leave 3.01 s": ([1.0, 2.0, 3.0, 3.9], True, True, [1, 2]),
    "but not more": ([1.0, 2.0, 4.5, 6.6], True, True, []),
    "young keyframes after VI init keep 0.51 s": ([8.0, 8.4, 8.8, 9.7], True, True, []),
    "without the IMU no guard applies": ([1.0, 4.0, 9.0, 9.9], False, False, [1, 2, 3]),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_cull_time_gap_guards_match_jax(monkeypatch, case):
    head, vi_inited, use_imu, expect = GUARD_CASES[case]
    m, st, cfg = _chain(head + _TAIL, vi_inited, use_imu)
    _, cam, _, _, _ = boot_run()
    js = jax_system_from_port(monkeypatch, cam, m, st, TrajStore(), use_imu=use_imu,
                              local_window=cfg.local_window, ba_window=cfg.ba_window,
                              n_levels=cfg.n_levels)
    monkeypatch.setattr(tmap, "kf_redundancy_all",
                        lambda mm: (torch.full((mm.K,), 0.95), torch.full((mm.K,), 100)))
    monkeypatch.setattr(jmap, "kf_redundancy_all",
                        lambda mm: (jnp.full((mm.K,), 0.95), jnp.full((mm.K,), 100)))
    before = list(st.kf_slots)
    js._cull_keyframes()
    m2, removed = mapping_ctl.cull_keyframes(m, st, cfg, NOISE)
    assert removed == [before[i] for i in expect], case
    assert st.kf_slots == js.kf_slots and st.free_slots == js.free_slots
    assert_maps_match(js.m, m2, rtol=1e-5, atol=1e-5, skip=("kf_preint",), msg=case)


def test_cull_protects_window_front_and_loop_edges(monkeypatch):
    """With a VI window longer than the newest-8 rule (local_window = 10) its
    front and the front's predecessor stay; so does a loop-edge carrier."""
    m, st, cfg = _chain([9.6, 9.7, 9.8, 9.9] + _TAIL, True, local_window=10)
    st.loop_edges = [(st.kf_slots[3], st.kf_slots[9])]
    monkeypatch.setattr(tmap, "kf_redundancy_all",
                        lambda mm: (torch.full((mm.K,), 0.95), torch.full((mm.K,), 100)))
    before = list(st.kf_slots)
    _, removed = mapping_ctl.cull_keyframes(m, st, cfg, NOISE)
    # 12 keyframes, window front at index 2, its predecessor 1, loop edge on 3:
    # no candidate is left
    assert removed == [] and st.kf_slots == before
    st.loop_edges = []
    _, removed = mapping_ctl.cull_keyframes(m, st, cfg, NOISE)
    assert removed[0] == before[3] and before[0] in st.kf_slots


def test_splice_over_256_rows_matches_jax_chained_form(monkeypatch):
    """The merged span of two keyframes' rows is longer than the 256 rows the
    JAX package integrates in one piece: it chains pieces, the port runs one
    recursion."""
    js, tm, st, _, cfg = _final_state(monkeypatch)
    victim, nxt = st.kf_slots[5], st.kf_slots[6]
    rng = np.random.default_rng(1)
    for slot, n in ((victim, 170), (nxt, 190)):
        rows = np.concatenate([rng.normal(size=(n, 3)) * 0.2,
                               rng.normal(size=(n, 3)) + [0, 0, 9.8],
                               np.full((n, 1), 0.005)], 1).astype(np.float32)
        st.kf_imu_raw[slot] = torch.from_numpy(rows)
        js.kf_imu_raw[slot] = rows
    js._splice_imu_chain(victim)
    tm2 = mapping_ctl.splice_imu_chain(tm, st, cfg, victim, NOISE)
    assert st.kf_imu_raw[nxt].shape[0] == 360 > cfg.max_imu_per_kf
    np.testing.assert_array_equal(st.kf_imu_raw[nxt].numpy(), js.kf_imu_raw[nxt])
    assert abs(float(tm2.kf_preint.dT[nxt]) - 1.8) < 1e-4
    _assert_preint_row(js.m, tm2, nxt, "spliced")
    # without the IMU nothing is spliced; the newest keyframe has no successor
    off = SlamConfig(use_imu=False)
    assert mapping_ctl.splice_imu_chain(tm, st, off, victim, NOISE) is tm
    assert mapping_ctl.splice_imu_chain(tm, st, cfg, st.kf_slots[-1], NOISE) is tm
