"""Host control of the keyframe event (port of the event path of
mc_slam_tpu/pipeline/mapping_ctl.py and of SlamSystem._insert_kf_raw).

The JAX package keeps these as methods of SlamSystem's mixins, dispatched
asynchronously with a deferred harvest. Here they are plain synchronous
module functions over an explicit `MappingState`; the orchestrator class
comes with a later slice. Covered: keyframe insertion before and after VI
initialization (`insert_keyframe`), the IMU edge lists (`imu_edge_lists`),
the covisibility queries, every branch of `_local_ba` (`local_ba`: the
visual window before VI init, the whole-map `force_all` form in its visual
and XYZ VI variants, the inverse-depth VI window `local_ba_idp`), and the
event order of `_local_mapping` (`keyframe_event`). Not covered: the
landmark-chunked whole-map BA (a `force_all` window of more than 40
keyframes raises), keyframe culling, loop detection (`kf_event_post` takes
zero histograms), slot recycling.

Padded window rows are never written back (the JAX package pads with copies
of the last slot and scatters every row, so that slot is written several
times, stale values among them): scatter-backs and the association prune
send rows past `n_real` off the table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import IMUNoise, preintegrate
from mc_slam_tpu_torch.pipeline import mapping
from mc_slam_tpu_torch.slam_map.mapstate import (MapState, _set_drop,
                                                 covisibility_weights)
from mc_slam_tpu_torch.solver import ba, ba_vi, ba_vi_idp, factors
from mc_slam_tpu_torch.solver.ba_vi_idp import BAStats


COVIS_TH = 15        # covisibility edge weight (SlamConfig.covis_th)
CULL_MIN_OBS = 3     # monocular nThObs (SlamConfig.cull_min_obs)
BA_ITERS = 8         # LM iterations of the VI BAs
VISUAL_BA_ITERS = 10  # LM iterations of the visual BAs
GBA_MAX_KF = 40      # a whole-map BA over more keyframes needs the chunked form


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """The fields of SlamConfig that mapping, tracking control and VI
    initialization read, with its defaults; examples/eval_clone.py's euroc
    profile sets n_levels=8, local_window=20."""
    n_levels: int = 8
    local_window: int = 10
    ba_window: int = 8
    max_new: int = 256
    ba_Pw: int = 4096
    min_init_matches: int = 60
    min_track_inliers: int = 12
    kf_min_gap: int = 3             # frames
    kf_max_gap: int = 20
    kf_ref_ratio: float = 0.8       # NeedNewKeyFrame ratio
    vi_init_time: float = 15.0      # seconds (config/euroc.yaml:6)
    vi_init_max_cond: float = 5e4   # step-3 condition-number acceptance
    vi_init_scale_tol: float = 0.5  # |s - s_star| / s agreement of steps 2 and 3
    g_mag: float = 9.81


@dataclasses.dataclass
class MappingState:
    """The host bookkeeping of SlamSystem that the event, keyframe decisions
    and VI initialization read and write."""
    kf_slots: list = dataclasses.field(default_factory=list)   # active slots, oldest first
    broken_chain_slots: set = dataclasses.field(default_factory=set)
    last_kf_slot: int = -1
    covis_row: np.ndarray | None = None    # the last event's covisibility row (host)
    vi_inited: bool = False
    n_kf: int = 0                          # keyframes inserted so far
    last_kf_frame: int = 0
    first_kf_time: float | None = None
    kf_imu_raw: dict = dataclasses.field(default_factory=dict)  # slot -> (T, 7) rows
    kf_id_host: dict = dataclasses.field(default_factory=dict)  # slot -> frame id
    ref_tracked: int | None = None         # the last event's well-observed count
    last_init_attempt_nkf: int = -1


class EventResult(NamedTuple):
    n_created: torch.Tensor    # points triangulated by the event
    n_fused: torch.Tensor      # associations added by fusion
    n_culled: torch.Tensor     # active points lost to culling / eviction
    ba: BAStats | None
    stats: tuple               # kf_event_post's (covis_row, red_ratio, n_pts, n_active, n_well)


def imu_edge_lists(all_slots, n_window, broken_chain_slots=(), prev_idx=None,
                   n_pad=None):
    """(idx_i, idx_j, ev) host edge-index lists for the window chain.
    Entry 0: the predecessor edge (always present; masked off when prev_idx
    is None); then consecutive-pair edges, valid only inside the real window
    and never across a broken IMU chain."""
    n_pad = n_pad if n_pad is not None else n_window
    idx_i = [prev_idx if prev_idx is not None else 0]
    idx_j = [0]
    ev = [1.0 if (prev_idx is not None
                  and all_slots[0] not in broken_chain_slots) else 0.0]
    for a, b in zip(range(n_pad - 1), range(1, n_pad)):
        idx_i.append(a)
        idx_j.append(b)
        ev.append(1.0 if (b < n_window and all_slots[b] not in broken_chain_slots)
                  else 0.0)
    return (np.asarray(idx_i, np.int32), np.asarray(idx_j, np.int32),
            np.asarray(ev, np.float32))


def vi_window_slots(st: MappingState, cfg: MappingConfig):
    """The VI local-BA window: the newest `local_window` keyframes of the
    chain, never extended back across a broken IMU chain."""
    w = list(st.kf_slots)[-cfg.local_window:]
    for i in range(len(w) - 1, 0, -1):
        if w[i] in st.broken_chain_slots:
            w = w[i:]
            break
    return w


def _ranked(st: MappingState, row, slot, n, fallback):
    """Keyframes by descending covisibility weight in `row` (the slot itself
    and inactive slots zeroed; equal weights to the lowest slot): the first n
    that clear COVIS_TH, else, with `fallback`, the single best if it shares
    any point (UpdateConnections keeps the max-weight edge)."""
    w = np.array(row, dtype=np.float32)
    w[slot] = 0
    active = np.zeros_like(w)
    active[list(st.kf_slots)] = 1.0
    w = w * active
    order = np.argsort(-w, kind="stable")
    out = [int(k) for k in order[:n] if w[k] >= COVIS_TH]
    if fallback and not out and w[order[0]] > 0:
        out = [int(order[0])]
    return out


def _covisible_strong(st: MappingState, cfg: MappingConfig, n):
    """Covisible neighbours of the newest keyframe that clear covis_th, from
    the covisibility row the last event left on the host (none before the
    first event)."""
    if st.covis_row is None:
        return []
    return _ranked(st, st.covis_row, st.last_kf_slot, n, fallback=False)


def covisible_stale(m: MapState, st: MappingState, slot, n, strong=False):
    """Neighbour selection from the covisibility row the last event left on
    the host, whichever keyframe produced it (consecutive keyframes share
    most of their covisibles; the row's own keyframe keeps its inflated
    self-weight and ranks first, which is the wanted window member). Before
    the first event there is no row: the fresh one of `slot` is read from
    the device, one copy."""
    row = st.covis_row
    if row is None:
        row = covisibility_weights(m, slot).cpu().numpy()
    return _ranked(st, row, slot, n, fallback=not strong)


def visual_window_slots(m: MapState, st: MappingState, cfg: MappingConfig):
    """The visual local-BA window: the newest keyframe, its covisibles, and
    always the previous keyframe (with a stale row it can be missing)."""
    slot = st.last_kf_slot
    window = [slot] + covisible_stale(m, st, slot, cfg.ba_window - 1)
    if len(st.kf_slots) >= 2:
        prev = st.kf_slots[-2]
        if prev not in window:
            window = window[:cfg.ba_window - 1] + [prev]
    return window


def window_problem(st: MappingState, cfg: MappingConfig):
    """The slots, free mask, edge lists and prior flag of the inverse-depth
    window BA, on the host (SlamSystem._local_ba's window and pad rule).
    Returns None when the window has fewer than 2 keyframes, else a dict
    with all_slots (padded), n_real, free, idx_i, idx_j, ev, front_broken."""
    window = vi_window_slots(st, cfg)
    if len(window) < 2:
        return None
    # fixed observers: strongly covisible keyframes outside the window; the
    # window front's chain predecessor joins as a fixed vertex carrying its
    # PRV + bias edge into the window
    fixed = [s for s in _covisible_strong(st, cfg, cfg.ba_window + 6)
             if s not in window][:4]
    prev_kf = None
    if window[0] not in st.broken_chain_slots:
        act = list(st.kf_slots)
        wi = act.index(window[0])
        if wi > 0:
            prev_kf = act[wi - 1]
            fixed = [prev_kf] + [s for s in fixed if s != prev_kf][:3]
    pad_to = max(cfg.ba_window, cfg.local_window) + 4
    all_slots, n_real, free = _pad_window(window, fixed, pad_to)
    prev_idx = len(window) if prev_kf is not None else None
    idx_i, idx_j, ev = imu_edge_lists(all_slots, len(window), st.broken_chain_slots,
                                      prev_idx=prev_idx, n_pad=len(all_slots))
    return dict(all_slots=all_slots, n_real=n_real, free=free, idx_i=idx_i,
                idx_j=idx_j, ev=ev, front_broken=window[0] in st.broken_chain_slots)


def _pad_window(window, fixed, pad_to):
    """(all_slots padded with copies of the last slot, n_real, free mask).
    With no outside observer the oldest window keyframe is the gauge."""
    all_slots = window + fixed
    n_real = len(all_slots)
    if n_real < pad_to:
        all_slots = all_slots + [all_slots[-1]] * (pad_to - n_real)
    free = np.zeros(len(all_slots), np.float32)
    free[:len(window)] = 1.0
    if not fixed:
        free[0] = 0.0
    return all_slots, n_real, free


def local_ba_idp(m: MapState, st: MappingState, cfg: MappingConfig, cam: Camera,
                 ext: factors.Extrinsics, gw, noise: IMUNoise, prune=True):
    """The inverse-depth VI window BA of one event over the MapState.
    Returns (m, BAStats or None when the window is too short)."""
    prob = window_problem(st, cfg)
    if prob is None:
        return m, None
    dev = m.mp_pos.device
    # ONE host->device copy for the whole problem (slots, edge lists, masks;
    # all of the padded window's length, small integers exact in float32)
    packed = torch.as_tensor(np.stack([
        np.asarray(prob[k], np.float32)
        for k in ("all_slots", "idx_i", "idx_j", "ev", "free")]), device=dev)
    ks, idx_i, idx_j = (packed[r].to(torch.int64) for r in range(3))
    prior = None
    if prob["front_broken"]:
        # a window that starts at a chain break has no history edge on its
        # bias chain: pin the front keyframe's biases with a weak prior
        info = np.zeros((15, 15), np.float32)
        info[9:12, 9:12] = np.eye(3) / 2e-3 ** 2
        info[12:15, 12:15] = np.eye(3) / 2e-2 ** 2
        front = prob["all_slots"][0]
        prior = ba_vi.PriorFactor(
            cam=torch.zeros((), dtype=torch.int64, device=dev),
            ns0=keyframe_navstate(m, front),
            info=torch.as_tensor(info, device=dev),
            valid=torch.ones((), dtype=torch.float32, device=dev))
    return ba_vi_idp.window_vi_ba_map(
        m, ks, idx_i, idx_j, packed[3], prob["n_real"], packed[4], cam, ext, gw,
        noise.sigma_bg, noise.sigma_ba, prior=prior, iters=BA_ITERS,
        Pw=min(cfg.ba_Pw, m.P), do_prune=prune)


def gather_obs(m: MapState, ks, n_real) -> ba.VisualObs:
    """The VisualObs batch of the observation tables of keyframe slots `ks`
    (local index space, full landmark-table point indices). Rows of slots
    past n_real (padding) carry no constraint."""
    n, Fn = ks.shape[0], m.F
    cam_idx = torch.arange(n, dtype=torch.int64, device=ks.device).repeat_interleave(Fn)
    mp = m.kf_mp[ks].reshape(-1)
    lvl = m.kf_level[ks].reshape(-1)
    valid = (mp >= 0) & m.kf_feat_valid[ks].reshape(-1) & (cam_idx < n_real)
    return ba.VisualObs(
        cam=cam_idx, pt=torch.clamp(mp, 0, m.P - 1).to(torch.int64),
        uv=m.kf_uv[ks].reshape(-1, 2),
        inv_sigma2=1.0 / (1.2 ** (2.0 * lvl.to(torch.float32))),
        valid=valid.to(torch.float32))


def local_ba(m: MapState, st: MappingState, cfg: MappingConfig, cam: Camera,
             ext: factors.Extrinsics, gw, noise: IMUNoise, force_all=False,
             prune=True):
    """SlamSystem._local_ba: the branch follows the state. After VI init a
    window event runs the inverse-depth BA (`local_ba_idp`); before it, the
    visual BA over the covisibility window. force_all: the whole map, oldest
    keyframe fixed, padded to a multiple of 8 keyframes, one round with no
    outlier re-classification (the reference's global BA): the visual form
    before VI init, the XYZ VI form (`ba_vi.vi_ba`) after.
    Returns (m, BAStats or None when the window has fewer than 2 keyframes);
    `overflow` is 0 (these solve over the whole landmark table)."""
    if force_all:
        window = list(st.kf_slots)
        if len(window) > GBA_MAX_KF:
            # the JAX package switches to its landmark-chunked Schur form
            # here; the dense Wcp would be O(Nc * Np) and is never its stand-in
            raise NotImplementedError(
                f"whole-map BA over {len(window)} keyframes (> {GBA_MAX_KF}) needs the "
                f"landmark-chunked solver, which is not ported yet")
        fixed = []
        pad_to = int(math.ceil(len(window) / 8)) * 8
    elif st.vi_inited:
        return local_ba_idp(m, st, cfg, cam, ext, gw, noise, prune=prune)
    else:
        window = visual_window_slots(m, st, cfg)
        # strong edges only: a weight-1 observer must not be the gauge anchor
        fixed = [s for s in covisible_stale(m, st, st.last_kf_slot, cfg.ba_window + 6,
                                            strong=True) if s not in window][:4]
        pad_to = max(cfg.ba_window, cfg.local_window) + 4
    if len(window) < 2:
        return m, None
    all_slots, n_real, free = _pad_window(window, fixed, pad_to)
    n = len(all_slots)
    idx_i, idx_j, ev = imu_edge_lists(all_slots, len(window), st.broken_chain_slots,
                                      prev_idx=None, n_pad=n)
    dev = m.mp_pos.device
    # ONE host->device copy for the whole problem
    rows = [all_slots, free, idx_i[:n], idx_j[:n], ev[:n]]
    packed = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in rows]),
                             device=dev)
    ks, free_t = packed[0].to(torch.int64), packed[1]
    obs = gather_obs(m, ks, n_real)
    pt_mask = m.mp_active.to(torch.float32)
    real = torch.arange(n, device=dev) < n_real
    ks_real = torch.where(real, ks, m.K)           # pad rows fall off the table
    if st.vi_inited:
        edges = ba_vi.edges_from_map(m.kf_preint, ks, packed[2], packed[3], packed[4],
                                     noise.sigma_bg, noise.sigma_ba)
        ns_w = NavState(*[a[ks] for a in m.kf_ns])
        ns2, pts2, chi2, cost, costs = ba_vi.vi_ba(
            ns_w, m.mp_pos, obs, edges, cam, ext, gw, free_t, pt_mask, prior=None,
            iters=BA_ITERS, two_phase=False)
        kf_ns2 = NavState(*[_set_drop(full, ks_real, w) for full, w in zip(m.kf_ns, ns2)])
    else:
        P2, R2, pts2, chi2, cost, costs = ba.visual_ba(
            m.kf_ns.P[ks], m.kf_ns.R[ks], m.mp_pos, obs, cam, ext, free_t, pt_mask,
            iters=VISUAL_BA_ITERS, two_phase=not force_all)
        kf_ns2 = m.kf_ns._replace(P=_set_drop(m.kf_ns.P, ks_real, P2),
                                  R=_set_drop(m.kf_ns.R, ks_real, R2))
    m = m._replace(kf_ns=kf_ns2, mp_pos=pts2)
    if prune:
        # remove outlier associations (chi2 gate at 1.5 x the mono threshold)
        bad = (chi2 > ba.CHI2_MONO * 1.5) & (obs.valid > 0)
        kept = torch.where(bad.reshape(n, -1), -1, m.kf_mp[ks])
        m = m._replace(kf_mp=_set_drop(m.kf_mp, ks_real, kept))
    seen = _set_drop(torch.zeros(m.P, dtype=torch.bool, device=dev),
                     torch.where(obs.valid > 0, obs.pt, m.P), True)
    stats = BAStats(cost0=costs[0], cost=cost, costs=costs,
                    n_landmarks=torch.sum(seen & m.mp_active),
                    overflow=torch.zeros((), dtype=torch.int64, device=dev))
    return m, stats


def cam_to_body(ext: factors.Extrinsics, P_c, R_c):
    """Camera pose (world-from-camera) -> body pose through the extrinsics."""
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    R_b = R_c @ Rbc.transpose(-1, -2)
    return P_c - (R_b @ pbc[..., None])[..., 0], R_b


def insert_keyframe(m: MapState, st: MappingState, slot: int, ns: NavState, feats,
                    uv, t_kf, fid, imu_rows, noise: IMUNoise, feat_mp=None,
                    cam_frame=False, ext: factors.Extrinsics | None = None):
    """Write a frame as keyframe `slot` (SlamSystem._insert_kf_raw): the
    preintegration over every IMU row since the last keyframe, the delta bias
    folded into the base bias (Frame::SetInitialNavStateAndBias). After VI
    init the rows are integrated at the bias carried into this keyframe;
    before it at zero biases (VI init integrates them again at its estimate,
    from `st.kf_imu_raw`).

    ns: the NavState written (before VI init: the pose with zero velocity and
    biases). cam_frame: ns.P / ns.R are a camera pose (world-from-camera),
    converted to the body pose through `ext`. imu_rows: (T, 7) tensor of
    [gyro, acc, dt] rows, or None (the first keyframe).
    Returns the new MapState; `st` is updated in place."""
    dev = m.mp_pos.device
    P, R = (cam_to_body(ext, ns.P, ns.R) if cam_frame else (ns.P, ns.R))
    pre = None
    if imu_rows is not None and imu_rows.shape[0] > 0:
        st.kf_imu_raw[slot] = imu_rows
        zero = torch.zeros(3, dtype=imu_rows.dtype, device=dev)
        pre = preintegrate(imu_rows, ns.bg_full if st.vi_inited else zero,
                           ns.ba_full if st.vi_inited else zero, noise)
    m = mapping.write_keyframe(
        m, slot, P, R, ns.V, ns.bg_full, ns.ba_full,
        torch.as_tensor(t_kf, dtype=torch.float32, device=dev),
        torch.as_tensor(fid, dtype=torch.int32, device=dev),
        uv, feats.level, feats.angle,
        torch.full((m.F,), -1.0, dtype=torch.float32, device=dev),
        feats.desc, feats.desc_pm1, feats.valid, feat_mp=feat_mp, pre=pre)
    st.kf_slots.append(slot)
    st.last_kf_slot = slot
    st.last_kf_frame = int(fid)
    st.kf_id_host[slot] = int(fid)
    st.n_kf += 1
    if st.first_kf_time is None:
        st.first_kf_time = float(t_kf)
    return m


def keyframe_event(m: MapState, st: MappingState, cfg: MappingConfig, frame_id: int,
                   cam: Camera, ext: factors.Extrinsics, gw, noise: IMUNoise,
                   hists=None, timer=None):
    """One keyframe event in SlamSystem._local_mapping's order: the pre-BA
    half (cull / evict, neighbours, triangulation, fusion), the local BA of
    the state's branch (`local_ba`: visual window before VI init, inverse-
    depth VI window after), the post-BA half (point-statistics refresh,
    stats, covisibility). The visual branch may read one covisibility row on
    the host (before the first event has left one); nothing else in here
    reads a device value. The caller reads EventResult when it needs the
    numbers and, as _harvest_event does, keeps the covisibility row and the
    well-observed count for the next decisions (`note_event_stats`).

    hists: (K, V) loop-detection histograms, zeros when loop closing is off.
    timer: optional callable(stage_name) invoked before "pre", "ba", "post"
    and "end" (a CUDA-event recorder). Returns (m, EventResult)."""
    slot = st.last_kf_slot
    dev = m.mp_pos.device
    mark = timer if timer is not None else (lambda name: None)
    if hists is None:
        hists = torch.zeros((m.K, 1), dtype=torch.float32, device=dev)
    n_before = torch.sum(m.mp_active)
    mark("pre")
    m, _, _, wslots, wvalid, (n_new, n_fused) = mapping.kf_event_pre(
        m, slot, frame_id, cam, ext, cfg.n_levels, min_obs=CULL_MIN_OBS,
        n_evict=int(0.07 * m.P), covis_th=COVIS_TH, max_new=cfg.max_new)
    n_culled = n_before + n_new - torch.sum(m.mp_active)
    mark("ba")
    m, ba_stats = local_ba(m, st, cfg, cam, ext, gw, noise)
    mark("post")
    m, stats, _, _ = mapping.kf_event_post(
        m, slot, wslots, wvalid, ext, hists, cfg.n_levels,
        min_obs=(2 if len(st.kf_slots) <= 2 else 3))
    mark("end")
    return m, EventResult(n_created=n_new, n_fused=n_fused, n_culled=n_culled,
                          ba=ba_stats, stats=stats)


def note_event_stats(st: MappingState, covis_row, n_well):
    """Keep what _harvest_event keeps of an event's stats on the host: the
    covisibility row (the next event's window and observer choice) and the
    newest keyframe's well-observed point count (need_new_kf's reference)."""
    st.covis_row = np.asarray(covis_row, np.float32)
    st.ref_tracked = int(n_well)


def keyframe_navstate(m: MapState, slot: int) -> NavState:
    """The NavState row of keyframe `slot`. After an event, tracking continues
    from the optimised newest keyframe's (the state carry of _local_mapping),
    with a fresh prior: the marginal prior of the frame before is stale."""
    return NavState(*[a[slot] for a in m.kf_ns])
