"""Host control of the keyframe event (port of the event path of
mc_slam_tpu/pipeline/mapping_ctl.py and of SlamSystem._insert_kf_raw).

The JAX package keeps these as methods of SlamSystem's mixins. Here they are
module functions over an explicit `MappingState`, which the orchestrator
class (pipeline/system.py) holds; the event comes in two halves,
`dispatch_event` (device work and the stats copy, not waited for) and
`harvest_event` (stats noted, keyframes culled), which the frame loop
(pipeline/frameloop.py) calls apart and `keyframe_event` back to back. Covered: keyframe insertion before and after VI
initialization (`insert_keyframe`), the IMU edge lists (`imu_edge_lists`),
the covisibility queries, every branch of `_local_ba` (`local_ba`: the
visual window before VI init, the whole-map `force_all` form in its visual
and XYZ VI variants, the inverse-depth VI window `local_ba_idp`, and the XYZ
VI window taken with a depth sensor or `use_idp_ba=False`), and the
event order of `_local_mapping` followed by `_harvest_event`
(`keyframe_event`: the stats are noted, then keyframes are culled), slot
allocation with recycling and eviction (`alloc_kf_slot`), keyframe removal
(`remove_keyframe`, `splice_imu_chain`), keyframe culling (`cull_keyframes`)
and the landmark-chunked whole-map BA (`global_ba_chunked`, taken by a
`force_all` window of more than 40 keyframes). Loop detection rides on the
event: `insert_keyframe` registers the keyframe's BoW histogram with the
detector it is given, `keyframe_event` scores it against every keyframe's
(`EventResult.detect`), and the caller (tracking_ctl) hands that to
`loopctl.try_close_loop`. With a depth sensor (`MappingState.sensor_depth`)
every XYZ BA carries the keyframes' u_right rows (`kf_ur`, bf = fx *
baseline) and the association prune gates them at CHI2_STEREO; the depth
points of a keyframe are written by `add_depth_points` (with `depth_to_world`
and `alloc_points`, which also seed the map of a depth frame). Not covered:
the mesh-sharded form of the chunked BA. The window VI BA of an event, in
either form, runs in the span "mapping.vi_ba" (`utils.metrics.span`).

Padded window rows are never written back (the JAX package pads with copies
of the last slot and scatters every row, so that slot is written several
times, stale values among them): scatter-backs and the association prune
send rows past `n_real` off the table.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import IMUNoise, preintegrate
from mc_slam_tpu_torch.parallel import dist_ba, dist_gba
from mc_slam_tpu_torch.pipeline import mapping
from mc_slam_tpu_torch.pipeline.pipebase import HostCopy
from mc_slam_tpu_torch.slam_map.mapstate import (MapState, _set_drop,
                                                 covisibility_weights)
from mc_slam_tpu_torch.solver import ba, ba_chunked, ba_vi, ba_vi_idp, factors
from mc_slam_tpu_torch.solver.ba_vi_idp import BAStats
from mc_slam_tpu_torch.utils.metrics import span

if TYPE_CHECKING:
    from mc_slam_tpu_torch.pipeline.system import SlamConfig


BA_ITERS = 8         # LM iterations of the VI BAs
VISUAL_BA_ITERS = 10  # LM iterations of the visual BAs
GBA_MAX_KF = 40      # a whole-map BA over more keyframes takes the chunked form


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
    free_slots: list = dataclasses.field(default_factory=list)  # culled slots, for reuse
    next_fresh_slot: int = 0               # high-water mark of slot allocation
    kf_time_host: dict = dataclasses.field(default_factory=dict)  # slot -> time
    loop_edges: list = dataclasses.field(default_factory=list)  # [(slot_a, slot_b)]
    chain_break_pending: bool = False      # the next keyframe starts a new IMU chain
    n_loops_closed: int = 0
    last_loop_nkf: int = -100              # n_kf at the last closure (the 10-keyframe cooldown)
    sensor_depth: bool = False             # stereo / RGB-D input seen: u_right rows in every BA
    mesh: object = None                    # parallel.dist_ba.Mesh of the sharded whole-map BA
    mesh_e: object = None                  # ... and of the edge-sharded essential graph


class EventResult(NamedTuple):
    n_created: torch.Tensor    # points triangulated by the event
    n_fused: torch.Tensor      # associations added by fusion
    n_culled: torch.Tensor     # active points lost to culling / eviction
    ba: BAStats | None
    stats: tuple               # kf_event_post's (covis_row, red_ratio, n_pts, n_active, n_well)
    removed: tuple = ()        # keyframe slots culled at the event's end
    detect: tuple | None = None  # (scores (K,), W (K, K)) for loop detection, with hists


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


def vi_window_slots(st: MappingState, cfg: SlamConfig):
    """The VI local-BA window: the newest `local_window` keyframes of the
    chain, never extended back across a broken IMU chain."""
    w = list(st.kf_slots)[-cfg.local_window:]
    for i in range(len(w) - 1, 0, -1):
        if w[i] in st.broken_chain_slots:
            w = w[i:]
            break
    return w


def _ranked(st: MappingState, row, slot, n, fallback, covis_th=15):
    """Keyframes by descending covisibility weight in `row` (the slot itself
    and inactive slots zeroed; equal weights to the lowest slot): the first n
    that clear covis_th, else, with `fallback`, the single best if it shares
    any point (UpdateConnections keeps the max-weight edge)."""
    w = np.array(row, dtype=np.float32)
    w[slot] = 0
    active = np.zeros_like(w)
    active[list(st.kf_slots)] = 1.0
    w = w * active
    order = np.argsort(-w, kind="stable")
    out = [int(k) for k in order[:n] if w[k] >= covis_th]
    if fallback and not out and w[order[0]] > 0:
        out = [int(order[0])]
    return out


def _covisible_strong(st: MappingState, cfg: SlamConfig, n):
    """Covisible neighbours of the newest keyframe that clear covis_th, from
    the covisibility row the last event left on the host (none before the
    first event)."""
    if st.covis_row is None:
        return []
    return _ranked(st, st.covis_row, st.last_kf_slot, n, fallback=False,
                   covis_th=cfg.covis_th)


def covisible_stale(m: MapState, st: MappingState, slot, n, strong=False, covis_th=15):
    """Neighbour selection from the covisibility row the last event left on
    the host, whichever keyframe produced it (consecutive keyframes share
    most of their covisibles; the row's own keyframe keeps its inflated
    self-weight and ranks first, which is the wanted window member). Before
    the first event there is no row: the fresh one of `slot` is read from
    the device, one copy."""
    row = st.covis_row
    if row is None:
        row = covisibility_weights(m, slot).cpu().numpy()
    return _ranked(st, row, slot, n, fallback=not strong, covis_th=covis_th)


def visual_window_slots(m: MapState, st: MappingState, cfg: SlamConfig):
    """The visual local-BA window: the newest keyframe, its covisibles, and
    always the previous keyframe (with a stale row it can be missing)."""
    slot = st.last_kf_slot
    window = [slot] + covisible_stale(m, st, slot, cfg.ba_window - 1,
                                      covis_th=cfg.covis_th)
    if len(st.kf_slots) >= 2:
        prev = st.kf_slots[-2]
        if prev not in window:
            window = window[:cfg.ba_window - 1] + [prev]
    return window


def window_problem(st: MappingState, cfg: SlamConfig):
    """The slots, free mask, edge lists and prior flag of the VI window BA
    (inverse-depth or XYZ), on the host (SlamSystem._local_ba's window and
    pad rule).
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


def _pack_problem(prob, dev):
    """ONE host->device copy of a window problem's slots, edge lists and
    masks (all of the padded window's length, small integers exact in
    float32): rows all_slots, idx_i, idx_j, ev, free."""
    return torch.as_tensor(np.stack([
        np.asarray(prob[k], np.float32)
        for k in ("all_slots", "idx_i", "idx_j", "ev", "free")]), device=dev)


def _front_bias_prior(m: MapState, front: int):
    """A window that starts at a chain break has no history edge on its bias
    chain: a weak prior pins the front keyframe's biases (local index 0)."""
    dev = m.mp_pos.device
    info = np.zeros((15, 15), np.float32)
    info[9:12, 9:12] = np.eye(3) / 2e-3 ** 2
    info[12:15, 12:15] = np.eye(3) / 2e-2 ** 2
    return ba_vi.PriorFactor(
        cam=torch.zeros((), dtype=torch.int64, device=dev),
        ns0=keyframe_navstate(m, front),
        info=torch.as_tensor(info, device=dev),
        valid=torch.ones((), dtype=torch.float32, device=dev))


def local_ba_idp(m: MapState, st: MappingState, cfg: SlamConfig, cam: Camera,
                 ext: factors.Extrinsics, gw, noise: IMUNoise, prune=True, ba_Pw=4096):
    """The inverse-depth VI window BA of one event over the MapState.
    ba_Pw: landmark slots of the compacted window problem. Returns (m, BAStats
    or None when the window is too short)."""
    prob = window_problem(st, cfg)
    if prob is None:
        return m, None
    packed = _pack_problem(prob, m.mp_pos.device)
    ks, idx_i, idx_j = (packed[r].to(torch.int64) for r in range(3))
    prior = _front_bias_prior(m, prob["all_slots"][0]) if prob["front_broken"] else None
    return ba_vi_idp.window_vi_ba_map(
        m, ks, idx_i, idx_j, packed[3], prob["n_real"], packed[4], cam, ext, gw,
        noise.sigma_bg, noise.sigma_ba, prior=prior, iters=BA_ITERS, rtol=cfg.ba_rtol,
        Pw=min(ba_Pw, m.P), do_prune=prune)


def stereo_bf(cam: Camera, cfg: SlamConfig):
    """fx * baseline (the reference's mbf), a 0-d tensor: the u_right row's
    u - bf / z."""
    return cam.fx * cfg.stereo_baseline


def gather_obs(m: MapState, ks, n_real, with_ur=False) -> ba.VisualObs:
    """The VisualObs batch of the observation tables of keyframe slots `ks`
    (local index space, full landmark-table point indices). Rows of slots
    past n_real (padding) carry no constraint. with_ur: the keyframes'
    u_right column (a depth sensor's map)."""
    n, Fn = ks.shape[0], m.F
    cam_idx = torch.arange(n, dtype=torch.int64, device=ks.device).repeat_interleave(Fn)
    mp = m.kf_mp[ks].reshape(-1)
    lvl = m.kf_level[ks].reshape(-1)
    valid = (mp >= 0) & m.kf_feat_valid[ks].reshape(-1) & (cam_idx < n_real)
    return ba.VisualObs(
        cam=cam_idx, pt=torch.clamp(mp, 0, m.P - 1).to(torch.int64),
        uv=m.kf_uv[ks].reshape(-1, 2),
        inv_sigma2=1.0 / (1.2 ** (2.0 * lvl.to(torch.float32))),
        valid=valid.to(torch.float32),
        ur=m.kf_ur[ks].reshape(-1) if with_ur else None)


def local_ba(m: MapState, st: MappingState, cfg: SlamConfig, cam: Camera,
             ext: factors.Extrinsics, gw, noise: IMUNoise, force_all=False,
             prune=True, ba_Pw=4096):
    """SlamSystem._local_ba: the branch follows the state. After VI init a
    window event runs the inverse-depth BA (`local_ba_idp`), or with a depth
    sensor or use_idp_ba=False the XYZ VI BA (`ba_vi.vi_ba`) over the same
    window with the chain predecessor as a fixed vertex and the broken-chain
    bias prior; before it, the visual BA over the covisibility window.
    force_all: the whole map, oldest keyframe fixed, one round with no outlier
    re-classification (the reference's global BA), the visual form before VI
    init, the XYZ VI form after: up to 40 keyframes dense (`ba.visual_ba` /
    `ba_vi.vi_ba`, padded to a multiple of 8 keyframes), above that
    landmark-chunked (`global_ba_chunked`; after VI init sharded over `st.mesh`
    when `SlamSystem.enable_mesh` set one). With a depth sensor every form
    carries the u_right rows.
    Returns (m, BAStats or None when the window has fewer than 2 keyframes);
    `overflow` is 0 (these solve over the whole landmark table)."""
    prior = None
    if force_all:
        window = list(st.kf_slots)
        if len(window) > GBA_MAX_KF:
            # the dense Wcp would be O(Nc * Np): a whole-map BA stays O(map)
            return global_ba_chunked(m, st, cfg, cam, ext, gw, noise, window, prune=prune)
        prob = _plain_problem(st, window, [], int(math.ceil(len(window) / 8)) * 8)
    elif st.vi_inited and cfg.use_idp_ba and not st.sensor_depth:
        with span("mapping.vi_ba"):
            return local_ba_idp(m, st, cfg, cam, ext, gw, noise, prune=prune, ba_Pw=ba_Pw)
    elif st.vi_inited:
        prob = window_problem(st, cfg)
        if prob is not None and prob["front_broken"]:
            prior = _front_bias_prior(m, prob["all_slots"][0])
    else:
        window = visual_window_slots(m, st, cfg)
        # strong edges only: a weight-1 observer must not be the gauge anchor
        fixed = [s for s in covisible_stale(m, st, st.last_kf_slot, cfg.ba_window + 6,
                                            strong=True, covis_th=cfg.covis_th)
                 if s not in window][:4]
        prob = _plain_problem(st, window, fixed, max(cfg.ba_window, cfg.local_window) + 4)
    if prob is None:
        return m, None
    n_real = prob["n_real"]
    n = len(prob["all_slots"])
    dev = m.mp_pos.device
    packed = _pack_problem(prob, dev)
    ks, free_t = packed[0].to(torch.int64), packed[4]
    obs = gather_obs(m, ks, n_real, with_ur=st.sensor_depth)
    bf = stereo_bf(cam, cfg)
    pt_mask = m.mp_active.to(torch.float32)
    real = torch.arange(n, device=dev) < n_real
    ks_real = torch.where(real, ks, m.K)           # pad rows fall off the table
    rtol = 0.0 if force_all else cfg.ba_rtol
    if st.vi_inited:
        edges = ba_vi.edges_from_map(m.kf_preint, ks, packed[1], packed[2], packed[3],
                                     noise.sigma_bg, noise.sigma_ba)
        ns_w = NavState(*[a[ks] for a in m.kf_ns])
        with span("mapping.vi_ba") if not force_all else contextlib.nullcontext():
            ns2, pts2, chi2, cost, costs = ba_vi.vi_ba(
                ns_w, m.mp_pos, obs, edges, cam, ext, gw, free_t, pt_mask, prior=prior,
                iters=BA_ITERS, bf=bf, rtol=rtol, two_phase=not force_all)
        kf_ns2 = NavState(*[_set_drop(full, ks_real, w) for full, w in zip(m.kf_ns, ns2)])
    else:
        P2, R2, pts2, chi2, cost, costs = ba.visual_ba(
            m.kf_ns.P[ks], m.kf_ns.R[ks], m.mp_pos, obs, cam, ext, free_t, pt_mask,
            iters=VISUAL_BA_ITERS, bf=bf, rtol=rtol, two_phase=not force_all)
        kf_ns2 = m.kf_ns._replace(P=_set_drop(m.kf_ns.P, ks_real, P2),
                                  R=_set_drop(m.kf_ns.R, ks_real, R2))
    m = m._replace(kf_ns=kf_ns2, mp_pos=pts2)
    return _finish_ba(m, obs, ks_real, chi2, cost, costs, prune)


def _plain_problem(st: MappingState, window, fixed, pad_to):
    """The problem dict of `window_problem` for a window with no predecessor
    vertex: the whole map, or the visual covisibility window. None when the
    window has fewer than 2 keyframes."""
    if len(window) < 2:
        return None
    all_slots, n_real, free = _pad_window(window, fixed, pad_to)
    idx_i, idx_j, ev = imu_edge_lists(all_slots, len(window), st.broken_chain_slots,
                                      prev_idx=None, n_pad=len(all_slots))
    return dict(all_slots=all_slots, n_real=n_real, free=free, idx_i=idx_i, idx_j=idx_j,
                ev=ev, front_broken=False)


def _finish_ba(m: MapState, obs: ba.VisualObs, ks_real, chi2, cost, costs, prune):
    """The tail the XYZ BAs share: the association prune (chi2 gate at 1.5 x
    the row's threshold, mono or stereo; rows of pad slots fall off the
    table) and the stats."""
    dev = m.mp_pos.device
    if prune:
        bad = (chi2 > ba.chi2_gate(obs.ur) * 1.5) & (obs.valid > 0)
        ks = torch.clamp(ks_real, max=m.K - 1)
        kept = torch.where(bad.reshape(ks.shape[0], -1), -1, m.kf_mp[ks])
        m = m._replace(kf_mp=_set_drop(m.kf_mp, ks_real, kept))
    seen = _set_drop(torch.zeros(m.P, dtype=torch.bool, device=dev),
                     torch.where(obs.valid > 0, obs.pt, m.P), True)
    stats = BAStats(cost0=costs[0], cost=cost, costs=costs,
                    n_landmarks=torch.sum(seen & m.mp_active),
                    overflow=torch.zeros((), dtype=torch.int64, device=dev))
    return m, stats


def global_ba_chunked(m: MapState, st: MappingState, cfg: SlamConfig, cam: Camera,
                      ext: factors.Extrinsics, gw, noise: IMUNoise, window, prune=True,
                      kf_pad=32, chunk=1024):
    """The whole-map BA through ba_chunked (GlobalBundleAdjustment
    [NavStatePRV], src/Optimizer.cpp:3346 / :629), for maps of more than 40
    keyframes: keyframes padded to a multiple of `kf_pad`, landmarks in chunks
    of `chunk`, the oldest keyframe fixed, one round. With prune, a flat chi2
    pass at the result clears outlier associations.

    The observation table goes to the host once (its grouping by chunk is
    host arithmetic) and comes back grouped. Pad rows are fixed and carry no
    observation; they are dropped from the scatter-back and from the prune
    (the JAX package writes them back: copies of the newest keyframe's
    pose from before the solve, over its result).
    Returns (m, BAStats)."""
    n_real = len(window)
    pad_n = int(math.ceil(n_real / kf_pad)) * kf_pad
    all_slots = list(window) + [window[-1]] * (pad_n - n_real)
    free = np.zeros(pad_n, np.float32)
    free[1:n_real] = 1.0                            # gauge: the oldest keyframe
    idx_i, idx_j, ev = imu_edge_lists(all_slots, n_real, st.broken_chain_slots,
                                      prev_idx=None, n_pad=pad_n)
    dev = m.mp_pos.device
    rows = [all_slots, free, idx_i, idx_j, ev]
    packed = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in rows]),
                             device=dev)            # one host->device copy
    ks, free_t = packed[0].to(torch.int64), packed[1]
    obs = gather_obs(m, ks, n_real, with_ur=st.sensor_depth)
    bf = stereo_bf(cam, cfg)
    n_chunks = max(1, m.P // chunk)
    if st.mesh is not None:
        # the chunk count divides the mesh (the JAX package's rounding; the
        # chunks get smaller, none is empty)
        n_chunks = int(math.ceil(n_chunks / st.mesh.size)) * st.mesh.size
    cols = [obs.cam[:, None].to(torch.float32), obs.pt[:, None].to(torch.float32),
            obs.uv, obs.inv_sigma2[:, None], obs.valid[:, None]]
    if obs.ur is not None:
        cols.append(obs.ur[:, None])
    flat = torch.cat(cols, dim=1).cpu().numpy()     # one device->host copy
    cobs, _ = ba_chunked.chunk_observations(
        flat[:, 0].astype(np.int64), flat[:, 1].astype(np.int64), flat[:, 2:4], flat[:, 4],
        flat[:, 5], m.P, n_chunks, ur=flat[:, 6] if obs.ur is not None else None,
        device=dev)
    pt_mask = m.mp_active.to(torch.float32)
    ks_real = torch.where(torch.arange(pad_n, device=dev) < n_real, ks, m.K)
    if st.vi_inited:
        edges = ba_vi.edges_from_map(m.kf_preint, ks, packed[2], packed[3], packed[4],
                                     noise.sigma_bg, noise.sigma_ba)
        ns_w = NavState(*[a[ks] for a in m.kf_ns])
        if st.mesh is not None:
            ns2, pts2, cost, costs = dist_ba.to_device(dist_gba.vi_gba_chunked_sharded(
                st.mesh, ns_w, m.mp_pos, cobs, edges, cam, ext, gw, free_t, pt_mask,
                iters=BA_ITERS, bf=bf), dev)
        else:
            ns2, pts2, cost, costs = ba_chunked.vi_gba_chunked(
                ns_w, m.mp_pos, cobs, edges, cam, ext, gw, free_t, pt_mask, iters=BA_ITERS,
                bf=bf)
        kf_ns2 = NavState(*[_set_drop(full, ks_real, w) for full, w in zip(m.kf_ns, ns2)])
    else:
        P2, R2, pts2, cost, costs = ba_chunked.visual_gba_chunked(
            m.kf_ns.P[ks], m.kf_ns.R[ks], m.mp_pos, cobs, cam, ext, free_t, pt_mask,
            iters=VISUAL_BA_ITERS, bf=bf)
        kf_ns2 = m.kf_ns._replace(P=_set_drop(m.kf_ns.P, ks_real, P2),
                                  R=_set_drop(m.kf_ns.R, ks_real, R2))
    m = m._replace(kf_ns=kf_ns2, mp_pos=pts2)
    chi2 = None
    if prune:
        # per-observation chi2 in one flat pass (no Schur structure involved;
        # the mono rows, gated per row as the JAX package does)
        r, _, _, z = factors.reproj_xyz(cam, ext, m.kf_ns.P[ks][obs.cam],
                                        m.kf_ns.R[ks][obs.cam], m.mp_pos[obs.pt], obs.uv)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        chi2 = torch.where(z > 0, chi2, torch.full_like(chi2, 1e9))
    return _finish_ba(m, obs, ks_real, chi2, cost, costs, prune)


def cam_to_body(ext: factors.Extrinsics, P_c, R_c):
    """Camera pose (world-from-camera) -> body pose through the extrinsics."""
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    R_b = R_c @ Rbc.transpose(-1, -2)
    return P_c - (R_b @ pbc[..., None])[..., 0], R_b


# ---------------------------------------------------------------------------
# Keyframe slots: allocation with recycling, removal, culling
# ---------------------------------------------------------------------------

def alloc_kf_slot(m: MapState, st: MappingState, cfg: SlamConfig, noise: IMUNoise,
                  traj=None):
    """The slot of the next keyframe (SlamSystem._alloc_kf_slot): a culled
    slot first, then a fresh one up to the table's size; at capacity the most
    redundant old keyframe is evicted (among the first 16 candidates outside
    the protected set: keyframe 0, the newest max(2, local_window), loop-edge
    carriers; equal ratios go to the HIGHER slot). The redundancy of every
    keyframe comes from one `kf_redundancy_all` and one copy.
    Returns (m, slot); `st` (and `traj`, on eviction) are updated in place."""
    if st.free_slots:
        return m, st.free_slots.pop(0)
    if st.next_fresh_slot < m.K:
        st.next_fresh_slot += 1
        return m, st.next_fresh_slot - 1
    prot = set(st.kf_slots[-max(2, cfg.local_window):]) | {st.kf_slots[0]}
    for e in st.loop_edges:
        prot.update(e[:2])
    cand = [s for s in st.kf_slots if s not in prot] or [st.kf_slots[1]]
    ratio = mapping.kf_redundancy_all(m)[0].cpu().numpy()
    victim = max((float(ratio[s]), s) for s in cand[:16])[1]
    m = remove_keyframe(m, st, cfg, victim, noise, traj=traj)
    return m, st.free_slots.pop(0)


def splice_imu_chain(m: MapState, st: MappingState, cfg: SlamConfig, slot: int,
                     noise: IMUNoise):
    """Before keyframe `slot` is removed, its raw IMU rows go in front of its
    successor's and the successor's preintegration is made again at its full
    bias (KeyFrame::SetBadFlag splicing, src/KeyFrame.cpp:1028-1030). The
    port's `preintegrate` takes any number of rows, so the merged span needs
    no chaining of fixed 256-row pieces as in the JAX package."""
    if not cfg.use_imu:
        return m
    act = st.kf_slots
    i = act.index(slot)
    if i + 1 >= len(act):
        return m
    nxt = act[i + 1]
    dev = m.mp_pos.device
    none = torch.zeros((0, 7), dtype=torch.float32, device=dev)
    merged = torch.cat([st.kf_imu_raw.get(slot, none), st.kf_imu_raw.get(nxt, none)])
    st.kf_imu_raw[nxt] = merged
    pre = preintegrate(merged, m.kf_ns.bg[nxt] + m.kf_ns.dbg[nxt],
                       m.kf_ns.ba[nxt] + m.kf_ns.dba[nxt], noise)
    return m._replace(kf_preint=type(m.kf_preint)(
        *[mapping._set_row(a, nxt, b) for a, b in zip(m.kf_preint, pre)]))


def remove_keyframe(m: MapState, st: MappingState, cfg: SlamConfig, slot: int,
                    noise: IMUNoise, traj=None):
    """Deactivate keyframe `slot` and recycle it (SlamSystem._remove_keyframe,
    the bookkeeping of KeyFrame::SetBadFlag): its IMU rows are spliced into
    its successor, the map points it anchored and the trajectory rows recorded
    against it pass to its heir (the next keyframe, else the previous), every
    host table forgets it. One device->host copy (the two poses).
    Returns m; `st` and `traj` are updated in place."""
    m = splice_imu_chain(m, st, cfg, slot, noise)
    act = st.kf_slots
    i = act.index(slot)
    heir = act[i + 1] if i + 1 < len(act) else act[i - 1]
    if traj is not None:
        # saved frame poses compose through the surviving parent; otherwise
        # they would keep their track-time pose and miss every later correction
        pair = torch.as_tensor([slot, heir], device=m.mp_pos.device)
        h = torch.cat([m.kf_ns.P[pair].reshape(-1), m.kf_ns.R[pair].reshape(-1)]).cpu().numpy()
        Pk, Ph = h[0:3], h[3:6]
        Rk, Rh = h[6:15].reshape(3, 3), h[15:24].reshape(3, 3)
        traj.reparent(slot, st.kf_id_host[slot], heir, st.kf_id_host[heir],
                      Rh.T @ (Pk - Ph), Rh.T @ Rk)      # the culled pose in the heir's frame
    m = m._replace(mp_ref_kf=torch.where(m.mp_ref_kf == slot, heir, m.mp_ref_kf))
    m = mapping.deactivate_keyframe(m, slot)
    st.kf_slots.remove(slot)
    st.loop_edges = [e for e in st.loop_edges if slot not in e[:2]]
    st.kf_imu_raw.pop(slot, None)
    st.kf_time_host.pop(slot, None)
    st.kf_id_host.pop(slot, None)
    st.broken_chain_slots.discard(slot)
    st.free_slots.append(slot)
    return m


def cull_keyframes(m: MapState, st: MappingState, cfg: SlamConfig, noise: IMUNoise,
                   traj=None, ratio_all=None, npts_all=None):
    """LocalMapping::KeyFrameCulling (src/LocalMapping.cpp:1777) as
    SlamSystem._cull_keyframes: a keyframe goes when more than 90 % of its
    points (and more than 20) are seen by at least 4 keyframes. With the IMU:
    never within 0.11 s of the newest keyframe, and the gap it leaves between
    its neighbours stays under 0.51 s (3.01 s after VI init, for keyframes
    older than 4 s). Protected: loop-edge carriers, the VI window's front and
    its predecessor, the newest max(8, ba_window) keyframes (the live
    triangulation partners). One removal a round, the redundancy computed
    again between rounds (one copy each); the first round is served from
    ratio_all / npts_all (host arrays, the event's stats) when given.
    Returns (m, removed slots)."""
    t_cur = st.kf_time_host[st.last_kf_slot]
    removed = []
    first = True
    while True:
        active = list(st.kf_slots)
        protected = {s for e in st.loop_edges for s in e[:2]}
        if cfg.use_imu and len(active) > cfg.local_window:
            wfront = len(active) - cfg.local_window
            protected |= {active[wfront], active[wfront - 1]}
        protected |= set(active[-max(8, cfg.ba_window):])
        if first and ratio_all is not None:
            first = False
        else:
            ratio, npts = mapping.kf_redundancy_all(m)
            h = torch.stack([ratio, npts.to(torch.float32)]).cpu().numpy()
            ratio_all, npts_all = h[0], h[1]
        victim = None
        for i, s in enumerate(active[1:-1], start=1):
            if s in protected:
                continue
            if cfg.use_imu:
                t_s = st.kf_time_host[s]
                if t_s >= t_cur - 0.11:
                    continue
                timegap = 3.01 if st.vi_inited and t_s < t_cur - 4.0 else 0.51
                if st.kf_time_host[active[i + 1]] - st.kf_time_host[active[i - 1]] > timegap:
                    continue
            if ratio_all[s] > 0.9 and npts_all[s] > 20:
                victim = s
                break
        if victim is None:
            return m, removed
        m = remove_keyframe(m, st, cfg, victim, noise, traj=traj)
        removed.append(victim)


def insert_keyframe(m: MapState, st: MappingState, cfg: SlamConfig, ns: NavState, feats,
                    uv, t_kf, fid, imu_rows, noise: IMUNoise, feat_mp=None,
                    cam_frame=False, ext: factors.Extrinsics | None = None, traj=None,
                    detector=None, ur=None):
    """Write a frame as a keyframe into the slot `alloc_kf_slot` gives
    (SlamSystem._insert_kf_raw): the preintegration over every IMU row since
    the last keyframe, the delta bias folded into the base bias
    (Frame::SetInitialNavStateAndBias). After VI init the rows are integrated
    at the bias carried into this keyframe; before it at zero biases (VI init
    integrates them again at its estimate, from `st.kf_imu_raw`).

    ns: the NavState written (before VI init: the pose with zero velocity and
    biases). cam_frame: ns.P / ns.R are a camera pose (world-from-camera),
    converted to the body pose through `ext`. imu_rows: (T, 7) tensor of
    [gyro, acc, dt] rows, or None (the first keyframe). traj: the TrajStore,
    for an eviction at capacity. detector: the `LoopDetector` that takes the
    keyframe's BoW histogram (None: no place recognition). ur: the frame's
    (F,) virtual right-image u (a depth sensor's; None: -1, monocular).
    Returns (m, slot); `st` is updated in place."""
    dev = m.mp_pos.device
    P, R = (cam_to_body(ext, ns.P, ns.R) if cam_frame else (ns.P, ns.R))
    m, slot = alloc_kf_slot(m, st, cfg, noise, traj=traj)
    pre = None
    if cfg.use_imu and imu_rows is not None and imu_rows.shape[0] > 0:
        st.kf_imu_raw[slot] = imu_rows
        zero = torch.zeros(3, dtype=imu_rows.dtype, device=dev)
        pre = preintegrate(imu_rows, ns.bg_full if st.vi_inited else zero,
                           ns.ba_full if st.vi_inited else zero, noise)
    m = mapping.write_keyframe(
        m, slot, P, R, ns.V, ns.bg_full, ns.ba_full,
        torch.as_tensor(t_kf, dtype=torch.float32, device=dev),
        torch.as_tensor(fid, dtype=torch.int32, device=dev),
        uv, feats.level, feats.angle,
        ur if ur is not None else torch.full((m.F,), -1.0, dtype=torch.float32, device=dev),
        feats.desc, feats.desc_pm1, feats.valid, feat_mp=feat_mp, pre=pre)
    st.n_kf += 1
    st.kf_time_host[slot] = float(t_kf)
    st.kf_id_host[slot] = int(fid)
    if st.chain_break_pending:
        st.broken_chain_slots.add(slot)
        st.chain_break_pending = False
    st.kf_slots.append(slot)
    st.last_kf_slot = slot
    st.last_kf_frame = int(fid)
    if st.first_kf_time is None:
        st.first_kf_time = float(t_kf)
    if detector is not None:
        detector.add_keyframe(slot, feats.desc_pm1, feats.valid.to(torch.float32), kf_id=fid)
    return m, slot


# ---------------------------------------------------------------------------
# Landmarks from metric depth (stereo / RGB-D)
# ---------------------------------------------------------------------------

def depth_to_world(cam: Camera, ext: factors.Extrinsics, uv, feat_depth, P_b, R_b):
    """Ideal pixel + depth -> world points under body pose (P_b, R_b)."""
    c = torch.stack([cam.cx, cam.cy])
    f = torch.stack([cam.fx, cam.fy])
    xn = (uv - c) / f
    Xc = torch.cat([xn * feat_depth[:, None], feat_depth[:, None]], dim=1)
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    Xb = (Rbc @ Xc[..., None])[..., 0] + pbc
    return (R_b @ Xb[..., None])[..., 0] + P_b


def alloc_points(m: MapState, Xw, desc, pm1, level, ref_slot: int, order_sel,
                 n_levels: int, frame_id: int, angle=None):
    """Write new landmarks into free map slots, in feature order
    (SlamSystem._alloc_points).

    order_sel: (F,) bool host mask of the features to add. Returns
    (m, feat_idx, slots) with the chosen feature indices and map slots as
    numpy arrays. The viewing normal is the unit direction from the
    reference keyframe's body position to the point; the JAX method writes
    Xw / dist, which is the same for a keyframe at the origin and not a unit
    vector for a keyframe elsewhere."""
    free_slots = np.nonzero(~m.mp_active.cpu().numpy())[0]
    feat_idx = np.nonzero(np.asarray(order_sel))[0]
    k = min(len(free_slots), len(feat_idx))
    feat_idx = feat_idx[:k]
    slots = free_slots[:k]
    if k == 0:
        return m, np.zeros(0, int), np.zeros(0, int)
    dev = m.mp_pos.device
    Xs = Xw.detach().cpu().numpy()[feat_idx]
    P_ref = m.kf_ns.P[ref_slot].cpu().numpy()
    dist = np.linalg.norm(Xs - P_ref, axis=1)
    lvl = np.asarray(level.cpu().numpy())[feat_idx].astype(np.float32)
    max_d = (dist * (1.2 ** lvl)).astype(np.float32)
    min_d = mapping.band_min_dist(max_d, n_levels).astype(np.float32)
    normal = ((Xs - P_ref) / np.maximum(dist, 1e-9)[:, None]).astype(np.float32)
    sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    fi = torch.as_tensor(feat_idx, dtype=torch.int64, device=dev)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    def put(field, value):
        out = field.clone()
        out[sl] = value
        return out

    kf_mp = m.kf_mp.clone()
    kf_mp[ref_slot, fi] = sl.to(torch.int32)
    m = m._replace(
        mp_pos=put(m.mp_pos, t(Xs)),
        mp_desc=put(m.mp_desc, desc[fi]),
        mp_pm1=put(m.mp_pm1, pm1[fi]),
        mp_normal=put(m.mp_normal, t(normal)),
        mp_min_dist=put(m.mp_min_dist, t(min_d)),
        mp_max_dist=put(m.mp_max_dist, t(max_d)),
        mp_ref_kf=put(m.mp_ref_kf, ref_slot),
        mp_angle=put(m.mp_angle, angle[fi]) if angle is not None else m.mp_angle,
        mp_first_kf=put(m.mp_first_kf, frame_id),
        mp_found=put(m.mp_found, 1.0),
        mp_visible=put(m.mp_visible, 1.0),
        mp_active=put(m.mp_active, True),
        kf_mp=kf_mp,
    )
    return m, feat_idx, slots


def add_depth_points(m: MapState, cfg: SlamConfig, cam: Camera, ext: factors.Extrinsics,
                     slot: int, feats, uv, feat_depth, frame_id: int, max_new=128):
    """A new keyframe's landmarks from depth (SlamSystem._add_depth_points,
    Tracking::CreateNewKeyFrame's close-point insertion for stereo / RGB-D):
    the valid features with depth that the keyframe does not associate yet,
    nearest first, at most `max_new`. One host copy (depth, validity,
    associations) besides `alloc_points`' own. Returns m."""
    host = torch.stack([feat_depth.to(torch.float32), feats.valid.to(torch.float32),
                        m.kf_mp[slot].to(torch.float32)]).cpu().numpy()
    d_np, valid, has_mp = host[0], host[1] > 0.5, host[2] >= 0
    cand = valid & (d_np > 1e-3) & ~has_mp
    if cand.sum() == 0:
        return m
    key = np.where(cand, d_np, np.inf)
    # numpy's default sort, as the JAX method's: equal depths (one rendered
    # patch) then fall on the same side of the cut in both packages
    order = np.argsort(key)[:max_new]
    sel = np.zeros_like(cand)
    sel[order[np.isfinite(key[order])]] = True
    Xw = depth_to_world(cam, ext, uv, feat_depth, m.kf_ns.P[slot], m.kf_ns.R[slot])
    m, _, _ = alloc_points(m, Xw, feats.desc, feats.desc_pm1, feats.level, slot, sel,
                           cfg.n_levels, frame_id, angle=feats.angle)
    return m


class PendingEvent(NamedTuple):
    """A keyframe event up to its stats copy (`dispatch_event`), waiting for
    `harvest_event`."""
    slot: int
    copy: HostCopy             # [n_well, covis row (K), red_ratio (K), n_pts (K)]
    stats: tuple
    detect: tuple | None
    n_created: torch.Tensor
    n_fused: torch.Tensor
    n_culled: torch.Tensor
    ba: BAStats | None
    t_disp: float              # host clock when the stats copy was queued


def dispatch_event(m: MapState, st: MappingState, cfg: SlamConfig, frame_id: int,
                   cam: Camera, ext: factors.Extrinsics, gw, noise: IMUNoise,
                   hists=None, timer=None, max_new=256, ba_Pw=4096, wait=False):
    """The device half of one keyframe event, in SlamSystem._local_mapping's
    order: the pre-BA half (cull / evict, neighbours, triangulation,
    fusion), the local BA of the state's branch (`local_ba`: visual window
    before VI init, inverse-depth VI window after), the post-BA half
    (point-statistics refresh, stats, covisibility, detection scores), then
    ONE copy of the stats to the host, started and not waited for unless
    `wait`. The visual branch may read one covisibility row on the host
    (before the first event has left one); nothing else reads a device
    value. hists / timer / max_new / ba_Pw: as `keyframe_event`'s.
    Returns (m, PendingEvent)."""
    slot = st.last_kf_slot
    dev = m.mp_pos.device
    mark = timer if timer is not None else (lambda name: None)
    with_hists = hists is not None
    if not with_hists:
        hists = torch.zeros((m.K, 1), dtype=torch.float32, device=dev)
    n_before = torch.sum(m.mp_active)
    mark("pre")
    m, _, _, wslots, wvalid, (n_new, n_fused) = mapping.kf_event_pre(
        m, slot, frame_id, cam, ext, cfg.n_levels, min_obs=cfg.cull_min_obs,
        n_evict=int(0.07 * m.P), covis_th=cfg.covis_th, max_new=max_new)
    n_culled = n_before + n_new - torch.sum(m.mp_active)
    mark("ba")
    m, ba_stats = local_ba(m, st, cfg, cam, ext, gw, noise, ba_Pw=ba_Pw)
    mark("post")
    m, stats, scores, W = mapping.kf_event_post(
        m, slot, wslots, wvalid, ext, hists, cfg.n_levels,
        min_obs=(2 if len(st.kf_slots) <= 2 else 3), refresh=cfg.refresh_stats)
    mark("cull")
    covis, red, npts, _, well = stats
    copy = HostCopy(torch.cat([well.to(torch.float32).reshape(1), covis, red,
                               npts.to(torch.float32)]), wait=wait)
    return m, PendingEvent(slot, copy, stats, (scores, W) if with_hists else None, n_new,
                           n_fused, n_culled, ba_stats, time.perf_counter())


def harvest_event(m: MapState, st: MappingState, cfg: SlamConfig, noise: IMUNoise,
                  ev: PendingEvent, traj=None):
    """The host half of a keyframe event (SlamSystem._harvest_event): the
    stats copy is read (it waits if it has not landed), the covisibility row
    and the well-observed count are kept for the next decisions
    (`note_event_stats`), and the redundancy of every keyframe serves the
    first round of `cull_keyframes`; nothing is done for a keyframe that is
    gone by then. traj: the TrajStore whose rows follow a culled keyframe to
    its heir. Returns (m, EventResult)."""
    host = ev.copy.numpy()
    removed = []
    if ev.slot in st.kf_slots:
        K = m.K
        note_event_stats(st, host[1:1 + K], host[0])
        m, removed = cull_keyframes(m, st, cfg, noise, traj=traj,
                                    ratio_all=host[1 + K:1 + 2 * K], npts_all=host[1 + 2 * K:])
    return m, EventResult(n_created=ev.n_created, n_fused=ev.n_fused, n_culled=ev.n_culled,
                          ba=ev.ba, stats=ev.stats, removed=tuple(removed), detect=ev.detect)


def keyframe_event(m: MapState, st: MappingState, cfg: SlamConfig, frame_id: int,
                   cam: Camera, ext: factors.Extrinsics, gw, noise: IMUNoise,
                   hists=None, timer=None, traj=None, max_new=256, ba_Pw=4096):
    """One keyframe event in SlamSystem._local_mapping's order, ended as
    _harvest_event ends it: `dispatch_event` (pre-BA half, local BA, post-BA
    half, the stats copy, waited for) then `harvest_event` (stats noted,
    keyframes culled).

    hists: (K, W) BoW histograms of the loop detector; None without place
    recognition (then `EventResult.detect` is None).
    timer: optional callable(stage_name) invoked before "pre", "ba", "post",
    "cull" and "end" (a CUDA-event recorder). traj: the TrajStore whose rows
    follow a culled keyframe to its heir. max_new: new points per neighbour
    pair; ba_Pw: landmark slots of the VI window BA.
    Returns (m, EventResult)."""
    m, ev = dispatch_event(m, st, cfg, frame_id, cam, ext, gw, noise, hists=hists, timer=timer,
                           max_new=max_new, ba_Pw=ba_Pw, wait=True)
    m, res = harvest_event(m, st, cfg, noise, ev, traj=traj)
    if timer is not None:
        timer("end")
    return m, res


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
