"""Host control of the Mono+IMU keyframe event (port of the event path of
mc_slam_tpu/pipeline/mapping_ctl.py and of SlamSystem._insert_kf_raw).

The JAX package keeps these as methods of SlamSystem's mixins, dispatched
asynchronously with a deferred harvest. Here they are plain synchronous
module functions over an explicit `MappingState`; the orchestrator class
comes with a later slice. Covered: keyframe insertion from a tracked frame
(`insert_keyframe`), the IMU edge lists (`imu_edge_lists`), the VI window
and pad rule of `_local_ba` with its inverse-depth branch (`local_ba_idp`),
and the event order of `_local_mapping` (`keyframe_event`). Not covered:
the visual and XYZ VI branches of `_local_ba`, keyframe culling, loop
detection (`kf_event_post` takes zero histograms), slot recycling.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import IMUNoise, preintegrate
from mc_slam_tpu_torch.pipeline import mapping
from mc_slam_tpu_torch.slam_map.mapstate import MapState
from mc_slam_tpu_torch.solver import ba_vi, ba_vi_idp, factors


COVIS_TH = 15        # covisibility edge weight (SlamConfig.covis_th)
CULL_MIN_OBS = 3     # monocular nThObs (SlamConfig.cull_min_obs)
BA_ITERS = 8         # LM iterations of the window BA


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """The sizes of SlamConfig that the keyframe event reads, with its
    defaults; examples/eval_clone.py's euroc profile sets local_window=20."""
    n_levels: int = 8
    local_window: int = 10
    ba_window: int = 8
    max_new: int = 256
    ba_Pw: int = 4096


@dataclasses.dataclass
class MappingState:
    """The host bookkeeping of SlamSystem that the event reads and writes."""
    kf_slots: list = dataclasses.field(default_factory=list)   # active slots, oldest first
    broken_chain_slots: set = dataclasses.field(default_factory=set)
    last_kf_slot: int = -1
    covis_row: np.ndarray | None = None    # the last event's covisibility row (host)


class EventResult(NamedTuple):
    n_created: torch.Tensor    # points triangulated by the event
    n_fused: torch.Tensor      # associations added by fusion
    n_culled: torch.Tensor     # active points lost to culling / eviction
    ba: ba_vi_idp.BAStats | None
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


def _covisible_strong(st: MappingState, cfg: MappingConfig, n):
    """Covisible neighbours of the newest keyframe that clear covis_th, from
    the covisibility row the last event left on the host (none before the
    first event)."""
    if st.covis_row is None:
        return []
    w = np.array(st.covis_row, dtype=np.float32)
    w[st.last_kf_slot] = 0
    active = np.zeros_like(w)
    active[list(st.kf_slots)] = 1.0
    w = w * active
    order = np.argsort(-w, kind="stable")
    return [int(k) for k in order[:n] if w[k] >= COVIS_TH]


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
    all_slots = window + fixed
    n_real = len(all_slots)
    if n_real < pad_to:
        all_slots = all_slots + [all_slots[-1]] * (pad_to - n_real)
    free = np.zeros(len(all_slots), np.float32)
    free[:len(window)] = 1.0
    if not fixed:
        free[0] = 0.0       # gauge: no outside observer anchors the problem
    prev_idx = len(window) if prev_kf is not None else None
    idx_i, idx_j, ev = imu_edge_lists(all_slots, len(window), st.broken_chain_slots,
                                      prev_idx=prev_idx, n_pad=len(all_slots))
    return dict(all_slots=all_slots, n_real=n_real, free=free, idx_i=idx_i,
                idx_j=idx_j, ev=ev, front_broken=window[0] in st.broken_chain_slots)


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


def insert_keyframe(m: MapState, st: MappingState, slot: int, ns: NavState, feats,
                    uv, t_kf, fid, imu_rows, noise: IMUNoise, feat_mp=None):
    """Write a tracked frame as keyframe `slot` (SlamSystem._insert_kf_raw for
    an initialized VI system): the preintegration over every IMU row since
    the last keyframe at the bias carried into this keyframe, the delta bias
    folded into the base bias (Frame::SetInitialNavStateAndBias).
    imu_rows: (T, 7) tensor of [gyro, acc, dt] rows, or None for the first
    keyframe. Returns the new MapState; `st` is updated in place."""
    dev = m.mp_pos.device
    pre = None
    if imu_rows is not None and imu_rows.shape[0] > 0:
        pre = preintegrate(imu_rows, ns.bg_full, ns.ba_full, noise)
    m = mapping.write_keyframe(
        m, slot, ns.P, ns.R, ns.V, ns.bg_full, ns.ba_full,
        torch.as_tensor(t_kf, dtype=torch.float32, device=dev),
        torch.as_tensor(fid, dtype=torch.int32, device=dev),
        uv, feats.level, feats.angle,
        torch.full((m.F,), -1.0, dtype=torch.float32, device=dev),
        feats.desc, feats.desc_pm1, feats.valid, feat_mp=feat_mp, pre=pre)
    st.kf_slots.append(slot)
    st.last_kf_slot = slot
    return m


def keyframe_event(m: MapState, st: MappingState, cfg: MappingConfig, frame_id: int,
                   cam: Camera, ext: factors.Extrinsics, gw, noise: IMUNoise,
                   hists=None, timer=None):
    """One keyframe event in SlamSystem._local_mapping's order: the pre-BA
    half (cull / evict, neighbours, triangulation, fusion), the inverse-depth
    window BA, the post-BA half (point-statistics refresh, stats, covisibility).
    Nothing in here reads a device value on the host; the caller reads
    EventResult when it needs the numbers and, as _harvest_event does, keeps
    the covisibility row for the next event's observer choice
    (`st.covis_row = result.stats[0].cpu().numpy()`).

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
    m, ba_stats = local_ba_idp(m, st, cfg, cam, ext, gw, noise)
    mark("post")
    m, stats, _, _ = mapping.kf_event_post(
        m, slot, wslots, wvalid, ext, hists, cfg.n_levels,
        min_obs=(2 if len(st.kf_slots) <= 2 else 3))
    mark("end")
    return m, EventResult(n_created=n_new, n_fused=n_fused, n_culled=n_culled,
                          ba=ba_stats, stats=stats)


def keyframe_navstate(m: MapState, slot: int) -> NavState:
    """The NavState row of keyframe `slot`. After an event, tracking continues
    from the optimised newest keyframe's (the state carry of _local_mapping),
    with a fresh prior: the marginal prior of the frame before is stale."""
    return NavState(*[a[slot] for a in m.kf_ns])
