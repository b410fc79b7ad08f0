"""Local-mapping stage programs (port of mc_slam_tpu/pipeline/mapping.py).

Replaces LocalMapping (src/LocalMapping.cpp): map-point culling (:1189), new
map points by epipolar-gated triangulation with covisible neighbours (:1241),
neighbour fusion (:1550), point-statistics refresh, and the fused pre- and
post-BA halves of a keyframe event. All dynamic structure (match counts, free
map slots) is padded and masked.

Differences of form from the JAX package, none of semantics:
* `.at[...].set(..., mode="drop")` writes through a buffer with one extra row
  that is sliced off (`_set_drop`); an index is never clipped to drop a write.
  `.at[].min` / `.at[].max` are `scatter_reduce` with `amin` / `amax`.
* `jnp.argsort` is stable and `lax.top_k` returns the lowest index among
  equals; here every sort that decides slots or neighbours is
  `stable=True`.
* `lax.scan` over neighbours is a Python loop; `lax.cond` on the map's
  occupancy is masked arithmetic (both branches computed, `torch.where` on
  the flag), so no function here reads a device value on the host.
* Keyframe slots may be Python ints or 0-d / (1,) integer tensors (the
  neighbours chosen on the device); rows are read with `index_select` and
  written with `index_copy`, never by indexing with a 0-d tensor, which
  would read it back.
* As in the JAX package, `fuse_into_keyframe` does not test whether the
  destination keyframe already holds the point in another feature
  (ORBmatcher::Fuse's IsInKeyFrame), so a keyframe can come to hold one
  point twice; the window BA's anchor pixel is chosen deterministically for
  that case (solver/ba_vi_idp.py).
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.frontend import matching
from mc_slam_tpu_torch.geometry.triangulation import parallax_cos, triangulate_two_view
from mc_slam_tpu_torch.slam_map.mapstate import (MapState, _row, _set_drop, _slot_tensor,
                                                 covisibility_weights, kf_sees_matrix,
                                                 observation_counts)
from mc_slam_tpu_torch.solver import factors

# Scale-invariance band floor: the reference always runs 8 pyramid levels,
# so its creation-time band [max_d / 1.2^7, max_d] never collapses
# (see mc_slam_tpu/pipeline/mapping.py:24-31).
BAND_LEVELS_FLOOR = 8

# epipolar pre-gate threshold on squared point-to-line distance, in units of
# sigma^2(level) (CheckDistEpipolarLine, src/ORBmatcher.cpp)
EPI_CHI2 = 36.0


def band_min_dist(max_d, n_levels):
    """Creation-time minimum scale-invariance distance, floored at the
    8-level band the reference always uses."""
    span = max(float(n_levels) - 1.0, float(BAND_LEVELS_FLOOR - 1))
    return max_d / (np.float32(1.2) ** np.float32(span))   # float32 power, as jnp


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _set_row(t, slot, value):
    """Copy of `t` with row `slot` (int or integer tensor) set to `value`."""
    out = t.clone()
    if isinstance(slot, int):
        out[slot] = value
    else:
        if not isinstance(value, torch.Tensor):
            value = torch.full((), value, dtype=t.dtype, device=t.device)
        out.index_copy_(0, slot.reshape(1).to(torch.int64),
                        value.to(t.dtype).expand(t.shape[1:])[None])
    return out


def _drop_dangling(m: MapState, new_active):
    """kf_mp with the associations of points that are no longer active cleared."""
    mp_ok = torch.cat([new_active, new_active.new_zeros(1)])
    idx = torch.where(m.kf_mp >= 0, m.kf_mp, m.P).to(torch.int64)
    return torch.where(mp_ok[idx], m.kf_mp, -1)


# ---------------------------------------------------------------------------
# Map-point culling (LocalMapping::MapPointCulling, src/LocalMapping.cpp:1189)
# ---------------------------------------------------------------------------

def cull_map_points(m: MapState, current_kf_id, min_obs=3):
    """Bad if found/visible < 0.25 (seen >= 4 times), or 2-4 keyframe ids old
    with < min_obs observations (3 mono, 2 stereo / RGB-D).
    Returns (m, n_deactivated)."""
    obs_n = observation_counts(m)
    found_ratio = m.mp_found / torch.clamp(m.mp_visible, min=1.0)
    age = current_kf_id - m.mp_first_kf
    bad = (found_ratio < 0.25) & (m.mp_visible >= 4)
    bad = bad | ((age >= 2) & (obs_n < min_obs) & (age <= 4))
    new_active = m.mp_active & ~bad
    return (m._replace(mp_active=new_active, kf_mp=_drop_dangling(m, new_active)),
            torch.sum(m.mp_active & bad))


def cull_orphans(m: MapState, current_kf_id, min_age=30):
    """Capacity-pressure sweep: deactivate points older than `min_age` frames
    with <= 1 observer. Run only under slot pressure (cull_and_evict).
    Returns (m, n_deactivated)."""
    obs_n = observation_counts(m)
    age = current_kf_id - m.mp_first_kf
    bad = m.mp_active & (obs_n <= 1) & (age > min_age)
    new_active = m.mp_active & ~bad
    return (m._replace(mp_active=new_active, kf_mp=_drop_dangling(m, new_active)),
            torch.sum(bad))


def evict_low_value(m: MapState, current_kf_id, n_evict: int):
    """Capacity-pressure eviction: deactivate the `n_evict` lowest-value
    active points (few observations first, then poor found/visible ratio;
    points younger than 30 frames are protected). Ties go to the lowest slot
    (stable sort). Returns (m, n_evicted)."""
    obs_n = observation_counts(m)
    found_ratio = m.mp_found / torch.clamp(m.mp_visible, min=1.0)
    age = current_kf_id - m.mp_first_kf
    score = obs_n * 10.0 + found_ratio
    protected = (~m.mp_active) | (age < 30)
    score = torch.where(protected, torch.inf, score)
    order = torch.argsort(score, stable=True)[:n_evict]
    evictable = torch.isfinite(score[order])
    new_active = _set_drop(m.mp_active, torch.where(evictable, order, m.P), False)
    return (m._replace(mp_active=new_active, kf_mp=_drop_dangling(m, new_active)),
            torch.sum(evictable))


# ---------------------------------------------------------------------------
# New map points: triangulate epipolar matches between the new keyframe and
# one neighbour (LocalMapping::CreateNewMapPoints, src/LocalMapping.cpp:1241)
# ---------------------------------------------------------------------------

def _cam_pose(m: MapState, ext: factors.Extrinsics, k):
    """World-from-camera rotation and centre of keyframe slot k."""
    Rwb = _row(m.kf_ns.R, k)
    Pwb = _row(m.kf_ns.P, k)
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -_mv(Rbc, ext.tcb)
    return Rwb @ Rbc, _mv(Rwb, pbc) + Pwb


def create_points_with_neighbor(m: MapState, kf_a, kf_b, cam: Camera,
                                ext: factors.Extrinsics, max_new: int = 256,
                                max_dist=matching.TH_LOW, min_parallax_cos=0.99996,
                                n_levels=8):
    """Triangulate new landmarks from unassociated features of keyframe a
    against keyframe b: descriptor NN under an epipolar gate, triangulation,
    depth / parallax / reprojection audit, allocation into the first free map
    slots (at most max_new, best Hamming first). Returns (m, n_created)."""
    Fn = m.F
    Rwc_a, Cwa = _cam_pose(m, ext, kf_a)
    Rwc_b, Cwb = _cam_pose(m, ext, kf_b)
    valid_a, valid_b = _row(m.kf_feat_valid, kf_a), _row(m.kf_feat_valid, kf_b)
    mp_a, mp_b = _row(m.kf_mp, kf_a), _row(m.kf_mp, kf_b)
    uv_a, uv_b = _row(m.kf_uv, kf_a), _row(m.kf_uv, kf_b)
    lvl_a, lvl_b = _row(m.kf_level, kf_a), _row(m.kf_level, kf_b)
    pm1_a = _row(m.kf_pm1, kf_a)

    free_a = valid_a & (mp_a < 0)
    free_b = valid_b & (mp_b < 0)
    dist = matching.hamming_matrix(pm1_a, _row(m.kf_pm1, kf_b))
    free = free_a[:, None] & free_b[None, :]

    # baseline / median scene depth (mono skips a neighbour below 0.01);
    # median depth over keyframe a's associated points, by a masked sort
    has_a = (mp_a >= 0) & valid_a
    Pc_a = _mv(Rwc_a.transpose(-1, -2),
               m.mp_pos[torch.clamp(mp_a, 0, m.P - 1).to(torch.int64)] - Cwa)
    z_sorted = torch.sort(torch.where(has_a, Pc_a[..., 2], torch.inf)).values
    n_assoc = torch.sum(has_a)
    med_idx = torch.clamp(n_assoc // 2, 0, Fn - 1).reshape(1)
    med_z = torch.where(n_assoc > 0, z_sorted.index_select(0, med_idx)[0], 1.0)
    baseline = torch.linalg.norm(Cwa - Cwb)
    bd_ratio = baseline / torch.clamp(med_z, min=1e-6)
    enough_baseline = bd_ratio > 0.01

    def norm(uv):
        return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                            (uv[..., 1] - cam.cy) / cam.fy], -1)
    xn_a_all = norm(uv_a)
    xn_b_all = norm(uv_b)

    # epipolar pre-gate: point-to-line distance in keyframe b under the
    # essential matrix of the relative pose, 6 sigma per level; applied only
    # where the geometry makes it informative (baseline / depth > 0.08)
    R_ba = Rwc_b.transpose(-1, -2) @ Rwc_a
    t_ba = _mv(Rwc_b.transpose(-1, -2), Cwa - Cwb)
    E = lie.hat(t_ba) @ R_ba
    ones = torch.ones((Fn, 1), dtype=xn_a_all.dtype, device=xn_a_all.device)
    xa_h = torch.cat([xn_a_all, ones], -1)
    xb_h = torch.cat([xn_b_all, ones], -1)
    l_b = xa_h @ E.T                                        # (Fa, 3) epipolar lines
    num = torch.abs(l_b @ xb_h.T)                           # (Fa, Fb)
    den = torch.sqrt(l_b[:, 0] ** 2 + l_b[:, 1] ** 2)[:, None]
    d_px = num / torch.clamp(den, min=1e-12) * cam.fx
    sig_b = 1.2 ** lvl_b.to(torch.float32)
    use_epi = bd_ratio > 0.08
    gate = free & ((d_px * d_px < EPI_CHI2 * sig_b[None, :] ** 2) | ~use_epi)

    # the ratio test is judged against every free feature, gated or not
    idx_b, best, ok = matching.match_nn(dist, gate, max_dist=max_dist, ratio=0.8,
                                        ratio_mask=free)
    ok = matching.resolve_duplicates(idx_b, best, ok, Fn)

    xn_b = xn_b_all[idx_b]
    Xw, da, db = triangulate_two_view(Rwc_a, Cwa, Rwc_b, Cwb, xn_a_all, xn_b)
    cosp = parallax_cos(Cwa, Cwb, Xw)

    def reproj_err(Rwc, Cw, uv):
        Pc = _mv(Rwc.transpose(-1, -2), Xw - Cw)
        z = torch.clamp(Pc[..., 2], min=1e-9)
        u = cam.fx * Pc[..., 0] / z + cam.cx
        v = cam.fy * Pc[..., 1] / z + cam.cy
        return torch.sum((torch.stack([u, v], -1) - uv) ** 2, -1)
    e_a = reproj_err(Rwc_a, Cwa, uv_a)
    e_b = reproj_err(Rwc_b, Cwb, uv_b[idx_b])
    sig_a = 1.2 ** (2.0 * lvl_a.to(torch.float32))
    good = ok & (da > 0.05) & (db > 0.05) & (cosp < min_parallax_cos) \
        & (e_a < 5.991 * sig_a) & (e_b < 5.991 * sig_a) \
        & torch.all(torch.isfinite(Xw), -1) & enough_baseline

    # at most max_new, best Hamming first; free map slots in index order
    n_take = min(max_new, Fn, m.P)
    order = torch.argsort(torch.where(good, best, matching.BIG), stable=True)[:n_take]
    slot_order = torch.argsort(m.mp_active.to(torch.int8), stable=True)[:n_take]
    write = good[order] & ~m.mp_active[slot_order]
    slots = torch.where(write, slot_order, m.P)

    dist_a = torch.linalg.norm(Xw[order] - Cwa, dim=-1)
    lvl = lvl_a[order].to(torch.float32)
    max_d = dist_a * (1.2 ** lvl)
    min_d = band_min_dist(max_d, n_levels)
    normal = (Xw[order] - Cwa) / torch.clamp(dist_a, min=1e-9)[:, None]
    kf_a_t = _slot_tensor(kf_a, slots.device).to(torch.int32)

    # feature associations in both keyframes (a first: for a == b nothing is
    # written at all, a self-pair has no baseline)
    row_a = _set_drop(mp_a, torch.where(write, order, Fn), slot_order.to(torch.int32))
    kf_mp = _set_row(m.kf_mp, kf_a, row_a)
    row_b = _set_drop(_row(kf_mp, kf_b), torch.where(write, idx_b[order], Fn),
                      slot_order.to(torch.int32))
    kf_mp = _set_row(kf_mp, kf_b, row_b)

    m2 = m._replace(
        mp_pos=_set_drop(m.mp_pos, slots, Xw[order]),
        mp_desc=_set_drop(m.mp_desc, slots, _row(m.kf_desc, kf_a)[order]),
        mp_pm1=_set_drop(m.mp_pm1, slots, pm1_a[order]),
        mp_angle=_set_drop(m.mp_angle, slots, _row(m.kf_angle, kf_a)[order]),
        mp_normal=_set_drop(m.mp_normal, slots, normal),
        mp_min_dist=_set_drop(m.mp_min_dist, slots, min_d),
        mp_max_dist=_set_drop(m.mp_max_dist, slots, max_d),
        mp_ref_kf=_set_drop(m.mp_ref_kf, slots, kf_a_t),
        mp_first_kf=_set_drop(m.mp_first_kf, slots, _row(m.kf_id, kf_a)),
        mp_found=_set_drop(m.mp_found, slots, 2.0),
        mp_visible=_set_drop(m.mp_visible, slots, 2.0),
        mp_active=_set_drop(m.mp_active, slots, True),
        kf_mp=kf_mp)
    return m2, torch.sum(write)


def create_points_with_neighbor_scan(m, kf_a, nbrs, cam, ext, max_new, n_levels):
    """Triangulate against several neighbours in turn, the MapState chained
    through. nbrs: (N,) neighbour slots on the device; pass kf_a itself for
    padding entries (a self-pair has zero baseline and writes nothing).
    Returns (m, n_created)."""
    total = torch.zeros((), dtype=torch.int64, device=m.mp_active.device)
    for i in range(nbrs.shape[0]):
        m, n = create_points_with_neighbor(m, kf_a, nbrs[i:i + 1], cam, ext,
                                           max_new=max_new, n_levels=n_levels)
        total = total + n
    return m, total


def create_points_with_neighbors(m: MapState, kf_a, nbrs, cam: Camera,
                                 ext: factors.Extrinsics, max_new: int = 256,
                                 n_levels=8):
    """See create_points_with_neighbor_scan."""
    return create_points_with_neighbor_scan(m, kf_a, nbrs, cam, ext, max_new, n_levels)


# ---------------------------------------------------------------------------
# Fuse (SearchInNeighbors, src/LocalMapping.cpp:1550): project keyframe src's
# map points into keyframe dst; matched free features gain the association,
# matched features that hold another point keep the better-observed one.
# ---------------------------------------------------------------------------

def fuse_into_keyframe(m: MapState, kf_src, kf_dst, cam: Camera,
                       ext: factors.Extrinsics, radius=3.0,
                       max_dist=matching.TH_LOW, obs_n=None, valid=None):
    """obs_n: optional precomputed observation_counts(m) (a fusion round
    computes them once). valid: optional 0-d / (1,) switch that turns the
    pair into a no-op (padding pairs of fuse_neighbors).
    Returns (m, n_new_associations)."""
    P, Fn = m.P, m.F
    mp_of_src = torch.where(_row(m.kf_feat_valid, kf_src), _row(m.kf_mp, kf_src), -1)
    src_has = mp_of_src >= 0
    mp_idx = torch.clamp(mp_of_src, 0, P - 1).to(torch.int64)
    Rwb = _row(m.kf_ns.R, kf_dst)
    Pwb = _row(m.kf_ns.P, kf_dst)
    Pb = _mv(Rwb.transpose(-1, -2), m.mp_pos[mp_idx] - Pwb)
    Pc = _mv(ext.Rcb, Pb) + ext.tcb
    z = Pc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    uv = torch.stack([cam.fx * Pc[..., 0] / zs + cam.cx,
                      cam.fy * Pc[..., 1] / zs + cam.cy], -1)
    vis = src_has & (z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height) & m.mp_active[mp_idx]

    cur_mp = _row(m.kf_mp, kf_dst)                            # (F,)
    dst_valid = _row(m.kf_feat_valid, kf_dst)
    dist = matching.hamming_matrix(m.mp_pm1[mp_idx], _row(m.kf_pm1, kf_dst))
    gate = matching.window_mask(uv, _row(m.kf_uv, kf_dst), radius)
    gate = gate & vis[:, None] & dst_valid[None, :]
    if valid is not None:
        gate = gate & (valid.reshape(()) > 0)
    fidx, best, ok = matching.match_nn(dist, gate, max_dist=max_dist)
    ok = matching.resolve_duplicates(fidx, best, ok, Fn)

    if obs_n is None:
        obs_n = observation_counts(m)
    # keep the better-observed point at the target feature
    cur_at = cur_mp[fidx]
    cur_obs = torch.where(cur_at >= 0,
                          obs_n[torch.clamp(cur_at, 0, P - 1).to(torch.int64)], -1.0)
    new_obs = obs_n[mp_idx]
    replace = ok & ((cur_at < 0) | (new_obs >= cur_obs))
    row = _set_drop(cur_mp, torch.where(replace, fidx, Fn), mp_idx.to(torch.int32))
    return (m._replace(kf_mp=_set_row(m.kf_mp, kf_dst, row)),
            torch.sum(replace & (cur_at < 0)))


def fuse_neighbors(m: MapState, kf_a, nbrs, nbrs_valid, cam: Camera,
                   ext: factors.Extrinsics):
    """Bidirectional fusion round: for each valid neighbour nb, fuse(nb -> a)
    then, after all of those, fuse(a -> nb). Observation counts are taken
    once at the start of the round. Returns (m, n_new_associations)."""
    obs_n = observation_counts(m)
    dev = m.mp_active.device
    a = _slot_tensor(kf_a, dev)
    N = nbrs.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = [(nbrs[i:i + 1], a, nbrs_valid[i:i + 1]) for i in range(N)] \
        + [(a, nbrs[i:i + 1], nbrs_valid[i:i + 1]) for i in range(N)]
    for src, dst, v in pairs:
        m, n = fuse_into_keyframe(m, src, dst, cam, ext, obs_n=obs_n, valid=v)
        total = total + n
    return m, total


# ---------------------------------------------------------------------------
# Keyframe culling support (LocalMapping::KeyFrameCulling, :1777)
# ---------------------------------------------------------------------------

def kf_redundancy(m: MapState, kf_slot):
    """(ratio, n_pts): the share of the keyframe's points seen by >= 4 keyframes."""
    mp = _row(m.kf_mp, kf_slot)
    has = (mp >= 0) & _row(m.kf_feat_valid, kf_slot)
    obs_n = observation_counts(m)
    n_pts = torch.sum(has)
    redundant = torch.sum(has & (obs_n[torch.clamp(mp, 0, m.P - 1).to(torch.int64)] >= 4.0))
    return redundant.to(torch.float32) / torch.clamp(n_pts.to(torch.float32), min=1.0), n_pts


def kf_redundancy_all(m: MapState):
    """(ratio (K,), n_pts (K,)) redundancy of every keyframe in one pass."""
    obs_n = observation_counts(m)
    has = (m.kf_mp >= 0) & m.kf_feat_valid
    mp = torch.clamp(m.kf_mp, 0, m.P - 1).to(torch.int64)
    red = torch.sum(has & (obs_n[mp] >= 4.0), dim=1).to(torch.float32)
    n_pts = torch.sum(has, dim=1)
    return red / torch.clamp(n_pts.to(torch.float32), min=1.0), n_pts


def write_keyframe(m: MapState, slot, P_pose, R_pose, V, bg, ba, t_kf, fid,
                   uv, level, angle, ur, desc, pm1, feat_valid,
                   feat_mp=None, pre=None) -> MapState:
    """All keyframe-table writes of an insertion; returns the new MapState
    (inputs are not modified). The base bias is written, the delta bias
    zeroed. feat_mp: optional (F,) feature -> map-point row (a keyframe made
    from a tracked frame); pre: optional PreintState row, the preintegration
    from the previous keyframe."""
    ns = m.kf_ns
    z3 = torch.zeros(3, dtype=ns.P.dtype, device=ns.P.device)
    ns = ns._replace(
        P=_set_row(ns.P, slot, P_pose), R=_set_row(ns.R, slot, R_pose),
        V=_set_row(ns.V, slot, V), bg=_set_row(ns.bg, slot, bg),
        ba=_set_row(ns.ba, slot, ba), dbg=_set_row(ns.dbg, slot, z3),
        dba=_set_row(ns.dba, slot, z3))
    m = m._replace(
        kf_ns=ns,
        kf_time=_set_row(m.kf_time, slot, t_kf),
        kf_id=_set_row(m.kf_id, slot, fid),
        kf_active=_set_row(m.kf_active, slot, True),
        kf_uv=_set_row(m.kf_uv, slot, uv),
        kf_level=_set_row(m.kf_level, slot, level),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_ur=_set_row(m.kf_ur, slot, ur),
        kf_desc=_set_row(m.kf_desc, slot, desc),
        kf_pm1=_set_row(m.kf_pm1, slot, pm1),
        kf_feat_valid=_set_row(m.kf_feat_valid, slot, feat_valid),
    )
    if feat_mp is not None:
        m = m._replace(kf_mp=_set_row(m.kf_mp, slot, feat_mp))
    if pre is not None:
        m = m._replace(kf_preint=type(m.kf_preint)(
            *[_set_row(a, slot, b) for a, b in zip(m.kf_preint, pre)]))
    return m


def prune_associations(m: MapState, ks, chi2, valid, gate):
    """Clear feature -> map-point associations whose post-BA chi2 exceeds
    1.5 x the gate. ks: (n,) distinct window slots aligned with the (n*F,)
    flat chi2 / valid; gate: scalar or (n*F,) threshold."""
    bad = ((chi2 > gate * 1.5) & (valid > 0)).reshape(ks.shape[0], -1)
    ks = ks.to(torch.int64)
    kf_mp = m.kf_mp.clone()
    kf_mp[ks] = torch.where(bad, -1, m.kf_mp[ks])
    return m._replace(kf_mp=kf_mp)


def deactivate_keyframe(m: MapState, kf_slot):
    """Remove a keyframe: clear its mask and feature associations."""
    return m._replace(kf_active=_set_row(m.kf_active, kf_slot, False),
                      kf_mp=_set_row(m.kf_mp, kf_slot, -1))


# ---------------------------------------------------------------------------
# Point statistics refresh (MapPoint::ComputeDistinctiveDescriptors and
# MapPoint::UpdateNormalAndDepth) over a fixed window of observing keyframes
# ---------------------------------------------------------------------------

def refresh_point_stats(m: MapState, slots, slot_valid, ext: factors.Extrinsics,
                        n_levels=8):
    """slots: (W,) keyframe slots; slots[0] is the new keyframe whose points
    are refreshed, the rest its top covisible observers; slot_valid: (W,)
    bool mask of padded entries. For every such point seen by >= 2 window
    keyframes: the representative descriptor (minimum median Hamming
    distance to the other observations) with its angle, the mean viewing
    normal, and the scale-invariance range when the reference keyframe is in
    the window."""
    W = slots.shape[0]
    P, Fn = m.P, m.F
    dev = slots.device
    slots = slots.to(torch.int64)
    # inverse lookup: feature index of each window keyframe observing point p
    kf_mp_w = m.kf_mp[slots]                                   # (W, F)
    obs_ok = m.kf_feat_valid[slots] & slot_valid[:, None] & (kf_mp_w >= 0)
    rows = torch.arange(W, dtype=torch.int64, device=dev).repeat_interleave(Fn)
    cols = torch.where(obs_ok, kf_mp_w, P).reshape(-1).to(torch.int64)
    feats = torch.arange(Fn, dtype=torch.int64, device=dev).repeat(W)
    inv = torch.full((W * (P + 1),), Fn, dtype=torch.int64, device=dev).scatter_reduce(
        0, rows * (P + 1) + cols, feats, reduce="amin", include_self=True
    ).reshape(W, P + 1)

    touched = m.kf_mp[slots[:1]][0]                            # (F,)
    pt = torch.clamp(touched, 0, P - 1).to(torch.int64)
    tmask = (touched >= 0) & m.kf_feat_valid[slots[:1]][0] & m.mp_active[pt]

    feat_iw = inv[:, pt].T                                     # (F, W)
    vmask = feat_iw < Fn
    fi = torch.clamp(feat_iw, 0, Fn - 1)
    w_ar = torch.arange(W, device=dev)[None, :]
    pm1_w = m.kf_pm1[slots][w_ar, fi]                          # (F, W, 256)
    desc_w = m.kf_desc[slots][w_ar, fi]                        # (F, W, 8)
    # pairwise Hamming within each point's observation set: (256 - dot) / 2
    pf = pm1_w.to(torch.float32)
    d = (256.0 - pf @ pf.transpose(-1, -2)) * 0.5              # (F, W, W)
    d = torch.where(vmask[:, None, :], d, torch.inf)
    cnt = torch.sum(vmask, -1)                                 # (F,)
    sortd = torch.sort(d, dim=-1).values
    med_idx = torch.clamp((cnt - 1) // 2, 0, W - 1)
    med = torch.gather(sortd, 2, med_idx[:, None, None].expand(-1, W, 1))[..., 0]
    med = torch.where(vmask, med, torch.inf)                   # (F, W)
    best_w = torch.argmin(med, dim=-1)                         # first minimum
    f_ar = torch.arange(Fn, device=dev)
    new_pm1 = pm1_w[f_ar, best_w]
    new_desc = desc_w[f_ar, best_w]
    # the representative's angle travels with its descriptor
    new_angle = m.kf_angle[slots][w_ar, fi][f_ar, best_w]

    # mean viewing normal over the window's observations
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -_mv(Rbc, ext.tcb)
    C_w = _mv(m.kf_ns.R[slots], pbc) + m.kf_ns.P[slots]        # (W, 3)
    dirs = m.mp_pos[pt][:, None, :] - C_w[None, :, :]          # (F, W, 3)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(vmask[..., None], dirs, 0.0), 1)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True),
                                  min=1e-9)

    # scale-invariance range re-anchored at the reference keyframe when it is
    # inside the window
    is_ref = (slots[None, :] == m.mp_ref_kf[pt][:, None]) & vmask
    ref_in = torch.any(is_ref, -1)
    w_ref = torch.argmax(is_ref.to(torch.int8), dim=-1)        # first True, else 0
    d_ref = torch.linalg.norm(m.mp_pos[pt] - C_w[w_ref], dim=-1)
    f_ref = fi[f_ar, w_ref]
    lvl_ref = m.kf_level[slots][w_ref, f_ref].to(torch.float32)
    max_d = d_ref * (1.2 ** lvl_ref)
    min_d = band_min_dist(max_d, n_levels)

    write = tmask & (cnt >= 2)
    idx = torch.where(write, pt, P)
    idx_ref = torch.where(write & ref_in, pt, P)
    return m._replace(
        mp_pm1=_set_drop(m.mp_pm1, idx, new_pm1),
        mp_desc=_set_drop(m.mp_desc, idx, new_desc),
        mp_angle=_set_drop(m.mp_angle, idx, new_angle),
        mp_normal=_set_drop(m.mp_normal, idx, normal),
        mp_max_dist=_set_drop(m.mp_max_dist, idx_ref, max_d),
        mp_min_dist=_set_drop(m.mp_min_dist, idx_ref, min_d),
    )


def update_found_visible(m: MapState, visible_mask, found_mask):
    """Tracking bookkeeping: IncreaseVisible / IncreaseFound counters."""
    return m._replace(mp_visible=m.mp_visible + visible_mask.to(m.mp_visible.dtype),
                      mp_found=m.mp_found + found_mask.to(m.mp_found.dtype))


def cull_and_evict(m: MapState, current_kf_id, min_obs: int = 3, n_evict: int = 0):
    """Start-of-event landmark maintenance: MapPointCulling, then the orphan
    sweep above 90 % occupancy and lowest-value eviction above 95 %. Both
    capacity policies are computed and selected by the occupancy flag on the
    device (no host read)."""
    m, _ = cull_map_points(m, current_kf_id, min_obs)

    def select(flag, m_new, m_old):
        return m_old._replace(
            mp_active=torch.where(flag, m_new.mp_active, m_old.mp_active),
            kf_mp=torch.where(flag, m_new.kf_mp, m_old.kf_mp))

    swept, _ = cull_orphans(m, current_kf_id)
    m = select(torch.sum(m.mp_active) > 0.9 * m.P, swept, m)
    if n_evict > 0:
        evicted, _ = evict_low_value(m, current_kf_id, n_evict)
        m = select(torch.sum(m.mp_active) > 0.95 * m.P, evicted, m)
    return m


def _event_stats(m: MapState, slot, sees, obs, min_obs):
    """(covis_row, red_ratio, n_pts, n_active, n_well_tracked) from the (K, P)
    membership matrix of active keyframes."""
    P = m.P
    obs_n = torch.sum(sees, dim=0) * m.mp_active               # (P,)
    mp = torch.clamp(m.kf_mp, 0, P - 1).to(torch.int64)
    red = torch.sum(obs & (obs_n[mp] >= 4.0), dim=1).to(torch.float32)
    n_pts = torch.sum(obs, dim=1)
    red_ratio = red / torch.clamp(n_pts.to(torch.float32), min=1.0)
    mp_ref = _row(m.kf_mp, slot)
    well = ((mp_ref >= 0) & _row(m.kf_feat_valid, slot)
            & (obs_n[torch.clamp(mp_ref, 0, P - 1).to(torch.int64)] >= min_obs))
    return obs_n, (red_ratio, n_pts, torch.sum(m.mp_active), torch.sum(well))


def kf_event_stats(m: MapState, slot, min_obs: int = 3):
    """Everything the host needs to steer one keyframe event: the
    covisibility row of `slot`, per-keyframe redundancy, the active-landmark
    count, and the count of well-observed points tracked by `slot`."""
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None]
    sees = kf_sees_matrix(m, obs)
    covis_row = sees @ (_row(sees, slot) * m.mp_active)
    _, rest = _event_stats(m, slot, sees, obs, min_obs)
    return (covis_row,) + rest


def kf_neighbors(m: MapState, slot, covis_th: int = 15):
    """Top covisible neighbours of `slot`, chosen on the device. Returns
    (nb4, nbv4, wslots8, wvalid8): the 4 triangulation / fusion partners
    (padded with `slot`, validity in nbv4) and the 8-slot refresh window.
    Mirrors GetCovisiblesByWeight with the max-weight fallback of
    UpdateConnections (src/KeyFrame.cpp:668-696). Equal weights go to the
    lowest slot (stable descending sort, as lax.top_k)."""
    dev = m.kf_active.device
    slot_t = _slot_tensor(slot, dev)
    w = covisibility_weights(m, slot) * m.kf_active.to(torch.float32)
    w = w.index_fill(0, slot_t, 0.0)
    top_w, top_i = torch.sort(w, descending=True, stable=True)
    top_w, top_i = top_w[:8], top_i[:8]
    ok8 = top_w >= covis_th
    ok8 = torch.cat([ok8[:1] | (top_w[:1] > 0), ok8[1:]])
    nb4 = torch.where(ok8[:4], top_i[:4], slot_t)
    nbv4 = ok8[:4].to(torch.float32)
    wslots = torch.cat([slot_t, top_i[:7]])
    wvalid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ok8[:7]])
    return nb4, nbv4, wslots, wvalid


def kf_event_pre(m: MapState, slot, current_kf_id, cam: Camera,
                 ext: factors.Extrinsics, n_levels, min_obs: int = 3,
                 n_evict: int = 0, covis_th: int = 15, max_new: int = 256):
    """The pre-BA half of a keyframe event: landmark maintenance, neighbour
    selection, triangulation against the 4 best neighbours, fusion.
    Returns (m, nb4, nbv4, wslots, wvalid, (n_created, n_fused))."""
    m = cull_and_evict(m, current_kf_id, min_obs=min_obs, n_evict=n_evict)
    nb4, nbv4, wslots, wvalid = kf_neighbors(m, slot, covis_th=covis_th)
    m, n_new = create_points_with_neighbor_scan(m, slot, nb4, cam, ext,
                                                max_new=max_new, n_levels=n_levels)
    m, n_fused = fuse_neighbors(m, slot, nb4, nbv4, cam, ext)
    return m, nb4, nbv4, wslots, wvalid, (n_new, n_fused)


def kf_event_post(m: MapState, slot, wslots, wvalid, ext: factors.Extrinsics,
                  hists, n_levels, min_obs: int = 3, refresh: bool = True):
    """The post-BA half of a keyframe event: point-statistics refresh,
    redundancy / tracked-point stats and loop-detection scores, with the
    (K, P) membership matrix built once and shared.
    Returns (m, stats, scores, W): stats as kf_event_stats, scores =
    hists @ hists[slot], W the (K, K) covisibility matrix."""
    if refresh:
        m = refresh_point_stats(m, wslots, wvalid, ext, n_levels=n_levels)
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None]
    sees = kf_sees_matrix(m, obs)
    sees_act = sees * m.mp_active[None, :]
    W = sees_act @ sees_act.T
    _, rest = _event_stats(m, slot, sees, obs, min_obs)
    stats = (_row(W, slot),) + rest
    scores = hists @ _row(hists, slot)
    return m, stats, scores, W
