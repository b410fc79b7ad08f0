"""Loop detection and correction (port of mc_slam_tpu/pipeline/loopclosing.py,
the role of LoopClosing).

BoW candidate retrieval gated by the covisibility minimum score, temporal
consistency over covisibility groups, the Sim3 solve between matched map
points (RANSAC + pixel refinement, batched over the candidates of an event),
the guided verification (a whole-map projection search through the candidate
Sim3, which runs the hand-written CUDA kernel on the card), and the loop
correction: Sim3 propagation, essential-graph optimization, map-point remap.

Differences of form from the JAX package, none of semantics:
* RANSAC sample indices are arguments (drawn from a `torch.Generator` when
  not given); the candidates of `sim3_ransac_batch` are one batched pass, no
  loop over candidates.
* `close_loop` pads neither vertices nor edges (the JAX package pads both to
  fixed sizes so that its program compiles once, with copies of the last
  slot that it scatters back as duplicates); each keyframe is written once.
* The detector's table is written in place (`hists[slot] = h`).
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.device import resolve
from mc_slam_tpu_torch.frontend import bow, matching
from mc_slam_tpu_torch.geometry import pnp, sim3solver
from mc_slam_tpu_torch.parallel import dist_ba, dist_posegraph
from mc_slam_tpu_torch.slam_map.mapstate import MapState, _set_drop, covisibility_matrix
from mc_slam_tpu_torch.solver import posegraph
from mc_slam_tpu_torch.solver.sim3opt import optimize_sim3

SIM3_ITERS = 300     # RANSAC hypotheses per loop candidate


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class LoopDetector:
    """Detector state: one BoW histogram per keyframe slot, on the device,
    and the host consistency counters."""

    def __init__(self, vocab, max_kf, min_consistency=3, idf=None, device=None):
        dev = vocab.device if device is None else resolve(device)
        self.vocab = vocab
        self.idf = idf
        self.hists = torch.zeros((max_kf, vocab.shape[0]), dtype=torch.float32, device=dev)
        self.min_consistency = min_consistency
        # [(covisibility group frozenset, consistency count)] carried between
        # keyframes (mvConsistentGroups)
        self.consistent_groups: list[tuple[frozenset, int]] = []
        # slot -> frame id of the histogram's occupant (host mirror): a slot
        # recycled between a detection's dispatch and its harvest still carries
        # the evicted keyframe's histogram, whose score must not go to the new
        # occupant
        self.hist_ids: dict[int, int] = {}
        self._dispatch_ids: dict[int, int] | None = None
        self.last_W = None
        self.last_diag = None

    def add_keyframe(self, slot, desc_pm1, valid, kf_id=None):
        self.hists[int(slot)] = bow.bow_histogram(desc_pm1, valid, self.vocab, idf=self.idf)
        if kf_id is not None:
            self.hist_ids[int(slot)] = int(kf_id)

    def snapshot_ids(self):
        """Note which keyframe holds each slot's histogram now, at the moment
        the scores are computed: `detect` drops a slot whose occupant has
        changed since."""
        self._dispatch_ids = dict(self.hist_ids)

    def detect_dispatch(self, m: MapState, slot):
        """The device half: the BoW scores of every keyframe against `slot`
        and the whole covisibility matrix. Returns (scores (K,), W (K, K));
        the slot -> id snapshot for the stale-slot guard is taken here."""
        self.snapshot_ids()
        return self.hists @ self.hists[int(slot)], covisibility_matrix(m)

    def detect(self, m: MapState, slot, kf_slots, kf_ids=None, min_gap=10, handles=None):
        """Loop candidates [(slot, streak-qualified)], best score first
        (DetectLoop): a candidate scores at least the minimum over the
        covisible keyframes (and 0.15), is not covisible (weight < 15) and at
        least `min_gap` frame ids away; each candidate's covisibility GROUP
        carries its own consistency counter across consecutive keyframes.
        Candidates with a streak of min_consistency come first, then the 3
        best of the rest, flagged so the caller can ask more of them.

        kf_ids: host {slot: frame id}; handles: (scores, W) of
        `detect_dispatch` or of the keyframe event. ONE device->host copy."""
        if handles is None:
            handles = self.detect_dispatch(m, slot)
        K = handles[0].shape[0]
        host = torch.cat([handles[0].reshape(-1), handles[1].reshape(-1)]).cpu().numpy()
        scores, W = host[:K], host[K:].reshape(K, K)
        self.last_W = W
        covis = W[slot].copy()
        covis[slot] = 0
        cov_slots = [k for k in np.nonzero(covis >= 15)[0] if k != slot]
        min_score = min((float(scores[k]) for k in cov_slots), default=0.3)
        if kf_ids is None:
            ids = m.kf_id.cpu().numpy()
            kf_ids = {k: int(ids[k]) for k in kf_slots}
        snap = self._dispatch_ids

        def fresh(k):
            cur = self.hist_ids.get(k)
            if snap is None or cur is None:
                return True      # no registration for this slot
            return snap.get(k) == cur

        far = [k for k in kf_slots if k != slot and covis[k] < 15
               and abs(kf_ids[slot] - kf_ids[k]) >= min_gap]
        cands = [k for k in far if scores[k] >= max(min_score, 0.15) and fresh(k)]
        self.last_diag = dict(min_score=round(float(min_score), 3),
                              best_noncovis=round(max((float(scores[k]) for k in far),
                                                      default=-1.0), 3),
                              n_cands=len(cands))
        if not cands:
            self.consistent_groups = []
            return []
        new_groups, enough, rest = [], [], []
        for k in cands:
            group = frozenset({k} | {int(x) for x in np.nonzero(W[k] >= 15)[0]})
            streak = 0
            for pg, pc in self.consistent_groups:
                if pg & group:
                    streak = max(streak, pc + 1)
            new_groups.append((group, streak))
            (enough if streak + 1 >= self.min_consistency else rest).append(
                (float(scores[k]), k))
        self.consistent_groups = new_groups
        enough.sort(reverse=True)
        rest.sort(reverse=True)
        return [(k, True) for _, k in enough] + [(k, False) for _, k in rest[:3]]


def _cam_coords(m: MapState, slot, mp, ext):
    """Positions of map points `mp` (clipped into the table) in the CAMERA
    frame of keyframe `slot`; both may carry a leading batch dim."""
    Rwb, Pwb = m.kf_ns.R[slot], m.kf_ns.P[slot]
    X = m.mp_pos[torch.clamp(mp, 0, m.P - 1).to(torch.int64)]
    Xb = _mv(Rwb.transpose(-1, -2)[..., None, :, :], X - Pwb[..., None, :])
    if ext is None:
        return Xb
    return _mv(ext.Rcb, Xb) + ext.tcb


def sim3_ransac_batch(m: MapState, idx, slot_cur, cand_slots, min_inliers, cam,
                      ext=None, fix_scale: bool = False,
                      generator: torch.Generator | None = None, curve: bool = False):
    """Sim3 RANSAC + pixel refinement for C loop candidates as one batched
    pass (ComputeSim3): mutual descriptor matching of the current keyframe's
    landmark features against each candidate's, 300 Horn hypotheses each, the
    refit on the best one's inliers, 10 LM iterations of `optimize_sim3` kept
    only where they strictly raise the inlier count.

    idx: (C, 300, 3) int64 sample indices, or None to draw them from
    `generator`; cand_slots: (C,) int64 keyframe slots; min_inliers: (C,)
    per-candidate consensus bar.
    Returns (C, 15) rows [ok, n_inliers, s, R (9), t (3)] for ONE host read
    (and the refinement's cost curves (iters, C) when `curve`)."""
    slot_cur = int(slot_cur)
    mp_c = m.kf_mp[slot_cur]
    has_c = (mp_c >= 0) & m.kf_feat_valid[slot_cur]
    mp_l = m.kf_mp[cand_slots]                                   # (C, F)
    has_l = (mp_l >= 0) & m.kf_feat_valid[cand_slots]
    midx, _, okm = matching.mutual_match(
        m.kf_pm1[slot_cur], has_c, m.kf_pm1[cand_slots], has_l,
        max_dist=matching.TH_LOW, ratio=0.9,
        angle_a=m.kf_angle[slot_cur], angle_b=m.kf_angle[cand_slots])
    Pc_cur = _cam_coords(m, slot_cur, mp_c, ext)                 # (F, 3)
    Pc_loop = _cam_coords(m, cand_slots, torch.gather(mp_l, 1, midx), ext)   # (C, F, 3)
    w = okm.to(torch.float32)
    C = cand_slots.shape[0]
    if idx is None:
        idx = pnp.draw_samples(generator, w, SIM3_ITERS, 3)      # (C, 300, 3)
    res = sim3solver.sim3_ransac(idx, Pc_loop, Pc_cur[None].expand(C, -1, -1), w, cam.fx,
                                 min_inliers=min_inliers, fix_scale=fix_scale)
    uv_cur = m.kf_uv[slot_cur]
    uv_loop = torch.gather(m.kf_uv[cand_slots], 1, midx[..., None].expand(-1, -1, 2))
    w_in = res.inliers.to(torch.float32) * w
    s2, R2, t2, n2, costs = optimize_sim3(res.s, res.R, res.t, Pc_cur, Pc_loop, uv_cur,
                                          uv_loop, w_in, cam, iters=10,
                                          fix_scale=fix_scale, curve=True)
    better = n2 > res.n_inliers
    s = torch.where(better, s2, res.s)
    R = torch.where(better[:, None, None], R2, res.R)
    t = torch.where(better[:, None], t2, res.t)
    n_in = torch.where(better, n2, res.n_inliers)
    packed = torch.cat([res.ok.to(s.dtype)[:, None], n_in.to(s.dtype)[:, None], s[:, None],
                        R.reshape(C, 9), t], dim=1)
    return (packed, costs) if curve else packed


def compute_sim3_for_loop(m: MapState, idx, slot_cur, slot_loop, cam, min_inliers=20,
                          fix_scale: bool = False, ext=None,
                          generator: torch.Generator | None = None):
    """The Sim3 between two keyframes (ComputeSim3): a `Sim3Result` whose
    (s, R, t) maps the loop keyframe's camera coordinates into the current
    keyframe's; `inliers` is None. fix_scale=True constrains the solve to
    SE3, required after VI init where the scale is observable. One candidate
    of `sim3_ransac_batch`; one host read."""
    dev = m.mp_pos.device
    row = sim3_ransac_batch(
        m, None if idx is None else idx[None], slot_cur,
        torch.as_tensor([int(slot_loop)], dtype=torch.int64, device=dev),
        torch.as_tensor([int(min_inliers)], device=dev), cam, ext=ext,
        fix_scale=fix_scale, generator=generator)[0]
    return sim3solver.Sim3Result(ok=row[0] > 0.5, s=row[2], R=row[3:12].reshape(3, 3),
                                 t=row[12:15], inliers=None, n_inliers=row[1].to(torch.int64))


def guided_search(m: MapState, slot_cur, slot_loop, group_slots, s_lc, R_lc, t_lc, cam,
                  ext=None):
    """The projection search of the guided verification: every active map
    point observed by the loop keyframe's covisibility GROUP goes through the
    candidate Sim3 into the current keyframe, and is matched there in an 8 px
    window (`matching.search_by_projection`, on the card the CUDA kernel).
    Returns (feature index (P,), distance (P,), ok (P,))."""
    slot_cur, slot_loop = int(slot_cur), int(slot_loop)
    mp = m.kf_mp[group_slots]                                    # (G, F)
    valid = (mp >= 0) & m.kf_feat_valid[group_slots] & m.kf_active[group_slots][:, None]
    sel = _set_drop(torch.zeros(m.P, dtype=torch.bool, device=mp.device),
                    torch.where(valid, mp, m.P).reshape(-1).to(torch.int64), True)
    sel = sel & m.mp_active
    # world -> loop CAMERA -> (Sim3, camera frames) -> current camera
    Xl = _mv(m.kf_ns.R[slot_loop].transpose(-1, -2), m.mp_pos - m.kf_ns.P[slot_loop])
    if ext is not None:
        Xl = _mv(ext.Rcb, Xl) + ext.tcb
    Xc = s_lc * _mv(R_lc, Xl) + t_lc
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    vis = sel & (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    dist = torch.linalg.norm(Xc, dim=-1)
    log_scale = float(np.log(np.float32(1.2)))
    lvl = torch.clamp(torch.round(torch.log(torch.clamp(m.mp_max_dist, min=1e-6)
                                            / torch.clamp(dist, min=1e-6)) / log_scale),
                      0, 7).to(torch.int32)
    return matching.search_by_projection(
        torch.stack([u, v], -1), vis, lvl, m.mp_desc, m.mp_pm1,
        m.kf_uv[slot_cur], m.kf_level[slot_cur], m.kf_desc[slot_cur], m.kf_pm1[slot_cur],
        m.kf_feat_valid[slot_cur], radius_px=8.0)


def guided_match_count(m: MapState, slot_cur, slot_loop, group_slots, s_lc, R_lc, t_lc,
                       cam, ext=None):
    """The guided-reprojection verification of a loop candidate (ComputeSim3's
    final gate): the number of group-wide matches of `guided_search`. A
    pairwise Sim3 between two aliased places can reach a high RANSAC
    consensus; the group's surrounding geometry will not re-project."""
    return torch.sum(guided_search(m, slot_cur, slot_loop, group_slots, s_lc, R_lc, t_lc,
                                   cam, ext=ext)[2])


def close_loop(m: MapState, kf_slots, slot_cur, slot_loop, sim3_lc, cam,
               fix_scale: bool = False, loop_edges=None, mesh=None, kf_ids=None,
               curve: bool = False):
    """Apply the loop correction: the Sim3 ESSENTIAL graph over the active
    keyframes (the sequential chain, every covisibility pair of weight >= 100,
    the current keyframe's >= 50 links, every PERSISTED earlier loop edge at
    weight 5, the new loop edge at weight 5), started from the loop correction
    propagated to the current keyframe's covisible group, optimized with the
    loop keyframe fixed; keyframe poses and velocities follow their vertex,
    map points follow the surviving keyframe nearest their creation time.

    sim3_lc: a Sim3Result mapping the loop keyframe's BODY frame into the
    current keyframe's (s, R, t tensors or numbers). loop_edges: [(slot_a,
    slot_b)] of earlier closures. mesh: a `parallel.dist_ba.Mesh`: the graph
    is solved edge-sharded over it (`dist_posegraph`). kf_ids: host {slot:
    frame id} (read from the device when not given). One host read (the
    covisibility matrix).
    Returns the new MapState (and the pose graph's cost curve when `curve`)."""
    slots = list(kf_slots)
    K = len(slots)
    idx_of = {s: i for i, s in enumerate(slots)}
    dtype, dev = m.mp_pos.dtype, m.mp_pos.device
    ks = torch.as_tensor(slots, dtype=torch.int64, device=dev)

    # vertices: world->keyframe (Scw) from the current body poses, s = 1
    Rwk, Pwk = m.kf_ns.R[ks], m.kf_ns.P[ks]
    R0 = Rwk.transpose(-1, -2)
    t0 = -_mv(R0, Pwk)
    s0 = torch.ones(K, dtype=dtype, device=dev)

    ei, ej, ew = [], [], []
    seen = {}

    def add_edge(a, b, w=1.0):
        if a == b:
            return
        key = (min(a, b), max(a, b))
        if key in seen:
            # one edge a pair, raised to the larger weight: a healed seam that
            # is also covisibility-connected stays one strong edge
            ew[seen[key]] = max(ew[seen[key]], w)
            return
        seen[key] = len(ei)
        ei.append(a)
        ej.append(b)
        ew.append(w)

    for a in range(K - 1):
        add_edge(a, a + 1)
    W = covisibility_matrix(m).cpu().numpy()
    for a, b in zip(*np.nonzero(np.triu(W, 1) >= 100)):
        if int(a) in idx_of and int(b) in idx_of:
            add_edge(idx_of[int(a)], idx_of[int(b)])
    for k in np.nonzero(W[slot_cur] >= 50)[0]:
        if int(k) in idx_of:
            add_edge(idx_of[int(k)], idx_of[slot_cur])
    # persisted loop edges: their measurement is the CURRENT relative Sim3, as
    # for every other edge; the persistence is topological
    for e in (loop_edges or []):
        a, b = e[0], e[1]
        if a in idx_of and b in idx_of and a != b:
            add_edge(idx_of[a], idx_of[b], w=5.0)
    i_loop, i_cur = idx_of[slot_loop], idx_of[slot_cur]
    n_edges = len(ei)
    # ONE host->device copy: edge ends, weights, the neighbour mask
    nb_mask = np.zeros(K, np.float32)
    nb_mask[i_cur] = 1.0
    for k in np.nonzero(W[slot_cur] >= 15)[0]:
        if int(k) in idx_of:
            nb_mask[idx_of[int(k)]] = 1.0
    free_np = np.ones(K, np.float32)
    free_np[i_loop] = 0.0                                   # the loop keyframe is the gauge
    n = max(n_edges + 1, K)
    pack = np.zeros((5, n), np.float32)
    pack[0, :n_edges], pack[1, :n_edges], pack[2, :n_edges] = ei, ej, ew
    pack[0, n_edges], pack[1, n_edges], pack[2, n_edges] = i_loop, i_cur, 5.0
    pack[3, :K], pack[4, :K] = nb_mask, free_np
    packed = torch.as_tensor(pack, device=dev)
    ei_a = packed[0, :n_edges + 1].to(torch.int64)
    ej_a = packed[1, :n_edges + 1].to(torch.int64)
    w = packed[2, :n_edges + 1].to(dtype)
    nbm, free = packed[3, :K] > 0, packed[4, :K].to(dtype)

    # edge measurements from the UNCORRECTED estimates; the loop edge
    # (i = loop, j = cur), the last row, carries the measured Sim3
    sm, Rm, tm = posegraph.edge_measurement(s0[ei_a], R0[ei_a], t0[ei_a],
                                            s0[ej_a], R0[ej_a], t0[ej_a])
    as_t = lambda x: torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x,
                                     dtype=dtype, device=dev)
    s_lc, R_lc, t_lc = as_t(sim3_lc.s), as_t(sim3_lc.R), as_t(sim3_lc.t)
    is_loop = torch.arange(n_edges + 1, device=dev) == n_edges
    sm = torch.where(is_loop, s_lc, sm)
    Rm = torch.where(is_loop[:, None, None], R_lc, Rm)
    tm = torch.where(is_loop[:, None], t_lc, tm)

    # PRE-PROPAGATE the correction to the current keyframe's covisible group
    # (CorrectLoop): the pose graph then starts near its optimum
    s_cur_c, R_cur_c, t_cur_c = lie.sim3_mul(s_lc, R_lc, t_lc,
                                             s0[i_loop], R0[i_loop], t0[i_loop])
    if fix_scale:
        s_cur_c = torch.ones_like(s_cur_c)
    rel = lie.sim3_mul(s0, R0, t0, *lie.sim3_inv(s0[i_cur], R0[i_cur], t0[i_cur]))
    s_corr, R_corr, t_corr = lie.sim3_mul(*rel, s_cur_c, R_cur_c, t_cur_c)
    g = posegraph.Sim3Graph(
        s=torch.where(nbm, s_corr, s0), R=torch.where(nbm[:, None, None], R_corr, R0),
        t=torch.where(nbm[:, None], t_corr, t0), ei=ei_a, ej=ej_a,
        s_m=sm, R_m=Rm, t_m=tm, w=w, free=free)
    if mesh is not None:
        # edge-sharded over the device mesh: each shard owns a range of edges,
        # one reduction of the 7K-dim normal equations per iteration
        R_new, s_new, t_new, _, costs = dist_ba.to_device(
            dist_posegraph.optimize_pose_graph_dist(mesh, g, iters=40, fix_scale=fix_scale,
                                                    curve=True), dev)
    else:
        R_new, s_new, t_new, _, costs = posegraph.optimize_pose_graph(
            g, iters=40, fix_scale=fix_scale, curve=True)

    # body poses back: R_wk = R_new^T, P = -1/s R^T t; velocities turn with
    # their keyframe's correction
    Rwk2 = R_new.transpose(-1, -2)
    Pwk2 = -_mv(Rwk2, t_new) / s_new[..., None]
    ns = m.kf_ns
    dR = Rwk2 @ Rwk.transpose(-1, -2)
    V2 = _mv(dR, ns.V[ks]) / s_new[..., None]
    ns = ns._replace(P=ns.P.index_copy(0, ks, Pwk2), R=ns.R.index_copy(0, ks, Rwk2),
                     V=ns.V.index_copy(0, ks, V2))

    # each map point moves with the surviving keyframe nearest its CREATION
    # time (frame-id space: slots are recycled)
    if kf_ids is None:
        ids = m.kf_id[ks].to(torch.int64)
    else:
        ids = torch.as_tensor([kf_ids[s] for s in slots], dtype=torch.int64, device=dev)
    tid = m.mp_first_kf.to(torch.int64)
    ids_sorted, order = torch.sort(ids, stable=True)
    pos = torch.clamp(torch.searchsorted(ids_sorted, tid), 0, K - 1)
    left = torch.clamp(pos - 1, 0, K - 1)
    use_left = torch.abs(ids_sorted[left] - tid) <= torch.abs(ids_sorted[pos] - tid)
    ref_local = order[torch.where(use_left, left, pos)]
    mp2 = posegraph.correct_map_points(m.mp_pos, ref_local, s0, R0, t0, s_new, R_new, t_new)
    mp2 = torch.where(m.mp_active[:, None], mp2, m.mp_pos)
    m = m._replace(kf_ns=ns, mp_pos=mp2)
    return (m, costs) if curve else m
