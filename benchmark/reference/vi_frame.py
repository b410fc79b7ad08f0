"""Plain statement of one monocular VI frame: the benchmark's reference for
the port's `pipeline/tracking._vi_frame_body` (TrackWithIMU and
TrackLocalMapWithIMU, src/Tracking.cpp:224-412, as the port states them).

From the frame's inputs (its image, the IMU rows since the last frame, the
last frame's state, gravity, the prior on the last state, the last frame's
associations and keypoint angles, the frame period) and the map's points:

1. ORB (`orb.extract`) and undistortion (`track.Rig.undistort`);
2. the rows preintegrated at the last state's full biases and the IMU
   prediction of the current state (`vi.preintegrate`, `vi.predict`);
3. the projection search at 15 px around the prediction, then the joint
   (last, current) solve (`vi.pose_only_vi`);
4. the search at 4 px around that solution, then the joint solve again,
   with the current state's marginal; the prior handed on is its symmetric
   part plus 1e-3 on the diagonal;
5. the bias-jump rule: a gyro delta bias that moved by more than 0.05 or
   an accelerometer delta bias by more than 0.5 since the last frame;
6. below 20 inliers, or on a bias jump, the visual fallback from the last
   pose (search at 40 px, pose LM, search at 4 px, pose LM:
   `track.solve_pose`). Its answer is taken where it has more inliers or
   the biases jumped: its pose, the velocity of the position change over
   the frame period, the last biases, and the fresh prior's information.

A search projects every active map point at the pose (`track.visible_points`),
matches it to the frame feature of least Hamming distance inside a square
window whose level is within one of the predicted level (distance <= 100,
< 0.9 x the second best), keeps one map point per feature (the least
distance, then the lowest point index), then prunes by rotation. An
association is an inlier where its chi2 is within the mono gate after the
solve.

Departures from the reference system, each the port's: the rotation prune
is the port's histogram (30 bins of the angle between a map point's angle
in the last frame and its match's, kept: the 3 fullest bins, and more down
the ranking until 90 % of the votes are covered, each with at least a
tenth of the fullest; applied only where the 3 fullest hold half the votes,
and only to map points the last frame saw); the search takes every active
map point, not the local map's; the joint solve runs 20 iterations and the
visual LM 20 a round. It imports nothing of the port.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import orb, track, vi
from benchmark.reference.track import BIG, CHI2_MONO, RATIO, TH_HIGH

BINS = 30


def rotation_prune(ok, idx, point_angle, feat_angle, seen):
    """ok (Np,) after dropping the map points whose angle change to their
    feature idx (Np,) falls outside the histogram's kept bins."""
    d = torch.remainder(point_angle - feat_angle[idx], 2.0 * math.pi)
    bins = torch.clamp((d * (BINS / (2.0 * math.pi))).to(torch.int64), 0, BINS - 1)
    votes = ok & seen
    hist = torch.zeros(BINS, dtype=torch.int32, device=ok.device).scatter_add(
        0, bins, votes.to(torch.int32))
    n = torch.clamp(hist.sum(), min=1)
    order = torch.argsort(-hist, stable=True)
    top = hist[order]
    run = torch.cumsum(top, 0)
    kept = (torch.cat([run.new_zeros(1), run[:-1]]) < 0.9 * n) \
        | (torch.arange(BINS, device=ok.device) < 3)
    kept = kept & (top.to(torch.float32) >= 0.1 * top[0].to(torch.float32)) & (top > 0)
    keep_bin = torch.zeros(BINS, dtype=torch.bool, device=ok.device)
    keep_bin[order] = kept
    applies = run[2].to(torch.float32) >= 0.5 * n.to(torch.float32)
    return ok & (keep_bin[bins] | ~applies | ~seen)


def last_angles(n_points, prev_feat_mp, prev_angle):
    """The last frame's keypoint angles on its map points' slots, and which
    slots it saw."""
    dev = prev_angle.device
    hit = prev_feat_mp >= 0
    slots = prev_feat_mp[hit].to(torch.int64)
    angle = torch.zeros(n_points, dtype=prev_angle.dtype, device=dev)
    angle[slots] = prev_angle[hit]
    seen = torch.zeros(n_points, dtype=torch.bool, device=dev)
    seen[slots] = True
    return angle, seen


def search(mp, f, uv, rig, P, R, radius, angles=None):
    """Projection search at body pose (P, R): (feature -> map point or -1)."""
    proj, vis, lvl = track.visible_points(mp, rig, P, R)
    dot = mp["pm1"].to(torch.float32) @ f["pm1"].to(torch.float32).T
    dist = torch.div(256 - dot.to(torch.int32), 2, rounding_mode="floor")
    gate = (torch.abs(proj[:, None, 0] - uv[None, :, 0]) < radius) \
        & (torch.abs(proj[:, None, 1] - uv[None, :, 1]) < radius) \
        & (torch.abs(lvl[:, None] - f["level"][None, :]) <= 1) \
        & vis[:, None] & f["valid"][None, :]
    d = torch.where(gate, dist, BIG)
    best, idx = torch.min(d, dim=-1)
    second = torch.amin(d.scatter(-1, idx[:, None], BIG), dim=-1)
    ok = (best <= TH_HIGH) & (best.to(torch.float32) < RATIO * second.to(torch.float32))
    rows = torch.arange(best.shape[0], device=best.device)
    key = torch.where(ok, best.to(torch.int64) * (1 << 32) + rows, 2 ** 62)
    win = torch.full((uv.shape[0],), 2 ** 62, dtype=torch.int64, device=best.device)
    win = win.scatter_reduce(0, idx, key, reduce="amin")
    ok = ok & (win[idx] == key)
    if angles is not None:
        ok = rotation_prune(ok, idx, angles[0], f["angle"], angles[1])
    feat_mp = torch.full((uv.shape[0],), -1, dtype=torch.int64, device=best.device)
    feat_mp[idx[ok]] = rows[ok]
    return feat_mp


def visual(f, uv, info, mp, rig, P, R, angles, iters):
    """The visual fallback from pose (P, R): (P, R, feat_mp of the inliers,
    n_inliers)."""
    for radius in (40.0, 4.0):
        fmp = search(mp, f, uv, rig, P, R, radius, angles)
        matched = fmp >= 0
        P, R, chi2, z = track.solve_pose(P, R, mp["pos"][fmp.clamp(min=0)], uv, info,
                                         matched.to(torch.float32), rig, iters)
    inlier = matched & (chi2 <= CHI2_MONO)
    return P, R, torch.where(inlier, fmp, -1), int((inlier & (z > 0)).sum())


def vi_frame(x, mp, rig, n_features, n_levels, iters=20, fb_min_inliers=20):
    """One VI frame from its inputs `x`: img (H, W) uint8, rows (T, 7), last
    (state dict), gw (3,), prior_s0 (state dict) and prior_info (15, 15),
    prev_feat_mp (F,) and prev_angle (F,) or None, dt (s), fresh_info
    (15, 15), noise (sigma_g, sigma_a), sigma_bg, sigma_ba; mp: the map's
    points (pos, pm1, active, min_dist, max_dist, normal).
    Returns a dict: state, feat_mp (F,), H_prior (15, 15), n_inliers, fallback."""
    f = orb.extract(x["img"], n_features, n_levels)
    uv = rig.undistort(f["xy"])
    info = 1.0 / (1.2 ** (2.0 * f["level"].to(torch.float32)))
    last, gw = x["last"], x["gw"]
    pre = vi.preintegrate(x["rows"], last["bg"] + last["dbg"], last["ba"] + last["dba"],
                          x["noise"])
    cur = vi.predict(last, pre, gw)
    prv_inf = vi.prv_info(pre)
    bias_inf = vi.bias_info(pre["dT"], x["sigma_bg"], x["sigma_ba"])
    angles = None
    if x["prev_feat_mp"] is not None:
        angles = last_angles(mp["pos"].shape[0], x["prev_feat_mp"], x["prev_angle"])
    for radius, marginal in ((15.0, False), (4.0, True)):
        fmp = search(mp, f, uv, rig, cur["P"], cur["R"], radius, angles)
        matched = fmp >= 0
        cur, chi2, n_in, Hm = vi.pose_only_vi(
            cur, last, pre, mp["pos"][fmp.clamp(min=0)], uv, info, matched.to(torch.float32),
            gw, x["prior_s0"], x["prior_info"], prv_inf, bias_inf, rig, iters, marginal)
    eye = torch.eye(15, dtype=Hm.dtype, device=Hm.device)
    out = dict(state=cur, feat_mp=torch.where(matched & (chi2 <= CHI2_MONO), fmp, -1),
               H_prior=0.5 * (Hm + Hm.T) + 1e-3 * eye, n_inliers=n_in, fallback=False)
    jump = bool((torch.amax(torch.abs(cur["dbg"] - last["dbg"])) > 0.05)
                | (torch.amax(torch.abs(cur["dba"] - last["dba"])) > 0.5))
    if n_in < fb_min_inliers or jump:
        P, R, fmp_v, n_v = visual(f, uv, info, mp, rig, last["P"], last["R"], angles, iters)
        if n_v > n_in or jump:
            V = (P - last["P"]) / max(float(x["dt"]), 1e-3)
            out = dict(state=dict(last, P=P, R=R, V=V), feat_mp=fmp_v,
                       H_prior=x["fresh_info"], n_inliers=n_v, fallback=True)
    return out
