"""The plain VI reference (`benchmark/reference/vi.py`, `vi_frame.py`)
against the port on the CPU: preintegration on seeded random rows, the joint
pose solve with its marginal on a synthetic problem with outliers, and the
whole VI frame (`pipeline/tracking._vi_frame_body`) on a tiny seeded world,
once with the visual fallback forced. Both sides compute in float32 with
different operation orders, so every tolerance is a rounding bound, each
given with its reason."""
import copy
import math

import numpy as np
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.reference import orb, track, vi
from benchmark.reference.vi_frame import vi_frame
from benchmark.runners import slam
from benchmark.runners.multiseq import World, intrinsics
from benchmark.sim.trajectory import TBC
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise, predict_navstate, preintegrate
from mc_slam_tpu_torch.pipeline import tracking, tracking_ctl
from mc_slam_tpu_torch.slam_map.mapstate import empty_map
from mc_slam_tpu_torch.solver import ba_vi, factors

torch.set_num_threads(2)
CPU = torch.device("cpu")
NOISE = euroc_noise(device="cpu")
SIGMAS = (float(NOISE.sigma_g), float(NOISE.sigma_a))
BG, BA = (0.003, -0.0045, 0.0035), (0.035, -0.02, 0.06)
GW = torch.tensor([0.0, 0.0, -9.81])


def close(a, b, atol, rtol=0.0):
    return torch.allclose(a.to(torch.float64), b.to(torch.float64), atol=atol, rtol=rtol)


def test_preintegration_matches_the_port():
    """20 rows of +-0.5 rad/s and 1 m/s^2 about gravity at 4-6 ms. The deltas
    agree to float32 rounding over 20 updates (1e-6 relative); the bias
    Jacobians and the covariance to 1e-4 relative: the port evaluates the
    right Jacobian's (1 - cos t) / t^2 in closed form at t ~ 3e-3 rad, where
    float32 cancellation leaves ~1e-2 relative error in that coefficient (a
    ~1e-5 term of the Jacobian), the reference by its Taylor series."""
    g = torch.Generator().manual_seed(11)
    T = 20
    rows = torch.cat([0.5 * torch.randn((T, 3), generator=g),
                      torch.tensor([0.0, 0.0, 9.81]) + torch.randn((T, 3), generator=g),
                      0.004 + 0.002 * torch.rand((T, 1), generator=g)], 1)
    bg = 0.01 * torch.randn(3, generator=g)
    ba = 0.1 * torch.randn(3, generator=g)
    port = preintegrate(rows, bg, ba, NOISE)
    ref = vi.preintegrate(rows, bg, ba, SIGMAS)
    for k in ("dP", "dV", "dR", "dT"):
        assert close(getattr(port, k), ref[k], atol=1e-7, rtol=1e-6), k
    for k in ("J_P_bg", "J_P_ba", "J_V_bg", "J_V_ba", "J_R_bg", "cov"):
        a, b = getattr(port, k), ref[k]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k


def _state(P, V, R, dbg=(0.0, 0.0, 0.0), dba=(0.0, 0.0, 0.0)):
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return NavState(P=f(P), V=f(V), R=f(R), bg=f(BG), ba=f(BA), dbg=f(dbg), dba=f(dba))


def _world_states(traj, t0, t1, g, perturb):
    """The true states at t0 and t1 and the IMU rows between them."""
    per = int(round((t1 - t0) * 200))
    rows = traj.imu(t0, per, bg=BG, ba=BA, noise_scale=1.0, gen=g, device=CPU)
    t = torch.tensor([t0, t1], dtype=torch.float64)
    P, R = traj.pose(t)
    e = 1e-4
    V = (traj.pose(t + e)[0] - traj.pose(t - e)[0]) / (2 * e)
    last = _state(P[0] + perturb, V[0], R[0])
    return last, (P[1], V[1], R[1]), rows


def test_the_pose_solve_matches_the_port_with_its_marginal():
    """A VI frame's joint solve on a synthetic problem: 300 points 2-8 m in
    front of the true current camera, seen with 0.5 px noise, 20 % of them
    replaced by uniform outliers, from a prediction 5 cm off. Both sides take
    the same preintegration and informations. Positions agree to 1e-5 m,
    rotations to 1e-5 rad, velocities to 1e-4 m/s, delta biases to 1e-6 and
    the marginal to 1e-3 relative (Frobenius): float32 normal equations of
    condition ~1e7 leave ~1e-5 relative in each LM step, and the 20
    accept / refuse decisions compare costs that differ by rounding near
    the optimum; the inlier sets are equal (no chi2 within 1e-3 of the gate
    here)."""
    from benchmark.sim.trajectory import Trajectory
    g = torch.Generator().manual_seed(12)
    traj = Trajectory(duration=144.0)
    last, (Pt, Vt, Rt), rows = _world_states(traj, 10.0, 10.05, g,
                                             torch.tensor([0.01, -0.01, 0.005]))
    c = mf.resolve_cell(mf.load_manifest(), "mono-vi.stream")["config"]["camera"]
    rig = track.Rig(intrinsics(c), c["width"], c["height"], TBC, CPU)
    cam = make_camera(*intrinsics(c)[:4], width=c["width"], height=c["height"], device="cpu")
    ext = factors.extrinsics_from_Tbc(TBC, device="cpu")
    O = 300
    Rwc = Rt.to(torch.float32) @ rig.Rcb.T
    Cw = Pt.to(torch.float32) - Rwc @ rig.tcb
    uv0 = torch.rand((O, 2), generator=g) * torch.tensor([c["width"], c["height"]])
    z = 2.0 + 6.0 * torch.rand(O, generator=g)
    xc = torch.stack([(uv0[:, 0] - rig.cx) / rig.fx * z, (uv0[:, 1] - rig.cy) / rig.fy * z, z], 1)
    pts = (Rwc @ xc.T).T + Cw
    uv = uv0 + 0.5 * torch.randn((O, 2), generator=g)
    out = torch.rand(O, generator=g) < 0.2
    uv[out] = torch.rand((int(out.sum()), 2), generator=g) * torch.tensor([c["width"],
                                                                           c["height"]])
    info = 1.0 / 1.2 ** (2.0 * torch.randint(0, 4, (O,), generator=g).to(torch.float32))
    valid = (torch.rand(O, generator=g) < 0.95).to(torch.float32)
    pre = preintegrate(rows, last.bg_full, last.ba_full, NOISE)
    cur0 = predict_navstate(last, pre, GW)
    cur0 = cur0._replace(P=cur0.P + torch.tensor([0.05, 0.0, -0.02]))
    info_prv = factors.imu_prv_info(pre)
    info_bias = factors.bias_rw_info(pre.dT, float(NOISE.sigma_bg), float(NOISE.sigma_ba))
    prior = ba_vi.PriorFactor(cam=torch.zeros((), dtype=torch.int64), ns0=last,
                              info=torch.as_tensor(tracking_ctl.fresh_prior_info(1e3)),
                              valid=torch.ones(()))
    obs = tracking.VisualObs(cam=torch.zeros(O, dtype=torch.int64), pt=torch.arange(O),
                             uv=uv, inv_sigma2=info, valid=valid)
    ns, chi2, n_in, Hm = ba_vi.pose_only_vi(cur0, last, pre, pts, obs, cam, ext, GW, prior,
                                            info_prv, info_bias, iters=20, compute_marg=True)
    pre_d = {k: getattr(pre, k) for k in pre._fields}
    s, chi2_r, n_r, Hm_r = vi.pose_only_vi(
        slam.state_dict(cur0), slam.state_dict(last), pre_d, pts, uv, info, valid, GW,
        slam.state_dict(last), prior.info, info_prv, info_bias, rig, iters=20, marginal=True)
    assert float((ns.P - Pt).norm()) < 0.02               # the solve found the truth
    assert close(ns.P, s["P"], 1e-5) and close(ns.R, s["R"], 1e-5)
    assert close(ns.V, s["V"], 1e-4)
    assert close(ns.dbg, s["dbg"], 1e-6) and close(ns.dba, s["dba"], 1e-6)
    assert int(n_in) == n_r and 0.5 * O < n_r < 0.85 * O
    assert torch.equal(chi2 <= 5.991, chi2_r <= 5.991)
    assert float((Hm - Hm_r).norm() / Hm_r.norm()) < 1e-3


def _tiny_frames():
    """A tiny seeded world (480x360, 512 features, 4 levels) with a map of
    the features of 5 frames around frame 200 lifted by their rendered depth,
    as the port's MapState and the reference's points."""
    spec = copy.deepcopy(mf.resolve_cell(mf.load_manifest(), "mono-vi.stream"))
    cfg = spec["config"]
    c = cfg["camera"]
    sx, sy = 480 / c["width"], 360 / c["height"]
    c.update(fx=c["fx"] * sx, fy=c["fy"] * sy, cx=c["cx"] * sx, cy=c["cy"] * sy,
             width=480, height=360)
    cfg["world"].update(tex_size=512)
    world = World(cfg, spec["traffic"], 2 ** 31 + 19, CPU)
    rig = track.Rig(intrinsics(c), c["width"], c["height"], TBC, CPU)
    kf = [190, 195, 200, 205, 210]
    img, dep = world.render(0, kf)
    f = orb.extract(img, 512, 4)
    xs = f["xy"][..., 0].to(torch.int64).clamp(0, c["width"] - 1)
    ys = f["xy"][..., 1].to(torch.int64).clamp(0, c["height"] - 1)
    d = torch.gather(dep.flatten(1), 1, ys * c["width"] + xs)
    P, R = world.trajs[0].pose(world.times(kf))
    P, R = P.to(torch.float32), R.to(torch.float32)
    uv = rig.undistort(f["xy"])
    xn = torch.stack([(uv[..., 0] - rig.cx) / rig.fx, (uv[..., 1] - rig.cy) / rig.fy], -1)
    Xc = torch.cat([xn * d[..., None], d[..., None]], -1)
    Xb = track.mv(rig.Rcb.T, Xc - rig.tcb)
    Xw = (track.mv(R[:, None], Xb) + P[:, None]).reshape(-1, 3)
    dist = torch.linalg.norm(Xw - P.repeat_interleave(512, 0), dim=-1)
    good = (f["valid"] & (d > 1e-3)).reshape(-1)
    n = int(good.sum())
    pad = lambda x: torch.cat([x[good], x.new_zeros((2048 - n,) + x.shape[1:])])
    max_d = dist * 1.2 ** f["level"].reshape(-1).to(torch.float32)
    ray = Xw - P.repeat_interleave(512, 0)
    m = empty_map(8, 2048, 512, device="cpu")
    m = m._replace(mp_pos=pad(Xw), mp_desc=pad(f["desc"].reshape(-1, 8)),
                   mp_pm1=pad(f["pm1"].reshape(-1, 256)),
                   mp_normal=pad(ray / ray.norm(dim=-1, keepdim=True)),
                   mp_max_dist=pad(max_d), mp_min_dist=pad(max_d / 1.2 ** 7),
                   mp_angle=pad(f["angle"].reshape(-1)), mp_active=pad(good))
    cam = make_camera(*intrinsics(c)[:4], k1=c["k1"], k2=c["k2"], p1=c["p1"], p2=c["p2"],
                      k3=c["k3"], width=480, height=360, device="cpu")
    return world, m, cam, rig


@pytest.fixture(scope="module")
def tiny():
    return _tiny_frames()


def _frame(tiny, k, last, prior_info, pfm, pan, g, fb_min_inliers=20):
    """Frame k through the port's VI frame behind the runner's recorder and
    through the reference; returns (port's answer, reference's, recorded call)."""
    world, m, cam, rig = tiny
    ext = factors.extrinsics_from_Tbc(TBC, device="cpu")
    t0, t1 = (k - 1) / 20, k / 20
    rows = world.trajs[0].imu(t0, 10, bg=BG, ba=BA, noise_scale=1.0, gen=g, device=CPU)
    img = world.render(0, [k])[0][0]
    prior = ba_vi.PriorFactor(cam=torch.zeros((), dtype=torch.int64), ns0=last,
                              info=prior_info, valid=torch.ones(()))
    rec = slam.Recorder(tracking._vi_frame_body)
    rec.on = True
    fresh = torch.as_tensor(tracking_ctl.fresh_prior_info(1e2))
    rec(m, img, rows, cam, ext, NOISE, last, GW, prior, pfm, pan, 0, 0.05, fresh,
        float(NOISE.sigma_bg), float(NOISE.sigma_ba), 512, 4, 20, 0.0, fb_min_inliers)
    x, out = rec.calls[0]
    ref = vi_frame(slam.reference_inputs(x), x["mp"], rig, 512, 4, iters=20,
                   fb_min_inliers=fb_min_inliers)
    return slam.program_answer(out), ref, out


def _assert_same(a, r):
    """The same associations and inlier count, and positions within 0.05 mm,
    rotations within 5e-4 deg, velocities within 1 mm/s, biases within
    0.05 mrad/s and 0.05 mm/s^2, the prior within 1e-3 relative: ten times
    the largest gaps these frames read (4.6e-3 mm, 6.9e-5 deg, 1.0e-2 mm/s,
    3.6e-3 mrad/s, 5.2e-5 mm/s^2, 1.8e-6), which are float32 rounding carried
    through the solves. The two sides extract the same features (the
    reference ORB equals the port's extractor to the bit on these frames)."""
    gaps = slam.frame_gaps(a, r)
    assert gaps[0] < 0.05 and gaps[1] < 5e-4 and gaps[2] < 1.0, gaps
    assert gaps[3] < 0.05 and gaps[4] < 0.05 and gaps[5] < 1e-3, gaps
    assert gaps[6] == 0 and not gaps[8], gaps
    assert a["fallback"] == r["fallback"]


def test_two_chained_vi_frames_match_the_port(tiny):
    """Frame 199 from the true state 2 cm off with a fresh prior and no last
    associations, then frame 200 chained on the port's answer (its prior,
    associations and keypoint angles, so the rotation prune runs)."""
    world = tiny[0]
    g = torch.Generator().manual_seed(13)
    last, _, _ = _world_states(world.trajs[0], 198 / 20, 199 / 20, g,
                               torch.tensor([0.02, 0.0, 0.0]))
    fresh = torch.as_tensor(tracking_ctl.fresh_prior_info(1e3))
    a, r, out = _frame(tiny, 199, last, fresh, None, None, g)
    _assert_same(a, r)
    assert not a["fallback"] and a["n_inliers"] > 100
    feats, _, ns, fmp, Hp = out[:5]
    a2, r2, _ = _frame(tiny, 200, ns, Hp, fmp, feats.angle, g)
    _assert_same(a2, r2)
    assert not a2["fallback"] and a2["n_inliers"] > 100
    P, _ = world.trajs[0].pose(torch.tensor([10.0], dtype=torch.float64))
    assert float((a2["state"]["P"] - P[0]).norm()) < 0.05


def test_the_forced_fallback_matches_the_port(tiny):
    """Frame 200 from a last state whose velocity is 4 m/s off (the IMU
    prediction lands 20 cm from the truth) and with the fallback made to run
    (an inlier floor no frame reaches): the visual answer from the last pose
    has more inliers and is taken on both sides, with its velocity, the last
    biases and the fresh prior's information."""
    world = tiny[0]
    g = torch.Generator().manual_seed(14)
    last, _, _ = _world_states(world.trajs[0], 199 / 20, 200 / 20, g, torch.zeros(3))
    last = last._replace(V=last.V + torch.tensor([4.0, 0.0, 0.0]))
    fresh = torch.as_tensor(tracking_ctl.fresh_prior_info(1e3))
    a, r, _ = _frame(tiny, 200, last, fresh, None, None, g, fb_min_inliers=10 ** 6)
    assert a["fallback"] and r["fallback"]
    _assert_same(a, r)
    assert torch.equal(a["H_prior"], r["H_prior"])
    assert math.isfinite(float(a["state"]["V"].norm()))
    assert np.isclose(float(r["state"]["dbg"].norm()), float(last.dbg.norm()))
