"""Lock-step runs of the port's `SlamSystem` and the JAX package's on EQUAL
feature tables: every frame the port's ORB extraction is replaced by the JAX
package's (converted, `torch_port_helpers.jax_features`), and both draw the
same two-view RANSAC samples (`jax_init_samples`). What is left to differ is
the code after the front end.

* The dot-world VI initialization of tests/test_torch_e2e.py (seeds 0 and 1,
  the experiment that settled ROADMAP F19): both packages start the map at
  the same frame from the same matches, samples, winning hypothesis and
  model; the winning fundamental matrix is the null vector of an 8 x 9
  float32 system conditioned at ~3e5 (pixel-scaled coordinates), which each
  library's float32 SVD solves to ~1e-4 (median over the 200 hypotheses, both
  packages, against float64), in other directions. So the two-view pose
  agrees to 1e-4 in rotation and 5e-3 in the unit baseline, the two-view
  point count to 3 points (a few points sit on the reprojection / parallax
  gates), and from there the runs part like two runs of one package on
  another BLAS (their keyframe decisions differ from frame 3 on): both
  initialize VI, each within the JAX test's gravity gate (cos > 0.995);
  measured on the CPU: gravity 2.01 / 3.99 degrees off the truth for the JAX
  package (seeds 0 / 1), 1.46 / 3.15 for the port.
* RGB-D on the dot world of tests/test_e2e_depth.py: no RANSAC at all, so
  every frame's tracked position must agree to 1e-3 m and the keyframe count
  must be the same after every frame.

Whole sequences through both packages: marked slow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.pipeline import system as jsystem
from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.pipeline.pipebase import OK
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem

import synth
from render import DotWorld
from torch_port_helpers import jax_features, jax_init_samples, jax_samples

torch.set_num_threads(2)
CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360, device="cpu")
JCAM = j_make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)


def _jax_system(monkeypatch, **cfg_kw):
    monkeypatch.setenv("MC_SLAM_PAIR", "1")
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "1")
    js = jsystem.SlamSystem(JCAM, jsystem.SlamConfig(**cfg_kw))
    js._summary_ready = lambda pend: True
    return js


def _vi_frames(seed):
    """tests/test_torch_e2e.py::test_vi_slam_initializes_and_tracks's frames
    with the world and the IMU noise drawn from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    world = DotWorld(rng)
    traj = synth.Trajectory("gentle", speed=1.0)
    bg_true = np.array([0.008, -0.012, 0.01], np.float32)
    ba_true = np.array([0.04, -0.03, 0.05], np.float32)
    out = []
    for i in range(95):
        t = i * 0.1
        P, R = traj.pose(t)
        imu = traj.imu_samples(max(0.0, t - 0.1), t, bg=bg_true, ba=ba_true, noise_g=1.7e-4,
                               noise_a=2e-3, rng=rng) if i > 0 else None
        out.append((t, world.render(R, P), imu))
    return out


def _angle_deg(a, b):
    c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _run(slam, frames, active):
    """Feed the frames; returns (first OK frame, map points then, n_kf per frame)."""
    init, n_init, n_kf = None, None, []
    for i, (t, img, imu) in enumerate(frames):
        slam.track(img, t, imu=imu)
        if init is None and slam.state == OK:
            init, n_init = i, active(slam)
        n_kf.append(slam.n_kf)
    return init, n_init, n_kf


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_vi_init_on_equal_feature_tables(monkeypatch, seed):
    from mc_slam_tpu.geometry import init2view as jinit
    from mc_slam_tpu_torch.geometry import init2view as tinit
    frames = _vi_frames(seed)
    kw = dict(max_kf=96, max_mp=2048, n_feat=384, n_levels=3, min_init_matches=50,
              use_imu=True, vi_init_time=5.5, kf_min_gap=2, local_window=8, g_mag=synth.G)
    calls = {}

    def spy(name, fn):
        def wrapped(sample_src, xn0, xn1, w, focal, *a, **k):
            res = fn(sample_src, xn0, xn1, w, focal, *a, **k)
            calls.setdefault(name, []).append(
                (sample_src, np.asarray(xn0), np.asarray(xn1), np.asarray(w), res))
            return res
        return wrapped

    monkeypatch.setattr(jinit, "initialize_two_view", spy("jax", jinit.initialize_two_view))
    monkeypatch.setattr(tinit, "initialize_two_view", spy("port", tinit.initialize_two_view))
    js = _jax_system(monkeypatch, **kw)
    j_init, j_pts, j_kf = _run(js, frames, lambda s: int(np.asarray(s.m.mp_active).sum()))
    slam = SlamSystem(CAM, SlamConfig(**kw), device="cpu")
    with jax_features(), jax_init_samples(seed=0):
        t_init, t_pts, t_kf = _run(slam, frames, lambda s: int(s.m.mp_active.sum()))
    gj, gt = np.asarray(js.gw), slam.gw.numpy()
    print(f"seed {seed}: two-view init at frame {j_init} / {t_init} with {j_pts} / {t_pts} "
          f"points; keyframes {j_kf[-1]} / {t_kf[-1]}; gravity off the truth "
          f"{_angle_deg(gj, synth.GW):.3f} / {_angle_deg(gt, synth.GW):.3f} degrees, "
          f"apart {_angle_deg(gj, gt):.3f}; first frame with another keyframe count "
          f"{next((i for i, (a, b) in enumerate(zip(j_kf, t_kf)) if a != b), None)}")
    # the same attempts on the same inputs
    assert t_init == j_init and len(calls["jax"]) == len(calls["port"])
    key, xj0, xj1, wj, rj = calls["jax"][-1]
    idx, xt0, xt1, wt, rt = calls["port"][-1]
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(xt0, xj0, atol=1e-6)
    np.testing.assert_allclose(xt1[wj > 0], xj1[wj > 0], atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), jax_samples(key, jnp.asarray(wj), 200, 8))
    assert bool(rt.ok) and bool(rj.ok) and bool(rt.used_h) == bool(rj.used_h)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=5e-3)
    assert abs(t_pts - j_pts) <= 3
    # then each run initializes VI within the gate of the JAX package's own test
    assert js.vi_inited and slam.vi_inited
    cos = lambda g: float(g @ synth.GW / (np.linalg.norm(g) * 9.81))
    assert cos(gj) > 0.995 and cos(gt) > 0.995


def _rgbd_pose(t):
    P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.05 * t], np.float32)
    R = lie.so3_exp(torch.tensor([0.0, 0.08 * np.sin(0.5 * t), 0.0])).numpy()
    return P, R.astype(np.float32)


@pytest.mark.slow
def test_rgbd_lockstep(monkeypatch, rng):
    world = DotWorld(rng)
    frames, depths = [], []
    for i in range(35):
        P, R = _rgbd_pose(i * 0.1)
        img, dep = world.render(R, P, with_depth=True)
        frames.append((i * 0.1, img, None))
        depths.append(dep)
    kw = dict(max_kf=64, max_mp=2048, n_feat=384, n_levels=3, cull_min_obs=2)
    js = _jax_system(monkeypatch, **kw)
    slam = SlamSystem(CAM, SlamConfig(**kw), device="cpu")
    j_pos, t_pos, j_kf, t_kf = [], [], [], []
    with jax_features():
        for (t, img, _), dep in zip(frames, depths):
            js.track(img, t, depth=dep)
            slam.track(img, t, depth=dep)
            j_pos.append(np.asarray(js.last_pose[0]))
            t_pos.append(slam.last_pose[0].numpy())
            j_kf.append(js.n_kf)
            t_kf.append(slam.n_kf)
    assert js.sensor_depth and slam.sensor_depth
    err = np.linalg.norm(np.asarray(j_pos) - np.asarray(t_pos), axis=1)
    print(f"RGB-D lock-step: {j_kf[-1]} keyframes, position difference max {err.max():.2e} m")
    assert t_kf == j_kf
    assert err.max() < 1e-3, err
