"""The port's copies of the numpy-only modules (`io/euroc.py`,
`io/trajectory.py`, `sim/euroc_writer.py`, `settings.py`) against the JAX
package's originals on the fixtures of tests/test_io.py and tests/test_aux.py:
a miniature ASL folder, a trajectory round trip, and a settings file in the
reference's OpenCV-YAML dialect. They are copies: results must be identical.
And the clone generator of tools/eval_clone.py against the same folder read
back."""
import argparse
import os

import numpy as np
import pytest
import torch

from mc_slam_tpu import settings as jsettings
from mc_slam_tpu.io import euroc as jeuroc, trajectory as jtrajectory
from mc_slam_tpu.sim.euroc_writer import EurocWriter as JEurocWriter
from mc_slam_tpu_torch import settings as tsettings
from mc_slam_tpu_torch.io import euroc as teuroc, trajectory as ttrajectory
from mc_slam_tpu_torch.pipeline.system import SlamConfig
from mc_slam_tpu_torch.sim.euroc_writer import EurocWriter
from mc_slam_tpu_torch.tools import eval_clone

from test_io import fake_euroc  # noqa: F401  (the fixture)

SETTINGS = """%YAML:1.0
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.2834
Camera.fps: 20
Camera.width: 752
Camera.height: 480
ORBextractor.nFeatures: 1000
ORBextractor.nLevels: 8
LocalMapping.LocalWindowSize: 20
test.VINSInitTime: 15.0
Camera.Tbc: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
"""


def test_euroc_reader_is_identical(fake_euroc):  # noqa: F811
    sj, st = jeuroc.load_sequence(fake_euroc), teuroc.load_sequence(fake_euroc)
    assert st.image_paths == sj.image_paths and len(st.image_paths) == 10
    np.testing.assert_array_equal(st.image_times, sj.image_times)
    np.testing.assert_array_equal(st.imu, sj.imu)
    fj, ft = list(jeuroc.slice_imu_per_frame(sj)), list(teuroc.slice_imu_per_frame(st))
    assert len(ft) == len(fj) == 10
    for (t0, p0, r0), (t1, p1, r1) in zip(fj, ft):
        assert t0 == t1 and p0 == p1
        np.testing.assert_array_equal(r1, r0)
        assert r1.dtype == np.float32 and r1.shape[1] == 7
    assert all(8 <= f[2].shape[0] <= 12 for f in ft[1:])
    np.testing.assert_array_equal(teuroc.load_gray_image(ft[3][1]),
                                  jeuroc.load_gray_image(fj[3][1]))


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def test_trajectory_writers_are_identical(tmp_path, rng):
    traj = [(float(i), rng.normal(size=3).astype(np.float32), _rot(rng)) for i in range(5)]
    for name in ("save_tum", "save_kitti"):
        a, b = tmp_path / f"j_{name}.txt", tmp_path / f"t_{name}.txt"
        getattr(jtrajectory, name)(str(a), traj)
        getattr(ttrajectory, name)(str(b), traj)
        assert a.read_text() == b.read_text() and len(a.read_text().splitlines()) == 5
    ts, Ps, qs = ttrajectory.load_tum(str(tmp_path / "t_save_tum.txt"))
    np.testing.assert_allclose(ts, np.arange(5))
    np.testing.assert_allclose(Ps, np.stack([t[1] for t in traj]), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(qs, axis=1), 1.0, atol=1e-5)
    for u, v in zip(jtrajectory.load_tum(str(tmp_path / "j_save_tum.txt")), (ts, Ps, qs)):
        np.testing.assert_array_equal(u, v)
    entries = [(float(i), rng.normal(size=3), _rot(rng), rng.normal(size=3),
                rng.normal(size=3), rng.normal(size=3)) for i in range(3)]
    a, b = tmp_path / "j_ns.txt", tmp_path / "t_ns.txt"
    jtrajectory.save_navstate(str(a), entries)
    ttrajectory.save_navstate(str(b), entries)
    assert a.read_text() == b.read_text()


def test_settings_loader_matches_and_builds_the_ports_camera(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text(SETTINGS)
    jcam, jkw, jT = jsettings.load_settings(str(p))
    cam, kw, Tbc = tsettings.load_settings(str(p), device="cpu")
    assert kw == jkw and kw["n_feat"] == 1000 and kw["local_window"] == 20
    assert kw["kf_max_gap"] == 20 and kw["vi_init_time"] == 15.0
    np.testing.assert_array_equal(Tbc, jT)
    assert Tbc.shape == (4, 4) and Tbc.dtype == np.float32
    for f in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"):
        assert isinstance(getattr(cam, f), torch.Tensor)
        assert float(getattr(cam, f)) == float(getattr(jcam, f)), f
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (752, 480)
    cfg = SlamConfig(use_imu=True, **kw)        # the keywords fit the port's config
    assert cfg.n_levels == 8
    # an empty file falls back to the EuRoC defaults, without a Tbc
    q = tmp_path / "empty.yaml"
    q.write_text("%YAML:1.0\n---\n")
    cam2, kw2, T2 = tsettings.load_settings(str(q), device="cpu")
    assert T2 is None and kw2 == jsettings.load_settings(str(q))[1]
    assert abs(float(cam2.fx) - 458.654) < 1e-4


def _write(writer_cls, root, rng):
    w = writer_cls(str(root))
    for i in range(3):
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        w.add_image(100.0 + 0.05 * i, img)
        w.add_gt(100.0 + 0.05 * i, rng.normal(size=3), _rot(rng), rng.normal(size=3),
                 np.array([0.003, -0.0045, 0.0035]), np.array([0.035, -0.02, 0.06]))
    for k in range(30):
        w.add_imu(100.0 + 0.005 * k, rng.normal(size=3), rng.normal(size=3))
    return w.finish()


def test_euroc_writer_is_identical_and_reads_back(tmp_path):
    gj = _write(JEurocWriter, tmp_path / "j", np.random.default_rng(5))
    gt = _write(EurocWriter, tmp_path / "t", np.random.default_rng(5))
    for rel in ("mav0/cam0/data.csv", "mav0/imu0/data.csv",
                "mav0/state_groundtruth_estimate0/data.csv"):
        assert (tmp_path / "j" / rel).read_text() == (tmp_path / "t" / rel).read_text(), rel
    assert os.path.relpath(gt, tmp_path / "t") == os.path.relpath(gj, tmp_path / "j")
    seq = teuroc.load_sequence(str(tmp_path / "t" / "mav0"))
    assert len(seq.image_paths) == 3 and seq.imu.shape == (30, 7)
    img = teuroc.load_gray_image(seq.image_paths[0])
    ref = jeuroc.load_gray_image(jeuroc.load_sequence(str(tmp_path / "j" / "mav0")).image_paths[0])
    np.testing.assert_array_equal(img, ref)
    assert img.shape == (48, 64)


def _clone_args(tmp_path, **kw):
    d = dict(dataset=str(tmp_path / "clone"), duration=0.2, fps=20.0, seed=0, tex_size=256,
             tex_scale=1.0, bg=[0.003, -0.0045, 0.0035], ba=[0.035, -0.02, 0.06], harden=True,
             blur_ms=12.0, laps=1, imu_noise_scale=1.0, yaw_scale=1.0, tex_contrast=1.0,
             weak_walls=[], weak_contrast=0.3)
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.mark.parametrize("harden", [True, False])
def test_clone_from_disk_equals_clone_in_memory(tmp_path, harden):
    """tools/eval_clone.py: the written ASL folder read back with io.euroc
    gives the frames, IMU rows and ground truth of the in-memory path."""
    args = _clone_args(tmp_path, harden=harden)
    eval_clone.write_clone(args, 4)
    disk, t_gt, P_gt = eval_clone.frames_from_disk(os.path.join(args.dataset, "mav0"), 0)
    mem, t_gt2, P_gt2 = eval_clone.frames_in_memory(args, 4)
    disk, mem = list(disk), list(mem)
    assert len(disk) == len(mem) == 4
    for (t0, i0, r0), (t1, i1, r1) in zip(disk, mem):
        assert abs(t0 - t1) < 1e-6 and i0.shape == (480, 752) and i0.dtype == np.uint8
        np.testing.assert_array_equal(i0, i1)
        assert r0.shape == r1.shape
        np.testing.assert_allclose(r0, r1, atol=2e-6)        # the CSV keeps 9 digits
    assert [f[2].shape[0] for f in mem[1:]] == [10, 10, 10]
    np.testing.assert_allclose(t_gt, t_gt2, atol=1e-6)
    np.testing.assert_allclose(P_gt, P_gt2, atol=1e-6)
    assert eval_clone.have_png_codec()


def test_clone_span_equals_whole_clone(tmp_path):
    """tools/eval_clone.py's run across calls: `frames_span` renders only the
    frames lo .. hi-1 of the whole clone and makes the others' draws all the
    same, so its frames, IMU rows and ground truth are those of the whole
    clone rendered in memory (the hardened profile: noise, flicker and
    occluders come from the generator). Four views rendered ahead, as on the
    card."""
    args = _clone_args(tmp_path, duration=0.3)
    whole, t_gt, P_gt = eval_clone.frames_in_memory(args, 6)
    whole = list(whole)
    span, t_gt2, P_gt2 = eval_clone.frames_span(args, 6, 2, 5, workers=4)
    span = list(span)
    assert len(span) == 3
    for (t0, i0, r0), (t1, i1, r1) in zip(whole[2:5], span):
        assert t0 == t1
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(t_gt, t_gt2)
    np.testing.assert_allclose(P_gt, P_gt2, atol=1e-12)


def test_eval_clone_seam_step_against_the_run_steps():
    """tools/eval_clone.py's score(): a jump planted at a seam stands out of
    the run's one-frame error steps away from the seams (its median, 99th
    percentile and max come from the same aligned error array)."""
    n, seam = 200, 120
    t = np.arange(n) * 0.05
    P_gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], 1)
    P_est = P_gt + np.random.default_rng(0).normal(scale=1e-4, size=P_gt.shape)
    P_est[seam:] += [0.01, 0.0, 0.0]
    traj = [(t[i], P_est[i], np.eye(3)) for i in range(n)]
    calls = [{"frames": [0, seam]}, {"frames": [seam, n]}]
    _, _, seams = eval_clone.score(traj, t, P_gt, calls, [])
    sm, = seams
    assert sm["frame"] == seam and sm["frame_steps"] == n - 2
    assert sm["step_m"] > 5 * sm["frame_step_p99_m"] and sm["frame_steps_at_least"] == 0
    assert sm["frame_step_median_m"] <= sm["frame_step_p99_m"] <= sm["frame_step_max_m"]
