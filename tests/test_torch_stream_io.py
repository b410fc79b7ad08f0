"""The port's host I/O against the JAX package's oracles: the streaming
surface (io/stream.py: back-pressure, IMU carried across drops, the IMU rows
cut at max_imu_rows counted), the native C++ loader's bindings
(io/native_loader.py) against the pure-Python reader, the runners of
mc_slam_tpu_torch/tools (run_euroc, run_mono, train_vocab) on a miniature
ASL folder, and the headless snapshots (viz/snapshot.py; tests/test_viz.py's
cases on a port map, and the covisibility edges against the JAX function)."""
import os

import numpy as np
import pytest
import torch

from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.io import euroc, native_loader
from mc_slam_tpu_torch.io.stream import StreamDriver
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fake_euroc(tmp_path_factory):
    """A miniature ASL folder with PIL-encoded PNGs (tests/test_io.py's)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("euroc") / "mav0"
    (root / "cam0" / "data").mkdir(parents=True)
    (root / "imu0").mkdir(parents=True)
    rng = np.random.default_rng(0)
    t0 = 1403636579763555584
    with open(root / "cam0" / "data.csv", "w") as f:
        f.write("#ts,filename\n")
        for i in range(10):
            ns = t0 + int(i * 0.05 * 1e9)
            img = rng.integers(0, 255, (480, 752), dtype=np.uint8)
            Image.fromarray(img, "L").save(root / "cam0" / "data" / f"{ns}.png")
            f.write(f"{ns},{ns}.png\n")
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#ts,wx,wy,wz,ax,ay,az\n")
        for i in range(100):
            ns = t0 + int(i * 0.005 * 1e9)
            v = rng.normal(size=6)
            f.write(f"{ns}," + ",".join(f"{x:.6f}" for x in v) + "\n")
    return str(root)


def _recording_driver(max_imu_per_kf=256):
    cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360, device="cpu")
    slam = SlamSystem(cam, SlamConfig(max_kf=16, max_mp=512, n_feat=64, n_levels=2,
                                      use_imu=True, max_imu_per_kf=max_imu_per_kf),
                      device="cpu")
    drv = StreamDriver(slam)
    seen = []
    slam.track = lambda img, t, imu=None, **k: seen.append((t, 0 if imu is None else len(imu)))
    return slam, drv, seen


def test_stream_driver_backpressure_and_imu_carry(rng):
    """tests/test_io.py's oracle: frames are dropped while the system is busy
    and their IMU rows are carried into the next processed frame. The port
    is synchronous: a frame is in flight exactly while `track` runs, so a
    source that delivers from inside it (another thread, here re-entrant) is
    dropped."""
    slam, drv, seen = _recording_driver()
    imu1 = np.zeros((5, 7), np.float32)
    img = rng.uniform(0, 255, (360, 480)).astype(np.float32)
    assert drv.on_frame(0.0, img, imu=None)
    drv.in_flight = 1                       # a frame inside track()
    assert not drv.accepting()
    assert not drv.on_frame(0.05, img, imu=imu1)
    assert not drv.on_frame(0.10, img, imu=imu1)
    assert drv.n_dropped == 2
    drv.in_flight = 0                       # track() returned
    assert drv.on_frame(0.15, img, imu=imu1)
    assert seen[-1] == (0.15, 15)
    assert drv.n_processed == 2
    # a delivery from inside track() is dropped, its rows kept for the next
    inner = []
    track = slam.track
    slam.track = lambda img_, t, imu=None: (inner.append(drv.on_frame(t + 0.01, img, imu1)),
                                            track(img_, t, imu))
    assert drv.on_frame(0.20, img, imu=imu1) and inner == [False]
    slam.track = track
    assert drv.on_frame(0.25, img, imu=imu1) and seen[-1] == (0.25, 10)
    assert drv.n_dropped == 3 and drv.n_imu_cut == 0
    drv.finish()


def test_stream_driver_counts_cut_imu_rows(rng):
    """F7: the rows a frame carries beyond the system's cfg.max_imu_per_kf
    are cut (the newest kept, as the JAX frame programs cut) and counted in
    n_imu_cut; a budget of one lets a second frame wait behind the one in
    flight."""
    slam, drv, seen = _recording_driver(max_imu_per_kf=8)
    img = np.zeros((360, 480), np.float32)
    rows = np.arange(5 * 7, dtype=np.float32).reshape(5, 7)
    drv.in_flight = 1
    assert not drv.on_frame(0.0, img, imu=rows)
    assert not drv.on_frame(0.05, img, imu=rows + 100)
    drv.in_flight = 0
    got = []
    slam.track = lambda img_, t, imu=None: got.append(imu)
    assert drv.on_frame(0.10, img, imu=rows + 200)
    assert drv.n_imu_cut == 15 - 8 and got[-1].shape == (8, 7)
    np.testing.assert_array_equal(got[-1][-5:], rows + 200)
    drv2 = StreamDriver(slam, budget=1)
    drv2.in_flight = 1
    assert drv2.accepting()
    drv2.in_flight = 2
    assert not drv2.accepting()


def test_native_loader_parity(fake_euroc):
    """tests/test_io.py's oracle: the native loader (the repo's
    native/libeuroc_loader.so through the port's bindings) against io.euroc:
    times, bit-exact PNG decode, IMU slices."""
    if not native_loader.available():
        pytest.skip("native/libeuroc_loader.so is not built (make -C native)")
    L = native_loader.NativeEurocLoader(fake_euroc)
    seq = euroc.load_sequence(fake_euroc)
    py = list(euroc.slice_imu_per_frame(seq))
    n = 0
    for (t, img, imu), (tp, path, imup) in zip(L, py):
        assert abs(t - tp) < 1e-9
        np.testing.assert_array_equal(img, euroc.load_gray_image(path))
        assert img.dtype == np.uint8
        assert imu.shape[0] == imup.shape[0]
        if imu.shape[0]:
            np.testing.assert_allclose(imu[:, :6], imup[:, :6], atol=1e-6)
        n += 1
    assert n == 10


def test_run_euroc_driver(fake_euroc, tmp_path):
    """tools/run_euroc.py on the miniature folder (5 frames, the small
    profile, on the CPU): it tracks, writes the three trajectory files and
    reports what it did."""
    from mc_slam_tpu_torch.tools import run_euroc
    out = tmp_path / "out"
    res = run_euroc.main([fake_euroc, "--profile", "small", "--n-feat", "256", "--device",
                          "cpu", "--max-frames", "5", "--out-dir", str(out)])
    assert res["frames"] == 5 and res["median_track_ms"] > 0
    for name in ("FrameTrajectory_TUM.txt", "KeyFrameTrajectory_TUM.txt",
                 "KeyFrameNavStateTrajectory.txt"):
        assert (out / name).exists()


def test_run_mono_driver(fake_euroc, tmp_path):
    """tools/run_mono.py on a TUM-layout folder made of the same PNGs."""
    from mc_slam_tpu_torch.tools import run_mono
    root = tmp_path / "tum"
    root.mkdir()
    seq = euroc.load_sequence(fake_euroc)
    with open(root / "rgb.txt", "w") as f:
        for t, p in zip(seq.image_times, seq.image_paths):
            f.write(f"{t:.6f} {os.path.relpath(p, root)}\n")
    out = tmp_path / "out"
    res = run_mono.main(["tum", str(root), "--n-feat", "256", "--n-levels", "3",
                         "--max-frames", "4", "--device", "cpu", "--out-dir", str(out)])
    assert res["frames"] == 4 and (out / "FrameTrajectory_TUM.txt").exists()


def test_train_vocab_driver(fake_euroc, tmp_path):
    """tools/train_vocab.py harvests the folder's frames and writes the
    shipped vocabulary's format, which bow.load_vocab reads back."""
    from mc_slam_tpu_torch.frontend import bow
    from mc_slam_tpu_torch.tools import train_vocab
    out = str(tmp_path / "vocab.npz")
    train_vocab.main(["--mav0", fake_euroc, "--words", "64", "--frames", "3", "--iters", "2",
                      "--n-feat", "256", "--out", out, "--device", "cpu"])
    vocab, idf = bow.load_vocab(out, device="cpu")
    assert vocab.shape == (64, 256) and vocab.dtype == torch.int8
    assert set(np.unique(vocab.numpy())) <= {-1, 1}
    assert idf.shape == (64,) and torch.isfinite(idf).all()


def _random_map(rng):
    from mc_slam_tpu_torch.slam_map.mapstate import empty_map
    K, F, P = 8, 32, 256
    m = empty_map(max_kf=K, max_mp=P, n_feat=F, device="cpu")
    return m._replace(
        kf_active=torch.ones(K, dtype=torch.bool),
        kf_feat_valid=torch.ones((K, F), dtype=torch.bool),
        kf_mp=torch.as_tensor(rng.integers(-1, P, size=(K, F)).astype(np.int32)),
        kf_ns=m.kf_ns._replace(P=torch.as_tensor(rng.normal(0, 1, (K, 3)), dtype=torch.float32)),
        mp_pos=torch.as_tensor(rng.normal(0, 3, (P, 3)), dtype=torch.float32),
        mp_active=torch.ones(P, dtype=torch.bool))


def test_map_snapshot_renders(tmp_path, rng):
    """tests/test_viz.py's case on a port map; the covisibility edges equal
    the JAX function's on the same tables."""
    pytest.importorskip("matplotlib")
    from mc_slam_tpu.viz import snapshot as jsnap
    from mc_slam_tpu_torch import convert
    from mc_slam_tpu_torch.viz import save_map_snapshot, snapshot
    m = _random_map(rng)
    traj = [(0.1 * i, rng.normal(0, 1, 3), np.eye(3)) for i in range(20)]
    out = save_map_snapshot(m, traj, str(tmp_path / "map.png"), covis_min_weight=1,
                            title="test map")
    assert os.path.getsize(out) > 10_000
    mj = convert.to_numpy(m)

    class _M:                       # the JAX function reads attributes only
        pass
    jm = _M()
    for k, v in mj.items():
        setattr(jm, k, v)
    for w in (1, 2):
        ii, jj = snapshot._covis_edges(m, w)
        ri, rj = jsnap._covis_edges(jm, w)
        np.testing.assert_array_equal(ii, ri)
        np.testing.assert_array_equal(jj, rj)


def test_frame_overlay_renders(tmp_path, rng):
    """tests/test_viz.py's case, with the features as tensors."""
    pytest.importorskip("matplotlib")
    from mc_slam_tpu_torch.viz import render_frame_overlay
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = torch.as_tensor(rng.uniform(0, 150, (64, 2)).astype(np.float32))
    valid = torch.as_tensor(rng.uniform(size=64) > 0.2)
    matched = torch.as_tensor(rng.uniform(size=64) > 0.5)
    out = render_frame_overlay(img, xy, valid, matched, str(tmp_path / "frame.png"),
                               title="frame 0")
    assert os.path.getsize(out) > 5_000
