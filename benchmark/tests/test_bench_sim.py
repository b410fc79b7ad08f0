"""The benchmark's torch clone against the port's numpy clone, on the CPU."""
import numpy as np
import torch

from benchmark.sim.room import Room, make_textures, pixel_rays
from benchmark.sim.trajectory import TBC, Trajectory
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.sim.room import RoomWorld
from mc_slam_tpu_torch.sim.trajectory import MavTrajectory

K = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)


def small_camera():
    """The EuRoC camera scaled to 160x120, as the port's Camera and as the
    benchmark's intrinsics tuple."""
    cam = make_camera(458.654 * 160 / 752, 457.296 * 120 / 480, 367.215 * 160 / 752,
                      248.375 * 120 / 480, k1=K[0], k2=K[1], p1=K[2], p2=K[3],
                      width=160, height=120, device="cpu")
    return cam, tuple(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy)) + K


def test_render_matches_the_port_within_one_grey_level():
    torch.set_num_threads(2)
    world = RoomWorld(np.random.default_rng(3), tex_size=256, tex_scale=1.0)
    cam, intr = small_camera()
    room = Room(torch.from_numpy(np.stack([p[4] for p in world.planes])), tex_scale=1.0)
    ts = torch.tensor([0.0, 13.3, 50.05, 77.7, 101.2], dtype=torch.float64)
    Rwc, Cw = Trajectory(120.0).camera(ts)
    img, depth = room.render(pixel_rays(intr, 160, 120, "cpu"), Rwc, Cw, 120, 160)
    port = MavTrajectory(120.0)
    for i, t in enumerate(ts.tolist()):
        P, R = port.pose(t)
        ref, z = world.render(cam, R @ TBC_np()[:3, :3], P + R @ TBC_np()[:3, 3],
                              with_depth=True)
        assert np.abs(img[i].numpy().astype(int) - ref.astype(int)).max() <= 1
        np.testing.assert_allclose(depth[i].numpy(), z, rtol=1e-5)


def TBC_np():
    return np.asarray(TBC, np.float64)


def test_imu_rows_follow_the_port_trajectory():
    rows = MavTrajectory(120.0).imu_samples(10.0, 10.5, bg=np.array([0.003, -0.0045, 0.0035]),
                                            ba=np.array([0.035, -0.02, 0.06]))
    mine = Trajectory(120.0).imu(10.0, len(rows), bg=(0.003, -0.0045, 0.0035),
                                 ba=(0.035, -0.02, 0.06))
    np.testing.assert_allclose(mine[:, :3].numpy(), rows[:, :3], atol=1e-6)
    np.testing.assert_allclose(mine[:, 3:6].numpy(), rows[:, 3:6], atol=1e-5)
    np.testing.assert_array_equal(mine[:, 6].numpy(), rows[:, 6])


def test_imu_noise_has_the_euroc_densities():
    rows = Trajectory(120.0).imu(0.0, 4000, noise_scale=1.0,
                                 gen=torch.Generator().manual_seed(4))
    clean = Trajectory(120.0).imu(0.0, 4000)
    sd = (rows - clean)[:, :6].to(torch.float64).std(0)
    np.testing.assert_allclose(sd[:3].numpy(), 1.7e-4, rtol=0.1)
    np.testing.assert_allclose(sd[3:].numpy(), 2e-3, rtol=0.1)


def test_textures_come_from_the_seed():
    a = make_textures(torch.Generator().manual_seed(2 ** 31 + 5), size=256)
    b = make_textures(torch.Generator().manual_seed(2 ** 31 + 5), size=256)
    c = make_textures(torch.Generator().manual_seed(2 ** 31 + 6), size=256)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (6, 256, 256) and float(a.min()) >= 0 and float(a.max()) <= 255
