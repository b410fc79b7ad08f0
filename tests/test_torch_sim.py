"""The port's simulator against the JAX package's: same numpy seed, same
textures and trajectory; rendered grey levels within one level where the
ray undistortion (float32, 20 fixed-point iterations) rounds differently;
IMU body rates within 1e-5 rad/s (a float32 so3_log of a 2e-4 s rotation,
divided by 2e-4). And chip_smoke.py's right images against a serial render,
bit for bit."""
import dataclasses

import numpy as np
import pytest

from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.sim import MavTrajectory as JTraj, RoomWorld as JRoom
from mc_slam_tpu.sim.room import make_texture as j_make_texture
from mc_slam_tpu_torch.camera import make_camera as t_make_camera
from mc_slam_tpu_torch.sim import MavTrajectory as TTraj, RoomWorld as TRoom, \
    make_texture as t_make_texture

INTR = (229.3, 228.6, 160.0, 120.0)
DIST = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)


def test_texture_same_seed():
    a = j_make_texture(np.random.default_rng(3), size=256, n_speckle=200, n_posters=4)
    b = t_make_texture(np.random.default_rng(3), size=256, n_speckle=200, n_posters=4)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def worlds():
    wj = JRoom(np.random.default_rng(0), tex_size=256, tex_scale=1.0)
    wt = TRoom(np.random.default_rng(0), tex_size=256, tex_scale=1.0)
    return wj, wt


def test_room_planes_identical(worlds):
    wj, wt = worlds
    for pj, pt in zip(wj.planes, wt.planes):
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t", [0.0, 2.5])
def test_render_within_one_grey_level(worlds, t):
    wj, wt = worlds
    cj = j_make_camera(*INTR, **DIST, width=320, height=240)
    ct = t_make_camera(*INTR, **DIST, width=320, height=240, device="cpu")
    P, R = JTraj().pose(t)
    img_j, z_j = wj.render(cj, R, P, with_depth=True)
    img_t, z_t = wt.render(ct, R, P, with_depth=True)
    diff = np.abs(img_j.astype(int) - img_t.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    np.testing.assert_allclose(z_j, z_t, rtol=1e-4)


def test_trajectory_and_imu():
    tj, tt = JTraj(duration=120.0), TTraj(duration=120.0)
    for t in (0.0, 1.3, 77.7):
        Pj, Rj = tj.pose(t)
        Pt, Rt = tt.pose(t)
        np.testing.assert_array_equal(Pj, Pt)
        np.testing.assert_array_equal(Rj, Rt)
        np.testing.assert_array_equal(tj.velocity(t), tt.velocity(t))
    bg, ba = np.array([0.003, -0.0045, 0.0035]), np.array([0.035, -0.02, 0.06])
    rj = tj.imu_samples(0.0, 0.1, bg=bg, ba=ba, noise_g=1.7e-4, noise_a=2e-3,
                        rng=np.random.default_rng(4))
    rt = tt.imu_samples(0.0, 0.1, bg=bg, ba=ba, noise_g=1.7e-4, noise_a=2e-3,
                        rng=np.random.default_rng(4))
    assert rj.shape == rt.shape == (20, 7)
    np.testing.assert_allclose(rj[:, 0:3], rt[:, 0:3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rj[:, 3:], rt[:, 3:])


def test_chip_smoke_right_images_equal_a_serial_render():
    """chip_smoke.render_right (path 7's right images) gives, frame for frame,
    the bytes of a serial render by one RoomWorld of the same seed, at the
    card's 752x480 over 32 frames (texture 1024): when it rendered on 8
    threads through one world, 1 to 4 such frames came out with patches of
    wrong pixels in 2 of 3 runs of this test (numpy's OpenBLAS called from
    several threads at once)."""
    import chip_smoke
    p = dataclasses.replace(chip_smoke.EUROC, tex_size=1024)
    n = 32
    traj = TTraj(duration=120.0)
    P, R = (np.asarray(a) for a in zip(*[traj.pose(i / p.fps) for i in range(n)]))
    seq = chip_smoke.Sequence([], [], P, R, None, [], np.arange(n) / p.fps)
    got = chip_smoke.render_right(seq, p, range(n))
    assert sorted(got) == list(range(n))
    world = TRoom(np.random.default_rng(0), tex_size=p.tex_size, tex_scale=1.0)
    cam = chip_smoke.profile_camera(p, "cpu")
    Rbc, pbc = chip_smoke.TBC[:3, :3], chip_smoke.TBC[:3, 3]
    right = np.array([chip_smoke.system.SlamConfig().stereo_baseline, 0.0, 0.0])
    for i in range(n):
        Rwc = R[i] @ Rbc
        ref = world.render(cam, Rwc, P[i] + R[i] @ pbc + Rwc @ right)
        assert got[i].dtype == np.uint8 and got[i].shape == (p.height, p.width)
        np.testing.assert_array_equal(got[i], ref, err_msg=f"frame {i}")
