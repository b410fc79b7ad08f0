"""The plain reference against the port at a small size on the CPU, and its
lower-precision control on the card."""
import numpy as np
import pytest
import torch

from benchmark.runners import multiseq
from benchmark.reference import orb
from benchmark.sim.room import Room, make_textures, pixel_rays
from benchmark.sim.trajectory import Trajectory
from benchmark.tests.tiny import tiny_spec
from benchmark.harness import manifest as mf


def rendered(n=2, size=(120, 160)):
    """n frames of the benchmark's clone with a scaled EuRoC camera."""
    H, W = size
    intr = (458.654 * W / 752, 457.296 * H / 480, 367.215 * W / 752, 248.375 * H / 480,
            -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    room = Room(make_textures(torch.Generator().manual_seed(9), size=256))
    Rwc, Cw = Trajectory(120.0).camera(torch.tensor([3.0, 41.5][:n], dtype=torch.float64))
    return room.render(pixel_rays(intr, W, H, "cpu"), Rwc, Cw, H, W)[0]


@pytest.mark.parametrize("size,n_feat,n_levels", [((120, 160), 128, 3), ((240, 320), 512, 8)])
def test_orb_matches_the_port_extractor(size, n_feat, n_levels):
    from mc_slam_tpu_torch.frontend import extractor
    torch.set_num_threads(2)
    img = rendered(2, size)
    ref = orb.extract(img, n_feat, n_levels)
    port = extractor.extract(img, n_features=n_feat, n_levels=n_levels)
    assert torch.equal(ref["valid"], port.valid) and int(port.valid.sum()) > n_feat // 2
    torch.testing.assert_close(ref["xy"], port.xy, rtol=0, atol=1e-5)
    assert torch.equal(ref["level"], port.level)
    torch.testing.assert_close(ref["angle"], port.angle, rtol=0, atol=1e-5)
    assert (ref["desc"] == port.desc).all(-1).float().mean() > 0.99
    assert (ref["pm1"] == port.desc_pm1).all(-1).float().mean() > 0.99


def test_reference_localizes_as_the_batched_step():
    torch.set_num_threads(2)
    cell = multiseq.Cell(tiny_spec(), 11, torch.device("cpu"))
    done = [cell.step(k) for k in range(cell.n_win)]
    pairs = [(multiseq.answer(done, b, k), cell.reference(b, done[k][0]))
             for b in range(cell.B) for k in range(cell.n_win)]
    g = multiseq.gaps(pairs, cell.cell["far_gap_mm"])
    assert g["inlier_diff_pct"] == 0 and g["match_diff_pct"] == 0, g
    limits = mf.resolve_cell(mf.load_manifest(), "multiseq.b11")["cell"]["limits"]
    assert all(g[k] <= limits[k] for k in limits), g


@pytest.mark.card
def test_the_tf32_control_fails_the_limits():
    """The reference with TF32 products, in the program's place, on the
    cell's streams at full width: at least one number over its limit, on each
    seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.calibrate import readings
    spec = mf.resolve_cell(mf.load_manifest(), "multiseq.b11")
    spec["traffic"].update(rendered_frames=4)
    limits = spec["cell"]["limits"]
    for seed in (21, 22, 23):
        r = readings(spec, seed, 4, torch.device("cuda", 0))
        assert all(r["program"][k] <= limits[k] for k in limits), r
        assert any(r["control"][k] > limits[k] for k in limits), r
