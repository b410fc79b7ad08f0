"""Parity of the port's ORB front end (pyramid, FAST, BRIEF, extract) with
the JAX package on the same rendered frame.

Tolerances: pyramid levels within 1e-4 grey. The port rebuilds jax.image's
antialiased weight matrices (mirroring XLA's fused multiply-add for the
sample positions); XLA's fused evaluation of the normalization still moves
a few weights by up to 3e-6, and the float32 sums of the resize products run
in another order. On one identical level image, FAST corners, scores,
keypoint tables and BRIEF bits are exact. Through `extract`, keypoint levels
and validity are exact; xy agree to 1e-4 px, FAST scores to 2e-3 (16-term
sums of level-pixel differences up to ~4000, so 1e-4 grey becomes ~1e-3) and
angles to 1e-4 rad; descriptor bits agree except where a BRIEF test
compares two blurred samples closer than the levels' 1e-4: observed 6 of
65536 bits on this frame, bounded here at 0.05%."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.frontend import extractor as jex, fast as jfast, orb as jorb, \
    pyramid as jpyr
from mc_slam_tpu_torch.frontend import extractor as tex, fast as tfast, \
    orb as torb, pyramid as tpyr
from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld

torch.set_num_threads(2)
N_FEAT, N_LEVELS = 256, 3


@pytest.fixture(scope="module")
def frame():
    import chip_smoke
    p = chip_smoke.Profile(width=320, height=240, n_feat=N_FEAT, n_levels=N_LEVELS)
    cam = chip_smoke.profile_camera(p, "cpu")
    world = RoomWorld(np.random.default_rng(0), tex_size=256, tex_scale=1.0)
    P, R = MavTrajectory().pose(0.3)
    return world.render(cam, R, P)


@pytest.fixture(scope="module")
def extracted(frame):
    fj = jex.extract(jnp.asarray(frame), n_features=N_FEAT, n_levels=N_LEVELS)
    ft = tex.extract(torch.from_numpy(frame), n_features=N_FEAT, n_levels=N_LEVELS)
    return {k: np.asarray(v) for k, v in fj._asdict().items()}, \
        {k: v.numpy() for k, v in ft._asdict().items()}


def test_resize_weights_match_jit():
    import jax
    from jax._src.image.scale import ResizeMethod, _kernels, compute_weight_mat
    for n_in, n_out in ((240, 200), (752, 627), (627, 522), (84, 70)):
        wj = jax.jit(lambda: compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, _kernels[ResizeMethod.LINEAR], True))()
        np.testing.assert_allclose(tpyr.resize_weights(n_in, n_out), np.asarray(wj),
                                   rtol=0, atol=3e-6)   # see module docstring


def test_pyramid_and_blur(frame):
    img = frame.astype(np.float32)
    lj = jpyr.build_pyramid(jnp.asarray(img), N_LEVELS)
    lt = tpyr.build_pyramid(torch.from_numpy(img), N_LEVELS)
    assert [a.shape for a in lj] == [tuple(b.shape) for b in lt]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-4)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np.asarray(jpyr.gaussian_blur(a)),
                                   tpyr.gaussian_blur(b).numpy(), rtol=0, atol=1e-4)


def test_fast_on_identical_level(frame):
    """Same level image into both detectors: corner maps, NMS and the keypoint
    table (grid argmax, stable top-k, subpixel fit) agree exactly."""
    img = frame.astype(np.float32)
    hj, lj, sj = jfast.fast_response_dual(jnp.asarray(img), 20.0, 7.0)
    ht, lt, st = tfast.fast_response_dual(torch.from_numpy(img), 20.0, 7.0)
    np.testing.assert_array_equal(np.asarray(hj), ht.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(jfast.nms3(sj)), tfast.nms3(st).numpy())
    xj, scj, vj = jfast.detect_grid(jnp.asarray(img), max_kp=200)
    xt, sct, vt = tfast.detect_grid(torch.from_numpy(img), max_kp=200)
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    np.testing.assert_array_equal(np.asarray(scj), sct.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_fast_topk_ties_keep_index_order():
    """A flat image with equal-score corners: the top-k keeps ties in
    ascending cell order, as lax.top_k."""
    img = np.full((128, 160), 100.0, np.float32)
    for y in range(20, 120, 32):
        for x in range(20, 150, 32):
            img[y:y + 4, x:x + 4] = 200.0
    xj, scj, vj = jfast.detect_grid(jnp.asarray(img), max_kp=8)
    xt, sct, vt = tfast.detect_grid(torch.from_numpy(img), max_kp=8)
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_pattern_and_brief_tables():
    np.testing.assert_array_equal(torb.PATTERN, jorb.PATTERN)
    np.testing.assert_array_equal(torb.MOMENT_W, jorb.MOMENT_W)
    # the gather tables are the argmax of the JAX one-hot selection tables
    np.testing.assert_array_equal(torb.SAMPLE_I1.reshape(-1), jorb.S1.argmax(1))
    np.testing.assert_array_equal(torb.SAMPLE_I2.reshape(-1), jorb.S2.argmax(1))


def test_brief_bits_on_identical_patches():
    rng = np.random.default_rng(3)
    patches = (rng.random((64, 31, 31)) * 255).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    bj = np.asarray(jorb.brief_from_patches(jnp.asarray(patches), jnp.asarray(angle)))
    bt = torb.brief_from_patches(torch.from_numpy(patches), torch.from_numpy(angle))
    np.testing.assert_array_equal(bj.astype(np.int64), bt.numpy())
    np.testing.assert_array_equal(np.asarray(jorb.pack_bits(jnp.asarray(bj))),
                                  torb.pack_bits(bt).numpy().view(np.uint32))
    words = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(jorb.unpack_pm1(jnp.asarray(words))),
                                  torb.unpack_pm1(torch.from_numpy(words.view(np.int32))).numpy())


def test_extract_tables(extracted):
    fj, ft = extracted
    for k in ("level", "valid"):
        np.testing.assert_array_equal(fj[k], ft[k])
    n_bits_differ = int((fj["desc_pm1"] != ft["desc_pm1"]).sum())
    assert n_bits_differ <= 0.0005 * fj["desc_pm1"].size, n_bits_differ
    np.testing.assert_array_equal(np.asarray(jorb.pack_bits(jnp.asarray(
        (ft["desc_pm1"] > 0).astype(np.uint32)))), ft["desc"].view(np.uint32))
    np.testing.assert_allclose(fj["xy"], ft["xy"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(fj["score"], ft["score"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(fj["angle"], ft["angle"], rtol=0, atol=1e-4)
    assert fj["valid"].sum() > N_FEAT // 2


def test_per_level_quota():
    for n, lv in ((1024, 8), (256, 3), (500, 4)):
        assert tex.per_level_quota(n, lv) == jex.per_level_quota(n, lv)
