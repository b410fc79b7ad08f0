"""Parity of the port's stereo matcher (`frontend.stereo.stereo_depth`) with
the JAX package's on the dot world of tests/test_e2e_depth.py (480x360, 384
features, 3 levels): the same feature tables (the JAX extraction, converted)
through both; a planted tie for the left-right mutual check; and the port of
`test_stereo_depth_accuracy` on the port's own extraction.

Tolerances: matching is integer arithmetic, so the `ok` mask and the match
indices are exact; depth = fx * b / disparity in float32 agrees to 1e-5
relative. The accuracy gate is the original's (median relative error < 0.08
against the rendered depth)."""
import jax.numpy as jnp
import numpy as np
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.frontend import extractor as jex, matching as jmatch, stereo as jstereo
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.frontend import extractor as tex, matching as tmatch, stereo as tstereo

from render import DotWorld

torch.set_num_threads(2)
B = 0.25          # the accuracy test's baseline: ~14 px of disparity at 5.5 m


def _pose(t):
    P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.05 * t], np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.08 * np.sin(0.5 * t), 0.0], jnp.float32)))
    return P, R.astype(np.float32)


def _both(jf):
    return jf, convert.to_torch(tex.Features, {k: np.asarray(v) for k, v in jf._asdict().items()},
                                "cpu")


def test_stereo_depth_equal_tables(rng):
    world = DotWorld(rng)
    P, R = _pose(0.3)
    left, right = world.render_stereo(R, P, baseline=B)
    jL, tL = _both(jex.extract(jnp.asarray(left), n_features=384, n_levels=3))
    jR, tR = _both(jex.extract(jnp.asarray(right), n_features=384, n_levels=3))
    dj, okj = jstereo.stereo_depth(jL.xy, jL.desc_pm1, jL.valid, jR.xy, jR.desc_pm1, jR.valid,
                                   300.0, B)
    dt, okt = tstereo.stereo_depth(tL.xy, tL.desc_pm1, tL.valid, tR.xy, tR.desc_pm1, tR.valid,
                                   300.0, B)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() > 100
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    assert np.all(dt.numpy()[~okj] == -1.0)
    # the nearest-neighbour indices under the row band / disparity gate
    dist_j = jmatch.hamming_matrix(jL.desc_pm1, jR.desc_pm1)
    dist_t = tmatch.hamming_matrix(tL.desc_pm1, tR.desc_pm1)
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
    xyL, xyR = np.asarray(jL.xy), np.asarray(jR.xy)
    dv = np.abs(xyL[:, None, 1] - xyR[None, :, 1])
    disp = xyL[:, None, 0] - xyR[None, :, 0]
    gate = ((dv <= 2.0) & (disp >= 0.5) & (disp <= 128.0) & np.asarray(jL.valid)[:, None]
            & np.asarray(jR.valid)[None, :])
    idx_j, _, _ = jmatch.match_nn(dist_j, jnp.asarray(gate), max_dist=jmatch.TH_HIGH, ratio=0.9)
    idx_t, _, _ = tmatch.match_nn(dist_t, torch.from_numpy(gate), max_dist=tmatch.TH_HIGH,
                                  ratio=0.9)
    np.testing.assert_array_equal(idx_t.numpy()[okj], np.asarray(idx_j)[okj])


def test_stereo_mutual_check_breaks_ties_to_the_lowest_left_index(rng):
    """Two left features with one descriptor on one row, one right feature
    that both match at distance 0: the right-to-left argmin ties, the lower
    left index keeps the match, the other fails the mutual check."""
    N, M = 12, 10
    pmL = np.where(rng.random((N, 256)) < 0.5, -1, 1).astype(np.int8)
    pmR = np.where(rng.random((M, 256)) < 0.5, -1, 1).astype(np.int8)
    uvL = np.stack([rng.uniform(100, 400, N), np.arange(N) * 20.0 + 20], 1).astype(np.float32)
    uvR = uvL[:M].copy()
    uvR[:, 0] -= 10.0                                   # 10 px of disparity
    pmR[:] = pmL[:M]
    # left rows 3 and 7 share row 3's descriptor and row; right row 3 matches both
    pmL[7] = pmL[3]
    uvL[7] = uvL[3] + [1.0, 0.5]
    validL, validR = np.ones(N, bool), np.ones(M, bool)
    dj, okj = jstereo.stereo_depth(*[jnp.asarray(a) for a in (uvL, pmL, validL, uvR, pmR, validR)],
                                   300.0, B)
    dt, okt = tstereo.stereo_depth(*[torch.from_numpy(a) for a in (uvL, pmL, validL, uvR, pmR,
                                                                   validR)], 300.0, B)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    assert okt[3] and not okt[7]
    np.testing.assert_allclose(float(dt[3]), 300.0 * B / 10.0, rtol=1e-5)
    # the helper on its own: every column's first minimum, whatever the order of equal values
    d = torch.tensor([[3, 1, 1], [1, 1, 2], [1, 5, 1]])
    assert tstereo.argmin_lowest(d, 0).tolist() == [1, 0, 0]
    assert tstereo.argmin_lowest(d, 1).tolist() == [1, 0, 0]


def test_stereo_depth_accuracy(rng):
    """tests/test_e2e_depth.py::test_stereo_depth_accuracy on the port's own
    extraction: row-banded stereo matching recovers metric depth."""
    world = DotWorld(rng)
    P, R = _pose(0.0)
    left, right = world.render_stereo(R, P, baseline=B)
    fL = tex.extract(torch.from_numpy(left), n_features=384, n_levels=3)
    fR = tex.extract(torch.from_numpy(right), n_features=384, n_levels=3)
    d, ok = tstereo.stereo_depth(fL.xy, fL.desc_pm1, fL.valid, fR.xy, fR.desc_pm1, fR.valid,
                                 300.0, B)
    ok = ok.numpy()
    assert ok.sum() > 100, ok.sum()
    _, dep = world.render(R, P, with_depth=True)
    xy = fL.xy.numpy().astype(int)
    gt = dep[np.clip(xy[:, 1], 0, 359), np.clip(xy[:, 0], 0, 479)]
    sel = ok & (gt > 0)
    rel = np.abs(d.numpy()[sel] - gt[sel]) / gt[sel]
    assert np.median(rel) < 0.08, np.median(rel)
