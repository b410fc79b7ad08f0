"""Parity of the port's two-view bootstrap with the JAX package: the
initialization matchers, every helper of geometry/init2view.py, and
`initialize_two_view` with the SAME 8-point samples on both sides (the JAX
function draws them inside from its key, init2view.py:231-234; the test
repeats those lines with the same key and hands the indices to the port).

Tolerances: matcher outputs (integers) exact. Helpers built on an SVD null
vector (`_dlt_homography`, `_eight_point_f`) are defined up to sign: compared
after sign alignment at 2e-3 of the largest entry (float32 SVD of a 16x9 / 8x9
system in two libraries). Scores of a given model 1e-4 relative, inlier masks
on >= 99.5 % of the matches. `initialize_two_view` is held to its SELECTED
result: ok, used_h, good (>= 99 % of rows, n_good within 2), R and t to 1e-3
(3e-3 on the planar scene), both scores to 1e-2 relative; per-hypothesis arrays are not compared
(their order and null-space choices differ by library)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu import lie as jlie
from mc_slam_tpu.frontend import matching as jmatch
from mc_slam_tpu.geometry import init2view as jinit
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.frontend import matching as tmatch
from mc_slam_tpu_torch.geometry import init2view as tinit

from test_geometry import FOCAL, two_view_scene
from torch_port_helpers import jax_samples

torch.set_num_threads(2)
_t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)


def pure_rotation_scene(rng, n=200):
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 10, n)], 1).astype(np.float32)
    R1 = np.asarray(jlie.so3_exp(jnp.asarray([0.0, -0.2, 0.05])), np.float32)
    xn0 = pts[:, :2] / pts[:, 2:3]
    Pc1 = (R1.T @ pts.T).T
    xn1 = Pc1[:, :2] / Pc1[:, 2:3]
    xn0 += rng.normal(size=xn0.shape) * 0.3 / FOCAL
    xn1 += rng.normal(size=xn1.shape) * 0.3 / FOCAL
    return (jnp.asarray(xn0, jnp.float32), jnp.asarray(xn1, jnp.float32),
            jnp.ones(n, jnp.float32))


def _scene(kind, rng):
    if kind == "rotation":
        return pure_rotation_scene(rng)
    return two_view_scene(rng, planar=(kind == "planar"))[:3]


def _align_sign(a, b):
    """b with the per-matrix sign that best matches a."""
    s = np.sign(np.sum(a * b, axis=(-1, -2), keepdims=True))
    return b * np.where(s == 0, 1.0, s)


def _features(rng, n=160, n_valid=150, shift=6.0):
    """Two feature tables: the second holds the first's descriptors with a few
    flipped bits, moved by `shift` pixels, shuffled, plus exact duplicates."""
    bits0 = rng.integers(0, 2, (n, 256))
    perm = rng.permutation(n)
    bits1 = bits0[perm].copy()
    flip = rng.random((n, 256)) < 0.04
    bits1 = np.where(flip, 1 - bits1, bits1)
    bits1[5] = bits1[6]                       # an exact tie between two candidates
    uv0 = np.stack([rng.uniform(0, 320, n), rng.uniform(0, 240, n)], 1)
    uv1 = uv0[perm] + rng.normal(size=(n, 2)) * shift
    ang0 = rng.uniform(0, 2 * np.pi, n)
    ang1 = ang0[perm] + 0.3 + rng.normal(size=n) * 0.02
    ang1[:10] += 2.0                           # rotation-inconsistent matches
    valid0 = np.arange(n) < n_valid
    valid1 = rng.random(n) < 0.95
    pm = lambda b: (b * 2 - 1).astype(np.int8)
    return dict(uv0=uv0.astype(np.float32), pm0=pm(bits0), v0=valid0,
                uv1=uv1.astype(np.float32), pm1=pm(bits1), v1=valid1,
                a0=ang0.astype(np.float32), a1=ang1.astype(np.float32))


@pytest.mark.parametrize("with_angles", [False, True])
def test_search_for_initialization_exact(rng, with_angles):
    f = _features(rng)
    kw_j = dict(f0_angle=jnp.asarray(f["a0"]), f1_angle=jnp.asarray(f["a1"])) if with_angles else {}
    kw_t = dict(f0_angle=_t(f["a0"]), f1_angle=_t(f["a1"])) if with_angles else {}
    ref = jmatch.search_for_initialization(
        jnp.asarray(f["uv0"]), jnp.asarray(f["pm0"]), jnp.asarray(f["v0"]),
        jnp.asarray(f["uv1"]), jnp.asarray(f["pm1"]), jnp.asarray(f["v1"]),
        radius=30.0, ratio=0.9, **kw_j)
    got = tmatch.search_for_initialization(
        _t(f["uv0"]), _t(f["pm0"], torch.int8), _t(f["v0"], torch.bool),
        _t(f["uv1"]), _t(f["pm1"], torch.int8), _t(f["v1"], torch.bool),
        radius=30.0, ratio=0.9, **kw_t)
    assert int(np.asarray(ref[2]).sum()) > 60
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("with_angles", [False, True])
def test_mutual_match_exact(rng, with_angles):
    f = _features(rng)
    kw_j = dict(angle_a=jnp.asarray(f["a0"]), angle_b=jnp.asarray(f["a1"])) if with_angles else {}
    kw_t = dict(angle_a=_t(f["a0"]), angle_b=_t(f["a1"])) if with_angles else {}
    ref = jmatch.mutual_match(jnp.asarray(f["pm0"]), jnp.asarray(f["v0"]),
                              jnp.asarray(f["pm1"]), jnp.asarray(f["v1"]),
                              max_dist=jmatch.TH_LOW, ratio=0.85, **kw_j)
    got = tmatch.mutual_match(_t(f["pm0"], torch.int8), _t(f["v0"], torch.bool),
                              _t(f["pm1"], torch.int8), _t(f["v1"], torch.bool),
                              max_dist=tmatch.TH_LOW, ratio=0.85, **kw_t)
    assert int(np.asarray(ref[2]).sum()) > 60
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_normalize_points_matches_jax(rng):
    xn0, _, w = _scene("general", rng)
    w = w.at[:17].set(0.0)
    xh_j, T_j = jinit._normalize_points(xn0, w)
    xh_t, T_t = tinit._normalize_points(_t(xn0), _t(w))
    np.testing.assert_allclose(xh_t.numpy(), np.asarray(xh_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_minimal_solvers_match_jax(rng, kind):
    """The batched DLT homography and 8-point F on the same samples."""
    xn0, xn1, w = _scene(kind, rng)
    idx = jax_samples(jax.random.PRNGKey(3), w, n_iters=40)
    s0, s1 = np.asarray(xn0)[idx] * FOCAL, np.asarray(xn1)[idx] * FOCAL
    for jf, tf, name in ((jinit._dlt_homography, tinit._dlt_homography, "H"),
                         (jinit._eight_point_f, tinit._eight_point_f, "F")):
        ref = np.asarray(jf(jnp.asarray(s0), jnp.asarray(s1)))
        got = _align_sign(ref, tf(_t(s0), _t(s1)).numpy())
        if name == "F" and kind == "planar":
            continue     # 8 coplanar points: a 3-d null space, any member is valid
        scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
        close = np.abs(got - ref).max(axis=(-1, -2)) <= 2e-3 * scale[:, 0, 0]
        # samples that repeat an index are rank deficient; they may differ
        distinct = np.array([len(set(r)) == 8 for r in idx])
        assert close[distinct].mean() >= 0.95, (name, close[distinct].mean())


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_scores_match_jax(rng, kind):
    """score_homography / score_fundamental of the SAME models."""
    xn0, xn1, w = _scene(kind, rng)
    uv0, uv1 = np.asarray(xn0) * FOCAL, np.asarray(xn1) * FOCAL
    idx = jax_samples(jax.random.PRNGKey(4), w, n_iters=16)
    Hs = np.asarray(jinit._dlt_homography(jnp.asarray(uv0[idx]), jnp.asarray(uv1[idx])))
    Fs = np.asarray(jinit._eight_point_f(jnp.asarray(uv0[idx]), jnp.asarray(uv1[idx])))
    Hinv = np.linalg.inv(Hs.astype(np.float64)).astype(np.float32)
    sj, ij = jinit.score_homography(jnp.asarray(Hs), jnp.asarray(Hinv), jnp.asarray(uv0)[None],
                                    jnp.asarray(uv1)[None], w[None])
    st, it = tinit.score_homography(_t(Hs), _t(Hinv), _t(uv0)[None], _t(uv1)[None], _t(w)[None])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-2)
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.995
    sj, ij = jinit.score_fundamental(jnp.asarray(Fs), jnp.asarray(uv0)[None],
                                     jnp.asarray(uv1)[None], w[None])
    st, it = tinit.score_fundamental(_t(Fs), _t(uv0)[None], _t(uv1)[None], _t(w)[None])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-2)
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.995


def test_check_rt_matches_jax(rng):
    xn0, xn1, w, pts, R1, C1 = two_view_scene(rng)
    th = 4.0 / FOCAL ** 2
    Xj, gj, nj, cj = jinit._check_rt(jnp.asarray(R1), jnp.asarray(C1), xn0, xn1, w, th_reproj=th)
    Xt, gt, nt, ct = tinit._check_rt(_t(R1), _t(C1), _t(xn0), _t(xn1), _t(w), th_reproj=th)
    assert int(nj) > 150 and abs(int(nt) - int(nj)) <= 1
    assert (gt.numpy() == np.asarray(gj)).mean() >= 0.99
    both = gt.numpy() & np.asarray(gj)
    np.testing.assert_allclose(Xt.numpy()[both], np.asarray(Xj)[both], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ct.numpy()[both], np.asarray(cj)[both], atol=1e-5)
    # the wrong motion (translation reversed) puts the points behind a camera
    _, _, n_bad, _ = tinit._check_rt(_t(R1), -_t(C1), _t(xn0), _t(xn1), _t(w), th_reproj=th)
    assert int(n_bad) < 10


def _pose_set(hyps):
    return [(np.asarray(R), np.asarray(t)) for R, t in hyps]


def _assert_same_pose_sets(ref, got, atol):
    """Every reference hypothesis appears among the port's (any order)."""
    for Rr, tr in ref:
        d = [max(np.abs(Rr - Rg).max(), np.abs(tr - tg).max()) for Rg, tg in got]
        assert min(d) < atol, min(d)


def test_decompositions_match_jax(rng):
    """_decompose_e and _decompose_h_normalized give the same SETS of motion
    hypotheses (their order may differ), the true motion among them."""
    _, _, _, _, R1, C1 = two_view_scene(rng)
    Rcw, tcw = R1.T, -R1.T @ C1                  # x1 = Rcw x0 + tcw
    tx = np.array([[0, -tcw[2], tcw[1]], [tcw[2], 0, -tcw[0]], [-tcw[1], tcw[0], 0]])
    E = (tx @ Rcw).astype(np.float32)
    ref = _pose_set(jinit._decompose_e(jnp.asarray(E)))
    got = _pose_set([(R.numpy(), t.numpy()) for R, t in tinit._decompose_e(_t(E))])
    assert len(got) == 4
    _assert_same_pose_sets(ref, got, 1e-4)
    unit = C1 / np.linalg.norm(C1)
    assert min(max(np.abs(R - R1).max(), np.abs(t - unit).max()) for R, t in got) < 1e-4
    # plane z = 6 in cam0: H = Rcw + tcw n^T / d
    n, d = np.array([0.0, 0.0, 1.0]), 6.0
    H = (Rcw + np.outer(tcw, n) / d).astype(np.float32)
    ref = _pose_set(jinit._decompose_h_normalized(jnp.asarray(H)))
    got = _pose_set([(R.numpy(), t.numpy()) for R, t in tinit._decompose_h_normalized(_t(H))])
    assert len(got) == 8
    _assert_same_pose_sets(ref, got, 1e-3)
    assert min(max(np.abs(R - R1).max(), np.abs(t - unit).max()) for R, t in got) < 1e-3


@pytest.mark.parametrize("kind,key", [("general", 0), ("planar", 1), ("rotation", 2)])
def test_initialize_two_view_matches_jax(rng, kind, key):
    """tests/test_geometry.py's three cases with the JAX call's own samples."""
    xn0, xn1, w = _scene(kind, rng)
    k = jax.random.PRNGKey(key)
    ref = jax.tree_util.tree_map(np.asarray, jinit.initialize_two_view(k, xn0, xn1, w, FOCAL))
    idx = jax_samples(k, w)
    got = convert.to_numpy(tinit.initialize_two_view(
        _t(idx, torch.int64), _t(xn0), _t(xn1), _t(w), FOCAL))
    assert bool(got["ok"]) == bool(ref.ok) == (kind != "rotation")
    assert bool(got["used_h"]) == bool(ref.used_h)
    if kind == "planar":
        assert bool(got["used_h"])
    np.testing.assert_allclose(got["score_h"], ref.score_h, rtol=1e-2)
    np.testing.assert_allclose(got["score_f"], ref.score_f, rtol=1e-2)
    if kind == "rotation":
        return
    assert abs(int(got["n_good"]) - int(ref.n_good)) <= 2
    assert (got["good"] == ref.good).mean() >= 0.99
    # the planar case goes through the SVD of a homography whose two larger
    # singular values are close: its translation moves 3x more in float32
    tol = 3e-3 if kind == "planar" else 1e-3
    np.testing.assert_allclose(got["R"], ref.R, atol=tol)
    np.testing.assert_allclose(got["t"], ref.t, atol=tol)
    both = got["good"] & ref.good
    np.testing.assert_allclose(got["Xw"][both], ref.Xw[both], rtol=5e-3, atol=5e-3)


def test_degenerate_sample_loses(rng):
    """A sample made of one match eight times gives singular systems: the
    port neither raises nor lets that hypothesis win, and the result equals
    the one without it."""
    xn0, xn1, w = _scene("general", rng)
    idx = jax_samples(jax.random.PRNGKey(0), w)
    bad = idx.copy()
    bad[0] = 7                                    # rank 2 / rank 1 systems
    bad[1, :4] = bad[1, 4:]                       # four distinct points only
    a = tinit.initialize_two_view(_t(idx, torch.int64), _t(xn0), _t(xn1), _t(w), FOCAL)
    b = tinit.initialize_two_view(_t(bad, torch.int64), _t(xn0), _t(xn1), _t(w), FOCAL)
    assert bool(b.ok) and bool(a.ok)
    assert torch.isfinite(b.score_h) and torch.isfinite(b.score_f)
    np.testing.assert_allclose(b.R.numpy(), a.R.numpy(), atol=2e-3)
    cos = float(torch.dot(a.t, b.t) / (a.t.norm() * b.t.norm()))
    assert cos > 0.9999
    # all-singular input: nothing to select, ok is False, nothing raises
    z = torch.zeros_like(_t(xn0))
    c = tinit.initialize_two_view(_t(idx, torch.int64), z, z, _t(w), FOCAL)
    assert not bool(c.ok)


def test_draw_samples_follows_weights_and_generator():
    w = torch.zeros(50)
    w[[3, 10, 11, 40]] = 1.0
    g = torch.Generator().manual_seed(5)
    a = tinit.draw_samples(w, 200, g)
    assert a.shape == (200, 8) and a.dtype == torch.int64
    assert set(a.unique().tolist()) == {3, 10, 11, 40}
    b = tinit.draw_samples(w, 200, torch.Generator().manual_seed(5))
    c = tinit.draw_samples(w, 200, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    counts = torch.bincount(a.reshape(-1), minlength=50)[[3, 10, 11, 40]].float()
    assert (counts / counts.sum() - 0.25).abs().max() < 0.05
