"""Parity of the projection search: the port's twin, the JAX Pallas kernel
(interpret mode, as tests/test_match_pallas.py runs it) and the JAX XLA path
agree exactly; the port's search_by_projection equals the JAX one; the
kernel wrapper validates its inputs and raises instead of falling back."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.frontend import match_pallas, matching as jmatch
from mc_slam_tpu.frontend.orb import unpack_pm1 as j_unpack_pm1
from mc_slam_tpu_torch.frontend import match_cuda, matching as tmatch
from mc_slam_tpu_torch.frontend.orb import pack_bits, unpack_pm1

torch.set_num_threads(2)


def _inputs(rng, M, N, width=640.0, ties=False):
    words_a = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    words_b = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    a_uv = rng.uniform(0, width, (M, 2)).astype(np.float32)
    b_uv = rng.uniform(0, width, (N, 2)).astype(np.float32)
    a_lvl = rng.integers(0, 4, M).astype(np.int32)
    b_lvl = rng.integers(0, 4, N).astype(np.int32)
    if ties:
        # duplicated candidates (equal best at two columns) and queries that
        # copy a candidate (distance 0 at its column)
        dup = rng.choice(N, N // 4, replace=False)
        words_b[dup] = words_b[rng.choice(N, N // 4)]
        b_uv[dup] = b_uv[rng.choice(N, N // 4)]
        src = rng.integers(0, N, M // 2)
        words_a[:M // 2] = words_b[src]
        a_uv[:M // 2] = b_uv[src] + rng.uniform(-5, 5, (M // 2, 2)).astype(np.float32)
        a_lvl[:M // 2] = b_lvl[src]
    return dict(words_a=words_a, words_b=words_b, a_uv=a_uv, b_uv=b_uv,
                a_lvl=a_lvl, b_lvl=b_lvl, a_v=rng.random(M) < 0.9,
                b_v=rng.random(N) < 0.9)


def _xla_reference(d, radius):
    a = j_unpack_pm1(jnp.asarray(d["words_a"]))
    b = j_unpack_pm1(jnp.asarray(d["words_b"]))
    dist = jmatch.hamming_matrix(a, b)
    gate = jmatch.window_mask(jnp.asarray(d["a_uv"]), jnp.asarray(d["b_uv"]), radius,
                              jnp.asarray(d["a_lvl"]), jnp.asarray(d["b_lvl"]))
    gate = gate & jnp.asarray(d["a_v"])[:, None] & jnp.asarray(d["b_v"])[None, :]
    dm = jnp.where(gate, dist, jmatch.BIG)
    idx = jnp.argmin(dm, axis=1)
    best = jnp.min(dm, axis=1)
    second = jnp.min(dm.at[jnp.arange(dm.shape[0]), idx].set(jmatch.BIG), axis=1)
    return np.asarray(best), np.asarray(second), np.asarray(idx)


def _port(d, radius, fn=match_cuda.hamming_top2_windowed):
    wa = torch.from_numpy(d["words_a"].view(np.int32))
    wb = torch.from_numpy(d["words_b"].view(np.int32))
    out = fn(wa, unpack_pm1(wa), torch.from_numpy(d["a_uv"]),
             torch.from_numpy(d["a_lvl"]), torch.from_numpy(d["a_v"]),
             wb, unpack_pm1(wb), torch.from_numpy(d["b_uv"]),
             torch.from_numpy(d["b_lvl"]), torch.from_numpy(d["b_v"]), radius)
    return [o.numpy() for o in out]


def _assert_same(ref, got):
    best, second, idx = ref
    has = best < match_pallas.BIG
    np.testing.assert_array_equal(best, got[0])
    np.testing.assert_array_equal(idx[has], got[2][has])
    np.testing.assert_array_equal(second[has], got[1][has])
    # nothing passed the gate: BIG and column 0 on both sides
    assert (got[0][~has] == match_cuda.BIG).all() and (got[2][~has] == 0).all()


@pytest.mark.parametrize("ties", [False, True])
def test_twin_equals_pallas_interpret_and_xla(ties):
    """tests/test_match_pallas.py's case (M=2048, N=512, r=60), and with
    planted ties."""
    d = _inputs(np.random.default_rng(0), 2048, 512, ties=ties)
    ref = _xla_reference(d, 60.0)
    a = j_unpack_pm1(jnp.asarray(d["words_a"]))
    b = j_unpack_pm1(jnp.asarray(d["words_b"]))
    pallas = match_pallas.hamming_top2_windowed(
        a, jnp.asarray(d["a_uv"]), jnp.asarray(d["a_lvl"]), jnp.asarray(d["a_v"]),
        b, jnp.asarray(d["b_uv"]), jnp.asarray(d["b_lvl"]), jnp.asarray(d["b_v"]),
        60.0, interpret=True)
    has = ref[0] < match_pallas.BIG
    pallas = [np.asarray(x) for x in pallas]
    np.testing.assert_array_equal(pallas[0], ref[0])
    np.testing.assert_array_equal(pallas[2][has], ref[2][has])
    np.testing.assert_array_equal(pallas[1][has], ref[1][has])
    _assert_same(ref, _port(d, 60.0))
    if ties:
        assert (ref[1][has] == ref[0][has]).sum() > 0     # ties really planted


@pytest.mark.parametrize("M,N,radius", [(1001, 333, 15.0), (777, 1000, 4.0),
                                        (64, 1, 40.0)])
def test_twin_equals_xla_ragged(M, N, radius):
    d = _inputs(np.random.default_rng(M), M, N, width=200.0, ties=True)
    _assert_same(_xla_reference(d, radius), _port(d, radius))


def test_compare_kernel_helper_on_cpu():
    """chip_smoke's phase-2 comparison, exercised on CPU (wrapper -> twin)."""
    import chip_smoke
    inp = chip_smoke.planted_inputs(1500, 200, np.random.default_rng(1), "cpu")
    chip_smoke.check_pack(inp["a_desc"], inp["a_pm1"])
    for radius in chip_smoke.RADII:
        err, n_has = chip_smoke.compare_kernel(inp, radius)
        assert err == 0 and n_has > 0


def _valid_args():
    wa = pack_bits(torch.randint(0, 2, (8, 256), dtype=torch.int32))
    wb = pack_bits(torch.randint(0, 2, (5, 256), dtype=torch.int32))
    return [wa, unpack_pm1(wa), torch.zeros(8, 2), torch.zeros(8, dtype=torch.int32),
            torch.ones(8, dtype=torch.bool), wb, unpack_pm1(wb), torch.zeros(5, 2),
            torch.zeros(5, dtype=torch.int32), torch.ones(5, dtype=torch.bool)]


@pytest.mark.parametrize("pos,bad,exc", [
    (0, lambda t: t.to(torch.int64), TypeError),             # words dtype
    (2, lambda t: t.to(torch.float64), TypeError),           # uv dtype
    (4, lambda t: t.to(torch.uint8), TypeError),             # valid dtype
    (7, lambda t: t.T.contiguous().T, ValueError),           # uv non-contiguous
    (5, lambda t: t[:, :4], ValueError),                      # wrong shape / strided
    (1, lambda t: t[:4], ValueError),                         # pm1 rows != words rows
])
def test_wrapper_raises_instead_of_falling_back(pos, bad, exc):
    args = _valid_args()
    match_cuda.hamming_top2_windowed(*args, 10.0)           # the valid call runs
    args[pos] = bad(args[pos])
    with pytest.raises(exc):
        match_cuda.hamming_top2_windowed(*args, 10.0)


def test_wrapper_counts_only_kernel_launches():
    before = match_cuda.LIB.launches
    match_cuda.hamming_top2_windowed(*_valid_args(), 10.0)   # CPU: the twin
    assert match_cuda.LIB.launches == before


@pytest.mark.parametrize("kernel", ["match_cuda", "pose_lm_cuda", "pose_vi_lm_cuda"])
def test_library_launch_counts_only_what_succeeded(kernel):
    """The launch every hand kernel's wrapper ends in
    (`cuda_build.Library.launch`), with the kernel's C entry replaced by a
    stub that returns 0, then CUDA error 7: the count rises on success only,
    and an error raises, naming the kernel and the error."""
    import copy
    from mc_slam_tpu_torch.solver import pose_lm_cuda, pose_vi_lm_cuda
    lib = copy.copy({"match_cuda": match_cuda, "pose_lm_cuda": pose_lm_cuda,
                     "pose_vi_lm_cuda": pose_vi_lm_cuda}[kernel].LIB)
    codes, seen = iter([0, 7]), []
    lib._fn = lambda *args: seen.append(args) or next(codes)
    n0 = lib.launches
    lib.launch(1, 2.5, None)
    assert lib.launches == n0 + 1 and seen == [(1, 2.5, None)]
    with pytest.raises(RuntimeError, match=f"^{lib.name} launch failed: CUDA error 7$"):
        lib.launch(3)
    assert lib.launches == n0 + 1 and len(seen) == 2
    assert lib.name == {"match_cuda": "hamming_top2_windowed",
                        "pose_lm_cuda": "pose_only_visual_lm",
                        "pose_vi_lm_cuda": "pose_only_vi_lm"}[kernel]


@pytest.mark.parametrize("with_angles", [False, True])
def test_search_by_projection(with_angles):
    rng = np.random.default_rng(5)
    M, N = 1536, 256
    d = _inputs(rng, M, N, width=320.0, ties=True)
    angle_a = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    angle_b = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    part = rng.random(M) < 0.5
    kw_j = kw_t = {}
    if with_angles:
        kw_j = dict(proj_angle=jnp.asarray(angle_a), feat_angle=jnp.asarray(angle_b),
                    proj_angle_valid=jnp.asarray(part))
        kw_t = dict(proj_angle=torch.from_numpy(angle_a),
                    feat_angle=torch.from_numpy(angle_b),
                    proj_angle_valid=torch.from_numpy(part))
    a = j_unpack_pm1(jnp.asarray(d["words_a"]))
    b = j_unpack_pm1(jnp.asarray(d["words_b"]))
    ij, dj, okj = jmatch.search_by_projection(
        jnp.asarray(d["a_uv"]), jnp.asarray(d["a_v"]), jnp.asarray(d["a_lvl"]), a,
        jnp.asarray(d["b_uv"]), jnp.asarray(d["b_lvl"]), b, jnp.asarray(d["b_v"]),
        radius_px=15.0, **kw_j)
    wa = torch.from_numpy(d["words_a"].view(np.int32))
    wb = torch.from_numpy(d["words_b"].view(np.int32))
    it, dt, okt = tmatch.search_by_projection(
        torch.from_numpy(d["a_uv"]), torch.from_numpy(d["a_v"]),
        torch.from_numpy(d["a_lvl"]), wa, unpack_pm1(wa), torch.from_numpy(d["b_uv"]),
        torch.from_numpy(d["b_lvl"]), wb, unpack_pm1(wb), torch.from_numpy(d["b_v"]),
        radius_px=15.0, **kw_t)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okj, okt.numpy())
    np.testing.assert_array_equal(np.asarray(ij)[okj], it.numpy()[okj])
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    assert okj.sum() > 20


def test_rotation_histogram_and_dedup():
    rng = np.random.default_rng(6)
    Na, Nb = 400, 150
    ang_a = rng.uniform(-np.pi, np.pi, Na).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, Nb).astype(np.float32)
    idx = rng.integers(0, Nb, Na)
    # a peaked histogram: most matches at a common rotation
    peaked = rng.random(Na) < 0.7
    ang_a[peaked] = (ang_b[idx[peaked]] + 0.3).astype(np.float32)
    matched = rng.random(Na) < 0.8
    part = rng.random(Na) < 0.8
    best = rng.integers(0, 60, Na).astype(np.int32)
    for p in (None, part):
        rj = jmatch.rotation_consistency_mask(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx), jnp.asarray(matched),
            participate=None if p is None else jnp.asarray(p))
        rt = tmatch.rotation_consistency_mask(
            torch.from_numpy(ang_a), torch.from_numpy(ang_b), torch.from_numpy(idx),
            torch.from_numpy(matched), participate=None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
        assert np.asarray(rj).sum() < matched.sum()
    dj = jmatch.resolve_duplicates(jnp.asarray(idx), jnp.asarray(best),
                                   jnp.asarray(matched), Nb)
    dt = tmatch.resolve_duplicates(torch.from_numpy(idx), torch.from_numpy(best),
                                   torch.from_numpy(matched), Nb)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_match_nn_and_hamming_matrix():
    rng = np.random.default_rng(7)
    wa = rng.integers(0, 2 ** 32, (120, 8), dtype=np.uint32)
    wb = rng.integers(0, 2 ** 32, (90, 8), dtype=np.uint32)
    a, b = j_unpack_pm1(jnp.asarray(wa)), j_unpack_pm1(jnp.asarray(wb))
    ta = unpack_pm1(torch.from_numpy(wa.view(np.int32)))
    tb = unpack_pm1(torch.from_numpy(wb.view(np.int32)))
    dj = np.asarray(jmatch.hamming_matrix(a, b))
    dt = tmatch.hamming_matrix(ta, tb)
    np.testing.assert_array_equal(dj, dt.numpy())
    np.testing.assert_array_equal(dj, np.asarray(jmatch.hamming_matrix_popcount(
        jnp.asarray(wa), jnp.asarray(wb))))
    mask = rng.random((120, 90)) < 0.3
    rmask = mask | (rng.random((120, 90)) < 0.3)
    for kw in ({}, {"ratio": 0.9}):
        ij, bj, okj = jmatch.match_nn(jnp.asarray(dj), jnp.asarray(mask), max_dist=120, **kw)
        it, bt, okt = tmatch.match_nn(dt, torch.from_numpy(mask), max_dist=120, **kw)
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
        np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    ij, bj, okj = jmatch.match_nn(jnp.asarray(dj), jnp.asarray(mask), max_dist=120,
                                  ratio=0.9, ratio_mask=jnp.asarray(rmask))
    it, bt, okt = tmatch.match_nn(dt, torch.from_numpy(mask), max_dist=120, ratio=0.9,
                                  ratio_mask=torch.from_numpy(rmask))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())


# ---- the batch dim (parallel/multiseq.py): B problems in one call ----

def _stack_port(ds):
    """The wrapper's ten inputs for the problems `ds`, stacked (B, ., .)."""
    cols = []
    for d in ds:
        wa = torch.from_numpy(d["words_a"].view(np.int32))
        wb = torch.from_numpy(d["words_b"].view(np.int32))
        cols.append([wa, unpack_pm1(wa), torch.from_numpy(d["a_uv"]),
                     torch.from_numpy(d["a_lvl"]), torch.from_numpy(d["a_v"]),
                     wb, unpack_pm1(wb), torch.from_numpy(d["b_uv"]),
                     torch.from_numpy(d["b_lvl"]), torch.from_numpy(d["b_v"])])
    return [torch.stack(c) for c in zip(*cols)]


@pytest.mark.parametrize("ties,radius", [(False, 15.0), (True, 4.0), (True, 40.0)])
def test_batched_twin_equals_per_problem_and_xla(ties, radius):
    """The wrapper on (B, M, .) / (B, N, .) CPU inputs (the batched twin):
    every problem exactly equal to the per-problem twin and to the JAX XLA
    path on that problem (best everywhere, idx / second where best < BIG)."""
    rng = np.random.default_rng(11)
    ds = [_inputs(rng, 700, 300, width=200.0, ties=ties) for _ in range(3)]
    best, second, idx = match_cuda.hamming_top2_windowed(*_stack_port(ds), radius)
    assert best.shape == (3, 700) and best.dtype == torch.int32
    for b, d in enumerate(ds):
        one = _port(d, radius)
        for got, want in zip((best[b], second[b], idx[b]), one):
            np.testing.assert_array_equal(got.numpy(), want)
        _assert_same(_xla_reference(d, radius), [t[b].numpy() for t in (best, second, idx)])


def test_batched_wrapper_validates_every_batch_dim():
    """One leading batch dim on every input or on none: a batch on one side
    only, or unequal B, raises; a batch of two dims raises."""
    rng = np.random.default_rng(12)
    args = _stack_port([_inputs(rng, 40, 20) for _ in range(2)])
    B, M, N = match_cuda.validate_inputs(*args)
    assert (B, M, N) == (2, 40, 20)
    for pos in (5, 7, 9):                         # candidates without the batch
        bad = list(args)
        bad[pos] = bad[pos][0]
        with pytest.raises(ValueError):
            match_cuda.hamming_top2_windowed(*bad, 10.0)
    bad = list(args)
    bad[2] = bad[2][:1]                           # uv of one problem only
    with pytest.raises(ValueError):
        match_cuda.hamming_top2_windowed(*bad, 10.0)
    with pytest.raises(ValueError):
        match_cuda.hamming_top2_windowed(*[a[None] for a in args], 10.0)


@pytest.mark.parametrize("with_angles", [False, True])
def test_batched_search_by_projection_equals_per_problem(with_angles):
    """search_by_projection with a leading B (one kernel launch on the card):
    indices, distances and the accepted mask of every problem exactly equal
    to the unbatched call on that problem (dedup per problem, ties to the
    lowest row; one rotation histogram per problem)."""
    rng = np.random.default_rng(13)
    M, N, B = 900, 200, 3
    ds = [_inputs(rng, M, N, width=240.0, ties=True) for _ in range(B)]
    ang_a = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, M)).astype(np.float32))
    ang_b = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, N)).astype(np.float32))
    part = torch.from_numpy(rng.random((B, M)) < 0.5)
    wa, pa, uva, la, va, wb, pb, uvb, lb, vb = _stack_port(ds)
    kw = (lambda s: dict(proj_angle=ang_a[s], feat_angle=ang_b[s],
                         proj_angle_valid=part[s])) if with_angles else (lambda s: {})
    it, dt, okt = tmatch.search_by_projection(uva, va, la, wa, pa, uvb, lb, wb, pb, vb,
                                              radius_px=15.0, **kw(slice(None)))
    assert it.shape == dt.shape == okt.shape == (B, M)
    for b in range(B):
        i1, d1, ok1 = tmatch.search_by_projection(uva[b], va[b], la[b], wa[b], pa[b],
                                                  uvb[b], lb[b], wb[b], pb[b], vb[b],
                                                  radius_px=15.0, **kw(b))
        assert torch.equal(ok1, okt[b]) and torch.equal(d1, dt[b])
        assert torch.equal(i1[ok1], it[b][ok1])
        assert int(ok1.sum()) > 20


def test_batched_compare_and_bound_helpers_on_cpu():
    """chip_smoke's batched comparison and bound (the phase "multiseq"):
    planted_inputs(batch=B) stacks B draws, compare_kernel holds the batch
    exactly, and the batched bound counts the bytes, pairs and passing pairs
    of every problem (their sums over the problems drawn alone)."""
    import chip_smoke
    inp = chip_smoke.planted_inputs(600, 128, np.random.default_rng(3), "cpu", batch=3)
    assert inp["a_desc"].shape == (3, 600, 8) and inp["b_pm1"].shape == (3, 128, 256)
    singles = [{k: v[b] for k, v in inp.items()} for b in range(3)]
    for radius in chip_smoke.RADII:
        err, n_has = chip_smoke.compare_kernel(inp, radius)
        assert err == 0 and n_has == sum(chip_smoke.compare_kernel(s, radius)[1]
                                         for s in singles)
        _, _, det = chip_smoke.search_bound(inp, radius)
        parts = [chip_smoke.search_bound(s, radius)[2] for s in singles]
        for key in ("bytes", "pairs", "passing_pairs", "operations"):
            assert det[key] == sum(p[key] for p in parts), key


def test_batched_extract_equals_per_image():
    """extractor.extract on (B, H, W) against extract on each image: every
    table equal but the IC angle, whose moments the batch takes in one
    stacked product (within 1e-4 rad; the descriptor bits stay equal)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from render import DotWorld
    from mc_slam_tpu_torch.frontend import extractor
    imgs = [DotWorld(np.random.default_rng(b), n_wall=300, n_front=80).render(
        np.eye(3, dtype=np.float32), np.asarray([0.03 * b, 0.01, 0.0], np.float32))
        for b in range(3)]
    fb = extractor.extract(torch.from_numpy(np.stack(imgs)), n_features=256, n_levels=3)
    assert fb.xy.shape == (3, 256, 2) and fb.desc.shape == (3, 256, 8)
    for b, img in enumerate(imgs):
        f = extractor.extract(torch.from_numpy(img), n_features=256, n_levels=3)
        for name in f._fields:
            if name == "angle":
                assert (fb.angle[b] - f.angle).abs().max() < 1e-4
            else:
                assert torch.equal(getattr(fb, name)[b], getattr(f, name)), name
