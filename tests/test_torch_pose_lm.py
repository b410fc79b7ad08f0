"""The pose LM kernel (`solver/pose_lm_cuda.py`, `csrc/pose_lm.cu`) and its
twin `ba.pose_only_visual_ref`.

On the CPU: the wrapper's input checks, and `ba.pose_only_visual` on CPU
tensors taking the twin (the same bits, no launch). Marked `card`: the
kernel against the twin on the card, at the batched localization step's
shapes (B = 11 problems, O = 1024 rows, Np = 16384 points, 10 iterations)
and at one problem without a batch dim, monocular and stereo, with gross
outliers and one problem whose Cholesky fails at every iteration; two
launches giving the same bits; views taken as their values; the launch
counter; the robust policy (gates, truncation) read from the Python modules.
The card tests skip without a CUDA device. This file imports no JAX, so on
the machine with the card it runs without the suite's conftest:

    python3 -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_pose_lm.py

Tolerances of the kernel against the twin: both run the same float32
arithmetic, but the 28 sums of each pass are taken in another order (a
block reduction against PyTorch's einsum), and the Jacobian products are
associated differently. That moves each accepted step by float32 rounding,
and where a candidate's cost ties the current one to rounding the two may
accept or reject differently; a converged pose then differs by about the
last step. Hence positions within 1e-4 m and rotations within 1e-4 rad (the
port's JAX-parity tolerances, tests/test_torch_solver.py; the card showed
gaps up to 3e-5 m), chi2 within 1e-2 relative plus 5e-2 (a pose gap of
3e-5 m moves the residual of a point 1.5 m away by ~0.01 px, so a row's
chi2 by ~2 |r| 0.01 px x its information: ~1 % of a large chi2, a few
hundredths near the gate), and inlier counts within 2 (a row on the gate).
The tolerances and the rotation gap are the kernel's module's
(`pose_lm_cuda.POSE_LM_*`, `rot_gap_rad`), by which `chip_smoke.py` holds the
kernel to its twin on recorded solves too.
"""
import math

import numpy as np
import pytest
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.solver import ba, factors, lm, pose_lm_cuda
from mc_slam_tpu_torch.solver.pose_lm_cuda import (
    POSE_LM_CHI2_ATOL as CHI2_ATOL, POSE_LM_CHI2_RTOL as CHI2_RTOL,
    POSE_LM_INLIER_TOL as INLIER_TOL, POSE_LM_POS_TOL as POS_TOL, POSE_LM_ROT_TOL as ROT_TOL,
    rot_gap_rad)

torch.set_num_threads(2)

FX, FY, CX, CY, W, H = 458.654, 457.296, 367.215, 248.375, 752, 480
BF = FX * 0.11
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])


def _rodrigues(phi):
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]]) / th
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def problems(seed, B, O, Np, stereo, fail=None, device="cpu"):
    """B localization problems drawn from `seed`: a body pose each, O rows
    of which ~20 % are gross outliers and ~10 % invalid, their points
    scattered in an Np-point table of the problem's own, and a start ~3 cm
    and ~1 degree off. `fail`: a problem whose information is negated, so
    that its normal equations are negative definite and the Cholesky fails
    at every iteration. Returns (P0, R0, pts_w, obs, camera, ext, P_true)
    with a leading B (B = None: no batch dim, one problem)."""
    rng = np.random.default_rng(seed)
    nb = 1 if B is None else B
    Rcb = TBC[:3, :3].T
    tcb = -Rcb @ TBC[:3, 3]
    P0, R0, pts, pt, uv, isig, valid, ur, Pt = ([] for _ in range(9))
    for b in range(nb):
        R = _rodrigues(rng.normal(size=3) * 0.5)
        P = rng.normal(size=3) * 3
        d = rng.uniform(1.5, 12.0, O)
        u_t, v_t = rng.uniform(0, W, O), rng.uniform(0, H, O)
        Xc = np.stack([(u_t - CX) / FX * d, (v_t - CY) / FY * d, d], 1)
        Xw = (R @ (Rcb.T @ (Xc - tcb).T)).T + P
        table = rng.normal(size=(Np, 3)) * 5
        idx = rng.choice(Np, O, replace=False)
        table[idx] = Xw
        lvl = rng.integers(0, 8, O)
        sig = 1.2 ** lvl
        u = u_t + rng.normal(size=O) * sig
        v = v_t + rng.normal(size=O) * sig
        out = rng.random(O) < 0.2
        u[out], v[out] = rng.uniform(0, W, out.sum()), rng.uniform(0, H, out.sum())
        has = rng.random(O) < 0.7
        r = np.where(has, u_t - BF / d + rng.normal(size=O) * sig, -1.0)
        info = 1.0 / sig ** 2
        if b == fail:
            info = -info
        P0.append(P + rng.normal(size=3) * 0.03)
        R0.append(R @ _rodrigues(rng.normal(size=3) * math.radians(1.0)))
        pts.append(table)
        pt.append(idx)
        uv.append(np.stack([u, v], 1))
        isig.append(info)
        valid.append((rng.random(O) < 0.9).astype(np.float64))
        ur.append(r)
        Pt.append(P)
    sel = (lambda x: x[0]) if B is None else np.stack
    f = lambda xs: torch.as_tensor(sel(xs), dtype=torch.float32, device=device)
    obs = ba.VisualObs(cam=torch.zeros(sel(pt).shape, dtype=torch.int64, device=device),
                       pt=torch.as_tensor(sel(pt), dtype=torch.int64, device=device),
                       uv=f(uv), inv_sigma2=f(isig), valid=f(valid),
                       ur=f(ur) if stereo else None)
    cam = make_camera(FX, FY, CX, CY, width=W, height=H, device=device)
    ext = factors.extrinsics_from_Tbc(TBC, device=device)
    return f(P0), f(R0), f(pts), obs, cam, ext, sel(Pt)


def _solve(fn, prob, iters, stereo):
    P0, R0, pts, obs, cam, ext, _ = prob
    return fn(P0, R0, pts, obs, cam, ext, iters=iters, bf=BF if stereo else 0.0)


# ---------------------------------------------------------------------------
# CPU


def _valid_args():
    P0, R0, pts, obs, cam, ext, _ = problems(0, 3, 40, 64, True)
    return dict(P0=P0, R0=R0, pts_w=pts, obs=obs, camera=cam, ext=ext, bf=BF)


def _bad(kind):
    a = _valid_args()
    obs = a["obs"]
    if kind == "dtype":
        a["P0"] = a["P0"].double()
    elif kind == "pt_dtype":
        a["obs"] = obs._replace(pt=obs.pt.to(torch.int32))
    elif kind == "shape":
        a["R0"] = torch.zeros(3, 3, 4)
    elif kind == "batch":
        a["pts_w"] = torch.cat([a["pts_w"], a["pts_w"][:1]])
    elif kind == "rows":
        a["obs"] = obs._replace(valid=obs.valid[:, :-1].contiguous())
    elif kind == "two_batch_dims":
        a["P0"] = a["P0"][None]
    elif kind == "contiguous":
        a["obs"] = obs._replace(uv=obs.uv.transpose(0, 1).contiguous().transpose(0, 1))
    elif kind == "too_many_rows":
        O = pose_lm_cuda.MAX_OBS + 1
        a["obs"] = ba.VisualObs(cam=torch.zeros(3, O, dtype=torch.int64),
                                pt=torch.zeros(3, O, dtype=torch.int64),
                                uv=torch.zeros(3, O, 2), inv_sigma2=torch.ones(3, O),
                                valid=torch.ones(3, O), ur=None)
    elif kind == "no_points":
        a["pts_w"] = torch.zeros(3, 0, 3)
    elif kind == "camera":
        a["camera"] = a["camera"]._replace(fx=a["camera"].fx.double())
    elif kind == "bf":
        a["bf"] = torch.full((1,), BF)
    return a


@pytest.mark.parametrize("kind", ["dtype", "pt_dtype", "shape", "batch", "rows",
                                  "two_batch_dims", "contiguous", "too_many_rows",
                                  "no_points", "camera", "bf"])
def test_validate_inputs_raises(kind):
    with pytest.raises((ValueError, TypeError)):
        pose_lm_cuda.validate_inputs(**_bad(kind))


def test_validate_inputs_accepts_both_layouts():
    assert pose_lm_cuda.validate_inputs(**_valid_args()) == (3, 40, 64)
    P0, R0, pts, obs, cam, ext, _ = problems(0, None, 40, 64, False)
    assert pose_lm_cuda.validate_inputs(P0, R0, pts, obs, cam, ext) == (None, 40, 64)


def test_wrapper_has_no_cpu_path():
    """The kernel's wrapper raises on CPU tensors: the twin is the
    dispatcher's (`ba.pose_only_visual`), never a fallback of the wrapper."""
    P0, R0, pts, obs, cam, ext, _ = problems(0, 2, 40, 64, False)
    with pytest.raises(ValueError, match="no kernel"):
        pose_lm_cuda.pose_only_visual_lm(P0, R0, pts, obs, cam, ext, iters=2,
                                         gates=(ba.CHI2_MONO, ba.CHI2_STEREO))


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("B", [None, 3])
def test_cpu_takes_the_twin(B, stereo):
    """On CPU tensors `pose_only_visual` is its twin, bit for bit, and
    launches nothing; the twin converges on these problems."""
    prob = problems(1, B, 256, 1024, stereo)
    n0 = pose_lm_cuda.LIB.launches
    got = _solve(ba.pose_only_visual, prob, 10, stereo)
    ref = _solve(ba.pose_only_visual_ref, prob, 10, stereo)
    assert pose_lm_cuda.LIB.launches == n0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    P, R, chi2, n_in = got
    lead = () if B is None else (B,)
    assert P.shape == lead + (3,) and R.shape == lead + (3, 3)
    assert chi2.shape == lead + (256,) and n_in.shape == lead and n_in.dtype == torch.int64
    assert np.abs(P.numpy() - prob[-1]).max() < 0.01


def test_cpu_twin_batch_matches_each_problem():
    """The batched twin solves each problem as the unbatched twin does."""
    prob = problems(2, 3, 256, 1024, True)
    P0, R0, pts, obs, cam, ext, _ = prob
    Pb, Rb, chi2b, nb = _solve(ba.pose_only_visual_ref, prob, 10, True)
    for b in range(3):
        ob = ba.VisualObs(*[None if x is None else x[b] for x in obs])
        P, R, chi2, n = ba.pose_only_visual_ref(P0[b], R0[b], pts[b], ob, cam, ext,
                                                iters=10, bf=BF)
        assert (P - Pb[b]).abs().max() < POS_TOL
        assert (R - Rb[b]).abs().max() < ROT_TOL
        assert abs(int(n) - int(nb[b])) <= INLIER_TOL


def test_cpu_twin_keeps_the_pose_when_cholesky_fails():
    """A problem with negative-definite normal equations rejects every
    candidate: it keeps its start (R normalized), the others converge."""
    prob = problems(3, 3, 256, 1024, False, fail=1)
    P0, R0 = prob[0], prob[1]
    P, R, _, _ = _solve(ba.pose_only_visual_ref, prob, 10, False)
    assert torch.equal(P[1], P0[1])
    assert torch.equal(R[1], lie.so3_normalize_fast(R0[1]))
    assert np.abs(P[[0, 2]].numpy() - prob[-1][[0, 2]]).max() < 0.01


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_close(got, ref):
    (P, R, chi2, n), (Pr, Rr, chi2r, nr) = got, ref
    assert P.shape == Pr.shape and R.shape == Rr.shape and chi2.shape == chi2r.shape
    assert n.shape == nr.shape and n.dtype == nr.dtype == torch.int64
    assert float((P - Pr).abs().max()) < POS_TOL
    assert rot_gap_rad(R, Rr) < ROT_TOL
    torch.testing.assert_close(chi2, chi2r, rtol=CHI2_RTOL, atol=CHI2_ATOL, equal_nan=True)
    assert int((n - nr).abs().max()) <= INLIER_TOL


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("B", [11, None])
def test_kernel_matches_twin_on_the_card(cuda, B, stereo):
    """At the batched step's shapes, with outliers and (batched) one problem
    whose Cholesky fails; that problem keeps its start (its position
    exactly, its rotation normalized)."""
    prob = problems(4, B, 1024, 16384, stereo, fail=None if B is None else 5, device=cuda)
    P0, R0, pts, obs, cam, ext, _ = prob
    # bf as the stereo system passes it: a 0-d tensor on the card
    kw = dict(iters=10, bf=torch.tensor(BF, device=cuda) if stereo else 0.0)
    n0 = pose_lm_cuda.LIB.launches
    got = ba.pose_only_visual(P0, R0, pts, obs, cam, ext, **kw)
    torch.cuda.synchronize()
    assert pose_lm_cuda.LIB.launches == n0 + 1
    ref = ba.pose_only_visual_ref(P0, R0, pts, obs, cam, ext, **kw)
    _assert_close(got, ref)
    ok = [b for b in range(11) if b != 5] if B is not None else slice(None)
    if B is not None:
        # the kernel's Gram-Schmidt rounds apart from PyTorch's norms
        assert torch.equal(got[0][5], prob[0][5])
        torch.testing.assert_close(got[1][5], lie.so3_normalize_fast(prob[1][5]),
                                   rtol=0, atol=1e-6)
    assert np.abs(got[0].cpu().numpy()[ok] - prob[-1][ok]).max() < 0.01


@pytest.mark.card
def test_kernel_batch_equals_each_problem_on_the_card(cuda):
    """Each block solves its problem alone: the batched launch gives every
    problem the bits of its own unbatched launch."""
    P0, R0, pts, obs, cam, ext, _ = prob = problems(5, 4, 1024, 16384, True, device=cuda)
    Pb, Rb, chi2b, nb = _solve(ba.pose_only_visual, prob, 10, True)
    for b in range(4):
        ob = ba.VisualObs(*[None if x is None else x[b] for x in obs])
        P, R, chi2, n = ba.pose_only_visual(P0[b], R0[b], pts[b], ob, cam, ext, iters=10,
                                            bf=BF)
        assert torch.equal(P, Pb[b]) and torch.equal(R, Rb[b])
        assert torch.equal(chi2, chi2b[b]) and torch.equal(n, nb[b])


@pytest.mark.card
def test_kernel_takes_views_as_their_values(cuda):
    """A view the twin takes (an expanded rotation, as tools/bench.py's
    batched step passes) gives the bits of its contiguous copy."""
    P0, R0, pts, obs, cam, ext, _ = problems(7, 8, 1024, 16384, False, device=cuda)
    R_view = R0[:1].expand(8, 3, 3)
    assert not R_view.is_contiguous()
    a = ba.pose_only_visual(P0, R_view, pts, obs, cam, ext, iters=10)
    b = ba.pose_only_visual(P0, R_view.contiguous(), pts, obs, cam, ext, iters=10)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_is_deterministic_and_counted(cuda, stereo):
    """Two launches give the same bits; the counter rises by one a call;
    rtol > 0 (the early stop) keeps to the twin too."""
    prob = problems(6, 11, 1024, 16384, stereo, device=cuda)
    n0 = pose_lm_cuda.LIB.launches
    a = _solve(ba.pose_only_visual, prob, 10, stereo)
    b = _solve(ba.pose_only_visual, prob, 10, stereo)
    torch.cuda.synchronize()
    assert pose_lm_cuda.LIB.launches == n0 + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    P0, R0, pts, obs, cam, ext, _ = prob
    kw = dict(iters=20, bf=BF if stereo else 0.0, rtol=1e-3)
    _assert_close(ba.pose_only_visual(P0, R0, pts, obs, cam, ext, **kw),
                  ba.pose_only_visual_ref(P0, R0, pts, obs, cam, ext, **kw))
    assert pose_lm_cuda.LIB.launches == n0 + 3


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_takes_the_robust_policy_from_python(cuda, stereo, monkeypatch):
    """The gates (ba.CHI2_MONO / CHI2_STEREO) and the truncation
    (lm.HUBER_TRUNC) reach the kernel at launch: with other values both the
    kernel and its twin move, and they still agree."""
    prob = problems(8, 11, 1024, 16384, stereo, device=cuda)
    before = _solve(ba.pose_only_visual, prob, 10, stereo)
    monkeypatch.setattr(ba, "CHI2_MONO", 3.0)
    monkeypatch.setattr(ba, "CHI2_STEREO", 5.0)
    monkeypatch.setattr(lm, "HUBER_TRUNC", 100.0)
    got = _solve(ba.pose_only_visual, prob, 10, stereo)
    _assert_close(got, _solve(ba.pose_only_visual_ref, prob, 10, stereo))
    assert not torch.equal(got[3], before[3])
